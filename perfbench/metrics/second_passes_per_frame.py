"""Second denoise passes per frame: the rescue gate's firings
(`fn.stats["second_passes"]` of the fused entry) over the frames of the
traced window. A pass that fires doubles the denoise of its frame."""


def read(r):
    return r["second_passes"] / r["frames"] if r["frames"] else None

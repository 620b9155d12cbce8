"""Device milliseconds of the glue per Bayer megapixel: every kernel of
the traced window that is neither a convolution or GEMM nor K1 nor a
copy (the bias curve, the VST and its inverse, the refine, the NLE's
thresholds, fits and histograms)."""


def read(r):
    t = r["class_s"].get("glue", 0.0)
    return t * 1e3 / r["mp"] if t > 0 and r["mp"] else None

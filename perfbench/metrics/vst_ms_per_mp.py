"""Device milliseconds a Bayer megapixel launched under the fused
entry's `yondx.sigma_corr`, `yondx.bias`, `yondx.vst` and
`yondx.inverse` spans: the guidance scale, the bias curve with its
Chebyshev fit and lookup, the forward VST with its normalisation, and
the inverse (spans.py)."""

ROWS = ("sigma_corr", "bias", "vst", "inverse")


def read(r):
    if not r.get("span_frames") or not r["mp"]:
        return None
    d = r["span_device_s"]
    return sum(d.get(k, 0.0) for k in ROWS) * 1e3 / r["mp"]

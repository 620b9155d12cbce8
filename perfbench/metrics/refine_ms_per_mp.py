"""Device milliseconds a Bayer megapixel launched under the fused
entry's `yondx.refine` spans: the method-noise Wiener refine, its
bucket floor and oriented shrink (spans.py)."""


def read(r):
    if not r.get("span_frames") or not r["mp"]:
        return None
    return r["span_device_s"].get("refine", 0.0) * 1e3 / r["mp"]

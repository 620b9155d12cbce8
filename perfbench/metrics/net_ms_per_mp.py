"""Device milliseconds a Bayer megapixel launched under the fused
entry's `yondx.net` spans: the SNR-Net from pad to unpad, its convs and
its own elementwise work (pad, clamp, casts, norms, residual adds)
alike (spans.py)."""


def read(r):
    if not r.get("span_frames") or not r["mp"]:
        return None
    return r["span_device_s"].get("net", 0.0) * 1e3 / r["mp"]

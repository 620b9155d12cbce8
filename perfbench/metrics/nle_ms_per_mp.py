"""Device milliseconds a Bayer megapixel launched under the fused
entry's `yondx.nle.self` and `yondx.nle.collab` spans: K1, the score3
threshold, the line fit, the MAD estimate and their combine
(spans.py)."""


def read(r):
    if not r.get("span_frames") or not r["mp"]:
        return None
    d = r["span_device_s"]
    return (d.get("nle.self", 0.0) + d.get("nle.collab", 0.0)) * 1e3 \
        / r["mp"]

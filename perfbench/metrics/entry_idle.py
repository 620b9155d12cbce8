"""Share of the frames' intervals, in %, in which the card was idle:
each frame's from its `yondx.frame` span's start to the end of the last
device operation it launched (spans.py). The idle between the harness's
calls is left out; the profiler slows the host's launches, as in
device_idle."""


def read(r):
    if not r.get("span_frames") or not r["span_frame_s"] > 0:
        return None
    return 100.0 * r["span_frame_idle_s"] / r["span_frame_s"]

"""Share of the untraced window, in %, in which the card was idle, as
far as the trace can tell: the traced window's device-busy time per
Bayer megapixel, times the megapixels of the untraced window, against
that window's host time. The profiler slows the host, so `device_idle`
(the traced window's own idle share) reads higher than a run without
it; this is the share that a gain on the host moves."""


def read(r):
    w, mp = r["plain_window_s"], r["plain_mp"]
    if not (w > 0 and mp > 0 and r["busy_s"] > 0 and r["mp"] > 0):
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["mp"] * mp / w)

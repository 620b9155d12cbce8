"""Share of the traced window, in %, in which no kernel, copy or memset
ran on the card. It is read under the profiler, which slows the host's
launches and so lengthens the gaps (device_idle_untraced estimates the
share without it)."""


def read(r):
    w = r["window_s"]
    return 100.0 * (1.0 - r["busy_s"] / w) if w > 0 and r["busy_s"] > 0 \
        else None

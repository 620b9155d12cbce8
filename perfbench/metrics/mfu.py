"""The whole frame's share of the card's peak, in %: the SNR-Net's
operations for every pass the untraced window ran (counts.py) over that
window's host time, against the configuration's peak."""


def read(r):
    w = r["plain_window_s"]
    return 100.0 * r["plain_net_flops"] / (r["peak_flops"] * w) \
        if w > 0 and r["plain_net_flops"] > 0 else None

"""Kernel K1 (csrc/nle_moments.cu) against its byte bound, in %: each
launch's input read once and outputs written once (counts.py, from the
band plan) over 3.35 TB/s, over K1's device time. Read only when the
trace holds as many K1 kernels as the port's launch counter counted."""


def read(r):
    t = r["class_s"].get("k1", 0.0)
    if t <= 0 or r["k1_events"] != r["k1_launches"]:
        return None
    return 100.0 * r["k1_bytes"] / r["hbm_bytes_per_s"] / t

"""The SNR-Net's convolutions against their roofline, in %: the least
time of every forward the window ran (each conv, transposed conv and
dense layer bounded by the larger of its operations over the
configuration's peak and its bytes over 3.35 TB/s, counts.py) over the
device time of the convolution and GEMM kernels."""


def read(r):
    t = r["class_s"].get("conv", 0.0)
    return 100.0 * r["net_bound_s"] / t if t > 0 else None

"""Device milliseconds of convolution and GEMM kernels (the SNR-Net's
cuDNN and cuBLAS work) per Bayer megapixel of the traced window."""


def read(r):
    t = r["class_s"].get("conv", 0.0)
    return t * 1e3 / r["mp"] if t > 0 and r["mp"] else None

"""The Wiener refine's CUDA kernels: the wrapper of csrc/refine.cu.

`wiener_refine` (refine.py) hands every CUDA tensor here: it launches the
kernels or raises. A CPU tensor runs the plain PyTorch version in
refine.py, which the CPU tests hold against the JAX package and the card
test against these kernels. There is no fallback between the two.

The kernels replace no TPU kernel: the JAX package leaves the refine to
XLA's fusion. They were added because the refine was the port's largest
stage on the card, ~555 eager launches and 22 ms of device time a
16.05 MP frame, with one blocking copy.

Bound on an H100 SXM at the product's shape: bytes. The refine reads
z_dn and z_noisy and writes its output (x01 is z_dn there), each
[1, 1736, 2312, 4] fp32, 64.2 MB: 192.6 MB, 0.057 ms at 3.35 TB/s. A few
hundred fp32 operations an output (~5 GFLOP) take ~0.07 ms at
67 TFLOP/s. The design (in the .cu file's note): the bucket floor's table
is made on the device by three small kernels, then one streaming pass per
a-trous level, each a 32 x 32 tile of all four channels with its halo in
shared memory, fp32 direct sums. 19 frame-sized plane reads and writes
(1.22 GB, 0.36 ms at 3.35 TB/s) and six launches a call. Its time is
reported beside this bound in PERF.md.

The kernels' settings are refine.py's (LEVELS, FLOOR_*, ...); the ones
compiled into the .cu file are checked against them when it loads.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..nle.boxfilter import box_mean
from ..nle.robust import _BAND, _band_plan
from .refine import (DIR_C0, DIR_C1, DIR_L, FLOOR_MAX_SAMPLES,
                     FLOOR_MIN_COUNT, FLOOR_NB, FLOOR_NBIN, FLOOR_Q,
                     FLOOR_SPAN, FLOOR_TRUST_HI, FLOOR_TRUST_LO, LEVELS,
                     STAB_K, _dir_mean_noise_vars, _local_floor, _q10_floor,
                     _starlet_noise_vars)

# launches of the refine kernels since the last reset (one per launch)
LAUNCHES = {"refine_floor": 0, "refine": 0}

_FIRST, _MID, _LAST = 0, 1, 2
_V_VALUE, _V_SCALAR, _V_MAP, _V_TABLE = 0, 1, 2, 3


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


class _Plane(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p)] + [
        (n, ctypes.c_longlong) for n in ("sl", "sy", "sx", "sc")]


class _PassArgs(ctypes.Structure):
    _fields_ = ([(n, _Plane) for n in ("zn", "zd", "x01", "vmap", "cin")]
                + [(n, ctypes.c_void_p) for n in ("cout", "rs", "st", "alpha",
                                                  "out", "vptr", "table")]
                + [(n, ctypes.c_int) for n in (
                    "L", "h", "w", "kind", "level", "m_ax", "k", "shrink",
                    "oriented", "ramp", "has_x01", "vmode")]
                + [(n, ctypes.c_float) for n in (
                    "vval", "dv", "nu_ax", "nu_dg", "beta", "allow_f",
                    "sat_lo", "inv_sat", "fa", "inv_1mfa", "c0", "c1")])


class _FloorArgs(ctypes.Structure):
    _fields_ = ([("zn", _Plane), ("zd", _Plane)]
                + [(n, ctypes.c_void_p) for n in ("counts", "part", "dmax",
                                                  "table", "vptr")]
                + [(n, ctypes.c_longlong) for n in ("n", "s", "ns")]
                + [(n, ctypes.c_int) for n in ("hh", "wh", "band", "step",
                                               "nparts", "min_count")]
                + [(n, ctypes.c_float) for n in (
                    "vval", "q", "trust_lo", "inv_trust", "den", "span",
                    "inv_span")])


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel library with the refine's entry points declared, once
    its argument structs and compiled settings are checked."""
    from ..cuda_build import load_library
    lib = load_library()
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in ("yondx_refine_sizeof", "yondx_refine_setting"):
        getattr(lib, name).argtypes = [i]
        getattr(lib, name).restype = i
    for which, cls in enumerate((_Plane, _PassArgs, _FloorArgs)):
        got = lib.yondx_refine_sizeof(which)
        if got != ctypes.sizeof(cls):
            raise RuntimeError(f"{cls.__name__} is {ctypes.sizeof(cls)} "
                               f"bytes, the library's {got}")
    want = (FLOOR_NB, FLOOR_NBIN, STAB_K, LEVELS)
    got = tuple(lib.yondx_refine_setting(j) for j in range(4))
    if got != want:
        raise RuntimeError(f"refine.cu is compiled for buckets, bins, gain "
                           f"box and levels {got}, refine.py sets {want}")
    lib.yondx_refine_pass.argtypes = [ctypes.POINTER(_PassArgs), p]
    lib.yondx_refine_pass.restype = i
    lib.yondx_refine_floor.argtypes = [ctypes.POINTER(_FloorArgs), i, i, p]
    lib.yondx_refine_floor.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def level_constants():
    """(det_vars, dir_vars): the a-trous bands' white-noise variance
    factors and their directional means' (refine.py's, computed once)."""
    det_vars, _ = _starlet_noise_vars(LEVELS)
    return tuple(det_vars), tuple(_dir_mean_noise_vars(LEVELS, DIR_L))


@functools.lru_cache(maxsize=None)
def erfinv_q(device: torch.device) -> float:
    """erfinv(FLOOR_Q) in float32 as the plain floor computes it on
    `device`: read once a device, so a refine makes no host sync."""
    return float(torch.erfinv(torch.tensor(FLOOR_Q, dtype=torch.float32,
                                           device=device)))


def _f32(v) -> float:
    return float(np.float32(v))


def _inv(div: float) -> float:
    """What torch multiplies a float32 CUDA tensor by to divide it by the
    Python number `div`: its reciprocal in double, rounded to float32."""
    return _f32(1.0 / div)


def _plane(x):
    """(_Plane of [L, h, w, 4] float32 x, the tensor it points into). The
    kernels take any strides; channels-contiguous pixels load as float4,
    so they must be 16-byte aligned."""
    st = x.stride()
    if st[-1] == 1 and (x.data_ptr() % 16 or any(s % 4 for s in st[:-1])):
        x = x.contiguous()
        st = x.stride()
    return _Plane(x.data_ptr(), *st), x


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"refine kernel ({what}) launch failed: "
                           f"cudaError {err}")


def floor_samples(L: int, h: int, w: int):
    """Where the bucket floor samples [L, h, w, 4] planes, as
    _bucket_floor_table does (_band_subsample_rows, then the Haar cells,
    then every s-th of them): (band, step, hh, wh, n, s, ns). Sampled row
    p is source row p // band * step + p % band; the Haar grid is
    hh x wh cells a plane; n cells in all, ns kept."""
    plan = _band_plan(h, w, L * 4, 4 * FLOOR_MAX_SAMPLES)
    if plan is None:
        rows, band, step = h, 1 << 30, 0
    else:
        keep, stride = plan
        rows, band, step = keep * _BAND, _BAND, stride * _BAND
    hh, wh = rows // 2, w // 2
    n = L * hh * wh * 4
    s = n // FLOOR_MAX_SAMPLES + 1 if n > FLOOR_MAX_SAMPLES else 1
    return band, step, hh, wh, n, s, (n + s - 1) // s


def _variance(noise_var, like, keep):
    """(vmode, vval, vptr, vmap _Plane) of a floor that is a number, a
    device scalar or a map broadcast to like's shape ([..., h, w, 4])."""
    if not isinstance(noise_var, torch.Tensor):
        return _V_VALUE, float(noise_var), None, _Plane()
    v = noise_var.to(device=like.device, dtype=torch.float32)
    keep.append(v)
    if v.numel() == 1:
        return _V_SCALAR, 0.0, v.data_ptr(), _Plane()
    vmap, vt = _plane(v.expand(like.shape).reshape((-1,) + like.shape[-3:])
                      .contiguous())
    keep.append(vt)
    return _V_MAP, 0.0, None, vmap


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _planes4(*ts):
    """The [..., h, w, 4] tensors as [L, h, w, 4]."""
    h, w = ts[0].shape[-3], ts[0].shape[-2]
    return [t.reshape(-1, h, w, 4) for t in ts]


def bucket_floor_table(z_dn, z_noisy, noise_var):
    """The bucket floor's [FLOOR_NB] table of float32 [..., h, w, 4] CUDA
    planes (refine._bucket_floor_table's) by three launches on the current
    stream, with no host sync; noise_var a number or a 0-d tensor."""
    zd4, zn4 = _planes4(z_dn, z_noisy)
    keep = []
    vmode, vval, vptr, _ = _variance(noise_var, z_dn, keep)
    if vmode == _V_MAP:
        raise ValueError("the bucket floor takes a scalar model variance")
    band, step, hh, wh, n, s, ns = floor_samples(*zd4.shape[:3])
    if n == 0:
        raise RuntimeError("the bucket floor needs planes of at least 2x2")
    nparts = min((ns + 1023) // 1024, 512)
    hist_blocks = min((ns + 4095) // 4096, 264)
    counts = torch.empty(FLOOR_NB * FLOOR_NBIN, dtype=torch.int32,
                         device=z_dn.device)
    buf = torch.empty(nparts + 1 + FLOOR_NB, device=z_dn.device)
    a = _FloorArgs()
    a.zn, zn = _plane(zn4)
    a.zd, zd = _plane(zd4)
    keep += [zn, zd]
    a.counts = counts.data_ptr()
    a.part = buf.data_ptr()
    a.dmax = buf.data_ptr() + 4 * nparts
    a.table = buf.data_ptr() + 4 * (nparts + 1)
    a.vptr, a.vval = vptr, vval
    a.n, a.s, a.ns = n, s, ns
    a.hh, a.wh, a.band, a.step = hh, wh, band, step
    a.nparts, a.min_count = nparts, FLOOR_MIN_COUNT
    a.q = FLOOR_Q
    a.trust_lo = FLOOR_TRUST_LO
    a.inv_trust = _inv(FLOOR_TRUST_HI - FLOOR_TRUST_LO)
    a.den = _f32(np.float32(erfinv_q(z_dn.device)) * np.float32(np.sqrt(2.0)))
    a.span = FLOOR_SPAN
    a.inv_span = _inv(FLOOR_SPAN)
    with torch.cuda.device(z_dn.device):
        lib, stream = _library(), _stream()
        for stage, blocks in ((0, nparts), (1, hist_blocks), (2, 1)):
            _check(lib.yondx_refine_floor(ctypes.byref(a), stage, blocks,
                                          stream), f"floor stage {stage}")
            LAUNCHES["refine_floor"] += 1
    return buf[nparts + 1:]


def wiener_refine_cuda(z_dn, z_noisy, noise_var, *, k, beta, deadband, x01,
                       sat_lo, sat_hi, noise_floor, floor_stride,
                       residual_shrink, shrink_lam, shrink_full_alpha,
                       shrink_mode):
    """wiener_refine on a CUDA device: the kernels, on the current stream
    of z_dn's device; arguments as wiener_refine's."""
    if residual_shrink and shrink_mode not in ("iso", "oriented"):
        raise ValueError(f"shrink mode {shrink_mode!r} is not 'iso' or "
                         "'oriented'")
    if noise_floor not in ("bucket", "local", "q10", "fixed"):
        raise ValueError(f"noise floor {noise_floor!r} is not one of "
                         "'bucket', 'local', 'q10', 'fixed'")
    shape = z_dn.shape
    if z_dn.ndim < 3 or shape[-1] != 4:
        raise ValueError(f"the refine kernels take [..., h, w, 4] planes, "
                         f"got {tuple(shape)}")
    for name, t in (("z_dn", z_dn), ("z_noisy", z_noisy), ("x01", x01)):
        if t is None:
            continue
        if t.shape != shape or t.dtype != torch.float32 \
                or t.device != z_dn.device:
            raise ValueError(f"{name} must be float32 {tuple(shape)} on "
                             f"{z_dn.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    h, w = shape[-3], shape[-2]
    zd4, zn4 = _planes4(z_dn, z_noisy)
    L = zd4.shape[0]
    keep = []   # every tensor a launch points into, alive until return

    a = _PassArgs()
    a.zn, t = _plane(zn4)
    keep.append(t)
    a.zd, t = _plane(zd4)
    keep.append(t)
    if x01 is z_dn:
        a.x01 = a.zd
    elif x01 is not None:
        a.x01, t = _plane(x01.reshape(-1, h, w, 4))
        keep.append(t)
    if noise_floor == "bucket":
        table = bucket_floor_table(z_dn, z_noisy, noise_var)
        keep.append(table)
        a.table, a.vmode = table.data_ptr(), _V_TABLE
    else:
        if noise_floor != "fixed":
            r = z_noisy - z_dn
            local_pow = box_mean(r * r, k)
            noise_var = (_local_floor(local_pow, noise_var, k)
                         if noise_floor == "local" else
                         _q10_floor(local_pow, noise_var, x01, k,
                                    floor_stride, sat_lo))
        a.vmode, a.vval, a.vptr, a.vmap = _variance(noise_var, z_dn, keep)
    a.L, a.h, a.w, a.k = L, h, w, k
    a.shrink, a.oriented = int(residual_shrink), int(shrink_mode == "oriented")
    a.ramp = int(residual_shrink and shrink_full_alpha < 1.0)
    a.has_x01 = int(x01 is not None)
    a.beta = beta
    a.allow_f = 1.0 + deadband * float(np.sqrt(2.0) / k)
    a.sat_lo = sat_lo
    a.inv_sat = _inv(sat_hi - sat_lo)
    fa = min(shrink_full_alpha, 1.0 - 1e-6)
    a.fa = fa
    a.inv_1mfa = _inv(1.0 - fa)
    a.c0, a.c1 = DIR_C0, DIR_C1

    out = torch.empty((L, h, w, 4), device=z_dn.device)
    a.out = out.data_ptr()
    kinds = [_FIRST]
    if residual_shrink:
        kinds += [_MID, _LAST]
        # c1 lives in `out` until the last pass writes over it
        scratch = torch.empty((4, L, h, w, 4), device=z_dn.device)
        keep.append(scratch)
        c2, rs, st, alpha = (scratch[i].data_ptr() for i in range(4))
        a.rs, a.st, a.alpha = rs, st, alpha
        det_vars, dir_vars = level_constants()
    with torch.cuda.device(z_dn.device):
        lib, stream = _library(), _stream()
        for j, kind in enumerate(kinds):
            a.kind, a.level = kind, j
            if residual_shrink:
                a.m_ax = min(DIR_L // 2,
                             max((min(h, w) - 1) // min(2 ** j, 4), 0))
                a.dv = shrink_lam * det_vars[j]
                a.nu_ax, a.nu_dg = (v / 4 for v in dir_vars[j])
                a.cin = (_Plane(out.data_ptr(), *out.stride()) if j == 1
                         else _Plane(c2, *out.stride()) if j == 2
                         else _Plane())
                a.cout = out.data_ptr() if j == 0 else c2
            _check(lib.yondx_refine_pass(ctypes.byref(a), stream),
                   f"pass {j}")
            LAUNCHES["refine"] += 1
    return out.reshape(shape)

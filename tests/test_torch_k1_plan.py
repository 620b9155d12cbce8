"""K1's tiling and index plan (yondx_torch/csrc/nle_moments.cu), emulated
in PyTorch on the CPU, against the JAX `nle_moments` on all three maps and
in all three flavours (self: mean, var, tex; collab dn: mean, var; collab
lr: var).

Only the card runs K1. This emulation follows its plan step for step in
fp32: the tile sizes and run limit read from the source, the staging with
periodic reflect-101 indices, the shift by one sample of the tile, the
order of the passes, and sliding sums over runs that restart, with run
lengths from the same rule as the source's run_length. It lives here only:
the package's plain version is the prefix-sum one in
yondx_torch/nle/boxfilter.py, which chip_smoke.py holds K1 against.
"""
import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from yondx.nle import boxfilter as j_box
from torch_test_util import _one_torch_thread  # noqa: F401

SRC = (Path(__file__).resolve().parents[1] / "yondx_torch" / "csrc"
       / "nle_moments.cu")
K, INNER = 29, 19


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         SRC.read_text()).group(1))


TH, TW, NTHREADS, MAX_RUN = (_const(n) for n in
                             ("TH", "TW", "NTHREADS", "MAX_RUN"))


def _cdiv(a, b):
    return -(-a // b)


def run_length(lanes, n, k):
    """The source's run_length: the run (at most MAX_RUN) minimising the
    block's passes over its runs times one run's cost; ties keep the
    longer run."""
    best, best_cost = 1, None
    for r in range(min(n, MAX_RUN), 0, -1):
        cost = _cdiv(lanes * _cdiv(n, r), NTHREADS) * (k + 2 * (r - 1))
        if best_cost is None or cost < best_cost:
            best, best_cost = r, cost
    return best


def geometry(k, inner, tex):
    """The source's Geom, as far as staging needs it: halo, staged tile
    and the x-moment rows and t1 columns."""
    kh = k // 2
    P = kh + (inner // 2 if tex else 0)
    return dict(kh=kh, P=P, RH=TH + 2 * P, RW=TW + 2 * P, MH=TH + 2 * kh,
                TWK=TW + 2 * kh)


def reflect101(i, n):
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


class _Sum:
    """fp32 running sum, plain or compensated (the source's Kahan)."""

    def __init__(self, shape, kahan):
        self.s = torch.zeros(shape)
        self.c = torch.zeros(shape) if kahan else None

    def add(self, v):
        if self.c is None:
            self.s = self.s + v
            return
        y = v - self.c
        t = self.s + y
        self.c = (t - self.s) - y
        self.s = t


def slide(x, n, k, r, scale=1.0, sub=0.0, kahan=False):
    """Sliding k-sums along the last axis, times scale, less sub: n
    outputs in runs of r, each opened by a direct sum and then slid (add
    the entering sample, subtract the leaving one), as hpass / vpass /
    vlast do; kahan compensates the sum, as in hpass<true> and vlast."""
    nruns = _cdiv(n, r)
    need = nruns * r + k - 1
    if need > x.shape[-1]:
        # feeds only the outputs past n of the last run
        x = torch.nn.functional.pad(x, (0, need - x.shape[-1]))
    starts = torch.arange(nruns) * r
    s = _Sum(x.shape[:-1] + (nruns,), kahan)
    for d in range(k):
        s.add(x[..., starts + d])
    outs = [s.s * scale - sub]
    for t in range(1, r):
        s.add(x[..., starts + t + k - 1] - x[..., starts + t - 1])
        outs.append(s.s * scale - sub)
    out = torch.stack(outs, -1).reshape(x.shape[:-1] + (nruns * r,))
    return out[..., :n]


def vslide(x, n, k, r, kahan=False):
    return slide(x.transpose(-1, -2), n, k, r,
                 kahan=kahan).transpose(-1, -2)


def k1_plan(x, k, inner, texture, mean):
    """[L, H, W, C] fp32 -> (mean, var, tex) by K1's plan; skipped maps
    are None."""
    L, H, W, C = x.shape
    g = geometry(k, inner, texture)
    P, kh, MH = g["P"], g["kh"], g["MH"]
    y0 = torch.arange(_cdiv(H, TH)) * TH
    x0 = torch.arange(_cdiv(W, TW)) * TW
    gy = reflect101(y0[:, None] - P + torch.arange(g["RH"]), H)
    gx = reflect101(x0[:, None] - P + torch.arange(g["RW"]), W)
    xc = x.permute(0, 3, 1, 2)                              # [L, C, H, W]
    tiles = xc[:, :, gy[:, None, :, None], gx[None, :, None, :]]
    rows = torch.clamp(H - y0, max=TH)
    cols = torch.clamp(W - x0, max=TW)
    shift = xc[:, :, (y0 + rows // 2)[:, None], (x0 + cols // 2)[None, :]]
    sx = tiles - shift[..., None, None]       # [L, C, ty, tx, RH, RW]

    inv_k2 = 1.0 / (k * k)
    run_hk, run_vk = run_length(MH, TW, k), run_length(TW, TH, k)

    def k_moments(t):
        """(E, E2 - E^2) of the k x k windows of t (MH rows, >= TW+2kh
        columns), as hpass<true> then vlast, both compensated."""
        u = slide(t, TW, k, run_hk, kahan=True)
        u2 = slide(t * t, TW, k, run_hk, kahan=True)
        s, s2 = (vslide(a, TH, k, run_vk, kahan=True) for a in (u, u2))
        m = s * inv_k2
        return m, torch.clamp(s2 * inv_k2 - m * m, min=0.0)

    off = P - kh
    m, var = k_moments(sx[..., off:off + MH, off:])
    out = [m + shift[..., None, None] if mean else None, var, None]
    if texture:
        vi = vslide(sx, MH, inner, run_length(g["RW"], MH, inner))
        # t1's own shift: its value at the tile's sample
        cr, cc = rows // 2 + kh, cols // 2 + kh
        t_shift = torch.zeros(vi.shape[:-2])
        for d in range(inner):
            t_shift = t_shift + vi[:, :, torch.arange(len(y0))[:, None],
                                   torch.arange(len(x0))[None, :],
                                   cr[:, None], (cc + d)[None, :]]
        inv_i2 = 1.0 / (inner * inner)
        t1 = slide(vi, g["TWK"], inner, run_length(MH, g["TWK"], inner),
                   scale=inv_i2, sub=(t_shift * inv_i2)[..., None, None])
        _, tvar = k_moments(t1)
        out[2] = torch.sqrt(tvar)

    def untile(t):
        ty, tx = t.shape[2], t.shape[3]
        t = t.permute(0, 2, 4, 3, 5, 1).reshape(L, ty * TH, tx * TW, C)
        return t[:, :H, :W, :]
    return tuple(None if t is None else untile(t) for t in out)


FLAVOURS = {"self": (True, True), "collab_dn": (False, True),
            "collab_lr": (False, False)}


@pytest.mark.parametrize("flavour", sorted(FLAVOURS))
@pytest.mark.parametrize("h", [1, 15, 23, 40, 300])
def test_k1_plan_matches_jax(h, flavour):
    """w = 520: 9 column tiles, the last one ragged; h = 300: 5 row tiles,
    the last ragged; h < 24: one tile taller than its plane."""
    texture, mean = FLAVOURS[flavour]
    x = np.random.default_rng(h).random((1, h, 520, 4)).astype(np.float32)
    got = k1_plan(torch.from_numpy(x), K, INNER, texture, mean)
    xj = jnp.asarray(x)
    if texture:
        ref = j_box.nle_moments(xj, K, INNER)
    elif mean:
        ref = (*j_box.mean_varfilt(xj, K), None)
    else:
        ref = (None, np.maximum(np.asarray(j_box.varfilt(xj, K)), 0.0), None)
    # fp32: K1's per-tile shift and sliding sums vs JAX's per-plane
    # centered prefix sums; the atol of the plain version's own parity
    # test (tests/test_torch_moments.py)
    for key, g, r, tol in zip(("mean", "var", "tex"), got, ref,
                              (2e-6, 1e-6, 1e-5)):
        assert (g is None) == (r is None), key
        if g is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=tol,
                                       err_msg=key)


def test_k1_plan_constant_plane_is_exact():
    """A constant plane shifts to exact zeros: mean is the constant, var
    and tex are 0, as chip_smoke.py asks of K1 on the card."""
    x = torch.full((1, 64, 96, 4), 0.37)
    m, v, t = k1_plan(x, K, INNER, True, True)
    assert torch.equal(m, x)
    assert float(v.abs().max()) == 0.0 and float(t.abs().max()) == 0.0


def _content(h, w, seed):
    """Image content as chip_smoke.py's make_frame makes it, as RGGB
    planes: flat levels in [0.05, 0.75) with Poisson-Gaussian noise and
    step edges between them."""
    rng = np.random.default_rng(seed)
    levels = rng.random((4, 6)) * 0.7 + 0.05
    clean = np.kron(levels, np.ones((2 * h // 4, 2 * w // 6)))
    noisy = (8.74 * rng.poisson(clean * 959.0 / 8.74)
             + rng.normal(0, 12.81, clean.shape)) / 959.0
    bayer = np.clip(noisy, 0, 1).astype(np.float32)
    return bayer.reshape(h, 2, w, 2).transpose(0, 2, 1, 3).reshape(1, h, w, 4)


def _direct64(x, k, inner):
    """(mean, var, tex^2) from float64 direct box sums, reflect-101."""
    def box(a, n):
        p = n // 2
        for ax in (1, 2):
            a = np.pad(a, [(0, 0)] * ax + [(p, p)] + [(0, 0)] * (3 - ax),
                       mode="reflect")
            cs = np.cumsum(a, axis=ax)
            cs = np.concatenate([np.zeros_like(np.take(cs, [0], axis=ax)),
                                 cs], axis=ax)
            m = a.shape[ax] - 2 * p
            a = (np.take(cs, np.arange(n, n + m), axis=ax)
                 - np.take(cs, np.arange(m), axis=ax)) / n
        return a
    x = x.astype(np.float64)
    m = box(x, k)
    t1 = box(x, inner)
    tm = box(t1, k)
    return m, box(x * x, k) - m * m, box(t1 * t1, k) - tm * tm


def test_plain_version_in_float64_is_float64():
    """The plain version keeps float64 input in float64 through its
    prefix sums: the reference chip_smoke.py holds K1 to on the card,
    where a float32 scan over the 50.3 MP frame's columns of image
    content drifted 7.5e-6 in the mean and 4.7e-6 in var. Against float64
    direct sums within 1e-12."""
    from yondx_torch.nle.boxfilter import nle_moments
    x = _content(96, 150, 1)
    m, v, t = nle_moments(torch.from_numpy(x).double(), K, INNER)
    assert m.dtype == v.dtype == t.dtype == torch.float64
    rm, rv, rt = _direct64(x, K, INNER)
    for g, r in ((m, rm), (v, rv), (t ** 2, rt)):
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-12)


def test_k1_plan_on_image_content_meets_k1_tol():
    """K1's plan on image content (flat levels, noise, step edges of up
    to 0.7, the shift often across an edge from a dark flat) against
    float64 within chip_smoke.py's K1_TOL (mean 1e-5, var 1e-6; tex^2
    held to the var bound, tex near 0 on the flats)."""
    x = _content(200, 390, 2)
    m, v, t = k1_plan(torch.from_numpy(x), K, INNER, True, True)
    rm, rv, rt = _direct64(x, K, INNER)
    assert np.abs(m.numpy() - rm).max() < 1e-5
    assert np.abs(v.numpy() - rv).max() < 1e-6
    assert np.abs(t.numpy().astype(np.float64) ** 2 - rt).max() < 1e-6

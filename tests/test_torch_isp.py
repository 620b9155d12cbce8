"""The port's ISP (yondx_torch/isp/: the rest of bayer, raw_io, filters,
demosaic, render) against the JAX package's and cv2 on the CPU, on
numpy-seeded inputs.

Tolerances: bit-equal where JAX's function is integer arithmetic or pure
indexing (flips, row splits, packing, the DN casts, the 3x3 median) and
for the demosaic and the 3x3 median against cv2 (5.0); `bayer2gray` and
`blur1d_log` within 1e-6; `guided_filter`, `fast_guided_filter`,
`bilateral_1d` and `row_denoise` within 1e-5 (float32 box means and
sums in another order); `fast_isp`, `simple_isp` and
`process_sidd_image` equal to JAX's in uint8 (the renders' truncating
casts) and within 1e-12 in float64; `process_rggb` within one 8-bit
level.
"""
import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yondx.isp import bayer as j_bayer
from yondx.isp import filters as j_filters
from yondx.isp import raw_io as j_raw
from yondx.isp import render as j_render

from yondx_torch.core.png import read_png
from yondx_torch.isp import bayer as t_bayer
from yondx_torch.isp import filters as t_filters
from yondx_torch.isp import raw_io as t_raw
from yondx_torch.isp import render as t_render
from yondx_torch.isp.demosaic import demosaic_ea

from torch_test_util import _one_torch_thread  # noqa: F401

PATTERNS = (((1, 2), (2, 3)), ((2, 1), (3, 2)), ((2, 3), (1, 2)),
            ((3, 2), (2, 1)))


def _rng(seed):
    return np.random.default_rng(seed)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


# ------------------------------------------------------------------ bayer
def test_bayer_helpers_match_jax():
    """flip_bayer by each pattern, bayer2rows / rows2bayer with leading
    dims: bit-equal; bayer2gray (symmetric border, [1,2,1]/4) to 1e-6."""
    x = _rng(0).random((2, 3, 8, 10)).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    for pat in PATTERNS:
        np.testing.assert_array_equal(_np(t_bayer.flip_bayer(xt, pat)),
                                      np.asarray(j_bayer.flip_bayer(xj, pat)))
    with pytest.raises(ValueError):
        t_bayer.flip_bayer(xt, ((1, 1), (1, 1)))
    rows = t_bayer.bayer2rows(xt)
    assert rows.shape == (2, 3, 2, 4, 10)
    np.testing.assert_array_equal(_np(rows),
                                  np.asarray(j_bayer.bayer2rows(xj)))
    np.testing.assert_array_equal(_np(t_bayer.rows2bayer(rows)), x)
    np.testing.assert_allclose(_np(t_bayer.bayer2gray(xt)),
                               np.asarray(j_bayer.bayer2gray(xj)),
                               rtol=0, atol=1e-6)


# ----------------------------------------------------------------- raw_io
def test_raw_io_matches_jax():
    """Packing, the DN casts, space-to-depth and the BGGR turns, on numpy
    and on tensors: bit-equal."""
    rng = _rng(1)
    raw = rng.random((16, 20)).astype(np.float32)
    raw16 = rng.integers(0, 1024, (16, 20)).astype(np.uint16)
    p4 = t_raw.pack_raw(raw)
    np.testing.assert_array_equal(p4, np.asarray(j_raw.pack_raw(raw)))
    np.testing.assert_array_equal(t_raw.unpack_raw(p4),
                                  np.asarray(j_raw.unpack_raw(p4)))
    assert isinstance(t_raw.pack_raw(torch.from_numpy(raw)), torch.Tensor)
    for kw in ({}, {"norm": False}, {"wp": 16383, "bl": 512, "clip": True,
                                     "bias": np.array([1.0, 2.0, 3.0, 4.0])}):
        got = t_raw.raw2bayer(raw16, **kw)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, j_raw.raw2bayer(raw16, **kw))
    pk = rng.random((4, 8, 10)).astype(np.float32) * 1.2 - 0.1
    got = t_raw.bayer2raw(pk)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, j_raw.bayer2raw(pk))
    np.testing.assert_array_equal(
        t_raw.bayer2raw(torch.from_numpy(pk)).to(torch.int32).numpy(), got)
    x = rng.random((8, 12, 3))
    np.testing.assert_array_equal(t_raw.space_to_depth(x),
                                  j_raw.space_to_depth(x))
    y = j_raw.space_to_depth(x)
    np.testing.assert_array_equal(t_raw.depth_to_space(y),
                                  j_raw.depth_to_space(y))
    for cam in ("IP", "S6", "GP", "N6", "G4"):
        np.testing.assert_array_equal(t_raw.to_bggr(raw, cam),
                                      j_raw.to_bggr(raw, cam))
        np.testing.assert_array_equal(t_raw.from_bggr(raw, cam),
                                      j_raw.from_bggr(raw, cam))


@pytest.mark.parametrize("shape", [(1, 2), (2, 3), (5, 7), (40, 52)])
def test_median3x3_matches_cv2(shape):
    """cv2.medianBlur(x, 3) on float32 planes (replicated borders),
    ties included."""
    x = _rng(2).random(shape).astype(np.float32)
    x[0, 0] = x[0, 1]
    np.testing.assert_array_equal(t_raw.median3x3(x), cv2.medianBlur(x, 3))


@pytest.mark.parametrize("dtype", [np.float32, np.uint16, np.float64])
def test_repair_bad_pixels_matches_jax(dtype):
    rng = _rng(3)
    raw = (rng.random((16, 20)) * 1000).astype(dtype)
    pts = [(0, 0), (3, 5), (15, 19), (8, 2)]
    got = t_raw.repair_bad_pixels(raw, pts)
    assert got.dtype == raw.dtype
    np.testing.assert_array_equal(got, j_raw.repair_bad_pixels(raw, pts))


# ---------------------------------------------------------------- filters
def test_filters_match_jax():
    rng = _rng(4)
    T, J = torch.from_numpy, jnp.asarray
    for shape in ((40, 52), (40, 52, 3)):
        p = rng.random(shape).astype(np.float32)
        g = rng.random(shape).astype(np.float32)
        for fn, kw in ((t_filters.guided_filter, {"d": 7, "eps": 0.01}),
                       (t_filters.fast_guided_filter, {"d": 5, "eps": 0.1})):
            ref = getattr(j_filters, fn.__name__)(J(p), J(g), **kw)
            np.testing.assert_allclose(_np(fn(T(p), T(g), **kw)),
                                       np.asarray(ref), rtol=0, atol=1e-5)
    s = rng.random(60).astype(np.float32)
    np.testing.assert_allclose(
        _np(t_filters.bilateral_1d(T(s), 25, 0.3, 1.5)),
        np.asarray(j_filters.bilateral_1d(J(s), 25, 0.3, 1.5)),
        rtol=0, atol=1e-5)
    b = rng.random((40, 52)).astype(np.float32)
    b += rng.normal(0, 0.05, (40, 1)).astype(np.float32)   # row noise
    np.testing.assert_allclose(_np(t_filters.row_denoise(T(b), 400.0)),
                               np.asarray(j_filters.row_denoise(J(b), 400.0)),
                               rtol=0, atol=1e-5)
    pos = rng.random((30, 3)).astype(np.float32) + 0.1
    for kw in ({}, {"c": 0.3, "log": False}):
        np.testing.assert_allclose(_np(t_filters.blur1d_log(T(pos), **kw)),
                                   np.asarray(j_filters.blur1d_log(J(pos),
                                                                   **kw)),
                                   rtol=0, atol=1e-6)


# --------------------------------------------------------------- demosaic
def _cv2_ea(x):
    return cv2.cvtColor(x, cv2.COLOR_BayerBG2RGB_EA)


@pytest.mark.parametrize("shape", [(16, 18), (9, 11), (6, 6), (64, 81),
                                   (33, 48)])
def test_demosaic_matches_cv2_random(shape):
    """Random 14-bit frames of even and odd sizes, and 2-bit ones (ties
    between the gradients everywhere): bit-equal, uint16 in and out."""
    rng = _rng(shape[0])
    for hi in (16384, 4):
        x = rng.integers(0, hi, shape).astype(np.uint16)
        got = demosaic_ea(x)
        assert got.dtype == np.uint16 and got.shape == shape + (3,)
        np.testing.assert_array_equal(got, _cv2_ea(x))


def test_demosaic_matches_cv2_small_and_periodic():
    """Every size from 2x2 to 4x4, and a periodic frame full of gradient
    ties; a torch input gives a torch output."""
    rng = _rng(5)
    for H in range(2, 5):
        for W in range(2, 5):
            x = rng.integers(0, 16384, (H, W)).astype(np.uint16)
            np.testing.assert_array_equal(demosaic_ea(x), _cv2_ea(x))
    p = np.tile(np.array([[100, 200, 100, 300], [200, 100, 400, 100],
                          [100, 300, 100, 200], [400, 100, 200, 100]],
                         np.uint16), (6, 7))
    np.testing.assert_array_equal(demosaic_ea(p), _cv2_ea(p))
    got = demosaic_ea(torch.from_numpy(p.astype(np.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _cv2_ea(p))


# ----------------------------------------------------------------- render
def _u8(img):
    return np.uint8(np.asarray(img) * 255)


def test_fast_isp_matches_jax():
    """RGBG planes with and without wb and CCM (float32 gains, as the
    trainer's sample carries them, and float64 ones): uint8-equal and
    within 1e-12 in float64; a tensor input gives a tensor output."""
    rng = _rng(6)
    x = rng.random((24, 20, 4)).astype(np.float32)
    wb32 = np.array([1.9, 1.0, 1.6, 1.0], np.float32)
    ccm = rng.normal(0, 0.2, (3, 3)) + np.eye(3)
    for kw in ({}, {"wb": wb32, "ccm": ccm.astype(np.float32)},
               {"wb": wb32.astype(np.float64), "ccm": ccm, "gamma": 2.4}):
        ref = j_render.fast_isp(x, **kw)
        got = t_render.fast_isp(x, **kw)
        assert got.shape == ref.shape == (48, 40, 3)
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(_u8(got), _u8(ref))
    got_t = t_render.fast_isp(torch.from_numpy(x), wb=torch.from_numpy(wb32),
                              ccm=ccm)
    assert isinstance(got_t, torch.Tensor)
    np.testing.assert_array_equal(
        _u8(got_t.numpy()), _u8(j_render.fast_isp(x, wb=wb32, ccm=ccm)))


def test_simple_isp_matches_jax():
    rng = _rng(7)
    x = rng.random((12, 10, 4)) * 16383
    for kw in ({}, {"wb": np.array([1.5, 1, 1, 1.2], np.float32)},
               {"bl": 64, "wp": 1023, "gamma": 1.0}):
        ref = j_render.simple_isp(x, **kw)
        got = t_render.simple_isp(x, **kw)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_process_sidd_image_matches_jax(pattern, tmp_path):
    """BGR uint8, equal to JAX's, for each CFA; the PNG's pixels equal
    those of the PNG cv2 writes for JAX."""
    rng = _rng(8)
    bayer = (rng.random((32, 48)) * 1.1 - 0.05).astype(np.float32)
    wb = np.array([0.52, 1.0, 0.61])
    cst2 = np.eye(3) * 0.8 + rng.random((3, 3)) * 0.1
    fj, ft = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    ref = j_render.process_sidd_image(bayer, pattern, wb, cst2,
                                      save_file_rgb=fj)
    got = t_render.process_sidd_image(bayer, pattern, wb, cst2,
                                      save_file_rgb=ft)
    assert got.dtype == np.uint8 and got.shape == (32, 48, 3)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(read_png(ft), cv2.imread(fj)[:, :, ::-1])
    got_t = t_render.process_sidd_image(torch.from_numpy(bayer), pattern, wb,
                                        cst2)
    np.testing.assert_array_equal(got_t.numpy(), ref)


def test_process_rggb_within_one_level():
    rng = _rng(9)
    x = rng.random((2, 16, 12, 4)).astype(np.float32)
    wb = (rng.random((2, 4)) + 0.8).astype(np.float32)
    m = (np.eye(3) + rng.normal(0, 0.1, (2, 3, 3))).astype(np.float32)
    ref = np.asarray(j_render.process_rggb(jnp.asarray(x), jnp.asarray(wb),
                                           jnp.asarray(m)))
    got = t_render.process_rggb(torch.from_numpy(x), torch.from_numpy(wb),
                                torch.from_numpy(m)).numpy()
    assert got.shape == ref.shape == (2, 16, 12, 3)
    assert np.abs(got - ref).max() <= 1 / 255 + 1e-7


def test_raw2rgb_rawpy_raises_naming_rawpy(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "rawpy", None)
    with pytest.raises(ImportError, match="rawpy"):
        t_render.raw2rgb_rawpy(np.zeros((8, 8, 4), np.float32))

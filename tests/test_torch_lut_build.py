"""The port's bias-table builders and NLE host helpers against the JAX
package and the committed tables, on the CPU.

Tolerances: the table builders, bias_points_numeric, pg_pdf_grid,
bias_curve_for and ransac_linefit are the same numpy/scipy arithmetic as
the JAX package's and are held bit for bit (the committed
checkpoints/bias_lut_2d.npy columns and bias_lut_sgext.npy too);
var_corr (prefix sums in torch and in XLA) to atol 2e-6; np_box_mean
against cv2.blur to 2 ulps in float32 (rtol 2.5e-7), rtol 1e-13 in
float64, exactly in uint8. The whole 2-D table takes minutes: one
16-column block of it is built here.
"""
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yondx.nle import boxfilter as j_box
from yondx.nle import fit as j_fit
from yondx.vst import bias as j_bias
from yondx.vst import lut as j_lut

from yondx_torch.nle import boxfilter as t_box
from yondx_torch.nle import fit as t_fit
from yondx_torch.vst import bias as t_bias
from yondx_torch.vst import lut as t_lut
from torch_test_util import _one_torch_thread  # noqa: F401

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints")


def test_bias_lut_block_bit_equal_to_committed():
    """Columns 600:616 (sg 5.00-5.15 e-) of the 2-D table, built as
    build_bias_lut builds them."""
    want = np.load(os.path.join(CKPT, "bias_lut_2d.npy"))[:, 600:616]
    got = t_lut.bias_lut_columns(600, 616).astype(np.float32)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def built_sgext(tmp_path_factory):
    """load_sgext_lut next to a main table that does not exist: it builds
    the extension table and writes it beside that path."""
    d = tmp_path_factory.mktemp("lut")
    main = str(d / "bias_lut_2d.npy")
    return d, t_lut.load_sgext_lut(main)


def test_build_bias_lut_sgext_bit_equal_to_committed(built_sgext):
    _, got = built_sgext
    np.testing.assert_array_equal(
        got, np.load(os.path.join(CKPT, "bias_lut_sgext.npy")))


def test_missing_sgext_table_is_written_and_reread(built_sgext):
    d, got = built_sgext
    path = d / "bias_lut_sgext.npy"
    assert path.exists()
    np.testing.assert_array_equal(np.load(path), got)
    assert t_lut._sgext_path_for(str(d / "bias_lut_2d.npy")) == str(path)
    np.testing.assert_array_equal(
        t_lut.load_sgext_lut(str(d / "bias_lut_2d.npy")), got)


def test_missing_2d_table_is_built_at_the_given_path(tmp_path, monkeypatch):
    """BiasLUT builds a missing table and writes it where it was asked
    for (the build itself stubbed: it takes minutes)."""
    calls = []
    fake = np.zeros((len(t_lut.X_LUT), len(t_lut.SG_LUT)), np.float32)
    monkeypatch.setattr(t_lut, "build_bias_lut",
                        lambda path=None: calls.append(path) or fake)
    path = str(tmp_path / "bias_lut_2d.npy")
    assert t_lut.BiasLUT(path).lut is not None
    assert calls == [path]


@pytest.mark.parametrize("lam", [0.5, 3.0, 20.0])
@pytest.mark.parametrize("clip", [False, True])
def test_pg_pdf_grid_matches_jax(lam, clip):
    x_t, p_t = t_bias.pg_pdf_grid(lam, 1.5, 2.0, r=12, pho=20, clip=clip)
    x_j, p_j = j_bias.pg_pdf_grid(lam, 1.5, 2.0, r=12, pho=20, clip=clip)
    np.testing.assert_array_equal(x_t, x_j)
    np.testing.assert_array_equal(p_t, p_j)


@pytest.mark.parametrize("close_form", [False, True])
def test_bias_points_numeric_matches_jax(close_form):
    lams = np.array([0.0, 0.3, 2.0, 9.0, 80.0])
    got = t_bias.bias_points_numeric(lams, 1.0, 1.5, pho_min=20,
                                     close_form=close_form)
    want = j_bias.bias_points_numeric(lams, 1.0, 1.5, pho_min=20,
                                      close_form=close_form)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("K,sigma", [(1.0, 8.0), (2.0, 19.9), (1.0, 10.5),
                                     (0.5, 30.0)])
def test_bias_curve_for_matches_jax(K, sigma):
    """sg = sigma / K on both sides of the table's 10 e-: a blend of two
    columns below, the exact column above."""
    lut = np.load(os.path.join(CKPT, "bias_lut_2d.npy"))
    np.testing.assert_array_equal(t_lut.bias_curve_for(K, sigma, lut),
                                  j_lut.bias_curve_for(K, sigma, lut))
    assert t_lut._sg_frac_index(sigma / K) == j_lut._sg_frac_index(sigma / K)


@pytest.mark.parametrize("masked", [False, True])
def test_ransac_linefit_matches_jax(masked):
    rng = np.random.default_rng(1)
    x = rng.random(800)
    y = 3e-3 * x + 2e-4 + rng.normal(0, 1e-4, 800)
    y[::9] += 5e-3                                   # outliers
    mask = (x > 0.2).astype(np.float32) if masked else None
    got = t_fit.ransac_linefit(x, y, mask)
    assert got == j_fit.ransac_linefit(x, y, mask)
    assert abs(got[0] - 3e-3) < 2e-4


@pytest.mark.parametrize("shape", [(40, 60), (2, 40, 60, 4)])
def test_var_corr_matches_jax(shape):
    x = np.random.default_rng(2).random(shape).astype(np.float32)
    got = t_box.var_corr(torch.from_numpy(x), 9).numpy()
    want = np.asarray(j_box.var_corr(jnp.asarray(x), 9))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("dtype", ["float32", "float64", "uint8"])
@pytest.mark.parametrize("shape", [(64, 80), (50, 70, 4), (33, 47, 3)])
def test_np_box_mean_matches_cv2_blur(dtype, shape):
    rng = np.random.default_rng(3)
    x = rng.random(shape) * (255 if dtype == "uint8" else 1)
    x = x.astype(dtype)
    for k in (3, 7, 29):
        got = t_box.np_box_mean(x, k)
        want = cv2.blur(x, (k, k))
        assert got.dtype == want.dtype and got.shape == want.shape
        if dtype == "uint8":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(
                got, want, rtol=2.5e-7 if dtype == "float32" else 1e-13)

"""The Wiener refine's CUDA kernels (csrc/refine.cu, wrapper
yondx_torch/pipeline/refine_kernels.py) against the plain PyTorch
version, refine.wiener_refine_plain.

The CPU tests check what the kernels are handed: the host constants
against the plain code's, the floor's sample geometry against
_band_subsample_rows, the kernel names against the benchmark's kernel
classes, and that a CPU tensor still takes the plain path.

The `cuda` tests skip without a card. On the card they hold the kernels
against the plain version run on the same card.

The bucket floor's table is compared exactly. Its counts are integers,
exact in any order, and each sample's bin and bucket take the float32
operations the plain version's tensor ops take on the card, in the same
order. Where the plain code divides a tensor by a Python number, torch
on a CUDA tensor multiplies by the number's reciprocal, taken in double
and rounded to float32, and so do the kernels (the bins, the trust
ramp, the saturation and alpha ramps). test_scalar_division_on_the_card
holds that rule.

Tolerance of the refined planes: 1e-5 absolute, in normalized VST
units with noise std nsr = 0.02-0.06. The kernels sum the box means
directly in fp32, where the plain version centers each plane and scans
in float64. They form the coherence from the channel mean of c_j
(mean(c_j) - blur(mean(c_j)) for mean(c_j - c_j+1)), and they contract
multiply-adds. Each of these costs a few ulps of O(1) values. 1e-5 is
2e-4 - 5e-4 of the noise std at its largest: a tenth of gru32.imx686's
dn_rms limit (3e-3 of it), the tightest of the benchmark's cells.
"""
import json
import os
import re

import numpy as np
import pytest
import torch

from chip_smoke import refine_inputs
from yondx_torch.nle.robust import _band_subsample_rows
from yondx_torch.pipeline import refine, refine_kernels
from torch_test_util import _one_torch_thread  # noqa: F401
from torch_test_util import refine_planes_data

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
ATOL = 1e-5
SETTINGS = [(f, s, fa) for f in ("bucket", "local", "q10", "fixed")
            for s in ("off", "iso", "oriented") for fa in (0.6, 1.0)]


def _kw(floor, shrink, full_alpha):
    return dict(noise_floor=floor, residual_shrink=shrink != "off",
                shrink_full_alpha=full_alpha,
                shrink_mode="iso" if shrink == "off" else shrink)


# ------------------------------------------------------------------ CPU
def test_kernel_constants_equal_plain_code():
    det_vars, dir_vars = refine_kernels.level_constants()
    assert list(det_vars) == refine._starlet_noise_vars(3)[0]
    assert list(dir_vars) == refine._dir_mean_noise_vars(3, 9)
    assert refine_kernels.erfinv_q(torch.device("cpu")) == float(
        torch.erfinv(torch.tensor(0.2, dtype=torch.float32)))


@pytest.mark.parametrize("shape", [(1, 96, 144), (2, 1736, 2312),
                                   (1, 2752, 4128), (1, 60, 9000),
                                   (3, 7, 9)])
def test_floor_samples_match_band_subsample(shape):
    """The rows, Haar grid and thinning the floor kernels read equal
    _bucket_noise_floor's: _band_subsample_rows of a row-index plane, and
    its 2^19-sample thinning."""
    L, h, w = shape
    band, step, hh, wh, n, s, ns = refine_kernels.floor_samples(L, h, w)
    rows = torch.arange(h, dtype=torch.float32)[None, :, None, None]
    kept = _band_subsample_rows(rows.expand(L, h, w, 4), 4 * (1 << 19))
    src = kept[0, :, 0, 0].long()
    p = torch.arange(src.shape[0])
    assert torch.equal(src, p // band * step + p % band)
    assert (hh, wh) == (src.shape[0] // 2, w // 2)
    assert n == L * hh * wh * 4
    assert ns == len(range(0, n, s))
    assert (s == 1) == (n <= 1 << 19)


def test_cpu_tensor_takes_plain_path():
    z_dn, z_noisy, nsr = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                          else a for a in refine_planes_data())
    refine_kernels.reset_launches()
    got = refine.wiener_refine(z_dn, z_noisy, nsr ** 2, x01=z_dn)
    ref = refine.wiener_refine_plain(z_dn, z_noisy, nsr ** 2, x01=z_dn)
    assert torch.equal(got, ref)
    assert refine_kernels.LAUNCHES == {"refine_floor": 0, "refine": 0}


def test_kernel_names_stay_in_the_glue_class():
    """No __global__ name matches the benchmark's conv, k1 or copy class,
    so the kernels' time stays in glue_ms_per_mp."""
    with open(os.path.join(REPO, "yondx_torch", "csrc", "refine.cu")) as f:
        src = f.read()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s+)?(\w+)", src)
    assert names and all(n.startswith("yondx_refine_") for n in names)
    with open(os.path.join(REPO, "perfbench", "kernel_classes.json")) as f:
        classes = json.load(f)
    for cls in ("conv", "k1", "copy"):
        for pat in classes[cls]:
            hit = [n for n in names if re.search(pat, n, re.IGNORECASE)]
            assert not hit, (cls, pat, hit)


# ----------------------------------------------------------------- card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the refine kernels run only there")
    return torch.device("cuda")


def _pair(dev, z_dn, z_noisy, var, **kw):
    """(kernels, plain version) of one call on the card, and the launches
    the kernels made."""
    refine_kernels.reset_launches()
    got = refine.wiener_refine(z_dn, z_noisy, var, **kw)
    launches = dict(refine_kernels.LAUNCHES)
    ref = refine.wiener_refine_plain(z_dn, z_noisy, var, **kw)
    torch.cuda.synchronize(dev)
    return got, ref, launches


def _launches(floor, shrink):
    return {"refine_floor": 3 if floor == "bucket" else 0,
            "refine": 1 if shrink == "off" else 3}


@pytest.mark.cuda
@pytest.mark.parametrize("floor,shrink,full_alpha", SETTINGS)
def test_kernels_match_plain_every_setting(cuda, floor, shrink, full_alpha):
    """Every floor x shrink x ramp setting of test_torch_est_refine's
    parity test, at the true noise variance and at 4x it."""
    z_dn, z_noisy, nsr = refine_planes_data()
    zd = torch.from_numpy(z_dn).to(cuda)
    zn = torch.from_numpy(z_noisy).to(cuda)
    for var in (nsr ** 2, (2 * nsr) ** 2):
        got, ref, launches = _pair(cuda, zd, zn, var, x01=zd,
                                   **_kw(floor, shrink, full_alpha))
        assert launches == _launches(floor, shrink)
        assert float((got - ref).abs().max()) <= ATOL
        assert float((ref - zd).abs().max()) > 1e-2 \
            or (floor == "fixed" and var > nsr ** 2)


def _frame(dev, shape, nsr, seed):
    """A smooth scene with edges, its noisy version and a 'denoised' one
    a fifth as noisy, made on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    h, w = shape[-3], shape[-2]
    yy = torch.linspace(0, 1, h, device=dev)[:, None, None]
    xx = torch.linspace(0, 1, w, device=dev)[None, :, None]
    ch = torch.arange(4, device=dev)[None, None, :]
    clean = (0.45 + 0.3 * torch.sin(9 * xx + 5 * yy + ch)
             + 0.2 * ((xx * 7 + yy * 3).floor() % 2) - 0.1).clamp(0, 1)
    clean = clean.expand(shape)
    noise = torch.randn(shape, generator=g, device=dev)
    z_noisy = clean + nsr * noise
    z_dn = clean + 0.2 * nsr * torch.randn(shape, generator=g, device=dev)
    return z_dn.contiguous(), z_noisy.contiguous()


@pytest.mark.cuda
def test_product_frame_matches_plain_without_a_sync(cuda):
    """The product call at the product's shape, noise_var a 0-d device
    tensor: within ATOL of the plain version, six launches, and no host
    sync (torch's sync debug mode raises on one)."""
    shape = (1, 1736, 2312, 4)
    nsr = 0.03
    z_dn, z_noisy = _frame(cuda, shape, nsr, 0)
    var = torch.tensor(nsr, device=cuda) ** 2
    refine.wiener_refine(z_dn, z_noisy, var, x01=z_dn)   # loads the library
    torch.cuda.synchronize(cuda)
    refine_kernels.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = refine.wiener_refine(z_dn, z_noisy, var, x01=z_dn)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert refine_kernels.LAUNCHES == {"refine_floor": 3, "refine": 3}
    ref = refine.wiener_refine_plain(z_dn, z_noisy, var, x01=z_dn)
    assert float((got - ref).abs().max()) <= ATOL
    assert float((ref - z_dn).abs().max()) > 1e-2


@pytest.mark.cuda
def test_sharded_rank_shape_and_strided_input(cuda):
    """A 3-D rank of the row-sharded route, [rows + 2 halo, w, 4], and
    z_dn a strided view (as run_net's unpad leaves it)."""
    halo = 64
    z_dn, z_noisy = _frame(cuda, (1, 500 + 2 * halo, 1200, 4), 0.02, 1)
    got, ref, launches = _pair(cuda, z_dn[0], z_noisy[0], 0.02 ** 2,
                               x01=z_dn[0])
    assert got.shape == z_dn[0].shape
    assert launches == {"refine_floor": 3, "refine": 3}
    assert float((got - ref).abs().max()) <= ATOL
    big = torch.zeros((1, 700, 1240, 4), device=cuda)
    view = big[:, 30:30 + z_dn.shape[1], 17:17 + z_dn.shape[2]]
    view.copy_(z_dn)
    got, ref, _ = _pair(cuda, view, z_noisy, torch.tensor(4e-4, device=cuda),
                        x01=view)
    assert float((got - ref).abs().max()) <= ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(7, 9, 4), (1, 20, 33, 4), (3, 3, 4),
                                   (2, 5, 40, 4)])
@pytest.mark.parametrize("mode", ["oriented", "iso"])
def test_small_planes_wrap_and_clamp(cuda, shape, mode):
    """Planes narrower than the blurs' pads (reflections wrap) and than
    the coherence's reach (m_ax clamps, to 0 on the 3x3 plane)."""
    z_dn, z_noisy = _frame(cuda, shape, 0.03, 2)
    for floor in ("bucket", "fixed"):
        got, ref, _ = _pair(cuda, z_dn, z_noisy, 0.03 ** 2, x01=z_dn,
                            noise_floor=floor, shrink_mode=mode)
        assert float((got - ref).abs().max()) <= ATOL


def test_compiled_settings_equal_refine_py():
    """The buckets, bins, gain box and levels compiled into refine.cu are
    refine.py's (the wrapper checks the same when the library loads)."""
    with open(os.path.join(REPO, "yondx_torch", "csrc", "refine.cu")) as f:
        src = f.read()
    got = {n: int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
           for n in ("NBK", "NBIN", "GAIN_BOX", "LEVELS")}
    assert got == {"NBK": refine.FLOOR_NB, "NBIN": refine.FLOOR_NBIN,
                   "GAIN_BOX": refine.STAB_K, "LEVELS": refine.LEVELS}


@pytest.mark.cuda
def test_scalar_division_on_the_card(cuda):
    """What the floor's bins rest on: torch divides a float32 CUDA tensor
    by a Python number as a multiply by refine_kernels._inv of it, the
    reciprocal in double rounded to float32 (the float32 reciprocal of
    the float32 number parts from it on most samples)."""
    x = torch.rand(1 << 20, device=cuda) * 10
    for div in (refine.FLOOR_SPAN, 0.98 - 0.92, 1.0 - 0.6, 3.0, 7.0):
        assert torch.equal(x / div, x * refine_kernels._inv(div))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["imx686", "rank", "planes", "small"])
def test_bucket_table_equals_plain_exactly(cuda, case):
    """The floor's [64] table bit for bit against the plain version's on
    the card: an IMX686-like frame (chip_smoke.refine_inputs: 10-bit
    levels, so many |Haar details| tie) at the product's shape with a
    0-d device variance, a sharded rank, the parity planes, a small
    plane. The
    model variance is 4x the noise's, so the floor is the measured
    quantile itself wherever a bucket holds min_count samples."""
    if case == "imx686":
        z_dn, z_noisy = refine_inputs(cuda, (1, 1736, 2312, 4), 0.03, 3)
        var = torch.tensor(0.06, device=cuda) ** 2
    elif case == "rank":
        z_dn, z_noisy = refine_inputs(cuda, (640, 2312, 4), 0.05, 4)
        var = 0.1 ** 2
    elif case == "planes":
        z_dn, z_noisy, nsr = refine_planes_data()
        z_dn = torch.from_numpy(z_dn).to(cuda)
        z_noisy = torch.from_numpy(z_noisy).to(cuda)
        var = (2 * nsr) ** 2
    else:
        z_dn, z_noisy = refine_inputs(cuda, (1, 20, 33, 4), 0.03, 5)
        var = 0.06 ** 2
    got = refine_kernels.bucket_floor_table(z_dn, z_noisy, var)
    ref = refine._bucket_floor_table(z_noisy, z_dn, var)
    assert got.shape == ref.shape == (refine.FLOOR_NB,)
    assert torch.equal(got, ref), (got - ref).abs().max()
    # the table is measured, not the model variance everywhere (a small
    # plane's buckets hold fewer than min_count samples)
    measured = bool((ref != torch.as_tensor(var, device=cuda)).any())
    assert measured == (case != "small")

"""The port's noise models, augmentations, raw and video data against the
JAX package's (CPU, fp32).

Tolerances:
- `core.rng.poisson` bit-equal to `jax.random.poisson` over lambda from 0
  to 2e4 (Knuth's branch below 10, the transformed rejection above, NaN
  and 0); XLA's float32 `lgamma` bit-equal; the "jax" field source's
  Poisson and uniform fields bit-equal; the "torch" source's Poisson
  field by its mean and variance per lambda (5 sigma of the estimates);
- the camera tables equal; `sample_params`, `sample_params_max` and
  `HighBitRecovery` (`get_lut`, `map`) equal for one np.random.Generator;
- scalars drawn from JAX keys (Brooks levels, PG parameters, gain
  offsets) within 1 ulp (rtol 2.4e-7); the noisy frames of
  `generate_noisy` (every noise_code letter), `brooks_add_noise`,
  `add_pg_noise`, `sna`, `illuminance_correct`, `raw_awgn_batch` and
  `awgn_one_channel_batch` within 1e-6 relative to the largest value
  (the fields are JAX's bit for bit; the arithmetic around them rounds
  in its own order), against the JAX functions run op by op;
- `SIDRawDataset` items equal on .npy Bayer frames written here; the
  video index plumbing exact.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yondx.data import augment as j_aug
from yondx.data import noise as j_noise
from yondx.data import raw_dataset as j_raw
from yondx.data import video as j_video

from yondx_torch.core import rng
from yondx_torch.data import augment as t_aug
from yondx_torch.data import noise as t_noise
from yondx_torch.data import raw_dataset as t_raw
from yondx_torch.data import video as t_video
from yondx_torch.train.draws import FieldSource
from torch_test_util import _one_torch_thread  # noqa: F401

JAX_FIELD = FieldSource("jax", "cpu")


def _close(got, want, rel=1e-6):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"err {err:.3e} vs max {scale:.3e}"


# ---------------------------------------------------------------- Poisson
def _lams(seed, n=2048):
    r = np.random.default_rng(seed)
    lam = np.concatenate([
        np.zeros(16), [np.nan, 9.999999, 10.0, 2e4],
        r.uniform(0, 12, n // 2), 10 ** r.uniform(0, np.log10(2e4), n // 2)])
    r.shuffle(lam)
    return lam.astype(np.float32).reshape(-1, 4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_poisson_bit_equal_to_jax(seed):
    lam = _lams(seed)
    key = jax.random.PRNGKey(seed + 11)
    want = np.asarray(jax.random.poisson(key, jnp.asarray(lam)))
    got = rng.poisson(np.asarray(key), lam)
    assert got.dtype == np.int32 and got.shape == lam.shape
    np.testing.assert_array_equal(got, want)
    # both branches ran and both matter
    assert (lam < 10).any() and (lam > 1e3).any()


def test_lgamma_bit_equal_to_xla():
    r = np.random.default_rng(4)
    x = np.concatenate([np.arange(1, 3001), r.uniform(0.5, 2e5, 4000),
                        [0.5, 1.5, 2.5]]).astype(np.float32)
    want = np.asarray(jax.jit(jax.lax.lgamma)(jnp.asarray(x)))
    np.testing.assert_array_equal(rng.lgamma_f32(x).view(np.uint32),
                                  want.view(np.uint32))
    with pytest.raises(ValueError):
        rng.lgamma_f32(np.float32([0.25]))


def test_field_source_poisson_and_uniform():
    """"jax": bit-equal to jax.random; "torch": a Poisson field (float32
    counts, on the device) whose mean and variance per lambda are
    lambda's."""
    lam = _lams(5)
    key = jax.random.PRNGKey(3)
    got = JAX_FIELD.poisson(np.asarray(key), torch.from_numpy(lam))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jax.random.poisson(key, jnp.asarray(lam))).astype(np.float32))
    u = JAX_FIELD.uniform(np.asarray(key), (3, 5, 4), -0.5, 0.5)
    np.testing.assert_array_equal(u.numpy(), np.asarray(jax.random.uniform(
        key, (3, 5, 4), minval=-0.5, maxval=0.5)))
    field = FieldSource("torch", "cpu", seed=7)
    for value in (0.0, 3.0, 40.0, 5000.0):
        n = 40000
        draw = field.poisson(None, torch.full((n,), value)).double()
        assert draw.dtype == torch.float64 and (draw >= 0).all()
        mean, var = float(draw.mean()), float(draw.var())
        assert abs(mean - value) <= 5 * np.sqrt(max(value, 1e-9) / n) + 1e-9
        assert abs(var - value) <= 5 * value * np.sqrt(2 / n) + 1e-9
    ut = field.uniform(None, (10000,), -0.5, 0.5)
    assert float(ut.min()) >= -0.5 and float(ut.max()) < 0.5


# ----------------------------------------------------------- camera models
def test_calibration_tables_equal():
    assert t_noise.CAMERA_NOISE_PARAMS == j_noise.CAMERA_NOISE_PARAMS
    for cam in ("NikonD850", "IMX686", "SonyA7S2_lowISO", "CRVD", "nope"):
        assert t_noise.get_camera_noisy_params(cam) == \
            j_noise.get_camera_noisy_params(cam)
    for cam, tab in j_noise.CAMERA_NOISE_PARAMS["per_iso"].items():
        for iso in list(tab) + ["123"]:
            assert t_noise.get_specific_noise_params(cam, iso) == \
                j_noise.get_specific_noise_params(cam, iso)


CAMERAS = ["NikonD850", "IMX686", "SonyA7S2", "CRVD"]


@pytest.mark.parametrize("camera", CAMERAS)
def test_sample_params_equal_for_one_generator(camera):
    for ln_ratio in (False, True):
        for seed in range(4):
            a = j_noise.sample_params(camera, ln_ratio,
                                      rng=np.random.default_rng(seed))
            b = t_noise.sample_params(camera, ln_ratio,
                                      rng=np.random.default_rng(seed))
            assert a == b
    for iso in (None, 1600, 6400, 25600):
        for ratio in (None, 50.0):
            a = j_noise.sample_params_max(camera, ratio, iso,
                                          rng=np.random.default_rng(3))
            b = t_noise.sample_params_max(camera, ratio, iso,
                                          rng=np.random.default_rng(3))
            assert a == b


def test_brooks_and_pg_scalars():
    for s in range(5):
        key = jax.random.PRNGKey(s)
        for a, b in zip(j_noise.brooks_noise_levels(key),
                        t_noise.brooks_noise_levels(np.asarray(key))):
            np.testing.assert_allclose(b, np.float32(a), rtol=2.4e-7)
        for a, b in zip(j_noise.sample_pg_params(key),
                        t_noise.sample_pg_params(np.asarray(key))):
            np.testing.assert_allclose(b, np.float32(a), rtol=2.4e-7)


def _clean(seed, shape=(2, 16, 16, 4)):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def test_brooks_and_pg_noise():
    y = _clean(1)
    key = jax.random.PRNGKey(9)
    _close(t_noise.brooks_add_noise(np.asarray(key), torch.from_numpy(y),
                                    0.01, 5e-4, field=JAX_FIELD),
           j_noise.brooks_add_noise(key, jnp.asarray(y), 0.01, 5e-4))
    _close(t_noise.add_pg_noise(np.asarray(key), torch.from_numpy(y), 0.003,
                                0.002, field=JAX_FIELD),
           j_noise.add_pg_noise(key, jnp.asarray(y), 0.003, 0.002))


@pytest.mark.parametrize("code", ["p", "g", "pg", "pgrqd", "prq", "pb",
                                  "grq", "pgd"])
def test_generate_noisy_each_noise_code(code):
    y = _clean(2)
    param = j_noise.sample_params("IMX686", rng=np.random.default_rng(5))
    param["bias"] = [0.3, -0.2, 0.1, 0.25]
    key = jax.random.PRNGKey(17)
    for ori, clip in ((False, False), (True, False), (False, True)):
        want = j_noise.generate_noisy(key, jnp.asarray(y), param, code,
                                      ori=ori, clip=clip)
        got = t_noise.generate_noisy(np.asarray(key), torch.from_numpy(y),
                                     param, code, ori=ori, clip=clip,
                                     field=JAX_FIELD)
        _close(got, want)


# ----------------------------------------------------------- augmentation
@pytest.mark.parametrize("command", ["augv5", "augv2"])
def test_get_aug_param(command):
    wb = np.random.default_rng(1).uniform(1.2, 2.6, (3, 3)).astype(
        np.float32)
    for s in range(6):
        key = jax.random.PRNGKey(s)
        want = j_aug.get_aug_param(key, jnp.asarray(wb), command)
        got = t_aug.get_aug_param(np.asarray(key), torch.from_numpy(wb),
                                  command)
        for a, b in zip(want, got):
            np.testing.assert_allclose(b, np.asarray(a), rtol=2.4e-7,
                                       atol=2.4e-7)


def test_sna_and_illuminance_correct():
    gt = _clean(3, (16, 16, 4))
    aug = np.float32([0.2, 0.0, 0.0, 0.5])
    key = jax.random.PRNGKey(21)
    for black_lr, ori, ratio in ((False, True, 1.0), (True, False, 4.0)):
        want = j_aug.sna(key, jnp.asarray(gt), jnp.asarray(aug), 2.5, 1023,
                         64, ratio, black_lr, ori)
        got = t_aug.sna(np.asarray(key), torch.from_numpy(gt), aug, 2.5,
                        1023, 64, ratio, black_lr, ori, field=JAX_FIELD)
        for a, b in zip(want, got):
            _close(b, a)
    pred = _clean(4) * 1.3
    src = np.minimum(_clean(5) + 0.2, 1.0)
    for p, s in ((pred, src), (pred[0], src[0])):
        _close(t_aug.illuminance_correct(torch.from_numpy(p),
                                         torch.from_numpy(s)),
               j_aug.illuminance_correct(jnp.asarray(p), jnp.asarray(s)))


@pytest.mark.parametrize("camera,noise_code,perturb,isos", [
    ("IMX686", "p", False, (6400, 100)),
    ("SonyA7S2", "pg", True, (1600, 25600))])
def test_high_bit_recovery_equal_for_one_generator(camera, noise_code,
                                                   perturb, isos):
    hj = j_aug.HighBitRecovery(camera, noise_code, perturb=perturb)
    ht = t_aug.HighBitRecovery(camera, noise_code, perturb=perturb)
    hj.get_lut(isos, rng=np.random.default_rng(2))
    ht.get_lut(isos, rng=np.random.default_rng(2))
    for iso in isos:
        lo, hi = hj.lut[iso]["low"], hj.lut[iso]["high"]
        assert (ht.lut[iso]["low"], ht.lut[iso]["high"]) == (lo, hi)
        info = hj.lut[iso]
        scale = info["param"]["wp"] - info["param"]["bl"]
        data = np.round(np.random.default_rng(8).normal(
            info["bias"], info["sigma"], (40, 50))) / scale
        for norm in (True, False):
            a = hj.map(data, iso, norm, rng=np.random.default_rng(6))
            b = ht.map(data, iso, norm, rng=np.random.default_rng(6))
            np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------- raw datasets
@pytest.fixture(scope="module")
def sid_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("sid")
    r = np.random.default_rng(12)
    for mode in ("train", "test"):
        (root / mode).mkdir()
        for i in range(2):
            frame = r.integers(512, 16383, (136, 200)).astype(np.uint16)
            np.save(root / mode / f"{i:05d}_00_10s.npy", frame)
    return str(root)


@pytest.mark.parametrize("mode,croptype", [("train", "non-overlapped"),
                                           ("train", "random"),
                                           ("test", "non-overlapped")])
def test_sid_raw_dataset_items(sid_root, mode, croptype):
    kw = dict(mode=mode, patch_size=64, crop_per_image=5, croptype=croptype,
              seed=3)
    dj = j_raw.SIDRawDataset(sid_root, **kw)
    dt = t_raw.SIDRawDataset(sid_root, **kw)
    assert len(dj) == len(dt) == 2
    for _ in range(2):                 # the crop generator advances
        for i in range(2):
            np.testing.assert_array_equal(dt[i], dj[i])
    with pytest.raises(FileNotFoundError):
        t_raw.SIDRawDataset(sid_root, mode="eval")


def test_raw_awgn_batches():
    hr = _clean(7, (3, 16, 16, 4))
    for s in range(6):                 # covers each vst/wb coin
        key = jax.random.PRNGKey(s)
        want = j_raw.raw_awgn_batch(key, jnp.asarray(hr))
        got = t_raw.raw_awgn_batch(np.asarray(key), torch.from_numpy(hr),
                                   field=JAX_FIELD)
        for a, b in zip(want, got):
            _close(b, a)
    key = jax.random.PRNGKey(4)
    want = j_raw.awgn_one_channel_batch(key, jnp.asarray(hr), channel=1)
    got = t_raw.awgn_one_channel_batch(np.asarray(key), torch.from_numpy(hr),
                                       channel=1, field=JAX_FIELD)
    for a, b in zip(want, got):
        _close(b, a)


# ------------------------------------------------------------------ video
def test_video_index_plumbing():
    frames = np.random.default_rng(2).random((2, 7, 4, 4, 3)).astype(
        np.float32)
    for n in (1, 3, 5, 7):
        for pad in (True, False):
            for reflect in (True, False):
                idx = j_video.frame_index_splitor(n, pad, reflect)
                np.testing.assert_array_equal(
                    t_video.frame_index_splitor(n, pad, reflect), idx)
                for gt, keep in ((False, False), (True, False), (True, True)):
                    want = j_video.multi_frame_loader(jnp.asarray(frames),
                                                      idx, gt, keep)
                    got = t_video.multi_frame_loader(
                        torch.from_numpy(frames), idx, gt, keep)
                    np.testing.assert_array_equal(got.numpy(),
                                                  np.asarray(want))

"""The training data path of the port against the JAX package (CPU, fp32).

- `awgn_*` with the "jax" field source against the JAX samplers run under
  jit, as the trainer runs them: sigmas exact, the Gaussian field
  bit-equal to jax.random.normal, the noisy crops to 2.4e-7 (XLA fuses
  clean + field * sigma into one fma: one ulp of values below 2).
- `data_aug8`: all 8 modes exact.
- `srgb_to_pseudo_raw_device` against the JAX transform, with and
  without bayer aug (every crop turned by k = 3, the reference's quirk):
  clean planes atol 1e-6, wb and patterns exact, cam2rgb rtol 1e-5
  (JAX's batched inverse under jit rounds apart from the LAPACK calls the
  host chain copies; only the sample dump reads cam2rgb).
- `BatchLoader` order and batches exact, `NpyFolderDataset` items and its
  readinto batches exact, the synthetic set's disk cache equal to a
  cache-free build.
- Every runfiles/Gaussian/*.yml read by the port's `load_runfile` equals
  JAX's; `trainer_awgn`'s parser equals JAX's; `--debug --cpu` on a tiny
  runfile runs and writes its checkpoint, which the JAX package reads.
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yondx.config import load_runfile as j_load_runfile
from yondx.cli import trainer_awgn as j_cli
from yondx.data import augment as j_augment
from yondx.data import datasets as j_datasets
from yondx.data import noise as j_noise
from yondx.data import unprocess as j_unprocess
from yondx.train.ckpt import load_checkpoint as j_load_checkpoint

from yondx_torch.cli import trainer_awgn as t_cli
from yondx_torch.config import load_runfile
from yondx_torch.core import rng
from yondx_torch.data import augment as t_augment
from yondx_torch.data import datasets as t_datasets
from yondx_torch.data import noise as t_noise
from yondx_torch.data import unprocess as t_unprocess
from yondx_torch.models.convert import params_to_state_dict
from yondx_torch.train.draws import FieldSource, eval_keys, train_keys
from torch_test_util import _two_torch_threads  # noqa: F401

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
GAUSSIAN = sorted(glob.glob(os.path.join(REPO, "runfiles", "Gaussian",
                                         "*.yml")))


# ------------------------------------------------------------------ noise
SAMPLERS = {
    "log_uniform": (j_noise.awgn_log_uniform, t_noise.awgn_log_uniform,
                    (5.0, 50.0)),
    "lowmix": (j_noise.awgn_log_uniform_lowmix,
               t_noise.awgn_log_uniform_lowmix, (1.0, 50.0)),
    "uniform": (j_noise.awgn_uniform, t_noise.awgn_uniform, (5.0, 50.0)),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
@pytest.mark.parametrize("seed", [0, 7, 1997])
def test_awgn_matches_jax(name, seed):
    j_fn, t_fn, (smin, smax) = SAMPLERS[name]
    clean = np.random.default_rng(seed).random((16, 8, 8, 4), np.float32)
    key = jax.random.PRNGKey(seed)
    j_noisy, j_sig = jax.jit(lambda k, c: j_fn(k, c, smin, smax))(
        key, jnp.asarray(clean))
    t_noisy, t_sig = t_fn(np.asarray(key), torch.from_numpy(clean), smin,
                          smax, field=FieldSource("jax", "cpu"))
    np.testing.assert_array_equal(t_sig.numpy(), np.asarray(j_sig))
    k2 = jax.random.split(key, 3 if name == "lowmix" else 2)[1]
    field = np.asarray(jax.random.normal(k2, clean.shape))
    np.testing.assert_array_equal(
        FieldSource("jax", "cpu").normal(np.asarray(k2), clean.shape).numpy(),
        field)
    np.testing.assert_allclose(t_noisy.numpy(), np.asarray(j_noisy),
                               rtol=0, atol=2.4e-7)


def test_exp_f32_is_xlas_exp():
    """The host sigmas need XLA's float32 exp bit for bit."""
    x = np.concatenate([
        np.random.default_rng(0).uniform(-4.0, 4.0, 200_000),
        np.linspace(np.log(1.0), np.log(50.0), 10_000)]).astype(np.float32)
    np.testing.assert_array_equal(rng.exp_f32(x),
                                  np.asarray(jax.jit(jnp.exp)(x)))


def test_field_sources():
    """"torch" fields are seeded N(0,1) draws on the asked device, the
    same for the same seed; an unknown source raises."""
    a = FieldSource("torch", "cpu", seed=3).normal(None, (4, 16, 16, 4))
    b = FieldSource("torch", "cpu", seed=3).normal(None, (4, 16, 16, 4))
    assert a.dtype == torch.float32 and a.shape == (4, 16, 16, 4)
    assert torch.equal(a, b)
    assert abs(float(a.mean())) < 0.1 and abs(float(a.std()) - 1) < 0.1
    with pytest.raises(ValueError):
        FieldSource("numpy", "cpu")


def test_key_chains_follow_the_jax_trainer():
    """train: PRNGKey(seed), split per step, split(sub, 3); eval:
    PRNGKey(2024), split(key, 3) per batch."""
    key = jax.random.PRNGKey(1997)
    got = train_keys(1997)
    for _ in range(3):
        key, sub = jax.random.split(key)
        want = np.asarray(jax.random.split(sub, 3))
        np.testing.assert_array_equal(np.stack(next(got)), want)
    key = jax.random.PRNGKey(2024)
    got = eval_keys()
    for _ in range(3):
        key, k1, k2 = jax.random.split(key, 3)
        np.testing.assert_array_equal(np.stack(next(got)),
                                      np.stack([k1, k2]))


# -------------------------------------------------------------- data_aug8
def test_data_aug8_all_modes_exact():
    imgs = np.random.default_rng(1).random((8, 6, 6, 3), np.float32)
    modes = np.arange(8, dtype=np.int32)
    want = np.asarray(j_augment.data_aug8(jnp.asarray(imgs),
                                          jnp.asarray(modes)))
    got = t_augment.data_aug8(torch.from_numpy(imgs), torch.from_numpy(modes))
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------- unprocess
@pytest.mark.parametrize("aug", [False, True], ids=["no-aug", "bayer-aug"])
def test_device_srgb_to_pseudo_raw_matches_jax(aug):
    imgs = np.random.default_rng(5).random((6, 32, 32, 3), np.float32)
    imgs[0, :8, :8] = 1.0                 # a highlight for the gain mask
    key = jax.random.PRNGKey(11)
    ref = jax.jit(lambda k, x: j_unprocess.srgb_to_pseudo_raw(
        k, x, bayer_aug_enabled=aug))(key, jnp.asarray(imgs))
    got = t_unprocess.srgb_to_pseudo_raw_device(
        np.asarray(key), torch.from_numpy(imgs), bayer_aug_enabled=aug)
    raw, wb, cam2rgb, pattern = (g.numpy() for g in got)
    np.testing.assert_allclose(raw, np.asarray(ref[0]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(wb, np.asarray(ref[1]))
    np.testing.assert_allclose(cam2rgb, np.asarray(ref[2]), rtol=1e-5,
                               atol=0)
    np.testing.assert_array_equal(pattern, np.asarray(ref[3]))
    if aug:
        assert len(set(pattern.tolist())) > 1    # drawn, yet all turn k=3


def test_batched_camera_draws_equal_the_per_crop_draws():
    """The port draws a batch's cameras in one go: rgb2cam, cam2rgb and
    (rgb_gain, red, blue) bit-equal to the JAX package's random_ccm and
    random_gains crop by crop; the batched normal bit-equal to
    jax.random.normal key by key."""
    keys = rng.split(rng.PRNGKey(23), 9)
    rgb2cam, cam2rgb, gains = t_unprocess._cameras(keys)
    for i, k in enumerate(keys):
        k_ccm, k_gain = jax.random.split(jnp.asarray(k))
        a, b = j_unprocess.random_ccm(k_ccm)
        np.testing.assert_array_equal(rgb2cam[i], np.asarray(a))
        np.testing.assert_array_equal(cam2rgb[i], np.asarray(b))
        np.testing.assert_array_equal(gains[i], np.asarray(
            j_unprocess.random_gains(k_gain), np.float32))
    keys = keys[:5]
    np.testing.assert_array_equal(
        rng.normal_each(keys, (3, 2)),
        np.stack([np.asarray(jax.random.normal(jnp.asarray(k), (3, 2)))
                  for k in keys]))


# --------------------------------------------------------------- datasets
def _npy_folder(root, n=10, shape=(8, 8, 3), dtype=np.uint8):
    d = os.path.join(root, "train_mix")
    os.makedirs(d)
    rs = np.random.default_rng(0)
    for i in range(n):
        arr = rs.integers(0, 255, shape).astype(dtype)
        np.save(os.path.join(d, f"{i:03d}.npy"), arr)
    return root


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_npy_folder_dataset_matches_jax(tmp_path, dtype):
    root = _npy_folder(str(tmp_path), dtype=dtype)
    ref = j_datasets.NpyFolderDataset(root, mode="train", subname="mix")
    got = t_datasets.NpyFolderDataset(root, mode="train", subname="mix")
    assert got.names == ref.names and len(got) == len(ref) == 10
    for i in range(10):
        a, b = got[i], ref[i]
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    idxs = np.array([3, 0, 7])
    rb, gb = ref.read_batch(idxs), got.read_batch(idxs)
    assert (rb is None) == (gb is None) == (dtype != np.uint8)
    if gb is not None:
        np.testing.assert_array_equal(gb, rb)
    with pytest.raises(FileNotFoundError):
        t_datasets.NpyFolderDataset(root, mode="eval")


@pytest.mark.parametrize("shuffle", [True, False])
def test_batch_loader_order_matches_jax(tmp_path, shuffle):
    root = _npy_folder(str(tmp_path), n=11)
    ds = t_datasets.NpyFolderDataset(root, mode="train", subname="mix")
    ref = j_datasets.BatchLoader(ds, 3, shuffle=shuffle, seed=5, workers=2)
    got = t_datasets.BatchLoader(ds, 3, shuffle=shuffle, seed=5, workers=2)
    assert len(got) == len(ref) == 3                    # drop-last
    for epoch in (0, 1, 4):
        want = list(ref.epoch(epoch))
        have = list(got.epoch(epoch))
        assert len(have) == len(want) == 3
        for a, b in zip(have, want):
            np.testing.assert_array_equal(a, b)


def test_synthetic_disk_cache_equals_a_cache_free_build(tmp_path):
    d = str(tmp_path / "synth")
    built = t_datasets.SyntheticSRGBDataset(length=5, size=48, seed=9,
                                            disk_cache=d)
    assert os.listdir(d) == ["v6_s9_p48_n5.npy"]
    mapped = t_datasets.SyntheticSRGBDataset(length=5, size=48, seed=9,
                                             disk_cache=d)
    plain = t_datasets.SyntheticSRGBDataset(length=5, size=48, seed=9,
                                            cache=False)
    ref = j_datasets.SyntheticSRGBDataset(length=5, size=48, seed=9,
                                          cache=False, disk_cache="")
    for i in range(5):
        for ds in (built, mapped):
            np.testing.assert_array_equal(ds[i], plain[i])
        np.testing.assert_array_equal(plain[i], ref[i])


# ---------------------------------------------------------- runfiles, CLI
def _same(a, b):
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("path", GAUSSIAN, ids=os.path.basename)
def test_gaussian_runfiles_read_as_jax_reads_them(path):
    assert _same(load_runfile(path, mode="train"),
                 j_load_runfile(path, mode="train"))


def _actions(parser):
    return [(a.option_strings, a.dest, a.default, a.type, a.nargs)
            for a in parser._actions]


def test_trainer_awgn_parser_equals_jax():
    assert _actions(t_cli.build_parser()) == _actions(j_cli.build_parser())


TINY = """mode: 'train'
checkpoint: '{tmp}/saved'
fast_ckpt: '{tmp}/ckpt'
model_name: 'tiny_gru'
result_dir: '{tmp}/images/'
dst: &base_dst
  root_dir: 'YOND'
  dataset: 'RGB_Img2Raw_Dataset'
  command: ''
  patch_size: 32
  sigma_min: 5
  sigma_max: 50
  clip: True
dst_train:
  <<: *base_dst
  mode: 'train'
dst_eval:
  <<: *base_dst
  mode: 'eval'
  sigma_list: [10, 25, 50]
dst_test:
  <<: *base_dst
  mode: 'test'
  sigma_list: [25]
arch:
  name: 'GuidedResUnet'
  guided: True
  in_nc: 4
  out_nc: 4
  nf: 4
  nframes: 1
  res: True
  norm: True
hyper:
  lr_scheduler: 'WarmupCosine'
  learning_rate: 1.e-3
  batch_size: 4
  last_epoch: 0
  step_size: 1
  stop_epoch: 4
  T: 1
  coldstart: False
  save_freq: 1
  plot_freq: 1
  best_psnr: 0.
"""


def test_cli_debug_cpu_writes_its_checkpoint(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)                  # ./logs lands in tmp_path
    path = tmp_path / "tiny.yml"
    path.write_text(TINY.format(tmp=tmp_path))
    t_cli.main(["-f", str(path), "--debug", "--cpu",
                "--steps-per-epoch", "2"])
    assert (tmp_path / "logs" / "log_tiny_gru.log").exists()
    for tag in ("last", "best"):
        ck = tmp_path / "ckpt" / f"tiny_gru_{tag}_model.ckpt"
        state = j_load_checkpoint(str(ck))
        assert state["epoch"] == 2                # --debug: 2 epochs
        assert int(state["opt_state"]["count"]) == 4
        sd = params_to_state_dict(state["params"])
        assert all(np.isfinite(v.numpy()).all() for v in sd.values())
    assert (tmp_path / "saved" / "tiny_gru_e0002.ckpt").exists()
    log = (tmp_path / "logs" / "log_tiny_gru.log").read_text()
    assert "sigma=25" in log and "Epoch 2: lr=" in log

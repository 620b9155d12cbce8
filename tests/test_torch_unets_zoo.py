"""The port's UNet family beyond the guided SNR-Nets (SNRnet, ResUnet,
ResUnet2, UNetSeeInDark) against flax, and the UNetSeeInDark 'unetn'
paths: its AWGN recipe, the trainer's eval anchor and the CLI (CPU, fp32).

Tolerances:
- each net's forward at nf 8 on the same params (drawn with numpy at
  flax's fan-in scale in the flax tree of `jax.eval_shape(model.init)`),
  against `model.apply`: atol 1e-5;
- the committed Gaussian_Unet_mix_5to50_norm at 64x64: atol 1e-4 (as the
  gru32 flagship, tests/test_torch_engine.py);
- `init_params` against the JAX trainer's `initialize_weights` (run
  eagerly, as the trainer runs it) on flax's tree: exact; the template's
  deconv biases are flax's zero init;
- one step of `runfiles/Gaussian/Unet_5to50_norm.yml` from the committed
  weights, batch 4 of 32-px crops: the bounds of the AWGN step test
  (tests/test_torch_train.py::_check_step: loss rtol 1e-5, gradients and
  moments 1e-4 / 2e-4 of each tensor's max, Adam's per-weight bound);
- `chip_smoke.py`'s JAX_EVAL_UNET: the JAX trainer's CPU eval of the
  committed net on the recipe's eval set cut to 64 crops, within 1e-4 dB
  and 1e-4 of SSIM (the anchor is printed to 4 decimals);
- the CLI's --input with the 'unetn' runfile (the ANY runfile with arch
  and model_name swapped to the Unet) against JAX's CLI: atol 2e-4.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yondx.models.registry as j_registry
import yondx.train.trainer as j_trainer_mod
from yondx.models import build_model as j_build_model
from yondx.parallel.mesh import make_mesh, replicate, shard_batch
from yondx.train import AWGNTrainer as JTrainer
from yondx.train.ckpt import load_checkpoint as j_load_checkpoint

from test_torch_train import _batch, _check_step, LR
from yondx_torch.cli import yond as t_yond
from yondx_torch.config import load_runfile
from yondx_torch.models import unets
from yondx_torch.models.convert import params_to_state_dict
from yondx_torch.models.registry import (MODEL_REGISTRY, build_model,
                                         init_params, is_guided)
from yondx_torch.models.unets import load_model
from yondx_torch.train import AWGNTrainer
from torch_test_util import _two_torch_threads  # noqa: F401

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CKPTS = os.path.join(REPO, "checkpoints", "Gaussian")
UNET_CKPT = os.path.join(CKPTS,
                         "Gaussian_Unet_mix_5to50_norm_best_model.ckpt")
UNET_RUNFILE = os.path.join(REPO, "runfiles", "Gaussian",
                            "Unet_5to50_norm.yml")
ANY_RUNFILE = os.path.join(REPO, "runfiles", "YOND",
                           "ANY_simple+full_pre_grumix.yml")
NETS = ("UNetSeeInDark", "ResUnet", "ResUnet2", "SNRnet")


def _arch(name, nf=8):
    return {"name": name, "guided": name == "SNRnet", "in_nc": 4,
            "out_nc": 4, "nf": nf, "nframes": 1, "res": True, "norm": True}


def _shapes(model, guided, size=32):
    args = (jnp.zeros((1, size, size, 4)),) + (
        (jnp.full((1,), 0.1),) if guided else ())
    return jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)


def _zeros(shapes):
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)


def test_registry_has_every_unet():
    for name in NETS:
        assert MODEL_REGISTRY[name] is getattr(unets, name)
        assert is_guided({"name": name}) == (name == "SNRnet")


@pytest.mark.parametrize("name", NETS)
def test_forward_matches_flax(name):
    arch = _arch(name)
    model = j_build_model(dict(arch))
    guided = arch["guided"]
    rng = np.random.default_rng(NETS.index(name))

    def draw(path, leaf):
        fan_in = int(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 1
        std = np.sqrt(1.0 / fan_in) if path[-1].key == "kernel" else 1e-2
        return (rng.standard_normal(leaf.shape) * std).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw,
                                                 _shapes(model, guided))
    net = build_model(arch)
    net.load_state_dict(params_to_state_dict(
        jax.tree.map(np.asarray, variables)), strict=True)
    x = rng.random((2, 32, 32, 4)).astype(np.float32)
    t = np.array([0.03, 0.2], np.float32)
    extra = (t,) if guided else ()
    ref = np.asarray(jax.jit(model.apply)(
        variables, jnp.asarray(x), *map(jnp.asarray, extra)))
    with torch.no_grad():
        got = net(torch.from_numpy(x),
                  *map(torch.from_numpy, extra)).numpy()
    assert got.shape == ref.shape == x.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", NETS)
def test_init_params_equal_jax(name):
    arch = _arch(name)
    model = j_build_model(dict(arch))
    want = params_to_state_dict(jax.tree.map(
        np.asarray, j_registry.initialize_weights(
            _zeros(_shapes(model, arch["guided"])), jax.random.PRNGKey(42))))
    got = init_params(build_model(arch))
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_array_equal(got[n].numpy(), want[n].numpy(), n)


def test_committed_unet_matches_flax():
    arch = load_runfile(UNET_RUNFILE)["arch"]
    params = j_load_checkpoint(UNET_CKPT)["params"]
    net = load_model(arch, UNET_CKPT, device="cpu")
    assert isinstance(net, unets.UNetSeeInDark)
    assert sum(p.numel() for p in net.parameters()) == sum(
        int(np.prod(np.shape(v))) for v in jax.tree.leaves(params))
    x = np.random.default_rng(9).random((2, 64, 64, 4)).astype(np.float32)
    ref = np.asarray(jax.jit(j_build_model(dict(arch)).apply)(
        params, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


# ------------------------------------------------------------ the recipe
def _recipe_args(tmp):
    """Unet_5to50_norm.yml as written, its writes under `tmp` and its eval
    set cut to 64 crops (the eval batch stays 64 // 8 = 8)."""
    args = load_runfile(UNET_RUNFILE, mode="train")
    args["fast_ckpt"] = os.path.join(tmp, "ckpt")
    args["checkpoint"] = os.path.join(tmp, "saved")
    args["result_dir"] = os.path.join(tmp, "images")
    args["dst_eval"]["synthetic_len"] = 64
    return args


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """The JAX and port AWGN trainers of the recipe with the committed
    Unet weights. The JAX trainer's synthetic sets cache into the
    module's tmp dir, and its fresh-init template and N(0, 0.02) draws
    (which the checkpoint overwrites) are skipped."""
    import functools
    tmp = str(tmp_path_factory.mktemp("unet"))
    old = os.getcwd()
    os.chdir(tmp)
    try:
        with pytest.MonkeyPatch.context() as data_mp:
            data_mp.setattr(j_trainer_mod, "SyntheticSRGBDataset",
                            functools.partial(
                                j_trainer_mod.SyntheticSRGBDataset,
                                disk_cache=os.path.join(tmp, "jax_synth")))
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(j_trainer_mod, "init_params",
                           lambda m, r, shape, guided: _zeros(_shapes(
                               m, guided, shape[1])))
                mp.setattr(j_registry, "initialize_weights", lambda p, r: p)
                jt = JTrainer(_recipe_args(os.path.join(tmp, "jax")),
                              mesh=make_mesh(1))
            jt.params = j_load_checkpoint(UNET_CKPT, jt.params)["params"]
            jt.opt_state = jt.tx.init(jt.params)
            tt = AWGNTrainer(_recipe_args(os.path.join(tmp, "port")),
                             device="cpu", field="jax")
            tt.load_params(jax.tree.map(np.asarray, jt.params))
            yield tmp, jt, tt
    finally:
        os.chdir(old)


def _jax_step(tr, params, opt_state, batch, key):
    """One step of the JAX trainer's own jitted step from (params,
    opt_state), its inputs placed on the mesh as its train loop places
    them (one compile: cheaper here than the op-by-op step of
    tests/test_torch_train.py, which shares its compiles between cases)."""
    params = replicate(tr.mesh, params)
    new_p, new_s, loss, m, _ = tr._make_train_step()(
        params, replicate(tr.mesh, opt_state), jnp.asarray(key),
        shard_batch(tr.mesh, batch), jnp.float32(LR), params,
        jnp.float32(0.0))
    return (jax.tree.map(np.asarray, new_p), jax.tree.map(np.asarray, new_s),
            float(loss), float(m))


def test_unet_recipe_step_matches_jax(trainers):
    """One step of the recipe (unguided: the net takes no sigma) on 4
    crops of 32 px at lr 1e-3, from the committed weights."""
    _, jt, tt = trainers
    assert not tt.guided and not jt.guided
    assert isinstance(tt.model, unets.UNetSeeInDark)
    params = jax.tree.map(np.asarray, jt.params)
    state = jax.tree.map(np.asarray, jt.opt_state)
    batch = _batch(31)
    key = np.asarray(jax.random.PRNGKey(5))
    j_out = _jax_step(jt, params, state, batch, key)
    from yondx_torch.core import rng
    loss, m, _ = tt.train_step(batch, rng.split(key, 3), LR)
    _check_step(tt, j_out, (float(loss), float(m)))


def test_jax_eval_unet_anchor_of_chip_smoke(trainers):
    """chip_smoke.py phase 12c holds the card's AWGNTrainer.eval of the
    committed Unet to JAX_EVAL_UNET: the JAX trainer's CPU eval."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _, jt, _ = trainers
    for sigma, (want_p, want_s) in smoke.JAX_EVAL_UNET.items():
        p, s = jt.eval(epoch=-1, sigma=sigma)
        assert abs(p - want_p) <= 1e-4 and abs(s - want_s) <= 1e-4, \
            (sigma, p, s)


def test_cli_input_with_the_unetn_runfile_matches_jax(tmp_path,
                                                      monkeypatch):
    """The ANY runfile with arch and model_name swapped to the committed
    Unet: the 'unetn' configuration, served unguided in VST space. Both
    CLIs on one 256x384 frame, tiles of 128."""
    from yondx.cli import yond as j_yond
    monkeypatch.chdir(tmp_path)
    text = open(ANY_RUNFILE).read()
    head, arch = text.split("arch:")
    head = head.replace("fast_ckpt: 'checkpoints/Gaussian'",
                        f"fast_ckpt: '{CKPTS}'").replace(
        "Gaussian_GRU_mix_1to50c_norm", "Gaussian_Unet_mix_5to50_norm")
    arch = arch.replace("'GuidedResUnet'", "'UNetSeeInDark'").replace(
        "guided: True", "guided: False")
    runfile = tmp_path / "unetn.yml"
    runfile.write_text(head + "arch:" + arch)
    rng = np.random.default_rng(8)
    levels = rng.random((4, 8)) * 0.7 + 0.05
    clean = np.kron(levels, np.ones((64, 48)))
    noisy = (8.74 * rng.poisson(clean * 959.0 / 8.74)
             + rng.normal(0, 12.81, clean.shape)) / 959.0
    np.save(tmp_path / "frame.npy", np.clip(noisy, 0, 1).astype(np.float32))
    monkeypatch.setattr(j_yond, "init_params",
                        lambda m, r, shape, guided: _zeros(_shapes(
                            m, guided, shape[1])))
    args = ["-f", str(runfile), "--input", "frame.npy", "--tile", "128"]
    j_yond.main(args + ["--output", "j.npy", "--cpu"])
    app = t_yond.main(args + ["--output", "t.npy", "--cpu"])
    assert isinstance(app.model, unets.UNetSeeInDark)
    assert not app.denoiser.guided
    ref, got = np.load(tmp_path / "j.npy"), np.load(tmp_path / "t.npy")
    assert got.shape == ref.shape == (256, 384)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)
    assert 10 * np.log10(1 / np.mean((got - clean) ** 2)) > \
        10 * np.log10(1 / np.mean((noisy - clean) ** 2)) + 5

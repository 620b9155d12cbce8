"""The port's AWGN trainer against the JAX package's (CPU, fp32).

The JAX side is `yondx.train.AWGNTrainer` on a one-device mesh, its step
run eagerly (`jax.disable_jit()`: one XLA compile per op, shared by every
case of the module, instead of one whole-step compile per case); the port
uses the "jax" field source, so both see the same batches, keys, cameras,
sigmas and Gaussian fields. Tiny nets: GuidedResUnet nf=4 on 32-px crops
(16x16 RGGB planes), batch 4; a GuidedResUnetS2D nf=8 student for the
distillation case. Tolerances:
- losses and the PSNR metric: rtol 1e-5; their autograd gradients against
  jax.grad: atol 1e-6 relative to the gradient's max;
- lr_lambda_from_hyper: exact, every runfiles/Gaussian run, every epoch;
- fresh init: exact (the port draws JAX's numbers);
- one train step, per option: loss rtol 1e-5; gradients (JAX's mu / 0.1)
  and both Adam moments within 1e-4 of each tensor's max (fp32 sums in
  other orders); updated parameters: Adam's first step is
  lr * g / (|g| + eps), so each entry is held to the move that its
  tensor's gradient error e can cause there (lr eps e / (|g| - e +
  eps)^2, doubled, plus 3e-8 for rounding: a few ulps of |p| <= 0.1),
  which is 2 lr where |g| <= 2e and its sign can flip; and at most 0.5%
  of all entries may be apart by more than 3e-8;
- predict (tiled inference): atol 1e-5;
- two epochs of two steps: per-epoch train and eval PSNR within 1e-3 dB;
- checkpoints: the port writes flax's bytes; each package reads the
  other's files, Adam state included; a resumed step equals JAX's
  (loss rtol 1e-5, moments 1e-4 of the max, parameters atol 1e-7).
"""
import copy
import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.serialization import to_state_dict

import yondx.train.trainer as j_trainer_mod
from yondx.core.meters import AverageMeter as JMeter
from yondx.parallel.mesh import make_mesh, replicate, shard_batch
from yondx.train import AWGNTrainer as JTrainer
from yondx.train import losses as j_losses
from yondx.train import schedule as j_schedule
from yondx.train import s2d_port as j_s2d_port
from yondx.train.ckpt import load_checkpoint as j_load_checkpoint
from yondx.train.ckpt import save_checkpoint as j_save_checkpoint

from yondx_torch.config import load_runfile
from yondx_torch.core import rng
from yondx_torch.models.convert import (params_to_state_dict,
                                        state_dict_to_params)
from yondx_torch.models.registry import build_model, init_params, param_count
from yondx_torch.train import AWGNTrainer
from yondx_torch.train import losses as t_losses
from yondx_torch.train import s2d_port as t_s2d_port
from yondx_torch.train import schedule as t_schedule
from yondx_torch.train.ckpt import load_checkpoint, save_checkpoint
from torch_test_util import _one_torch_thread  # noqa: F401

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
GAUSSIAN = sorted(glob.glob(os.path.join(REPO, "runfiles", "Gaussian",
                                         "*.yml")))
LR = 1e-3
GRU4 = {"name": "GuidedResUnet", "guided": True, "in_nc": 4, "out_nc": 4,
        "nf": 4, "nframes": 1, "res": True, "norm": True}
S2D8 = {"name": "GuidedResUnetS2D", "guided": True, "in_nc": 4,
        "out_nc": 4, "nf": 8, "nframes": 1, "res": True, "norm": True,
        "out_k": 3}


def _args(tmp, arch=GRU4, patch=32, command="", **extra):
    dst = {"patch_size": patch, "sigma_min": 5, "sigma_max": 50,
           "clip": True, "command": command, "synthetic_len": 8}
    args = {
        "model_name": "t_gru", "fast_ckpt": os.path.join(tmp, "ckpt"),
        "checkpoint": os.path.join(tmp, "saved"), "result_dir": tmp,
        "arch": dict(arch),
        "hyper": {"lr_scheduler": "WarmupCosine", "learning_rate": 2e-4,
                  "batch_size": 4, "last_epoch": 0, "step_size": 5,
                  "stop_epoch": 2, "T": 1, "coldstart": False,
                  "save_freq": 1, "plot_freq": 1, "best_psnr": 0.0},
        "dst_train": dict(dst, mode="train"),
        "dst_eval": dict(dst, mode="eval", sigma_list=[10, 25, 50]),
    }
    args.update(extra)
    return args


class _Chdir:
    """Run inside `path` (the trainers write ./logs/)."""

    def __init__(self, path):
        self.path = path

    def __enter__(self):
        self.old = os.getcwd()
        os.makedirs(self.path, exist_ok=True)
        os.chdir(self.path)

    def __exit__(self, *exc):
        os.chdir(self.old)


def _batch(seed, n=4, size=32):
    return np.random.default_rng(seed).integers(
        0, 256, (n, size, size, 3)).astype(np.uint8)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


# ------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return str(tmp_path_factory.mktemp("train"))


@pytest.fixture(autouse=True, scope="module")
def _jax_synth_cache_in_work(work):
    """The JAX trainer's synthetic sets cache into the module's
    temporary directory, not the JAX package's fixed default."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_trainer_mod, "SyntheticSRGBDataset", functools.partial(
            j_trainer_mod.SyntheticSRGBDataset,
            disk_cache=os.path.join(work, "jax_synth")))
        yield


@pytest.fixture(scope="module")
def jbase(work):
    """The JAX trainer of the base configuration, fresh."""
    with _Chdir(work):
        tr = JTrainer(_args(os.path.join(work, "jax")), mesh=make_mesh(1))
    return tr


@pytest.fixture(scope="module")
def fresh(jbase):
    """The base trainer's fresh params and Adam state (numpy)."""
    return _np_tree(jbase.params), _np_tree(jbase.opt_state)


def _port(args, **kw):
    return AWGNTrainer(args, device="cpu", field="jax", **kw)


def _jax_step(tr, params, opt_state, batch, key, use_cons=0.0):
    """One eager step of the JAX trainer from (params, opt_state), its
    inputs placed on the mesh as its train loop places them (so the
    loop's eager ops reuse these compiles)."""
    step = tr._make_train_step()
    params = replicate(tr.mesh, params)
    with jax.disable_jit():
        out = step(params, replicate(tr.mesh, copy.deepcopy(opt_state)),
                   jnp.asarray(key), shard_batch(tr.mesh, batch),
                   jnp.float32(LR), params, jnp.float32(use_cons))
    new_p, new_s, loss, m, _ = out
    return _np_tree(new_p), _np_tree(new_s), float(loss), float(m)


def _moments(state):
    """(mu, nu) as state_dicts and the count of an optax adam state (the
    namedtuples or their state dict)."""
    if hasattr(state, "inner_state"):
        inner = state.inner_state[0]
        inner = {"mu": inner.mu, "nu": inner.nu, "count": inner.count}
    else:
        inner = state["inner_state"]["0"]
    return (params_to_state_dict(_np_tree(inner["mu"])),
            params_to_state_dict(_np_tree(inner["nu"])), int(inner["count"]))


def _close_to_max(got, want, frac, what):
    """Each tensor within `frac` of its largest magnitude."""
    for name in want:
        w, g = want[name].numpy(), got[name].numpy()
        err = float(np.abs(g - w).max())
        assert err <= frac * max(float(np.abs(w).max()), 1e-12), \
            f"{what} {name}: err {err:.3e} vs max {np.abs(w).max():.3e}"


def _adam_bound(g, g_other, lr, eps=1e-8):
    """How far Adam's first step lr * g / (|g| + eps) can move apart for
    gradients that differ by e = max |g - g_other| over the tensor: by
    lr * eps * e / (|g| - e + eps)^2 while |g| > 2e (twice that bound
    here), by 2 lr where g is within rounding of 0 and its sign can
    flip."""
    e = np.abs(g_other - g).max()
    a = np.abs(g)
    return np.where(a > 2 * e, 2 * lr * eps * e / (a - e + eps) ** 2,
                    2 * lr)


def _check_step(port, j_out, t_out, lr=LR):
    """Port step (after `port.train_step`) against the JAX step output."""
    j_params, j_state, j_loss, j_m = j_out
    t_loss, t_m = t_out
    assert abs(t_loss - j_loss) <= 1e-5 * abs(j_loss)
    assert abs(t_m - j_m) <= 1e-5 * abs(j_m)
    mu, nu, count = _moments(j_state)
    assert count == 1
    names = [n for n, _ in port.model.named_parameters()]
    t_grad = {n: p.grad.detach() for n, p in port.model.named_parameters()}
    j_grad = {n: mu[n] / np.float32(0.1) for n in names}
    _close_to_max(t_grad, j_grad, 1e-4, "grad")
    st = port.optimizer.state
    pmap = dict(port.model.named_parameters())
    _close_to_max({n: st[pmap[n]]["exp_avg"] for n in names}, mu, 1e-4, "mu")
    _close_to_max({n: st[pmap[n]]["exp_avg_sq"] for n in names}, nu, 2e-4,
                  "nu")
    want = params_to_state_dict(j_params)
    frozen = {n for n in names if n.split(".")[0] in port._frozen}
    moved = total = 0
    for n in names:
        g = j_grad[n].numpy()
        d = np.abs(pmap[n].detach().numpy() - want[n].numpy())
        if n in frozen:
            assert d.max() == 0.0, n
            continue
        assert d.max() <= 2 * lr * (1 + 1e-6), n
        assert (d <= _adam_bound(g, t_grad[n].numpy(), lr) + 3e-8).all(), n
        moved += int((d > 3e-8).sum())
        total += d.size
    assert moved <= 0.005 * total, f"{moved} of {total} entries moved apart"


# ----------------------------------------------------------------- losses
LOSSES = {
    "l1": lambda m, p, t: m.l1_loss(p, t),
    "charbonnier": lambda m, p, t: m.charbonnier_loss(p, t),
    "gradient": lambda m, p, t: m.gradient_loss(p, t),
    "pyramid": lambda m, p, t: m.pyramid_loss(p, t),
    "unet": lambda m, p, t: m.unet_loss(p, t),
    "unet_charb_pyr": lambda m, p, t: m.unet_loss(p, t, charbonnier=True,
                                                 pyramid=True),
    "dpsv": lambda m, p, t: m.unet_dpsv_loss(
        [p, m._down2(p) * 0.9, m._down2(m._down2(p))], t),
    "dpsv_up": lambda m, p, t: m.unet_dpsv_loss_up(
        [p, p * 0.8, m._down2(p)], t, charbonnier=True),
    "psnr": lambda m, p, t: m.psnr_loss(p, t),
    "psnr_3d": lambda m, p, t: m.psnr_loss(p[0], t[0]),
}
GANS = [(k, d) for k in ("SGAN", "RSGAN", "RaSGAN", "RaLSGAN")
        for d in (True, False)]


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_and_gradient_match_jax(name):
    rs = np.random.default_rng(3)
    p = rs.random((2, 16, 16, 4), np.float32)
    t = rs.random((2, 16, 16, 4), np.float32)
    fn = LOSSES[name]
    j_val, j_grad = jax.value_and_grad(
        lambda x: fn(j_losses, x, jnp.asarray(t)))(jnp.asarray(p))
    tp = torch.from_numpy(p).requires_grad_(True)
    t_val = fn(t_losses, tp, torch.from_numpy(t))
    t_val.backward()
    assert abs(float(t_val.detach()) - float(j_val)) <= 1e-5 * abs(float(j_val))
    g = np.asarray(j_grad)
    assert np.abs(tp.grad.numpy() - g).max() <= 1e-6 * np.abs(g).max()


@pytest.mark.parametrize("kind,for_d", GANS)
def test_gan_loss_and_gradient_match_jax(kind, for_d):
    rs = np.random.default_rng(4)
    r = rs.normal(size=(8, 1)).astype(np.float32)
    f = rs.normal(size=(8, 1)).astype(np.float32)
    j_val, j_grad = jax.value_and_grad(lambda x: j_losses.gan_loss(
        jnp.asarray(r), x, kind, for_d))(jnp.asarray(f))
    tf = torch.from_numpy(f).requires_grad_(True)
    t_val = t_losses.gan_loss(torch.from_numpy(r), tf, kind, for_d)
    t_val.backward()
    assert abs(float(t_val.detach()) - float(j_val)) <= 1e-5 * abs(float(j_val))
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(j_grad),
                               rtol=0, atol=1e-6 * np.abs(j_grad).max())
    with pytest.raises(ValueError):
        t_losses.gan_loss(torch.from_numpy(r), tf, "WGAN")


# --------------------------------------------------------------- schedule
@pytest.mark.parametrize("path", GAUSSIAN, ids=os.path.basename)
def test_lr_schedule_matches_jax_exactly(path):
    hyper = load_runfile(path)["hyper"]
    j_fn = j_schedule.lr_lambda_from_hyper(hyper)
    t_fn = t_schedule.lr_lambda_from_hyper(hyper)
    for e in range(0, hyper["stop_epoch"] + 1):
        assert t_fn(e) == j_fn(e), (path, e)
    for name in ("MultiStep", "constant"):
        h = dict(hyper, lr_scheduler=name)
        j_fn = j_schedule.lr_lambda_from_hyper(h)
        t_fn = t_schedule.lr_lambda_from_hyper(h)
        assert [t_fn(e) for e in range(hyper["stop_epoch"] + 1)] == \
            [j_fn(e) for e in range(hyper["stop_epoch"] + 1)]


# ------------------------------------------------------------- fresh init
def test_fresh_init_equals_jax(work, fresh):
    """GuidedResUnet nf=4: the JAX trainer's init_params(PRNGKey(0)) +
    initialize_weights(PRNGKey(42)) against the port's, exactly."""
    params, _ = fresh
    with _Chdir(work):
        port = _port(_args(os.path.join(work, "port_init")))
    want = params_to_state_dict(params)
    got = port.model.state_dict()
    assert list(sorted(got)) == list(sorted(want))
    for n in want:
        np.testing.assert_array_equal(got[n].numpy(), want[n].numpy(), n)
    assert param_count(port.model) == param_count(want) == \
        int(sum(np.prod(np.shape(x)) for x in jax.tree.leaves(params)))


# ------------------------------------------------------------ train steps
STEP_OPTIONS = {"plain": {}, "chroma_aug": {"command": "chroma_aug"},
                "low_sigma": {"command": "low_sigma"},
                "consistency": {"command": "consistency"},
                "remat": {"remat": True},
                "no_bayeraug": {"command": "no_bayeraug"}}


@pytest.mark.parametrize("option", list(STEP_OPTIONS))
def test_train_step_matches_jax(work, jbase, fresh, option):
    opt = STEP_OPTIONS[option]
    params, state = fresh
    cmd = opt.get("command", "")
    jbase.chroma_aug = "chroma_aug" in cmd
    jbase.low_sigma = "low_sigma" in cmd
    jbase.consistency = "consistency" in cmd
    jbase.bayeraug = "no_bayeraug" not in cmd
    jbase.hyper["remat"] = opt.get("remat", False)
    use_cons = 1.0 if jbase.consistency else 0.0
    batch = _batch(list(STEP_OPTIONS).index(option))
    key = np.asarray(jax.random.PRNGKey(21))
    try:
        j_out = _jax_step(jbase, params, state, batch, key, use_cons)
    finally:
        jbase.chroma_aug = jbase.low_sigma = jbase.consistency = False
        jbase.bayeraug = True
        jbase.hyper["remat"] = False
    args = _args(os.path.join(work, "port_" + option), command=cmd)
    args["hyper"]["remat"] = opt.get("remat", False)
    with _Chdir(work):
        port = _port(args)
    ema = copy.deepcopy(port.model) if use_cons else None
    loss, m, _ = port.train_step(batch, rng.split(key, 3), LR, use_cons, ema)
    _check_step(port, j_out, (float(loss), float(m)))


def test_train_step_rgb_mode_matches_jax(work):
    arch = dict(GRU4, in_nc=3, out_nc=3)
    args = _args(os.path.join(work, "rgb"), arch=arch, patch=16)
    with _Chdir(work):
        jtr = JTrainer(copy.deepcopy(args), mesh=make_mesh(1))
        port = _port(copy.deepcopy(args))
    params, state = _np_tree(jtr.params), _np_tree(jtr.opt_state)
    for n, t in params_to_state_dict(params).items():
        np.testing.assert_array_equal(port.model.state_dict()[n].numpy(),
                                      t.numpy(), n)
    batch = _batch(8, size=16)
    key = np.asarray(jax.random.PRNGKey(5))
    j_out = _jax_step(jtr, params, state, batch, key)
    loss, m, sample = port.train_step(batch, rng.split(key, 3), LR)
    assert sample[0].shape == (16, 16, 3)
    _check_step(port, j_out, (float(loss), float(m)))


def test_train_step_distill_frozen_ported_matches_jax(work, fresh):
    """A GuidedResUnetS2D student (its fresh init held exactly) against a
    GuidedResUnet teacher, freeze 'ported': the frozen stages' moments
    advance, their weights do not."""
    tmp = os.path.join(work, "distill")
    teacher, _ = fresh
    j_save_checkpoint(os.path.join(tmp, "ckpt", "t_teacher_last_model.ckpt"),
                      teacher, None, 0, 0.0)
    args = _args(tmp, arch=S2D8, distill={
        "teacher_arch": dict(GRU4), "teacher_ckpt": "t_teacher",
        "weight": 0.5, "gt_weight": 1.0, "freeze": "ported"})
    with _Chdir(work):
        jtr = JTrainer(copy.deepcopy(args), mesh=make_mesh(1))
        port = _port(copy.deepcopy(args))
    params, state = _np_tree(jtr.params), _np_tree(jtr.opt_state)
    for n, t in params_to_state_dict(params).items():
        np.testing.assert_array_equal(port.model.state_dict()[n].numpy(),
                                      t.numpy(), n)
    assert len(port._frozen) == 13 and port._frozen_params
    batch = _batch(9)
    key = np.asarray(jax.random.PRNGKey(6))
    j_out = _jax_step(jtr, params, state, batch, key)
    loss, m, _ = port.train_step(batch, rng.split(key, 3), LR)
    _check_step(port, j_out, (float(loss), float(m)))


def test_s2d_port_matches_jax():
    """port_guidedresunet_to_s2d and extend_with_tail on state_dicts equal
    the JAX package's on flax trees."""
    src = state_dict_to_params(init_params(build_model(dict(GRU4, nf=8)), 1))
    dst = state_dict_to_params(init_params(build_model(dict(S2D8, nf=16)), 2))
    j_out, j_ported, j_fresh = j_s2d_port.port_guidedresunet_to_s2d(src, dst)
    t_out, t_ported, t_fresh = t_s2d_port.port_guidedresunet_to_s2d(
        params_to_state_dict(src), params_to_state_dict(dst))
    assert (t_ported, t_fresh) == (j_ported, j_fresh)
    for n, t in params_to_state_dict(j_out).items():
        np.testing.assert_array_equal(t_out[n].numpy(), t.numpy(), n)
    tail = state_dict_to_params(init_params(
        build_model(dict(S2D8, nf=16, tail_nf=4)), 3))
    j_ext = j_s2d_port.extend_with_tail(j_out, tail)
    t_ext = t_s2d_port.extend_with_tail(t_out, params_to_state_dict(tail))
    for n, t in params_to_state_dict(j_ext).items():
        np.testing.assert_array_equal(t_ext[n].numpy(), t.numpy(), n)
    with pytest.raises(KeyError):           # a GuidedResUnet source
        t_s2d_port.extend_with_tail(params_to_state_dict(src),
                                    params_to_state_dict(tail))
    with pytest.raises(ValueError):         # an S2D of another width
        t_s2d_port.extend_with_tail(init_params(build_model(S2D8), 4),
                                    params_to_state_dict(tail))


def test_predict_matches_jax(work, jbase):
    """Tiled full-frame inference (tiles of 32 with halo 8 on a 40x56
    Bayer frame) with the fresh net: the port's predict against JAX's,
    atol 1e-5."""
    frame = np.random.default_rng(12).random((40, 56)).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jbase.predict(frame, tile=32, halo=8, t=0.1))
    with _Chdir(work):
        port = _port(_args(os.path.join(work, "port_predict")))
    got = port.predict(frame, tile=32, halo=8, t=0.1)
    assert got.shape == want.shape == (40, 56)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ------------------------------------------------------------ checkpoints
def test_checkpoint_bytes_equal_flax(work, fresh):
    """The port's writer emits flax's bytes for the trainer's tree."""
    params, state = fresh
    a, b = (os.path.join(work, f"bytes_{s}.ckpt") for s in "jt")
    j_save_checkpoint(a, params, state, 7, 31.25)
    save_checkpoint(b, params, to_state_dict(state), 7, 31.25)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


# ------------------------------------------------- two epochs, and resume
class _Recording(JMeter):
    """AverageMeter that keeps each epoch's average at reset."""

    def __init__(self, *a):
        self.avgs = []
        super().__init__(*a)

    def reset(self):
        if getattr(self, "count", 0):
            self.avgs.append(self.avg)
        super().reset()


@pytest.fixture(scope="module")
def two_epochs(work, jbase):
    """Both trainers, fresh from the same init, run 2 epochs of 2 steps
    with an eval and a save after each."""
    meters = {}
    runs = {}
    for side in ("jax", "port"):
        if side == "jax":
            tr = jbase
        else:
            with _Chdir(work):
                tr = _port(_args(os.path.join(work, "port_e2e")))
        tr.train_psnr = _Recording("PSNR", ":2f")
        tr.eval_psnr = _Recording("PSNR", ":2f")
        with _Chdir(work), jax.disable_jit():
            tr.train(stop_epoch=2, steps_per_epoch=2)
        tr.train_psnr.reset()
        tr.eval_psnr.reset()
        meters[side] = (tr.train_psnr.avgs, tr.eval_psnr.avgs)
        runs[side] = tr
    return runs, meters


def test_two_epochs_match_jax(two_epochs):
    runs, meters = two_epochs
    (j_train, j_eval), (t_train, t_eval) = meters["jax"], meters["port"]
    assert len(j_train) == len(t_train) == 2
    assert len(j_eval) == len(t_eval) == 2
    np.testing.assert_allclose(t_train, j_train, rtol=0, atol=1e-3)
    np.testing.assert_allclose(t_eval, j_eval, rtol=0, atol=1e-3)
    assert runs["port"].epoch == runs["jax"].epoch == 2
    assert [s["epoch"] for s in runs["port"].steps] == [1, 1, 2, 2]
    assert all(np.isfinite(s["loss"]) for s in runs["port"].steps)


def test_port_checkpoint_reads_in_jax(two_epochs):
    """The port's `last` file through yondx.train.ckpt.load_checkpoint
    with JAX's templates: the port's arrays, Adam state included."""
    runs, _ = two_epochs
    port, jtr = runs["port"], runs["jax"]
    path = os.path.join(port.fast_ckpt, "t_gru_last_model.ckpt")
    state = j_load_checkpoint(path, _np_tree(jtr.params),
                              _np_tree(jtr.opt_state))
    assert state["epoch"] == 2
    want = port.model.state_dict()
    for n, t in params_to_state_dict(_np_tree(state["params"])).items():
        np.testing.assert_array_equal(t.numpy(), want[n].numpy(), n)
    mu, nu, count = _moments(_np_tree(state["opt_state"]))
    assert count == 4 and int(state["opt_state"].count) == 4
    st = port.optimizer.state
    for n, p in port.model.named_parameters():
        np.testing.assert_array_equal(mu[n].numpy(),
                                      st[p]["exp_avg"].numpy(), n)
        np.testing.assert_array_equal(nu[n].numpy(),
                                      st[p]["exp_avg_sq"].numpy(), n)
    assert os.path.exists(os.path.join(port.model_dir, "t_gru_e0002.ckpt"))
    # and the port reads it back to the same arrays
    back = load_checkpoint(path)
    assert back["epoch"] == 2 and back["best_psnr"] == state["best_psnr"]


def test_resume_jax_checkpoint_next_step_matches(work, two_epochs):
    """A JAX-written `last` checkpoint (epoch 2, Adam count 4) resumed by
    the port with last_epoch -1: its next step equals JAX's."""
    runs, _ = two_epochs
    jtr = runs["jax"]
    path = os.path.join(jtr.fast_ckpt, "t_gru_last_model.ckpt")
    args = _args(os.path.join(work, "resume"))
    args["fast_ckpt"] = jtr.fast_ckpt
    args["model_name"] = "t_gru"
    args["hyper"]["last_epoch"] = -1
    with _Chdir(work):
        port = _port(args)
    assert port.epoch == 2
    state = j_load_checkpoint(path, _np_tree(jtr.params),
                              _np_tree(jtr.opt_state))
    batch = _batch(33)
    key = np.asarray(jax.random.PRNGKey(77))
    j_params, j_state, j_loss, _ = _jax_step(
        jtr, _np_tree(state["params"]), _np_tree(state["opt_state"]), batch,
        key)
    loss, _, _ = port.train_step(batch, rng.split(key, 3), LR)
    assert abs(float(loss) - j_loss) <= 1e-5 * abs(j_loss)
    mu, nu, count = _moments(j_state)
    assert count == 5
    pmap = dict(port.model.named_parameters())
    st = port.optimizer.state
    assert all(int(st[p]["step"]) == 5 for p in pmap.values())
    _close_to_max({n: st[p]["exp_avg"] for n, p in pmap.items()}, mu, 1e-4,
                  "mu")
    _close_to_max({n: st[p]["exp_avg_sq"] for n, p in pmap.items()}, nu,
                  2e-4, "nu")
    for n, t in params_to_state_dict(j_params).items():
        np.testing.assert_allclose(pmap[n].detach().numpy(), t.numpy(),
                                   rtol=0, atol=1e-7, err_msg=n)


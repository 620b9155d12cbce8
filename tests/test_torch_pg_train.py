"""The port's noise-estimation training path against the JAX package's
(CPU, fp32): the score2 threshold and stdfilt, the est nets and their
flax default init, the Poisson-Gaussian batch and EstUnet features, one
PGEstTrainer step per flavour, two epochs, checkpoints both ways, the
train_est CLI and the PGE eval set.

Tiny shapes: batches of 2 crops of 64 px ([2,32,32,4] RGGB), est nets
at nf=4, depth 2. The JAX step is the JAX trainer's own jitted step.
Tolerances:
- `linspace_f32`, the flax default init (est_UNet at EstPGE.yml's
  widths, EstUnet at its defaults), `sample_pg_prior_each`, the batch's
  beta1, beta2, patterns and wb, and its Poisson counts on JAX's clean
  planes: exact;
- the batch's clean planes atol 1e-6 (the device unprocess), its
  noisy planes atol 2.4e-7 (XLA fuses the shot product and the Gaussian
  term into an fma: one ulp of values below 2);
- `stdfilt` atol 1e-6 where its variance clears 1e-6, and as a
  variance atol 1e-7 everywhere (a flat window's variance is fp32
  rounding, ~1e-8, which the sqrt takes to ~1e-4); the score2
  threshold 1e-6 relative with its quantile exact; `pg_est_features`
  within 1e-5 (the mask exact);
- the est nets' forward atol 1e-5 relative to the output's largest value;
- one train step: the AWGN step tests' bounds (loss rtol 1e-5;
  gradients (JAX's mu / 0.1) and mu within 1e-4 of each tensor's max,
  nu 2e-4; each weight within the move Adam's first step can make for
  its tensor's gradient error, at most 0.5% of the entries apart by
  more than 3e-8);
- two epochs of two steps: each epoch's mean loss rtol 1e-4; the
  checkpoints: each package reads the other's, the forward through
  either atol 1e-5 relative, a JAX checkpoint resumed with its epoch,
  Adam count and moments exact;
- the PGE eval loss: the port's CPU value within 1e-5 relative of JAX's
  on 4 crops; on the full 64-crop set JAX's CPU value within 1e-5 of
  the anchor that chip_smoke.py holds the card to within 1e-4 (the
  port's CPU value there is 2.3e-5 from JAX's: its device unprocess
  rounds ~half the clean values 1 ulp from XLA's, which moves ~50 of
  the 1M Poisson draws of a batch across an acceptance edge).
"""
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.serialization import to_state_dict

import yondx.train.pg_trainer as j_pg_mod
from yondx.data import datasets as j_datasets
from yondx.data.pg_dataset import (pg_est_features as j_features,
                                   pg_training_batch as j_batch,
                                   sample_pg_prior as j_prior)
from yondx.models.registry import build_model as j_build
from yondx.models.registry import init_params as j_init
from yondx.nle.boxfilter import stdfilt as j_stdfilt
from yondx.nle.threshold import adaptive_threshold_score2 as j_score2
from yondx.train.ckpt import load_checkpoint as j_load_checkpoint
from yondx.train.ckpt import save_checkpoint as j_save_checkpoint
from yondx.train.pg_trainer import PGEstTrainer as JTrainer

from yondx_torch.cli import train_est
from yondx_torch.data import pg_dataset as t_pg
from yondx_torch.io.ckpt import load_checkpoint as t_read
from yondx_torch.models.convert import (params_to_state_dict,
                                        state_dict_to_params)
from yondx_torch.models.registry import build_model, flax_init_params
from yondx_torch.nle.boxfilter import stdfilt
from yondx_torch.nle.threshold import adaptive_threshold_score2, linspace_f32
from yondx_torch.train.draws import FieldSource
from yondx_torch.train.pg_trainer import (PGEstTrainer, eval_pge,
                                          pge_eval_batches)
from torch_test_util import _two_torch_threads  # noqa: F401

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
EST_CKPT = os.path.join(REPO, "checkpoints", "Gaussian",
                        "EstPGE_d3nf16_last_model.ckpt")
PGE_ARCH = {"name": "est_UNet", "in_nc": 4, "out_nc": 2, "nf": 16,
            "depth": 3}
TINY = {"pge": {"name": "est_UNet", "in_nc": 4, "out_nc": 2, "nf": 4,
                "depth": 2},
        "map": {"name": "EstUnet", "in_nc": 12, "out_nc": 4, "nf": 4,
                "depth": 2, "res": False, "use_type": "std", "pge": False,
                "nframes": 1, "k": 19}}
LR = 1e-3
JAX_FIELD = FieldSource("jax", "cpu")


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return str(tmp_path_factory.mktemp("pg_train"))


@pytest.fixture(autouse=True, scope="module")
def _jax_synth_cache_in_work(work):
    """The JAX est trainer's synthetic sets cache into the module's
    temporary directory, not the JAX package's fixed default."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_pg_mod, "SyntheticSRGBDataset", functools.partial(
            j_pg_mod.SyntheticSRGBDataset,
            disk_cache=os.path.join(work, "jax_synth")))
        yield


def _args(tmp, flavor, **hyper):
    h = {"lr_scheduler": "WarmupCosine", "learning_rate": LR,
         "batch_size": 2, "last_epoch": 0, "step_size": 1, "stop_epoch": 2,
         "T": 1, "coldstart": False, "save_freq": 1}
    h.update(hyper)
    return {"model_name": f"t_{flavor}", "fast_ckpt": tmp,
            "arch": dict(TINY[flavor]), "hyper": h,
            "dst_train": {"patch_size": 64, "synthetic_len": 4}}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _imgs(seed, n=2, size=64):
    return np.random.default_rng(seed).integers(
        0, 256, (n, size, size, 3)).astype(np.uint8)


def _close_to_max(got, want, frac, what):
    for name in want:
        w, g = np.asarray(want[name]), np.asarray(got[name])
        err = float(np.abs(g - w).max())
        assert err <= frac * max(float(np.abs(w).max()), 1e-12), \
            f"{what} {name}: err {err:.3e} vs max {np.abs(w).max():.3e}"


# ------------------------------------------------------ filters, threshold
@pytest.mark.parametrize("step", [1, 2, 4, 5, 10, 25])
def test_linspace_f32_equals_jnp(step):
    n = 100 // step
    np.testing.assert_array_equal(linspace_f32(step, 100, n),
                                  np.asarray(jnp.linspace(step, 100, n)))


def test_stdfilt_and_score2_threshold():
    r = np.random.default_rng(7)
    for i in range(4):
        x = r.uniform(0, 1, (2, 32, 32, 4)).astype(np.float32)
        x[:, :16] *= 0.1 * i
        got = stdfilt(torch.from_numpy(x), 19).numpy()
        want = np.asarray(j_stdfilt(jnp.asarray(x), 19))
        # as variances: the prefix sums round in their own order, ~1e-8
        # of a flat window's variance, which the sqrt takes to ~1e-4
        np.testing.assert_allclose(got ** 2, want ** 2, rtol=0, atol=1e-7)
        above = want ** 2 > 1e-6
        np.testing.assert_allclose(got[above], want[above], rtol=0,
                                   atol=1e-6)
        tex = np.abs(r.normal(0, 0.05, (32, 32, 4))).astype(np.float32)
        tex[:8 * (i + 1)] += 0.3
        th_j, q_j = j_score2(jnp.asarray(tex))
        th_t, q_t = adaptive_threshold_score2(torch.from_numpy(tex))
        assert abs(float(th_t) - float(th_j)) <= 1e-6 * abs(float(th_j))
        assert float(q_t) == float(q_j)


# ----------------------------------------------------------------- models
@pytest.mark.parametrize("pge,use_type", [(True, "std"), (False, "std"),
                                          (False, "var"), (True, "var")])
def test_est_unet_forward_matches_flax(pge, use_type):
    """The params are numpy draws at flax's fan-in scale in the tree of
    `jax.eval_shape(model.init)` (flax's own init is held bit for bit by
    test_flax_default_init_bit_equal; run eagerly here it took ~30 s)."""
    arch = {"name": "EstUnet", "in_nc": 12, "out_nc": 4, "nf": 8,
            "depth": 3, "pge": pge, "use_type": use_type}
    rng = np.random.default_rng(3)
    x = rng.random((2, 32, 32, 12), np.float32)
    jm = j_build(arch)

    def draw(path, leaf):
        fan_in = int(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 1
        std = np.sqrt(1.0 / fan_in) if path[-1].key == "kernel" else 1e-2
        return (rng.standard_normal(leaf.shape) * std).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, jax.eval_shape(
        jm.init, jax.random.PRNGKey(5), jnp.zeros(x.shape)))
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    net = build_model(arch)
    net.load_state_dict(params_to_state_dict(_np_tree(params)), strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # the state_dict maps back to flax's tree, name for name
    back = state_dict_to_params(net.state_dict())
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(_np_tree(params))


@pytest.mark.parametrize("arch,shape", [
    (PGE_ARCH, (1, 32, 32, 4)),
    ({"name": "EstUnet", "in_nc": 12, "out_nc": 4, "pge": False},
     (1, 32, 32, 12))], ids=["est_UNet_d3nf16", "EstUnet_default"])
def test_flax_default_init_bit_equal(arch, shape):
    """init_params(model, PRNGKey(0), (1, ps/2, ps/2, in_nc)) with no
    initialize_weights (the est trainer's fresh net) against the port's
    flax_init_params, exactly (the dummy input's size sets no parameter:
    32 px here)."""
    want = params_to_state_dict(_np_tree(j_init(
        j_build(arch), jax.random.PRNGKey(0), shape, guided=False)))
    got = flax_init_params(build_model(arch))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), want[name].numpy(),
                                      name)


# ------------------------------------------------------------------- data
def test_sample_pg_prior_bit_equal():
    keys = jax.random.split(jax.random.PRNGKey(2), 64)
    b1, b2 = jax.jit(jax.vmap(j_prior))(keys)
    t1, t2 = t_pg.sample_pg_prior_each(np.asarray(keys))
    np.testing.assert_array_equal(t1, np.asarray(b1))
    np.testing.assert_array_equal(t2, np.asarray(b2))
    s1, s2 = t_pg.sample_pg_prior(np.asarray(keys[3]))
    assert (s1, s2) == (t1[3], t2[3])


@pytest.fixture(scope="module")
def jax_batch():
    """JAX's jitted batch of two crops of 64 px, and its input."""
    imgs = np.random.default_rng(4).random((2, 64, 64, 3), np.float32)
    key = jax.random.PRNGKey(6)
    lr, hr, meta = jax.jit(j_batch)(key, jnp.asarray(imgs))
    return imgs, key, _np_tree((lr, hr, meta))


def test_pg_training_batch_matches_jax(jax_batch):
    imgs, key, (lr, hr, meta) = jax_batch
    got = t_pg.pg_training_batch(np.asarray(key), torch.from_numpy(imgs),
                                 field=JAX_FIELD)
    t_lr, t_hr, t_meta = got
    for k in ("beta1", "beta2", "pattern", "wb"):
        np.testing.assert_array_equal(t_meta[k].numpy(), meta[k], k)
    np.testing.assert_allclose(t_hr.numpy(), hr, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_lr.numpy(), lr, rtol=0, atol=2.4e-7)
    # the Poisson counts on JAX's clean planes, through the field
    k_n1 = jax.random.split(key, 4)[2]
    lam = np.maximum(hr, 0) / meta["beta1"][:, None, None, None]
    np.testing.assert_array_equal(
        JAX_FIELD.poisson(np.asarray(k_n1), torch.from_numpy(lam)).numpy(),
        np.asarray(jax.random.poisson(k_n1, jnp.asarray(lam)), np.float32))


def test_pg_est_features_match_jax(jax_batch):
    _, _, (lr, hr, meta) = jax_batch
    want = _np_tree(jax.jit(j_features)(lr, hr, meta["beta1"],
                                        meta["beta2"]))
    got = t_pg.pg_est_features(*(torch.from_numpy(np.asarray(a)) for a in
                                 (lr, hr, meta["beta1"], meta["beta2"])))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(got["mask"].numpy(), want["mask"])


# ------------------------------------------------------------ train steps
def _adam_bound(g, g_other, lr, eps=1e-8):
    e = np.abs(g_other - g).max()
    a = np.abs(g)
    return np.where(a > 2 * e, 2 * lr * eps * e / (a - e + eps) ** 2,
                    2 * lr)


def _moments(state):
    inner = state["inner_state"]["0"]
    return (params_to_state_dict(inner["mu"]),
            params_to_state_dict(inner["nu"]), int(inner["count"]))


@pytest.mark.parametrize("flavor", ["pge", "map"])
def test_one_train_step_matches_jax(work, flavor):
    tmp = os.path.join(work, f"step_{flavor}")
    jt = JTrainer(_args(tmp, flavor))
    port = PGEstTrainer(_args(tmp, flavor), device="cpu", field="jax")
    assert port.flavor == jt.flavor == flavor
    fresh = params_to_state_dict(_np_tree(jt.params))
    for n, t in port.model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), fresh[n].numpy(), n)
    batch, key = _imgs(1), jax.random.PRNGKey(3)
    params, state, loss = jt._step(jt.params, jt.opt_state, key,
                                   jnp.asarray(batch), jnp.float32(LR))
    t_loss = float(port.train_step(batch, np.asarray(key), LR))
    assert abs(t_loss - float(loss)) <= 1e-5 * abs(float(loss))
    mu, nu, count = _moments(to_state_dict(_np_tree(state)))
    assert count == 1
    pmap = dict(port.model.named_parameters())
    st = port.optimizer.state
    t_grad = {n: p.grad.numpy() for n, p in pmap.items()}
    j_grad = {n: mu[n].numpy() / np.float32(0.1) for n in pmap}
    _close_to_max(t_grad, j_grad, 1e-4, "grad")
    _close_to_max({n: st[p]["exp_avg"] for n, p in pmap.items()}, mu, 1e-4,
                  "mu")
    _close_to_max({n: st[p]["exp_avg_sq"] for n, p in pmap.items()}, nu,
                  2e-4, "nu")
    want = params_to_state_dict(_np_tree(params))
    moved = total = 0
    for n, p in pmap.items():
        d = np.abs(p.detach().numpy() - want[n].numpy())
        assert d.max() <= 2 * LR * (1 + 1e-6), n
        assert (d <= _adam_bound(j_grad[n], t_grad[n], LR) + 3e-8).all(), n
        moved += int((d > 3e-8).sum())
        total += d.size
    assert moved <= 0.005 * total, f"{moved} of {total} entries moved apart"


@pytest.mark.parametrize("flavor", ["pge", "map"])
def test_two_epochs_and_checkpoints_both_ways(work, flavor, capsys):
    """Two epochs of two steps through each package's train(); each
    writes its `last` checkpoint every epoch; the other package reads it
    and runs the same forward."""
    dirs = {p: os.path.join(work, f"epochs_{flavor}_{p}")
            for p in ("jax", "port")}
    jt = JTrainer(_args(dirs["jax"], flavor))
    j_avg = jt.train(epochs=2, steps_per_epoch=2)
    j_log = capsys.readouterr().out
    port = PGEstTrainer(_args(dirs["port"], flavor), device="cpu",
                        field="jax")
    t_avg = port.train(epochs=2, steps_per_epoch=2)
    assert len(port.steps) == 4 and port.epoch == 2
    assert abs(t_avg - j_avg) <= 1e-4 * abs(j_avg)
    j_epochs = [float(line.split("loss=")[1]) for line in j_log.splitlines()
                if "[est] Epoch" in line]
    for e in (1, 2):
        t_mean = np.mean([s["loss"] for s in port.steps if s["epoch"] == e])
        assert abs(t_mean - j_epochs[e - 1]) <= 1e-4 * abs(j_epochs[e - 1]) \
            + 5e-6                        # the JAX line has 5 decimals
    x = np.random.default_rng(2).random(
        (2, 32, 32, TINY[flavor]["in_nc"]), np.float32)
    name = f"t_{flavor}_last_model.ckpt"
    # the port's file in JAX, JAX's file in the port
    j_state = j_load_checkpoint(os.path.join(dirs["port"], name))
    assert j_state["epoch"] == 2
    j_out = np.asarray(jt.model.apply(j_state["params"], jnp.asarray(x)))
    with torch.no_grad():
        t_out = port.model(torch.from_numpy(x)).numpy()
    assert np.abs(t_out - j_out).max() <= 1e-5 * np.abs(j_out).max()
    mu, _, count = _moments(j_state["opt_state"])
    assert count == 4
    st = port.optimizer.state
    for n, p in port.model.named_parameters():
        np.testing.assert_array_equal(st[p]["exp_avg"].numpy(),
                                      mu[n].numpy())
    t_state = t_read(os.path.join(dirs["jax"], name))
    other = build_model(TINY[flavor])
    other.load_state_dict(params_to_state_dict(t_state["params"]))
    with torch.no_grad():
        o_out = other(torch.from_numpy(x)).numpy()
    want = np.asarray(jt.model.apply(jt.params, jnp.asarray(x)))
    assert np.abs(o_out - want).max() <= 1e-5 * np.abs(want).max()


def test_resume_a_jax_checkpoint(work):
    """A JAX-written est checkpoint (after one step, epoch 3) resumed by
    the port with last_epoch -1: epoch, Adam count and moments as
    written; the next step equals JAX's from the same state."""
    tmp = os.path.join(work, "resume")
    jt = JTrainer(_args(tmp, "pge"))
    params, state, _ = jt._step(jt.params, jt.opt_state,
                                jax.random.PRNGKey(8),
                                jnp.asarray(_imgs(5)), jnp.float32(LR))
    j_save_checkpoint(os.path.join(tmp, "t_pge_last_model.ckpt"),
                      jax.device_get(params), jax.device_get(state), 3)
    port = PGEstTrainer(_args(tmp, "pge", last_epoch=-1, stop_epoch=4),
                        device="cpu", field="jax")
    assert port.epoch == 3
    st = port.optimizer.state
    mu, nu, count = _moments(to_state_dict(_np_tree(state)))
    for n, p in port.model.named_parameters():
        assert int(st[p]["step"]) == count == 1
        np.testing.assert_array_equal(st[p]["exp_avg"].numpy(),
                                      mu[n].numpy())
        np.testing.assert_array_equal(st[p]["exp_avg_sq"].numpy(),
                                      nu[n].numpy())
    batch, key = _imgs(6), jax.random.PRNGKey(9)
    p2, s2, loss = jt._step(params, state, key, jnp.asarray(batch),
                            jnp.float32(LR))
    t_loss = float(port.train_step(batch, np.asarray(key), LR))
    assert abs(t_loss - float(loss)) <= 1e-5 * abs(float(loss))
    assert {int(s["step"]) for s in st.values()} == {2}
    want = params_to_state_dict(_np_tree(p2))
    for n, p in port.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   rtol=0, atol=2 * LR)


def test_train_est_cli(work):
    """`train_est <runfile> 1 --cpu` on a tiny runfile writes the
    checkpoint at its save_freq, which the JAX package reads."""
    tmp = os.path.join(work, "cli")
    os.makedirs(tmp)
    runfile = os.path.join(tmp, "est_tiny.yml")
    with open(runfile, "w") as f:
        f.write(f"""mode: 'train'
fast_ckpt: '{tmp}'
model_name: 'EstTiny'
dst_train:
  patch_size: 64
  synthetic_len: 4
arch:
  name: 'est_UNet'
  in_nc: 4
  out_nc: 2
  nf: 4
  depth: 2
hyper:
  lr_scheduler: 'WarmupCosine'
  learning_rate: 1.e-3
  batch_size: 2
  last_epoch: 0
  step_size: 1
  stop_epoch: 5
  T: 1
  coldstart: False
  save_freq: 1
""")
    loss = train_est.main([runfile, "1", "--cpu"])
    assert np.isfinite(loss)
    state = j_load_checkpoint(os.path.join(tmp, "EstTiny_last_model.ckpt"))
    assert state["epoch"] == 1
    assert int(state["opt_state"]["inner_state"]["0"]["count"]) == 2


# -------------------------------------------------------------- PGE eval
def _jax_eval_pge(params, n_crops, size, batch_size, cache):
    """The JAX package's counterpart of yondx_torch's eval_pge."""
    ds = j_datasets.SyntheticSRGBDataset(length=n_crops, size=size,
                                         seed=2024, disk_cache=cache)
    model = j_build(PGE_ARCH)

    @jax.jit
    def loss(key, batch):
        x = batch.astype(jnp.float32) / 255.0
        lr, _, meta = j_batch(key, x)
        pred = model.apply(params, jnp.clip(lr, 0.0, 1.0)).reshape(
            lr.shape[0], -1)
        target = jnp.stack([meta["beta1"], jnp.sqrt(meta["beta2"])], -1)
        return jnp.mean(jnp.abs(jnp.log(pred + 1e-6)
                                - jnp.log(target + 1e-6)))

    key = jax.random.PRNGKey(2024)
    out = []
    for s in range(0, n_crops - batch_size + 1, batch_size):
        key, sub = jax.random.split(key)
        out.append(float(loss(sub, jnp.asarray(np.stack(
            [ds[i] for i in range(s, s + batch_size)])))))
    return float(np.mean(out))


@pytest.fixture(scope="module")
def est_params():
    return j_load_checkpoint(EST_CKPT)["params"]


def test_eval_pge_matches_jax(work, est_params):
    net = build_model(PGE_ARCH)
    net.load_state_dict(params_to_state_dict(t_read(EST_CKPT)["params"]))
    got = eval_pge(net, pge_eval_batches("cpu", n_crops=4, size=64,
                                         batch_size=2))
    want = _jax_eval_pge(est_params, 4, 64, 2, os.path.join(work, "ev"))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_eval_pge_anchor_of_chip_smoke(work, est_params):
    """chip_smoke.py phase 11e holds the card's value for the committed
    estimator to EST_EVAL_JAX: the JAX package's CPU value on the full
    eval set (64 crops of 256 px, batches of 16)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want = _jax_eval_pge(est_params, 64, 256, 16, os.path.join(work, "ev"))
    assert abs(smoke.EST_EVAL_JAX - want) <= 1e-5, want

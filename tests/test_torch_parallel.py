"""The port's row-sharded frame route (yondx_torch.parallel) against the
JAX package's on the CPU.

The port runs in spawned gloo groups, one per world size (2 and 4 ranks,
each serving every case of its size through `parallel.mesh.run_calls`);
the JAX side on the 8-device CPU mesh of tests/conftest.py, over its
first 2 or 4 devices, each sharded function under one jax.jit (outside a
jit a shard_map runs op by op: ~22 s a call here; the module fixture
`_jax_sharded_jitted` gives the JAX product route the jitted functions
too). Small frames. Tolerances:
- the halo exchange: exact (it moves rows); `sharded_box_stats` at n = 2
  and 4: 1e-5 absolute, as tests/test_parallel.py holds JAX's to the
  whole frame;
- the sharded self and collab NLE fits, the MAD estimates and the robust
  combinations at n = 2 against JAX's sharded ones: 1e-4 relative (+1e-9;
  the same histogram algorithm, moments in another float order); the
  fits also against the port's whole-frame estimates within JAX's own
  bounds (tests/test_parallel.py: fit and robust 1% + 1e-7, MAD 1e-3 +
  1e-9);
- `spatial_denoise_sharded_pair` with a GuidedResUnet nf 8 (numpy-drawn
  weights, 'pre' bias, refine with the local floor): both outputs within
  1e-4 of JAX's;
- `iter_denoise_frame_sharded` with the 3x3 box blur under the 'rescue'
  and 'avg' policies: regs 1e-4 relative, every round's output 1e-4;
- `FullFrameHarness(mesh=)` (the eval mode of the full-frame datasets) on
  that frame with its clean GT: PSNR within 1e-3 dB and SSIM within 1e-5
  of JAX's harness on its mesh, the metrics pickle written once;
- `yond --input --mesh 2 --device cpu` on the 252x384 frame against JAX's
  `--mesh 2 --cpu`: 2e-4 (the single-card CLI test's bound);
- `--mesh 4` on CUDA with fewer than 4 cards raises ValueError.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from yondx.cli import yond as j_yond
from yondx.models import build_model as j_build_model
from yondx.eval import fullframe as j_fullframe
from yondx.parallel import make_mesh as j_make_mesh
from yondx.parallel import shard_batch as j_shard
from yondx.parallel import product as j_product
from yondx.parallel import spatial as j_spatial
from yondx.parallel.product import iter_denoise_frame_sharded as j_iter
from yondx.pipeline import PipelineConfig as JPipe
from yondx.pipeline import VSTDenoiser as JDenoiser
from yondx.pipeline import YONDEngine as JEngine
from yondx.train.ckpt import save_checkpoint
from yondx.vst.lut import BiasLUT as JBiasLUT

from yondx_torch.cli import yond as t_yond
from yondx_torch.eval.fullframe import denoise_any
from yondx_torch.models.unets import load_model
from yondx_torch.nle import nlf as t_nlf
from yondx_torch.nle import robust as t_robust
from yondx_torch.parallel import spawn
from yondx_torch.parallel import spatial as t_spatial
from yondx_torch.parallel.mesh import make_mesh, run_calls
from yondx_torch.parallel.product import iter_denoise_frame_sharded
from yondx_torch.pipeline.denoiser import VSTDenoiser
from yondx_torch.pipeline.engine import PipelineConfig, YONDEngine
from test_product_50mp import P0, _BlurModel
from test_torch_cli import NF8, RUNFILE
from torch_test_util import (BoxBlur3, _one_torch_thread,  # noqa: F401
                             run_fullframe)

K, SIGMA, SCALE = 8.74, 12.81, 959.0


# -------------------------------------------------------------- inputs
def _box_frame():
    return np.random.default_rng(0).random((128, 64, 4)).astype(np.float32)


def _nle_pair():
    """tests/test_parallel.py's collab frame: 8x4 flat levels of 64x32
    RGGB pixels with PG noise, and a proxy keeping 10% of the noise."""
    rng = np.random.default_rng(9)
    levels = rng.random((8, 4)) * 0.7 + 0.05
    clean = np.kron(levels, np.ones((64, 32)))[..., None].repeat(4, -1)
    noisy = np.clip(clean + rng.normal(0, np.sqrt(3e-3 * clean + 8e-5),
                                       clean.shape), 0, 1).astype(np.float32)
    dn = np.clip(clean + 0.1 * (noisy - clean), 0, 1).astype(np.float32)
    return noisy, dn


def _product_frame(clean_too=False):
    """A 256x256 Bayer frame of 4x4 flat levels with shot noise (K 24,
    sigma 6 DN at scale 959), so the collab round keeps a positive
    slope (tests/test_product_50mp.py's rescue scene, smaller)."""
    rng = np.random.default_rng(11)
    clean = np.kron(rng.random((4, 4)) * 0.6 + 0.2, np.ones((64, 64)))
    noisy = (24.0 * rng.poisson(clean * SCALE / 24.0)
             + rng.normal(0, 6.0, clean.shape)) / SCALE
    noisy = np.clip(noisy, 0, 1).astype(np.float32)
    return (noisy, clean.astype(np.float32)) if clean_too else noisy


def _frames():
    """A one-frame full-frame dataset with its GT (the harness's items)."""
    noisy, clean = _product_frame(clean_too=True)
    return [{"name": "f0", "lr": noisy, "hr": clean, "wp": 1023, "bl": 64,
             "ratio": 1.0}]


def _pair_frame():
    rng = np.random.default_rng(5)
    clean = np.kron(rng.random((4, 2)) * 0.6 + 0.2, np.ones((48, 32)))
    noisy = (K * rng.poisson(clean[..., None] * SCALE / K, (192, 64, 4))
             + rng.normal(0, SIGMA, (192, 64, 4))) / SCALE
    return np.clip(noisy, 0, 1).astype(np.float32)


PAIR_KW = dict(halo=16, bias_corr="pre", sigma_corr=1.03, guided=True,
               refine=True, refine_floor="local")
POLICIES = ("rescue", "avg")


def _t_engine(policy):
    den = VSTDenoiser(BoxBlur3(), guided=False, bias_corr=None,
                      vst_type="asym", device="cpu")
    return YONDEngine(den, PipelineConfig(
        est_type="simple", bias_corr=None, max_iter=1,
        extras={"iter_policy": policy}))


def _j_engine(policy):
    den = JDenoiser(_BlurModel(), None, guided=False, bias_corr=None,
                    vst_type="asym")
    return JEngine(den, JPipe(est_type="simple", bias_corr=None, max_iter=1,
                              extras={"iter_policy": policy}))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """An nf=8 GuidedResUnet's numpy-drawn weights saved by the JAX
    package, a runfile naming them and a 252x384 noisy frame."""
    root = tmp_path_factory.mktemp("par")
    model = j_build_model(dict(NF8))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 4)), jnp.full((1,), 0.1))
    rng = np.random.default_rng(4)

    def draw(path, leaf):
        fan_in = int(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 1
        std = np.sqrt(1.0 / fan_in) if path[-1].key == "kernel" else 1e-2
        return (rng.standard_normal(leaf.shape) * std).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    ckpt = root / "ckpt" / "tiny_GRU_best_model.ckpt"
    save_checkpoint(str(ckpt), params)
    runfile = root / "tiny.yml"
    runfile.write_text(RUNFILE.format(ckpt=root / "ckpt"))
    rng = np.random.default_rng(8)
    clean = np.kron(rng.random((6, 8)) * 0.7 + 0.05,
                    np.ones((256 // 6, 384 // 8)))
    noisy = (8.74 * rng.poisson(clean * 959.0 / 8.74)
             + rng.normal(0, 12.81, clean.shape)) / 959.0
    frame = root / "frame.npy"
    np.save(frame, np.clip(noisy, 0, 1).astype(np.float32))
    (root / "jax").mkdir()
    return {"root": root, "model": model, "params": params, "ckpt": ckpt,
            "runfile": runfile, "frame": frame}


# ------------------------------------------------ JAX's sharded functions
@functools.lru_cache(maxsize=None)
def _j_fit(name, mesh, k):
    """A jitted JAX sharded NLE function of (frame[, proxy])."""
    fn = getattr(j_spatial, name)
    kw = {} if "mad" in name else {"k": k}
    return jax.jit(lambda *a: fn(mesh, *a, **kw))


@functools.lru_cache(maxsize=None)
def _j_collab_robust(mesh, k):
    return jax.jit(lambda x, d, r1, r2: j_spatial.sharded_collab_nlf_robust(
        mesh, x, d, k=k, self_reg=(r1, r2)))


@functools.lru_cache(maxsize=None)
def _j_pair(mesh, apply_fn, kw):
    return jax.jit(lambda params, x, curve, K_, s_, sc, corr:
                   j_spatial.spatial_denoise_sharded_pair(
                       mesh, apply_fn, params, x, curve, K_, s_, sc,
                       sigma_corr=corr, **dict(kw)))


def _jit_self_robust(mesh, x, k=29, axis="data"):
    return _j_fit("sharded_self_nlf_robust", mesh, k)(x)


def _jit_collab_robust(mesh, x, d, k=29, axis="data", self_reg=None):
    return _j_collab_robust(mesh, k)(x, d, *self_reg)


def _jit_pair(mesh, apply_fn, params, x, curve, K_, s_, sc,
              sigma_corr=1.03, **kw):
    return _j_pair(mesh, apply_fn, tuple(sorted(kw.items())))(
        params, x, jnp.asarray(curve, jnp.float32), jnp.float32(K_),
        jnp.float32(s_), jnp.float32(sc), jnp.float32(sigma_corr))


@pytest.fixture(autouse=True, scope="module")
def _jax_sharded_jitted():
    """JAX's product route calls its sharded functions jitted (the same
    functions; outside a jit they run op by op)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_product, "sharded_self_nlf_robust", _jit_self_robust)
        mp.setattr(j_product, "sharded_collab_nlf_robust",
                   _jit_collab_robust)
        mp.setattr(j_product, "spatial_denoise_sharded_pair", _jit_pair)
        yield


def _curve():
    return np.asarray(JBiasLUT().curve(K, SIGMA), np.float32)


def _cli_args(tiny):
    return ["-f", str(tiny["runfile"]), "--input", str(tiny["frame"]),
            "--mesh", "2"]


# --------------------------------------------------------- port groups
@pytest.fixture(scope="module")
def world2(tiny):
    """Every n = 2 case on one spawned gloo group of the port: {name:
    rank 0's result}, and rank 1's results beside."""
    on_rows = t_spatial.on_rows
    noisy, dn = _nle_pair()
    bayer = _product_frame()
    net = load_model(NF8, str(tiny["ckpt"]), device="cpu")
    cases = {
        "halo": (on_rows, (t_spatial._halo_exchange_rows, (_box_frame(),),
                           8), {}),
        "box": (on_rows, (t_spatial.sharded_box_stats, (_box_frame(),)),
                {"k": 29}),
        "self": (on_rows, (t_spatial.sharded_self_nlf, (noisy,)), {}),
        "mad_self": (on_rows, (t_spatial.sharded_mad_self_estimate,
                               (noisy,)), {}),
        "self_robust": (on_rows, (t_spatial.sharded_self_nlf_robust,
                                  (noisy,)), {}),
        "collab": (on_rows, (t_spatial.sharded_collab_nlf, (noisy, dn)), {}),
        "mad_collab": (on_rows, (t_spatial.sharded_mad_collab_estimate,
                                 (noisy, dn)), {}),
        "collab_robust": (on_rows, (t_spatial.sharded_collab_nlf_robust,
                                    (noisy, dn)), {"self_reg": (3e-3, 8e-5)}),
        "pair": (on_rows, (t_spatial.spatial_denoise_sharded_pair,
                           (_pair_frame(),), _curve(), K, SIGMA, SCALE),
                 dict(PAIR_KW, lead=(net,))),
        **{f"product_{pol}": (iter_denoise_frame_sharded,
                              (_t_engine(pol), bayer, dict(P0)),
                              {"halo": 16}) for pol in POLICIES},
        "harness": (run_fullframe, (_t_engine("rescue"), _frames(), "m"),
                    {}),
        "cli": (t_yond._rank_main,
                (_cli_args(tiny) + ["--output", str(tiny["root"] / "t.npy"),
                                    "--device", "cpu"],), {}),
    }
    old = os.getcwd()
    os.chdir(tiny["root"])
    try:
        res = spawn(2, run_calls, list(cases.values()), device="cpu")
    finally:
        os.chdir(old)
    return ({name: r for name, r in zip(cases, res[0])},
            {name: r for name, r in zip(cases, res[1])})


@pytest.fixture(scope="module")
def world4():
    on_rows = t_spatial.on_rows
    cases = {"halo": (on_rows, (t_spatial._halo_exchange_rows,
                                (_box_frame(),), 8), {}),
             "box": (on_rows, (t_spatial.sharded_box_stats, (_box_frame(),)),
                     {"k": 29})}
    res = spawn(4, run_calls, list(cases.values()), device="cpu")
    return {name: r for name, r in zip(cases, res[0])}


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _close(got, want, rtol, atol=1e-9):
    for g, w in zip(got, want):
        g, w = float(g), float(w)
        assert abs(g - w) <= rtol * abs(w) + atol, (got, want)


# ---------------------------------------------------------------- tests
@pytest.mark.parametrize("n", [2, 4])
def test_halo_exchange_and_box_stats_match_jax(n, world2, world4):
    got = world2[0] if n == 2 else world4
    x = _box_frame()
    mesh = j_make_mesh(n)
    xs = j_shard(mesh, x)
    halo = jax.jit(jax.shard_map(
        lambda v: j_spatial._halo_exchange_rows(v, 8, "data"), mesh=mesh,
        in_specs=P("data"), out_specs=P("data")))(xs)
    np.testing.assert_array_equal(_np(got["halo"]), np.asarray(halo))
    want = _j_fit("sharded_box_stats", mesh, 29)(xs)
    for g, w in zip(got["box"], want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-5, rtol=0)


def test_sharded_nle_matches_jax_and_the_whole_frame(world2):
    got = world2[0]
    noisy, dn = _nle_pair()
    mesh = j_make_mesh(2)
    xs, ds = j_shard(mesh, noisy), j_shard(mesh, dn)
    fns = {"self": "sharded_self_nlf",
           "mad_self": "sharded_mad_self_estimate",
           "self_robust": "sharded_self_nlf_robust",
           "collab": "sharded_collab_nlf",
           "mad_collab": "sharded_mad_collab_estimate"}
    want = {name: _j_fit(fn, mesh, 29)(*((xs,) if "self" in name
                                         else (xs, ds)))
            for name, fn in fns.items()}
    want["collab_robust"] = _jit_collab_robust(mesh, xs, ds,
                                               self_reg=(3e-3, 8e-5))
    for name, w in want.items():
        _close(got[name], w, 1e-4)
        # every rank holds the same frame-wide scalars
        assert [float(v) for v in got[name]] == \
            [float(v) for v in world2[1][name]], name
    x, d = torch.from_numpy(noisy), torch.from_numpy(dn)
    whole = {"self": (t_nlf.self_nlf(x), 1e-2, 1e-7),
             "mad_self": (t_robust.mad_self_estimate(x), 1e-3, 1e-9),
             "self_robust": (t_robust.self_nlf_robust(x), 1e-2, 1e-7),
             "collab": (t_nlf.collab_nlf(x, d), 1e-2, 1e-7),
             "mad_collab": (t_robust.mad_collab_estimate(x, d), 1e-3, 1e-9),
             "collab_robust": (t_robust.collab_nlf_robust(x, d), 1e-2,
                               1e-7)}
    for name, (w, rtol, atol) in whole.items():
        _close(got[name], w, rtol, atol)


def test_spatial_denoise_pair_matches_jax(world2, tiny):
    mesh = j_make_mesh(2)
    kw = dict(PAIR_KW)
    want = _jit_pair(mesh, tiny["model"].apply, tiny["params"],
                     j_shard(mesh, _pair_frame()), _curve(), K, SIGMA, SCALE,
                     sigma_corr=kw.pop("sigma_corr"), **kw)
    got = world2[0]["pair"]
    for g, w in zip(got, want):
        assert g.shape == w.shape == (192, 64, 4)
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-4, rtol=0)
    # the refine moved the output off the raw net output
    assert float((got[0] - got[1]).abs().max()) > 1e-3


@pytest.mark.parametrize("policy", POLICIES)
def test_product_route_matches_jax(policy, world2):
    bayer = _product_frame()
    want = j_iter(j_make_mesh(2), _j_engine(policy), bayer, dict(P0),
                  halo=16)
    got, other = world2[0][f"product_{policy}"], world2[1][f"product_{policy}"]
    assert len(got["regs"]) == len(want["regs"]) == 2
    for g, w in zip(got["regs"], want["regs"]):
        _close(g, w, 1e-4)
    assert len(got["raw_dns"]) == len(want["raw_dns"])
    for g, w, o in zip(got["raw_dns"], want["raw_dns"], other["raw_dns"]):
        assert g.shape == w.shape == bayer.shape
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=0)
        np.testing.assert_array_equal(g, o)     # every rank returns it


def test_fullframe_harness_on_a_mesh_matches_jax(world2, tiny, monkeypatch):
    monkeypatch.chdir(tiny["root"] / "jax")
    want = j_fullframe.FullFrameHarness(_j_engine("rescue"), _frames(), "m",
                                        mesh=j_make_mesh(2)).run()
    got = world2[0]["harness"]
    assert abs(got["psnr"] - want["psnr"]) <= 1e-3
    assert abs(got["ssim"] - want["ssim"]) <= 1e-5
    assert world2[1]["harness"] == got
    assert (tiny["root"] / "metrics" / "m_metrics.pkl").exists()


def test_cli_mesh_matches_jax(world2, tiny, monkeypatch):
    """JAX's params template is zeros of the traced shapes (the checkpoint
    fills it), as in tests/test_torch_cli.py."""
    monkeypatch.chdir(tiny["root"])

    def zeros_template(model, rng, input_shape, guided=None):
        shapes = jax.eval_shape(model.init, rng, jnp.zeros(input_shape),
                                jnp.full((input_shape[0],), 0.1))
        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    monkeypatch.setattr(j_yond, "init_params", zeros_template)
    j_yond.main(_cli_args(tiny) + ["--output", "j.npy", "--cpu"])
    ref = np.load(tiny["root"] / "j.npy")
    got = np.load(tiny["root"] / "t.npy")
    assert got.shape == ref.shape == (252, 384)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)
    # rank 0 wrote the log; the .npy is one file
    assert (tiny["root"] / "logs" / "log_tiny_ANY.log").exists()


def test_mesh_needs_a_card_a_rank(tiny):
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have >= 4:
        pytest.skip("this machine has 4 cards")
    with pytest.raises(ValueError, match=f"needs 4 cards.*has {have}"):
        t_yond.main(["-f", str(tiny["runfile"]), "--input",
                     str(tiny["frame"]), "--mesh", "4"])
    with pytest.raises(ValueError, match=f"needs 4 cards.*has {have}"):
        spawn(4, run_calls, [], device="cuda")
    with pytest.raises(TypeError, match="Mesh"):
        denoise_any(None, str(tiny["frame"]), mesh=j_make_mesh(2))
    # a group of one needs no spawn; a mesh of 4 in it is refused
    with pytest.raises(ValueError, match="4 processes"):
        make_mesh(4, device="cpu")

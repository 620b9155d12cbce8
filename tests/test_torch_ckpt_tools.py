"""The port's checkpoint recipe tools (yondx_torch/cli/{ship_weights,
fork_checkpoint,port_s2d_init,port_s2d_tail,port_reference_checkpoint,
compare_ckpts}.py) against the JAX scripts of the same names, loaded from
scripts/, on the CPU, on copies of the committed checkpoints in tmp_path.

Every file a tool writes loads in JAX's load_checkpoint and in the
port's, with every leaf bit-equal to what the JAX script writes from the
same input (the fresh stages of port_s2d_init and the tail's too: the
port's flax_init_params is flax's eager init bit for bit); the tail's
output is bit-identical to its source net's; fork_checkpoint refuses to
clobber; ship_weights with no arguments writes nothing. compare_ckpts on
one flat scene of one crop: each scene's PSNR within 0.01 dB of the JAX
script's (the two packages' NLE fits agree to about 1e-4 relative).
Where a JAX script builds a flax init only as load_checkpoint's template
(every leaf is then the file's: its PRNGKey(0) inits), its abstract
shapes stand in for it and skip ~22 s of eager init on the CPU.
"""
import contextlib
import importlib.util
import io
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from yondx.models import registry as j_registry
from yondx.train.ckpt import load_checkpoint as j_load

from yondx_torch.cli import (compare_ckpts, fork_checkpoint,
                             probe_sigma_corr_blind, port_s2d_init,
                             port_s2d_tail, port_reference_checkpoint,
                             ship_weights, sweep_policy)
from yondx_torch.models.convert import params_to_state_dict
from yondx_torch.models.registry import build_model
from yondx_torch.models.torch_port import guidedresunet_to_torch
from yondx_torch.models.unets import GRU32_ARCH, S2D64_ARCH, S2DT16_ARCH
from yondx_torch.io.ckpt import load_checkpoint as read_params
from yondx_torch.train.ckpt import load_checkpoint as t_load
from yondx_torch.train.s2d_port import S2D_PORT_MAP
from torch_test_util import _one_torch_thread  # noqa: F401

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CKPTS = os.path.join(REPO, "checkpoints", "Gaussian")
GRU32 = "Gaussian_GRU_mix_1to50c_norm"
S2D3 = "Gaussian_GRUS2D3_mix_1to50c_norm"
EST = "EstPGE_d3nf16"


def _run_script(name, argv, monkeypatch):
    """Run scripts/<name>.py's main() with argv, JAX on the CPU."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    mod.main()


def _abstract_template(monkeypatch, only_key0=False):
    """The JAX scripts' inits that only template load_checkpoint become
    abstract; with only_key0, just those from PRNGKey(0) (the scripts'
    fresh stages come from PRNGKey(1) and stay real)."""
    real = j_registry.init_params

    def init(model, rng, *a, **k):
        if only_key0 and np.asarray(jax.random.key_data(rng)).any():
            return real(model, rng, *a, **k)
        return jax.eval_shape(lambda: real(model, rng, *a, **k))

    monkeypatch.setattr(j_registry, "init_params", init)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_same_file(got_path, want_path):
    """Both files, read by JAX's reader and by the port's, hold the same
    params (bit for bit), epoch, best_psnr and opt_state."""
    want = j_load(want_path)
    for got in (j_load(got_path), t_load(got_path)):
        g, w = _flat(got["params"]), _flat(want["params"])
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert got["epoch"] == want["epoch"]
        assert got["best_psnr"] == want["best_psnr"]
        assert bool(got["opt_state"]) == bool(want["opt_state"])
    return want


def _copy(names, dst):
    dst = str(dst)
    os.makedirs(dst, exist_ok=True)
    for n in names:
        shutil.copy(os.path.join(CKPTS, n), os.path.join(dst, n))
    return dst


def test_ship_weights_matches_jax(tmp_path, monkeypatch):
    src = _copy([f"{EST}_last_model.ckpt"], tmp_path)
    src = os.path.join(src, f"{EST}_last_model.ckpt")
    assert t_load(src)["opt_state"]
    _run_script("ship_weights", [src, str(tmp_path / "jax.ckpt")],
                monkeypatch)
    rec = ship_weights.main([src, str(tmp_path / "port.ckpt")])
    want = _assert_same_file(str(tmp_path / "port.ckpt"),
                             str(tmp_path / "jax.ckpt"))
    assert want["opt_state"] == {} and want["epoch"] == 80
    assert (tmp_path / "port.ckpt").read_bytes() == \
        (tmp_path / "jax.ckpt").read_bytes()
    assert rec[0]["bytes_dst"] < rec[0]["bytes_src"]
    # an existing destination is refused, and no arguments ship nothing
    with pytest.raises(FileExistsError):
        ship_weights.main([src, str(tmp_path / "port.ckpt")])
    before = sorted(os.listdir(tmp_path))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert ship_weights.main([]) == []
    assert "usage" in buf.getvalue()
    assert sorted(os.listdir(tmp_path)) == before
    with pytest.raises(SystemExit):
        ship_weights.main([src])


@pytest.mark.parametrize("last", [False, True], ids=["best", "last"])
def test_fork_checkpoint_matches_jax(tmp_path, monkeypatch, last):
    d = _copy([f"{GRU32}_best_model.ckpt"], tmp_path)
    flag = ["--last"] if last else []
    _run_script("fork_checkpoint", [GRU32, "ForkJ", "--ckpt-dir", d, *flag],
                monkeypatch)
    dst = fork_checkpoint.main([GRU32, "ForkT", "--ckpt-dir", d, *flag])
    assert dst == os.path.join(d, "ForkT_last_model.ckpt")
    want = _assert_same_file(dst, os.path.join(d, "ForkJ_last_model.ckpt"))
    assert (want["epoch"], want["best_psnr"], want["opt_state"]) == (0, 0.0,
                                                                     {})
    src = _flat(t_load(os.path.join(d, f"{GRU32}_best_model.ckpt"))["params"])
    got = _flat(t_load(dst)["params"])
    assert all(np.array_equal(got[k], src[k]) for k in src)
    with pytest.raises(FileExistsError):
        fork_checkpoint.main([GRU32, "ForkT", "--ckpt-dir", d, *flag])


def test_port_s2d_init_matches_jax(tmp_path, monkeypatch):
    d = _copy([f"{GRU32}_best_model.ckpt"], tmp_path)
    _abstract_template(monkeypatch, only_key0=True)
    _run_script("port_s2d_init", ["--ckpt-dir", d, "--dst", "S2DJ"],
                monkeypatch)
    rec = port_s2d_init.main(["--ckpt-dir", d, "--dst", "S2DT", "--cpu"])
    _assert_same_file(rec["out"], os.path.join(d, "S2DJ_last_model.ckpt"))
    assert rec["fresh"] == ["conv_in", "conv_out"]
    flag = params_to_state_dict(t_load(os.path.join(
        d, f"{GRU32}_best_model.ckpt"))["params"])
    got = params_to_state_dict(t_load(rec["out"])["params"])
    for k, v in got.items():
        if k.split(".")[0] in rec["ported"]:
            twin = S2D_PORT_MAP[k.split(".")[0]]
            assert torch.equal(v, flag["unet." + twin + k[k.index("."):]])
    with pytest.raises(FileExistsError):
        port_s2d_init.main(["--ckpt-dir", d, "--dst", "S2DT", "--cpu"])


def test_port_s2d_tail_matches_jax(tmp_path, monkeypatch):
    d = _copy([f"{S2D3}_last_model.ckpt"], tmp_path / "checkpoints" /
              "Gaussian")
    monkeypatch.chdir(tmp_path)       # the JAX script's paths are relative
    _abstract_template(monkeypatch, only_key0=True)
    _run_script("port_s2d_tail", ["--dst", "TailJ"], monkeypatch)
    rec = port_s2d_tail.main(["--ckpt-dir", d, "--dst", "TailT", "--cpu"])
    want = _assert_same_file(rec["out"], os.path.join(
        d, "TailJ_last_model.ckpt"))
    tail = _flat(want["params"])
    assert not tail["params/tail_2/kernel"].any()
    assert rec["tail_params"] == sum(v.size for k, v in tail.items()
                                     if k.startswith("params/tail_"))
    # the extended net's output equals the source's, on another input
    src, ext = build_model(S2D64_ARCH), build_model(S2DT16_ARCH)
    src.load_state_dict(params_to_state_dict(t_load(os.path.join(
        d, f"{S2D3}_last_model.ckpt"))["params"]))
    ext.load_state_dict(params_to_state_dict(t_load(rec["out"])["params"]))
    x = np.random.default_rng(5).random((2, 64, 96, 4))
    port_s2d_tail.identity_check(src.eval(), ext.eval(), "cpu", x)
    with pytest.raises(FileExistsError):
        port_s2d_tail.main(["--ckpt-dir", d, "--dst", "TailT", "--cpu"])


def test_port_reference_checkpoint_matches_jax(tmp_path, monkeypatch):
    params = t_load(os.path.join(CKPTS, f"{GRU32}_best_model.ckpt"))["params"]
    pth = tmp_path / "ref.pth"
    torch.save({k: torch.from_numpy(np.array(v))
                for k, v in guidedresunet_to_torch(params).items()}, pth)
    _abstract_template(monkeypatch)
    _run_script("port_reference_checkpoint",
                ["--pth", str(pth), "--out", str(tmp_path / "jax.ckpt")],
                monkeypatch)
    rec = port_reference_checkpoint.main(
        ["--pth", str(pth), "--out", str(tmp_path / "port.ckpt")])
    want = _assert_same_file(rec["out"], str(tmp_path / "jax.ckpt"))
    assert rec["params"] == sum(v.size for v in _flat(params).values())
    # .ckpt -> .pth -> .ckpt gives the committed weights back
    src = _flat(params)
    assert all(np.array_equal(_flat(want["params"])[k], src[k]) for k in src)
    with pytest.raises(FileExistsError):
        port_reference_checkpoint.main(
            ["--pth", str(pth), "--out", str(tmp_path / "port.ckpt")])


def test_compare_ckpts_matches_jax(tmp_path, monkeypatch):
    """scripts/compare_ckpts.py runs at import: its source, with the gate
    cut to one scene of one crop, runs in a namespace of its own."""
    path = os.path.join(CKPTS, f"{GRU32}_best_model.ckpt")
    src = open(os.path.join(REPO, "scripts", "compare_ckpts.py")).read()
    cuts = (('for i in range(8)]', 'for i in range(1)]'),
            ('content="flat")', 'content="flat", n_crops=1)'),
            ('jax.config.update("jax_compilation_cache_dir", '
             '"/tmp/yondx_xla_cache")', 'pass'))
    for old, new in cuts:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    _abstract_template(monkeypatch)
    monkeypatch.setattr(sys, "argv", ["compare_ckpts.py", path])
    ns = {"__file__": os.path.join(REPO, "scripts", "compare_ckpts.py"),
          "__name__": "_jax_compare_ckpts"}
    exec(compile(src, "compare_ckpts.py", "exec"), ns)
    got = compare_ckpts.compare(
        path, [compare_ckpts.make_scene(0, n_crops=1, content="flat")],
        "cpu")
    assert got["arch"] == "GuidedResUnet"
    np.testing.assert_allclose(got["psnrs"], ns["vals"], atol=0.01, rtol=0)
    assert abs(got["noisy"] - ns["noisy_p"]) < 1e-4
    assert got["mean"] > got["noisy"] + 5.0


@pytest.mark.parametrize("name,arch", [
    (f"{GRU32}_best_model.ckpt", GRU32_ARCH),
    (f"{S2D3}_last_model.ckpt", S2D64_ARCH),
    ("Gaussian_GRUS2DT_mix_1to50c_norm_best_model.ckpt", S2DT16_ARCH)])
def test_compare_ckpts_reads_the_arch_off_the_file(name, arch):
    params = read_params(os.path.join(CKPTS, name))["params"]
    assert compare_ckpts.arch_of(params) == arch


@pytest.mark.parametrize("tool,argv", [
    (sweep_policy, []), (probe_sigma_corr_blind, []), (port_s2d_init, []),
    (port_s2d_tail, []), (compare_ckpts, ["x.ckpt"])],
    ids=["sweep_policy", "probe_sigma_corr_blind", "port_s2d_init",
         "port_s2d_tail", "compare_ckpts"])
def test_device_tools_default_to_the_card(tool, argv, tmp_path,
                                          monkeypatch):
    """The tools that run a net default to "cuda" and raise where there is
    none (no quiet CPU run), before they write anything; ship_weights,
    fork_checkpoint and port_reference_checkpoint do host work only."""
    assert not torch.cuda.is_available()
    monkeypatch.chdir(REPO)
    argv = argv + (["--out", str(tmp_path / "out.json")]
                   if tool in (sweep_policy, probe_sigma_corr_blind) else [])
    if tool in (port_s2d_init, port_s2d_tail):
        argv += ["--ckpt-dir", str(_copy([], tmp_path))]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)
    assert not os.listdir(tmp_path)

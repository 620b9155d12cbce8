"""The port's runfile reader, CLI, frame loader and bench against the JAX
package's (CPU).

- The reader equals `yaml.load(..., FullLoader)` plus `load_runfile`'s
  normalisations on every runfile of the repo, and raises outside its
  YAML subset.
- `yondx.cli.yond.main([..., "--cpu"])` and the port's CLI on the
  CPU denoise the same .npy with a tiny nf=8 GuidedResUnet runfile
  whose checkpoint is written with the JAX package's save_checkpoint:
  outputs agree to atol 2e-4.
- The bench's flags and JSON keys are bench.py's.
"""
import ast
import glob
import importlib.util
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch
import yaml

from yondx.config import load_runfile as j_load_runfile
from yondx.core.io import dataload as j_dataload
from yondx.models import build_model as j_build_model
from yondx.train.ckpt import save_checkpoint

from yondx_torch import bench
from yondx_torch.cli import yond as t_yond
from yondx_torch.config import load_runfile
from yondx_torch.config.yaml_subset import YAMLSubsetError, load
from yondx_torch.core.io import dataload
from yondx_torch.eval.fullframe import denoise_any
from torch_test_util import _one_torch_thread  # noqa: F401

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
RUNFILES = sorted(glob.glob(os.path.join(REPO, "runfiles", "**", "*.yml"),
                            recursive=True))


def _same(a, b):
    """Equal values and types, with dict order and NaN handled."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


# ---------------------------------------------------------------- runfiles
@pytest.mark.parametrize("path", RUNFILES,
                         ids=[os.path.basename(p) for p in RUNFILES])
def test_runfile_reader_matches_yaml_and_jax(path):
    with open(path, encoding="utf-8") as f:
        text = f.read()
    assert _same(load(text), yaml.load(text, Loader=yaml.FullLoader))
    for kw in ({}, {"mode": "test", "host_prefix": "/data"}):
        assert _same(load_runfile(path, **kw), j_load_runfile(path, **kw))


def test_reader_matches_yaml_on_the_whole_subset():
    text = """\
# comment
a: &x
  b: 1
  c: [1, 2.5, 'x', "y\\n", yes, ~, 1.e-3, -.inf, +12_3, -0.5e+2]
d:
  <<: *x
  b: 2
e:
- 1
- [a, b,
   c]   # a flow list over two lines
- *x
f: 'it''s'
g: don't
h: 0.
i: 1e3
j:
k: [[1, 2], [], .nan]
l: "a # b"  # c
m:
  - Off
'q k': 3
1: one
r:
  <<: [*x]
"""
    assert _same(load(text), yaml.load(text, Loader=yaml.FullLoader))


@pytest.mark.parametrize("text", [
    "a: {b: 1}", "a: |\n  x", "a: >\n  x", "a: !!str 1", "---\na: 1",
    "%YAML 1.1\na: 1", "a: 0x1f", "a: 010", "a: 1:30", "a: b: c",
    "a:\n  - b: 1", "a: *nope", "a: [1, 2", "a: b\n  c", "\ta: 1",
    "a: 'open", "a: \"\\x41\"", "a: @b"])
def test_reader_raises_outside_its_subset(text):
    with pytest.raises(YAMLSubsetError):
        load(text)


# -------------------------------------------------------------- frames
def test_dataload_matches_jax(tmp_path):
    x = np.random.default_rng(0).random((6, 8)).astype(np.float32)
    raw = (np.arange(1440 * 2560) % 1024).astype(np.uint16)
    np.save(tmp_path / "f.npy", x)
    scipy.io.savemat(tmp_path / "f.mat", {"x": x})
    raw.tofile(tmp_path / "f.raw")
    for name in ("f.npy", "f.mat", "f.raw"):
        path = str(tmp_path / name)
        np.testing.assert_array_equal(dataload(path), j_dataload(path))
    with pytest.raises(ValueError):
        dataload(str(tmp_path / "f.xyz"))
    if importlib.util.find_spec("rawpy") is None:
        with pytest.raises(ImportError):
            dataload(str(tmp_path / "f.ARW"))


# ------------------------------------------------------------------ CLI
NF8 = {"name": "GuidedResUnet", "guided": True, "in_nc": 4, "out_nc": 4,
       "nf": 8, "nframes": 1, "res": True, "norm": True}
RUNFILE = """\
mode: 'eval'
fast_ckpt: '{ckpt}'
model_name: 'tiny_GRU'
method_name: 'tiny_ANY'
result_dir: 'images/'
pipeline:
  data_type: "ANY"
  full_est: True
  est_type: 'simple+full'
  k: 29
  full_dn: True
  vst_type: 'exact'
  bias_corr: 'pre'
  denoiser_type: 'gru32n'
  iter: 'iter'
  max_iter: 1
  clip: False
  sigma_corr: 'adaptive'
arch:
  name: 'GuidedResUnet'
  guided: True
  in_nc: 4
  out_nc: 4
  nf: 8
  nframes: 1
  res: True
  norm: True
"""


@pytest.fixture(scope="module")
def tiny_runfile(tmp_path_factory):
    """An ANY runfile of a random-init nf=8 GuidedResUnet whose params
    (numpy draws of the traced shapes) are saved by the JAX package."""
    root = tmp_path_factory.mktemp("cli")
    model = j_build_model(dict(NF8))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 4)), jnp.full((1,), 0.1))
    rng = np.random.default_rng(4)

    def draw(path, leaf):
        fan_in = int(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 1
        std = np.sqrt(1.0 / fan_in) if path[-1].key == "kernel" else 1e-2
        return (rng.standard_normal(leaf.shape) * std).astype(np.float32)

    save_checkpoint(str(root / "ckpt" / "tiny_GRU_best_model.ckpt"),
                    jax.tree_util.tree_map_with_path(draw, shapes))
    path = root / "tiny.yml"
    path.write_text(RUNFILE.format(ckpt=root / "ckpt"))
    rng = np.random.default_rng(8)
    levels = rng.random((6, 8)) * 0.7 + 0.05
    clean = np.kron(levels, np.ones((256 // 6, 384 // 8)))
    noisy = (8.74 * rng.poisson(clean * 959.0 / 8.74)
             + rng.normal(0, 12.81, clean.shape)) / 959.0
    frame = root / "frame.npy"
    np.save(frame, np.clip(noisy, 0, 1).astype(np.float32))
    return root, path, frame


def test_cli_matches_jax(tiny_runfile, monkeypatch):
    """Both CLIs denoise the same 252x384 frame, tiles of 128 (3x3 with
    the default halo of 64, one padded chunk of 8). The JAX CLI's params
    template (which the checkpoint then fills) is made of zeros of the
    traced shapes, not by an eager flax init, which takes ~30 s here."""
    from yondx.cli import yond as j_yond
    root, path, frame = tiny_runfile
    monkeypatch.chdir(root)

    def zeros_template(model, rng, input_shape, guided=None):
        shapes = jax.eval_shape(model.init, rng, jnp.zeros(input_shape),
                                jnp.full((input_shape[0],), 0.1))
        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    monkeypatch.setattr(j_yond, "init_params", zeros_template)
    args = ["-f", str(path), "--input", str(frame), "--tile", "128"]
    j_yond.main(args + ["--output", "j.npy", "--cpu"])
    app = t_yond.main(args + ["--output", "t.npy", "--device", "cpu"])
    ref, got = np.load(root / "j.npy"), np.load(root / "t.npy")
    assert got.shape == ref.shape == (252, 384)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)
    assert app.engine.device.type == "cpu"
    # --cpu is --device cpu
    assert t_yond.YOND(["-f", str(path), "--cpu"]).device == "cpu"


def test_cli_raises_for_what_the_port_lacks(tiny_runfile, monkeypatch):
    root, path, frame = tiny_runfile
    monkeypatch.chdir(root)
    base = ["-f", str(path), "--device", "cpu"]
    # --mesh 4 on CUDA needs 4 cards, one a rank (on the CPU it runs 4
    # gloo ranks: tests/test_torch_parallel.py)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < 4:
        with pytest.raises(ValueError, match=f"needs 4 cards.*has {have}"):
            t_yond.main(["-f", str(path), "--input", str(frame), "--mesh",
                         "4"])
    # the ANY runfile names no dataset: eval and test mode raise where
    # JAX's _dataset raises
    with pytest.raises(NotImplementedError, match="provide data under"):
        t_yond.main(base)                       # eval mode, no --input
    with pytest.raises(NotImplementedError, match="provide data under"):
        t_yond.main(base + ["-m", "test"])
    text = path.read_text()
    # BM3D without the pipeline block's opt-in raises, as in JAX
    bm3d = root / "bm3d.yml"
    bm3d.write_text(text.replace("'gru32n'", "'bm3d'"))
    with pytest.raises(RuntimeError, match="allow_experimental_bm3d"):
        t_yond.YOND(["-f", str(bm3d), "--cpu"])
    # an est_* block whose weights are not under fast_ckpt
    est = root / "est.yml"
    est.write_text(text + "est_net:\n  name: 'est_UNet'\n")
    with pytest.raises(FileNotFoundError, match="est_net"):
        t_yond.YOND(["-f", str(est), "--cpu"])
    missing = root / "missing.yml"
    missing.write_text(text.replace("tiny_GRU", "absent_GRU"))
    with pytest.raises(FileNotFoundError):
        t_yond.YOND(["-f", str(missing), "--cpu"])
    app = t_yond.YOND(base)
    # a mesh must be the port's (not a jax Mesh or a device count)
    with pytest.raises(TypeError, match="yondx_torch.parallel.Mesh"):
        denoise_any(app.engine, str(frame), mesh=object())


# ---------------------------------------------------------------- bench
class _Parsed(Exception):
    def __init__(self, parser):
        self.parser = parser


@pytest.fixture
def bench_py():
    spec = importlib.util.spec_from_file_location(
        "bench_py", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bench_py_parser(bench_py, monkeypatch):
    """bench.py's own argparse parser, caught at its parse_args call."""
    import argparse

    def catch(self, *a, **kw):
        raise _Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(_Parsed) as info:
            bench_py.main()
    return info.value.parser


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default,
                     tuple(a.choices) if a.choices else None, a.type)
            for a in parser._actions if a.dest != "help"}


def test_bench_flags_and_frame_match_bench_py(bench_py, monkeypatch):
    for a, b in zip(bench.make_frame(96, 128), bench_py.make_frame(96, 128)):
        np.testing.assert_array_equal(a, b)
    ref = _options(_bench_py_parser(bench_py, monkeypatch))
    got = _options(bench.build_parser())
    assert set(got) == set(ref) | {"device"}
    for dest, opt in ref.items():
        assert got[dest] == opt, dest
    assert set(bench.ARCHS) == set(ref["arch"][2])
    cli = bench.build_parser().parse_args(
        ["--arch", "gru32", "--nle-max-px", "0", "--sigma-corr", "1.03",
         "--pallas-nle", "on", "--frames", "2", "--refine", "off"])
    assert (cli.arch, cli.nle_max_px, cli.sigma_corr, cli.pallas_nle,
            cli.frames, cli.refine) == ("gru32", 0, "1.03", "on", 2, "off")


def _bench_py_json_keys():
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "dumps" and isinstance(node.args[0], ast.Dict):
            return [k.value for k in node.args[0].keys]
    raise AssertionError("no json.dumps({...}) in bench.py")


def test_bench_prints_bench_py_json(monkeypatch, capsys):
    """The port's bench on a small frame on the CPU: bench.py's JSON keys
    in its order, the value in MP/s from the median frame time, and main
    prints the record as one JSON line."""
    noisy, clean = bench.make_frame(96, 128)
    monkeypatch.setattr(bench, "make_frame", lambda: (noisy, clean))
    monkeypatch.chdir(REPO)
    cli = bench.build_parser().parse_args(["--arch", "s2dt16", "--device",
                                           "cpu"])
    rec, chk = bench.run(cli, runs=3)
    assert list(rec) == _bench_py_json_keys()
    mps = noisy.size / 1e6 / float(np.median(chk["times_s"]))
    assert rec["value"] == round(mps, 2) and rec["unit"] == "MP/s"
    assert rec["vs_baseline"] == round(mps / 50.0, 3)
    assert rec["metric"].startswith("fused blind Bayer denoise iter=1")
    assert f"psnr {chk['psnr_in']:.2f}->{chk['psnr_out']:.2f}dB; " \
        f"K_est={chk['k_est']:.2f}" in rec["metric"]
    monkeypatch.setattr(bench, "run", lambda cli: (rec, chk))
    bench.main([])
    assert capsys.readouterr().out == json.dumps(rec) + "\n"

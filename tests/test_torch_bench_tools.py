"""The port's one-off bench CLIs (yondx_torch/cli/{bench_loader,
bench_robust_overhead,chroma_probe,unet_roofline}.py) against the JAX
scripts they port, loaded from scripts/, on the CPU.

- bench_loader: build_corpus's files bit-equal between the packages at n
  8; the port's BatchLoader epochs 0-2 (batch 4, seed 0) equal to JAX's,
  epoch 1 from the batches epoch 0 read ahead, epoch 2 after close();
  main on that corpus prints the script's lines in their layout, and its
  exit code is 0 exactly when the wait is under 5% (a 0.2 s simulated
  step, so that both runs pass the gate).
- bench_robust_overhead: on the script's frame cut to 384 x 512, the two
  histogram layouts on the same cells against the script's (counts
  exactly; sum_m, float32 sums in another order on each side, rtol 1e-5
  of each other and of the float64 sum), the MAD self and collab regs at
  rtol 1e-3 (the robust NLE's parity bound); the row labels equal to the
  script's (its timings not run).
- chroma_probe: the committed 1to50c flagship at sigma 5: every bias
  within 1e-5 of JAX's (its outputs read at full precision by wrapping
  its jitted apply), the printed lines equal.
- unet_roofline at --H 64 --W 64 --reps 1 --dtype f32: tags,
  multiplicities and FLOPs equal to the script's, the whole net's
  forward sum within rtol 1e-4 of JAX's (its flax init jitted here; the
  port's flax_init_params is the same draw; JAX's conv rows not timed).
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from yondx.data import datasets as j_datasets
from yondx.models import registry as j_registry

from yondx_torch.cli import bench_loader as t_loader
from yondx_torch.cli import bench_robust_overhead as t_robust
from yondx_torch.cli import chroma_probe as t_chroma
from yondx_torch.cli import unet_roofline as t_roof
from yondx_torch.data import datasets as t_datasets
from torch_test_util import _one_torch_thread  # noqa: F401
from torch_test_util import layout, load_jax_script, printed

CKPT = "checkpoints/Gaussian/Gaussian_GRU_mix_1to50c_norm_best_model.ckpt"


def _gate(line):
    return layout(re.sub(r"PASS|FAIL", "<gate>", line))


def test_bench_loader_matches_jax(monkeypatch, tmp_path, capsys):
    mod = load_jax_script(monkeypatch, tmp_path, "bench_loader", [])
    roots = {k: str(tmp_path / k) for k in ("jax", "port")}
    mod.build_corpus(roots["jax"], 8)
    t_loader.build_corpus(roots["port"], 8)
    names = sorted(os.listdir(os.path.join(roots["jax"], "train")))
    assert names == sorted(os.listdir(os.path.join(roots["port"], "train")))
    assert len(names) == 8
    for n in names:
        a, b = (np.load(os.path.join(roots[k], "train", n))
                for k in ("jax", "port"))
        assert a.dtype == b.dtype == np.uint8 and a.shape == (256, 256, 3)
        assert np.array_equal(a, b), n
    loaders = [pkg.BatchLoader(pkg.NpyFolderDataset(roots[k], "train"), 4,
                               shuffle=True, seed=0, prefetch=8, workers=2)
               for pkg, k in ((j_datasets, "jax"), (t_datasets, "port"))]
    for e in (0, 1):
        ja, po = (list(ld.epoch(e)) for ld in loaders)
        assert len(ja) == len(po) == 2
        for a, b in zip(ja, po):
            assert np.array_equal(a, b)
        # the port's epoch e ended with epoch e + 1's batches in flight
        # (epoch 1 above started from them)
        assert loaders[1]._ahead[0] == e + 1 and \
            len(loaders[1]._ahead[1]) == 2
    loaders[1].close()
    assert [b.tolist() for b in loaders[1].epoch(2)] == \
        [b.tolist() for b in loaders[0].epoch(2)]

    flags = ["--n", "8", "--batch", "4", "--steps", "4", "--step-time",
             "0.2", "--workers", "2"]
    monkeypatch.setattr("sys.argv", ["bench_loader", "--root", roots["jax"],
                                     *flags])
    rc = mod.main()
    want = printed(capsys.readouterr().out, r"(corpus|cold|batch=)")
    got = t_loader.main(["--root", roots["port"], *flags])
    lines = printed(capsys.readouterr().out, r"(corpus|cold|batch=)")
    assert [_gate(x) for x in lines] == [_gate(x) for x in want]
    assert len(lines) == 3 and got["n_cold"] == 2 and got["steps"] == 4
    for code, line in ((rc, want[-1]), (got["rc"], lines[-1])):
        pct = float(re.search(r"= ([0-9.]+)% of step", line).group(1))
        assert code == (0 if pct < 5.0 else 1)
        assert line.endswith("PASS" if code == 0 else "FAIL")
    assert got["rc"] == (0 if got["pct"] < 5.0 else 1)


def test_bench_robust_overhead_matches_jax(monkeypatch, tmp_path, capsys):
    mod = load_jax_script(monkeypatch, tmp_path, "bench_robust_overhead", [])
    noisy, clean = t_robust.make_frame(384, 512)
    x, dn = torch.from_numpy(noisy), torch.from_numpy(clean)
    for name, args in (("mad_self_estimate", (noisy,)),
                       ("mad_collab_estimate", (noisy, clean))):
        want = getattr(mod, name)(*map(jnp.asarray, args))
        got = getattr(t_robust, name)(*map(torch.from_numpy, args))
        np.testing.assert_allclose([float(v) for v in got],
                                   [float(v) for v in want], rtol=1e-3,
                                   err_msg=name)
    bs = t_robust._band_subsample_rows(x, 4 * t_robust._MAX_CELLS)
    d, m = t_robust._haar_hh(bs)
    cells = [t_robust._maybe_subsample(d, m),
             (d.reshape(-1)[: 1 << 16], m.reshape(-1)[: 1 << 16])]
    for d2, m2 in cells:
        jd, jm = jnp.asarray(d2.numpy()), jnp.asarray(m2.numpy())
        _, bucket = t_robust._bins(torch.abs(d2), m2, 1.0)
        exact = np.zeros(t_robust.NB_M)
        np.add.at(exact, bucket.numpy(), m2.numpy().astype(np.float64))
        for name in ("hist_two", "hist_one"):
            (jc, js), (tc, ts) = (getattr(mod, name)(jd, jm),
                                  getattr(t_robust, name)(d2, m2))
            assert tc.shape == jc.shape and ts.shape == js.shape
            assert np.array_equal(tc.numpy(), np.asarray(jc)), name
            # float32 sums in another order in each package (and each
            # layout): both lie ~2.8e-6 from the float64 sum here
            for s in (ts.numpy(), np.asarray(js)):
                np.testing.assert_allclose(s, exact, rtol=1e-5,
                                           err_msg=name)
            np.testing.assert_allclose(ts.numpy(), np.asarray(js),
                                       rtol=1e-5, atol=0, err_msg=name)
        c2, s2 = t_robust.hist_two(d2, m2)
        c1, s1 = t_robust.hist_one(d2, m2)
        assert np.array_equal(c2.numpy(), c1.reshape(-1).numpy())
        np.testing.assert_allclose(s1.numpy(), s2.numpy(), rtol=1e-5)

    # the rows: JAX's labels with its timings not run
    monkeypatch.setattr(mod, "timed", lambda fn, *a, **k: 0.0)
    mod.main()
    want = printed(capsys.readouterr().out, r"(mad|band|haar|hist)")
    monkeypatch.setattr(t_robust, "FRAME", (384, 512))
    monkeypatch.setattr(t_robust, "REPS", 1)
    got = t_robust.main(["--cpu"])
    lines = printed(capsys.readouterr().out, r"(mad|band|haar|hist)")
    assert [layout(x) for x in lines] == [layout(x) for x in want]
    assert len(lines) == 9
    assert list(got["rows"]) == [x.split(":")[0].rstrip() for x in want]
    assert all(np.isfinite(v) and v > 0 for v in got["rows"].values())
    assert np.array_equal(got["hist_two"][0],
                          got["hist_one"][0].reshape(-1))


def test_chroma_probe_matches_jax(monkeypatch, tmp_path, capsys):
    mod = load_jax_script(monkeypatch, tmp_path, "chroma_probe",
                          [CKPT, "--cpu"])
    outs, jit = [], jax.jit

    def recording_jit(fn, *a, **k):
        f = jit(fn, *a, **k)

        def call(*args):
            out = f(*args)
            if np.ndim(out) == 4:
                outs.append(np.asarray(out, np.float64))
            return out
        return call

    monkeypatch.setattr(jax, "jit", recording_jit)
    mod.main()
    monkeypatch.setattr(jax, "jit", jit)
    want = printed(capsys.readouterr().out, r"(==|  )")
    got = t_chroma.main([CKPT, "--cpu"])
    lines = printed(capsys.readouterr().out, r"(==|  )")
    assert lines == want and len(lines) == 2 + len(t_chroma.RATIOS)
    rec = got[CKPT]
    assert len(outs) == len(t_chroma.RATIOS)
    for r, out in zip(t_chroma.RATIOS, outs):
        g = 0.30
        clean = np.array([min(g / r, 1.0), g, g, min(g * r, 1.0)],
                         np.float32)
        want_bias = (out - clean).mean(axis=(0, 1, 2))
        np.testing.assert_allclose(rec["bias"][r], want_bias, rtol=0,
                                   atol=1e-5, err_msg=str(r))
    assert rec["worst"] == max(float(np.abs(b).max())
                               for b in rec["bias"].values())


def test_unet_roofline_matches_jax(monkeypatch, tmp_path):
    init = j_registry.init_params
    flags = ["--H", "64", "--W", "64", "--reps", "1", "--dtype", "f32"]
    mod = load_jax_script(monkeypatch, tmp_path, "unet_roofline", flags)
    # real weights for the forward, from a jitted flax init
    monkeypatch.setattr(j_registry, "init_params", lambda model, key, shape:
                        jax.jit(lambda k: init(model, k, shape))(key))
    flops, lines, sums = [], [], []
    conv_flops = mod.conv_flops

    def rec_flops(*a, **k):
        flops.append(conv_flops(*a, **k))
        return flops[-1]

    time_fn = mod.time_fn

    def rec_time(fn, *args, reps=10):
        if len(args) == 1:          # a conv row: JAX's time not compared
            return 1e-3
        sums.append(float(np.asarray(fn(*args))))     # the whole net
        return time_fn(fn, *args, reps=reps)

    normal = jax.random.normal

    def inputs_only(key, shape, dtype=jnp.float32):
        # the conv rows' draws (not timed here) as zeros; the net's input
        # [1, H, W, 4] drawn
        return normal(key, shape, dtype) if shape == (1, 64, 64, 4) \
            else jnp.zeros(shape, dtype)

    monkeypatch.setattr(jax.random, "normal", inputs_only)
    monkeypatch.setattr(mod, "conv_flops", rec_flops)
    monkeypatch.setattr(mod, "time_fn", rec_time)
    monkeypatch.setattr(mod, "log", lines.append)
    mod.main()
    got = t_roof.main([*flags, "--cpu"])
    n_rows = len(t_roof.inventory(64, 64))
    assert n_rows == 14 and len(got["rows"]) == n_rows
    want_rows = [re.match(r"(.{26}) .* x(\d+)$", x).groups()
                 for x in lines[:n_rows]]
    assert [(r["tag"], r["n"]) for r in got["rows"]] == \
        [(t.rstrip(), int(n)) for t, n in want_rows]
    assert [r["flops"] for r in got["rows"]] == flops[:n_rows]
    assert [r["flops"] for r in got["lane"]] == flops[n_rows:]
    assert [r["cout"] for r in got["lane"]] == [32, 64, 128, 256]
    assert len(sums) == 1
    np.testing.assert_allclose(got["net_sum"], sums[0], rtol=1e-4)
    for r in got["rows"] + got["lane"]:
        assert np.isfinite(r["ms"]) and r["ms"] > 0
    assert np.isfinite(got["net_ms"]) and got["net_ms"] > 0


def test_npy_folder_fast_path_reads_headers_with_public_numpy_api(
        tmp_path):
    """NpyFolderDataset's batched readinto path takes the corpus's data
    offset from numpy's public header readers (the card machine's numpy
    has no private `format._read_array_header`, which the port named
    before) and reads the batch the per-item path reads."""
    import inspect
    assert "_read_array_header(" not in inspect.getsource(
        t_datasets.NpyFolderDataset)
    t_loader.build_corpus(str(tmp_path), 6)
    ds = t_datasets.NpyFolderDataset(str(tmp_path), "train")
    got = ds.read_batch([4, 0, 5])
    assert ds._fast and got.dtype == np.uint8
    assert np.array_equal(got, np.stack([ds[i] for i in (4, 0, 5)]))


def test_synthetic_set_built_in_workers_is_the_sequential_set(monkeypatch,
                                                              tmp_path):
    """A set of PARALLEL_BUILD_MIN crops or more is built by worker
    interpreters (here 2, the threshold cut to 4) from any working
    directory: the same crops, bit for bit, as one process builds."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(t_datasets, "PARALLEL_BUILD_MIN", 4)
    monkeypatch.setattr(t_datasets.os, "cpu_count", lambda: 2)
    cache = tmp_path / "cache"
    built = t_datasets.SyntheticSRGBDataset(length=7, size=32, seed=5,
                                            disk_cache=str(cache))
    plain = t_datasets.SyntheticSRGBDataset(length=7, size=32, seed=5,
                                            cache=False)
    assert os.listdir(cache) == ["v6_s5_p32_n7.npy"]
    for i in range(7):
        assert np.array_equal(built[i], plain[i]), i

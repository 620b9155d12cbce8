"""The port's eval and test harnesses against the JAX package's (CPU,
fp32), on numpy-seeded fixtures:

- `eval/sidd.SIDDEvalHarness` on a SIDD layout of [2, 4, 128, 128] blocks
  read by each package's own `SIDDValDataset`, with the box-mean
  denoiser of tests/test_sidd_harness.py, and its per-crop scoring;
- `eval/fullframe.FullFrameHarness` on its two routes: ELD frames whole
  with the illuminance alignment, and a GBRG frame overlap-tiled (the
  CFA rotated); the automatic route by frame size;
- `eval/dnd.denoise_dnd` and `bundle_submissions_raw` on a DND-like
  image of two boxes;
- the CLI's `-m eval` and `-m test` on the nf=8 runfile of
  tests/test_torch_cli.py made a SIDD runfile.

Tolerances: denoised outputs (the npy cache, the per-crop and bundle
.mat files, each round of a frame) atol 2e-4, as `test_cli_matches_jax`;
PSNR and SSIM in the metrics pickle and the returned means within 1e-3;
regs rtol 1e-3, as tests/test_torch_engine.py, or for the full frames the
larger of that and JAX's own spread under a +-1e-6 shift of the frame
(the rule chip_smoke.py holds the card to: beta2 is ill-conditioned at
that level in both packages). The pickles hold the same
keys and value types (plain floats and lists, never tensors).
"""
import contextlib
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import torch

from yondx.cli import yond as j_yond
from yondx.data import datasets as j_datasets
from yondx.data import eval_datasets as j_eval_ds
from yondx.eval import dnd as j_dnd
from yondx.eval import fullframe as j_fullframe
from yondx.eval import sidd as j_sidd
from yondx.nle import box_mean as j_box_mean
from yondx.pipeline import PipelineConfig as JPipelineConfig
from yondx.pipeline import VSTDenoiser as JVSTDenoiser
from yondx.pipeline import YONDEngine as JYONDEngine

from yondx_torch.cli import yond as t_yond
from yondx_torch.data import datasets as t_datasets
from yondx_torch.data import eval_datasets as t_eval_ds
from yondx_torch.eval import dnd as t_dnd
from yondx_torch.eval import fullframe as t_fullframe
from yondx_torch.eval import metrics as t_metrics
from yondx_torch.eval import sidd as t_sidd
from yondx_torch.nle.boxfilter import box_mean as t_box_mean
from yondx_torch.pipeline.denoiser import VSTDenoiser
from yondx_torch.pipeline.engine import PipelineConfig, YONDEngine

from test_torch_cli import tiny_runfile  # noqa: F401  (module fixture)
from torch_test_util import _one_torch_thread  # noqa: F401

K, SIG = 6.0, 8.0


class _JBlur:
    def apply(self, p, x, t=None):
        return j_box_mean(x, 7)


class _TBlur(torch.nn.Module):
    def forward(self, x, t=None):
        return t_box_mean(x, 7)


# the box-mean harness tests run round 0 only (as test_sidd_harness.py's
# sRGB case): the collab round doubles JAX's compile of each shape (13.0
# against 6.0 s for the crop stack here), and the CLI test below holds
# the harness with max_iter 1 through the runfile
MAX_ITER = 0


def _engines():
    """(JAX engine, port engine): the box-mean denoiser in VST space, the
    'pre' bias, self estimate, MAX_ITER collab rounds."""
    j = JYONDEngine(JVSTDenoiser(_JBlur(), None, guided=False,
                                 bias_corr="pre"),
                    JPipelineConfig(est_type="simple", max_iter=MAX_ITER))
    t = YONDEngine(VSTDenoiser(_TBlur(), guided=False, bias_corr="pre",
                               device="cpu"),
                   PipelineConfig(est_type="simple", max_iter=MAX_ITER))
    return j, t


@pytest.fixture(scope="module")
def engines():
    """One engine pair for the module: JAX compiles per input shape, so
    the ELD frames and the DND boxes share a shape and one compile."""
    return _engines()


def _pg(clean, rng, scale, k=K, sig=SIG):
    """Poisson-Gaussian noise (k, sig in DN of `scale`) on [0, 1]."""
    noisy = (k * rng.poisson(clean * scale / k)
             + rng.normal(0, sig, clean.shape)) / scale
    return np.clip(noisy, 0, 1).astype(np.float32)


def _write_sidd(root, n=2, crops=4, size=128, seed=21):
    """SIDD_Validation_Raw/ with [n, crops, size, size] noisy, GT and
    benchmark blocks: each crop one flat level with Poisson-Gaussian
    noise (K 6, sigma 8 DN over 959 DN). Flat crops keep the k=29 self
    fit off the edges between levels, where 64-px blocks put it on a
    knife edge (a 1e-6 shift of the input moves beta2 by 0.2% in JAX
    alone)."""
    rng = np.random.default_rng(seed)
    levels = rng.random((n, crops, 1, 1)) * 0.5 + 0.2
    clean = np.kron(levels, np.ones((1, 1, size, size)))
    noisy = _pg(clean, rng, 959.0)
    val = root / "SIDD" / "SIDD_Validation_Raw"
    val.mkdir(parents=True)
    for key, v in (("ValidationNoisyBlocksRaw", noisy),
                   ("ValidationGtBlocksRaw", clean.astype(np.float32)),
                   ("BenchmarkNoisyBlocksRaw", noisy[::-1].copy())):
        sio.savemat(val / f"{key}.mat", {key: v})
    return root / "SIDD"


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _assert_regs(got, ref, rounds, spread=0.0):
    """Regs of the first `rounds` rounds within the larger of rtol 1e-3
    and `spread`; every round's a tuple of two plain floats."""
    assert type(got) is type(ref) is list and len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert type(g) is type(r) is tuple and len(g) == len(r) == 2
        assert all(type(x) is float and np.isfinite(x) for x in g + r)
        if i < rounds:
            allowed = np.maximum(1e-3 * np.abs(r), np.asarray(spread)[i])
            assert (np.abs(np.subtract(g, r)) <= allowed).all(), \
                (i, g, r, allowed)


def _assert_metrics(got, ref, reg_rounds=2, spreads=None):
    """Two metrics pickles: the same scenes and keys; regs of the first
    `reg_rounds` rounds within rtol 1e-3 (or the scene's entry of
    `spreads`, where larger), PSNR / SSIM (floats or lists of floats)
    within 1e-3."""
    assert list(got) == list(ref)
    for name in ref:
        assert sorted(got[name]) == sorted(ref[name]), name
        for key, r in ref[name].items():
            g = got[name][key]
            if key == "reg":
                _assert_regs(g, r, reg_rounds,
                             np.zeros((len(r), 2)) if spreads is None
                             else spreads[name])
                continue
            assert type(g) is type(r), (name, key)
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-3)


def _assert_npy_dirs(got_dir, ref_dir):
    names = sorted(os.listdir(ref_dir))
    assert names and sorted(os.listdir(got_dir)) == names
    for n in names:
        g, r = np.load(os.path.join(got_dir, n)), np.load(
            os.path.join(ref_dir, n))
        assert g.shape == r.shape and g.dtype == r.dtype == np.float32
        np.testing.assert_allclose(g, r, atol=2e-4, rtol=0)


# ------------------------------------------------------------------ SIDD
def test_sidd_harness_matches_jax(engines, tmp_path, monkeypatch):
    root = _write_sidd(tmp_path)
    j_eng, t_eng = engines
    res = {}
    for side, eng, ds, harness in (
            ("jax", j_eng, j_datasets.SIDDValDataset, j_sidd.SIDDEvalHarness),
            ("port", t_eng, t_datasets.SIDDValDataset,
             t_sidd.SIDDEvalHarness)):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        h = harness(eng, ds(str(root), mode="eval"), "sidd_h",
                    max_iter=MAX_ITER)
        res[side] = h.run(wp=1023, bl=64)
    assert len(res["port"]["psnr"]) == MAX_ITER + 2   # each round, last
    # the scenes estimate K: JAX's own K_est within 10% of the truth
    ref = _load(tmp_path / "jax" / "metrics" / "sidd_h_metrics.pkl")
    for rec in ref.values():
        assert abs(rec["reg"][0][0] * 959 - K) < 0.1 * K
    for key in ("psnr", "ssim"):
        np.testing.assert_allclose(res["port"][key], res["jax"][key],
                                   rtol=0, atol=1e-3)
    assert res["port"]["psnr"][0] > 25            # the box mean denoises
    _assert_metrics(
        _load(tmp_path / "port" / "metrics" / "sidd_h_metrics.pkl"), ref)
    _assert_npy_dirs(tmp_path / "port" / "npy" / "sidd_h",
                     tmp_path / "jax" / "npy" / "sidd_h")
    assert np.load(tmp_path / "port" / "npy" / "sidd_h" / "001.npy").shape \
        == (MAX_ITER + 1, 4, 128, 128)


def test_sidd_per_crop_scoring_matches_jax(tmp_path):
    """Per-crop PSNR (data_range 1) and SSIM (x255) meaned over the crops,
    -1 for an output that is not positive, on crops of very different
    error (where one PSNR over the stack would differ by > 1 dB), of the
    SIDD test's crop size (JAX scores eagerly: one compile a shape)."""
    rng = np.random.default_rng(3)
    hr = rng.random((4, 128, 128)).astype(np.float32)
    dn = hr + np.stack([rng.normal(0, s, (128, 128))
                        for s in (0.001, 0.01, 0.05, 0.2)]).astype(np.float32)
    hs = [cls(None, None, "proto", max_iter=1, logfile=str(tmp_path / "l"))
          for cls in (j_sidd.SIDDEvalHarness, t_sidd.SIDDEvalHarness)]
    for h in hs:
        h._score_scene("s", [dn, np.zeros_like(dn)], dn, hr)
    (jh, th) = hs
    for it in range(3):
        assert abs(th.psnrs[it].avg - jh.psnrs[it].avg) < 1e-3
        assert abs(th.ssims[it].avg - jh.ssims[it].avg) < 1e-3
    assert th.psnrs[1].avg == -1 and th.ssims[1].avg == -1
    assert th.metrics["s"]["psnr"] == pytest.approx(jh.metrics["s"]["psnr"],
                                                    abs=1e-3)


def test_sidd_write_submission_matches_jax(tmp_path):
    """SubmitRaw.mat (key 'results', float32 [scenes, 32, 256, 256])."""
    res = np.random.default_rng(5).random((2, 3, 8, 8))
    paths = [cls(None, None, "sub").write_submission(res, str(tmp_path / d))
             for cls, d in ((j_sidd.SIDDEvalHarness, "jax"),
                            (t_sidd.SIDDEvalHarness, "port"))]
    assert paths[1] == str(tmp_path / "port" / "sub" / "SubmitRaw.mat")
    got, ref = (sio.loadmat(p)["results"] for p in paths[::-1])
    assert got.dtype == np.float32 and got.shape == (2, 3, 8, 8)
    np.testing.assert_array_equal(got, ref)


def test_sidd_save_plot_writes_pngs_and_scores_srgb(tmp_path, monkeypatch):
    """save_plot on a scene with metadata: the noisy, GT and each round's
    sRGB PNG of the crop strip, read back at [H, crops * W, 3], and
    psnr_rgb / ssim_rgb in the scene's record, per round, and in the
    returned means (tests/test_torch_viz.py holds their values to
    JAX's)."""
    monkeypatch.chdir(tmp_path)
    from yondx_torch.core.png import read_png
    rng = np.random.default_rng(8)
    hr = rng.random((3, 32, 32)).astype(np.float32) * 0.5 + 0.2
    dn = [hr + rng.normal(0, s, hr.shape).astype(np.float32)
          for s in (0.02, 0.01)]
    meta = {"bayer_2by2": [[2, 1], [3, 2]], "wb": [0.5, 1.0, 0.6],
            "cst2": np.eye(3) * 0.9 + 0.05}
    h = t_sidd.SIDDEvalHarness(None, None, "plot", max_iter=1,
                               save_plot=True,
                               sample_dir=str(tmp_path / "img"),
                               logfile=str(tmp_path / "l"))
    h._score_scene("0123_s", dn, dn[0], hr, meta)
    names = sorted(os.listdir(tmp_path / "img"))
    assert names == ["0123_0.png", "0123_1.png", "0123_gt.png",
                     "0123_noisy.png"]
    for n in names:
        img = read_png(str(tmp_path / "img" / n))
        assert img.shape == (32, 96, 3) and img.dtype == np.uint8
    rec = h.metrics["0123_s"]
    assert len(rec["psnr_rgb"]) == len(rec["ssim_rgb"]) == 2
    assert rec["psnr_rgb"][1] > rec["psnr_rgb"][0] > 20
    assert all(0 < s <= 1 for s in rec["ssim_rgb"])
    assert h.psnrs_rgb[-1].avg == rec["psnr_rgb"][-1]


# ------------------------------------------------------------- fullframe
class _Frames:
    """In-memory frames dataset."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return dict(self.items[i])


@contextlib.contextmanager
def _spy(engine, calls):
    """Record each round's outputs and which engine entry ran."""
    for name in ("iter_denoise", "iter_denoise_tiled"):
        orig = getattr(engine, name)

        def run(*a, _orig=orig, _name=name, **kw):
            res = _orig(*a, **kw)
            calls.append((_name, [np.asarray(d) for d in res["raw_dns"]]))
            return res
        setattr(engine, name, run)
    try:
        yield
    finally:
        for name in ("iter_denoise", "iter_denoise_tiled"):
            delattr(engine, name)


# the shape of the ELD frames, the tiled GBRG frame (square: its CFA
# rotation keeps it) and the DND boxes, so their NLE and scoring share
# JAX's compiles
FRAME = (192, 192)


def _write_eld(root, seed=23):
    """ELD/SonyA7S2/scene-1/IMG_000{1,4,9}.npy, IMG_0016.npy of FRAME:
    2x2 flat levels, uint16 at wp 16383, bl 512; the noisy ids at 0.8x
    the GT exposure, with the SIDD fixture's noise relative to the
    range (K and sigma x 15871 / 959)."""
    rng = np.random.default_rng(seed)
    d = root / "SonyA7S2" / "scene-1"
    d.mkdir(parents=True)
    scale = 16383 - 512
    H, W = FRAME
    clean = np.kron(rng.random((2, 2)) * 0.6 + 0.1, np.ones((H // 2, W // 2)))
    for i in (1, 4, 9, 16):
        frame = clean if i in (1, 16) else _pg(
            clean * 0.8, rng, scale, K * scale / 959, SIG * scale / 959)
        np.save(d / f"IMG_{i:04d}.npy",
                np.round(frame * scale + 512).astype(np.uint16))
    return root


def _shift_spreads(h, ds, metrics):
    """JAX's own regs spread when each frame of the run moves by +-1e-6
    (beta2 is ill-conditioned at that level in both packages,
    tests/test_torch_fused.py::test_beta2_moves_under_1e6_shift): the
    harness's params and route, per frame name."""
    out = {}
    for k in range(len(metrics)):
        data = ds[k]
        wp, bl = data.get("wp", 1023), data.get("bl", 64)
        p = {"wp": wp, "bl": bl, "ratio": 1.0, "scale": float(wp - bl),
             "gain": 1.0, "sigma": 0.0, "cfa": data["cfa"]}
        if p["cfa"] != [[1, 2], [2, 3]]:
            p["rot_cfa"] = True
        base = np.array(metrics[data["name"]]["reg"])
        lr = np.asarray(data["lr"], np.float32)
        out[data["name"]] = np.max(
            [np.abs(np.array(h._denoise_frame(lr + d, dict(p))[1]) - base)
             for d in (np.float32(1e-6), np.float32(-1e-6))], axis=0)
    return out


def _run_fullframe(engines, tmp_path, monkeypatch, datasets, limit=None,
                   **kw):
    j_eng, t_eng = engines
    out = {}
    for side, eng, ds, cls in (
            ("jax", j_eng, datasets[0], j_fullframe.FullFrameHarness),
            ("port", t_eng, datasets[1], t_fullframe.FullFrameHarness)):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        calls = []
        h = cls(eng, ds, "ff", **kw)
        with _spy(eng, calls):
            res = h.run(limit=limit)
        out[side] = (res, calls,
                     _load(tmp_path / side / "metrics" / "ff_metrics.pkl"), h)
    (jr, jc, jm, jh), (tr, tc, tm, _) = out["jax"], out["port"]
    assert [c[0] for c in tc] == [c[0] for c in jc]
    for (_, g), (_, r) in zip(tc, jc):
        assert len(g) == len(r) == MAX_ITER + 1
        for a, b in zip(g, r):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=2e-4, rtol=0)
    _assert_metrics(tm, jm, spreads=_shift_spreads(jh, datasets[0], jm))
    for key in ("psnr", "ssim"):
        assert abs(tr[key] - jr[key]) < 1e-3
    return tr, tc, tm


def test_fullframe_eld_whole_frame_with_alignment_matches_jax(
        engines, tmp_path, monkeypatch):
    root = _write_eld(tmp_path / "ELD")
    ds = (j_eval_ds.ELDDataset(str(root), scenes=[1]),
          t_eval_ds.ELDDataset(str(root), scenes=[1]))
    res, calls, metrics = _run_fullframe(engines, tmp_path, monkeypatch, ds,
                                         limit=2, illum_correct=True)
    assert [c[0] for c in calls] == ["iter_denoise"] * 2
    assert set(metrics) == {"SonyA7S2_s01_0004", "SonyA7S2_s01_0009"}
    # the frames estimate K: the port's K_est within 10% of the truth
    for rec in metrics.values():
        assert abs(rec["reg"][0][0] * 959 - K) < 0.1 * K
    # the noisy frames sit at 0.8x the GT: only the alignment scores them
    assert res["psnr"] > 25


def test_fullframe_tiled_route_with_cfa_rotation_matches_jax(
        engines, tmp_path, monkeypatch):
    rng = np.random.default_rng(29)
    H, W = FRAME
    clean = np.kron(rng.random((2, 2)) * 0.6 + 0.1, np.ones((H // 2, W // 2)))
    item = {"name": "gbrg", "lr": _pg(clean, rng, 959.0),
            "hr": clean.astype(np.float32), "wp": 1023, "bl": 64,
            "ratio": 1.0, "cfa": [[2, 3], [1, 2]]}
    ds = _Frames([item])
    res, calls, _ = _run_fullframe(engines, tmp_path, monkeypatch, (ds, ds),
                                   tile=128, halo=32)
    assert [c[0] for c in calls] == ["iter_denoise_tiled"]
    assert res["psnr"] > 25


def test_fullframe_route_by_size_matches_jax():
    """tile 0 tiles at 1024 from 16 MP (LRID's 3472x4624) and runs ELD's
    Sony 2848x4256 whole; -1 is always whole, > 0 always tiled; a mesh
    that is not the port's is refused (the sharded route itself:
    tests/test_torch_parallel.py)."""
    for tile in (0, -1, 512):
        j = j_fullframe.FullFrameHarness(None, None, "r", tile=tile)
        t = t_fullframe.FullFrameHarness(None, None, "r", tile=tile)
        for shape in ((2848, 4256), (3472, 4624), (64, 64)):
            lr = np.broadcast_to(np.float32(0), shape)
            assert t._route(lr) == j._route(lr)
    t = t_fullframe.FullFrameHarness(None, None, "r")
    assert [t._route(np.broadcast_to(np.float32(0), s))
            for s in ((2848, 4256), (3472, 4624))] == [0, 1024]
    with pytest.raises(TypeError, match="yondx_torch.parallel.Mesh"):
        t_fullframe.FullFrameHarness(None, None, "r", mesh=object())


# ------------------------------------------------------------------ DND
class _DND:
    """One DND-like image in [0, 1] (wp 1, bl 0) of 2x4 flat levels with
    two boxes of FRAME's shape (1-indexed [y0, x0, y1, x1])."""

    def __init__(self, seed=31):
        rng = np.random.default_rng(seed)
        H, W = FRAME
        clean = np.kron(rng.random((2, 4)) * 0.6 + 0.1, np.ones((H, W // 2)))
        self.lr = _pg(clean, rng, 959.0)
        self.boxes = np.array([[1, 1, H, W], [H + 1, W + 1, 2 * H, 2 * W]],
                              np.float64)

    def __len__(self):
        return 1

    def __getitem__(self, i):
        return {"name": "0001", "lr": self.lr, "wp": 1, "bl": 0,
                "ratio": 1.0, "cfa": [[1, 2], [2, 3]], "boxes": self.boxes}


def test_dnd_submission_matches_jax(engines, tmp_path):
    """Each box one iter_denoise; the per-crop files and the image's
    bundle (the 1x2 object row, israw, eval_version) against JAX's.
    The reader is held on h5py files in test_torch_eval_datasets.py."""
    j_eng, t_eng = engines
    jb = j_dnd.denoise_dnd(j_eng, _DND(), str(tmp_path / "jax"))
    tb = t_dnd.denoise_dnd(t_eng, _DND(), str(tmp_path / "port"))
    assert t_dnd.bundle_submissions_raw(tb) == \
        j_dnd.bundle_submissions_raw(jb) == 1
    names = sorted(os.listdir(jb))
    assert sorted(os.listdir(tb)) == names == ["0001.mat", "0001_01.mat",
                                               "0001_02.mat"]
    for n in names:
        g, r = sio.loadmat(os.path.join(tb, n)), sio.loadmat(
            os.path.join(jb, n))
        assert sorted(k for k in g if not k.startswith("__")) == \
            sorted(k for k in r if not k.startswith("__"))
        if "Idenoised_crop" in r:
            g, r = [g["Idenoised_crop"]], [r["Idenoised_crop"]]
        else:
            assert g["israw"].squeeze() and str(np.squeeze(
                g["eval_version"])) == "1.0"
            assert g["Idenoised"].shape == r["Idenoised"].shape == (1, 2)
            g, r = list(g["Idenoised"][0]), list(r["Idenoised"][0])
        for a, b in zip(g, r):
            assert a.shape == b.shape == FRAME and a.dtype == np.float32
            np.testing.assert_allclose(a, b, atol=2e-4, rtol=0)
    with pytest.raises(ValueError, match="boxes"):
        t_dnd.denoise_dnd(t_eng, _Frames([{"lr": np.zeros(FRAME)}]),
                          str(tmp_path / "none"))


# ------------------------------------------------------------------ CLI
SIDD_DST = """\
dst_eval:
  root_dir: 'SIDD'
  dataset: 'SIDD_Dataset'
  mode: 'eval'
dst_test:
  root_dir: 'SIDD'
  dataset: 'SIDD_Dataset'
  mode: 'test'
"""


def test_cli_eval_and_test_modes_match_jax(  # noqa: F811
        tiny_runfile, tmp_path, monkeypatch):
    """`yond -f <the nf=8 runfile as SIDD>` in eval mode, then `-m test`,
    each CLI in a working directory of its own holding the SIDD layout
    ([2, 4, 128, 128]): the metrics pickle, the npy cache of each mode.
    The JAX CLI's params template is made of zeros of the traced shapes,
    as in test_cli_matches_jax. Of the regs, the self round is held at
    rtol 1e-3; the collab round fits the random-weight net's output (10
    dB), where a +-1e-6 shift of the input moves beta1 by up to 20% in
    JAX alone, so it is held to be two plain floats (the box-mean
    harness test holds the collab round at rtol 1e-3). The second pass
    does not fire, so the cached outputs are held at atol 2e-4. The JAX
    side calls `eval` then `benchmark` on one `YOND`, as its `main`
    dispatches the two modes: its denoiser compiles per instance."""
    _, path, _ = tiny_runfile
    text = path.read_text().replace('"ANY"', '"SIDD"').replace(
        "tiny_ANY", "tiny_SIDD")
    runfile = tmp_path / "sidd.yml"
    runfile.write_text(text + SIDD_DST)

    def zeros_template(model, rng, input_shape, guided=None):
        shapes = jax.eval_shape(model.init, rng, jnp.zeros(input_shape),
                                jnp.full((input_shape[0],), 0.1))
        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    monkeypatch.setattr(j_yond, "init_params", zeros_template)
    for side in ("jax", "port"):
        _write_sidd(tmp_path / side)
    monkeypatch.chdir(tmp_path / "jax")
    j_app = j_yond.YOND(["-f", str(runfile), "--cpu"])
    npy = {}
    for mode in ("eval", "test"):
        for side in ("jax", "port"):
            monkeypatch.chdir(tmp_path / side)
            if side == "jax":
                j_app.eval() if mode == "eval" else j_app.benchmark()
            else:
                app = t_yond.main(["-f", str(runfile), "-m", mode,
                                   "--device", "cpu"])
                assert app.engine.device.type == "cpu"
            d = tmp_path / side / "npy" / "tiny_SIDD"
            npy[side] = d
        _assert_npy_dirs(npy["port"], npy["jax"])
        _assert_metrics(
            _load(tmp_path / "port" / "metrics" / "tiny_SIDD_metrics.pkl"),
            _load(tmp_path / "jax" / "metrics" / "tiny_SIDD_metrics.pkl"),
            reg_rounds=1)
        if mode == "eval":
            m = _load(tmp_path / "port" / "metrics" / "tiny_SIDD_metrics.pkl")
            assert sorted(m) == ["0000", "0001"]
            assert len(m["0000"]["psnr"]) == 2
            for side in ("jax", "port"):
                for f in (tmp_path / side / "npy" / "tiny_SIDD").iterdir():
                    f.unlink()


class _FlagWrites:
    """Stands in for torch.backends.cudnn or torch.backends.cuda.matmul:
    records every attribute written, reads through to the module."""

    def __init__(self, module, name, log):
        object.__setattr__(self, "_module", module)
        object.__setattr__(self, "_name", name)
        object.__setattr__(self, "_log", log)

    def __getattr__(self, key):
        return getattr(self._module, key)

    def __setattr__(self, key, value):
        self._log.append((self._name, key, value))


def test_precision_flags_written_once_by_the_cli(  # noqa: F811
        tiny_runfile, tmp_path, monkeypatch):
    """The TF32 flags are process-wide and the SIDD harness scores on 4
    threads beside the engine: scoring (`crop_means`, `matlab_ssim`)
    writes no flag, and the CLI writes float32 (both TF32 flags off)
    once, at start-up."""
    writes = []
    monkeypatch.setattr(torch.backends, "cudnn", _FlagWrites(
        torch.backends.cudnn, "cudnn", writes))
    monkeypatch.setattr(torch.backends.cuda, "matmul", _FlagWrites(
        torch.backends.cuda.matmul, "matmul", writes))
    rng = np.random.default_rng(6)
    hr = rng.random((4, 64, 64)).astype(np.float32)
    dn = (hr + rng.normal(0, 0.05, hr.shape)).astype(np.float32)
    t_sidd.crop_means(dn, hr)
    t_metrics.matlab_ssim(dn[0] * 255, hr[0] * 255)
    assert writes == []
    _, path, _ = tiny_runfile
    monkeypatch.chdir(tmp_path)
    t_yond.YOND(["-f", str(path), "--device", "cpu"])
    assert writes == [("cudnn", "allow_tf32", False),
                      ("matmul", "allow_tf32", False)]

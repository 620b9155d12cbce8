"""The port's figure tools and host helpers against the JAX package's and
cv2 on the CPU, on numpy-seeded inputs: the PNG codec (core/png.py) and
`dataload` of .png, `eval/visualization.py`, `eval/debugger.py`,
`core/profiling.py`'s span and trace, `core/logging.set_logfile`, the
trainer's sample dump, the SIDD harness's sRGB branch, `native.py`'s
host filters and the attention and upsampling blocks of
`models/blocks.py`.

Tolerances: pixels bit-equal (the codec both ways with cv2, dataload,
the PNGs plot_sample, the debugger, the trainer dump and the SIDD branch
write, the native filters); sRGB PSNR and SSIM within 1e-3 (float32
metrics in another order); quality_assess within 1e-4; the blocks within
1e-5 of flax at the converted weights.
"""
import os
import struct
import sys
import types
import zlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yondx import native as j_native
from yondx.core import io as j_io
from yondx.core import logging as j_logging
from yondx.eval import debugger as j_debugger
from yondx.eval import sidd as j_sidd
from yondx.eval import visualization as j_viz
from yondx.models import blocks as j_blocks
from yondx.train import trainer as j_trainer

from yondx_torch import native as t_native
from yondx_torch.core import io as t_io
from yondx_torch.core import logging as t_logging
from yondx_torch.core import png
from yondx_torch.core import profiling as t_prof
from yondx_torch.eval import debugger as t_debugger
from yondx_torch.eval import sidd as t_sidd
from yondx_torch.eval import visualization as t_viz
from yondx_torch.models import blocks as t_blocks
from yondx_torch.models.convert import params_to_state_dict
from yondx_torch.train import trainer as t_trainer

from torch_test_util import _one_torch_thread  # noqa: F401


def _img(shape, dtype, seed=0):
    hi = 256 if dtype == np.uint8 else 65536
    x = np.random.default_rng(seed).integers(0, hi, shape).astype(dtype)
    x[:6] = x[:1]                       # flat rows: Up / Paeth predict
    return x


# ---------------------------------------------------------------- PNG codec
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_codec_against_cv2(tmp_path, dtype, channels):
    """cv2 reads what the port writes (gray, RGB, RGBA; cv2 holds BGR),
    and the port reads what cv2 writes at compression 0, 1 and 9 and
    under its filtered strategy (other scanline filters)."""
    shape = (37, 53) + ((channels,) if channels > 1 else ())
    img = _img(shape, dtype, channels)
    bgr = {1: lambda a: a, 3: lambda a: a[:, :, ::-1],
           4: lambda a: a[:, :, (2, 1, 0, 3)]}[channels]
    mine = str(tmp_path / "mine.png")
    png.write_png(mine, img)
    got = cv2.imread(mine, cv2.IMREAD_UNCHANGED)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, bgr(img))
    theirs = str(tmp_path / "cv2.png")
    for flags in ([cv2.IMWRITE_PNG_COMPRESSION, 0],
                  [cv2.IMWRITE_PNG_COMPRESSION, 1],
                  [cv2.IMWRITE_PNG_COMPRESSION, 9],
                  [cv2.IMWRITE_PNG_STRATEGY,
                   cv2.IMWRITE_PNG_STRATEGY_FILTERED]):
        cv2.imwrite(theirs, bgr(img), flags)
        back = png.read_png(theirs)
        assert back.dtype == dtype
        np.testing.assert_array_equal(back, img)


def _chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _handmade(W, H, depth, ctype, rows, filters, extra=b"", interlace=0):
    raw = b"".join(bytes([f]) + r for f, r in zip(filters, rows))
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0,
                                          0, interlace))
            + extra + _chunk(b"IDAT", zlib.compress(raw))
            + _chunk(b"IEND", b""))


def test_png_reader_palette_low_bits_filters(tmp_path):
    """A palette file (with and without tRNS), 1-, 2- and 4-bit gray, and
    every scanline filter by hand, read as cv2.imread reads them
    (IMREAD_UNCHANGED, BGR reversed); an interlaced file raises."""
    rng = np.random.default_rng(3)
    plte = rng.integers(0, 256, (5, 3), dtype=np.uint8)
    idx = rng.integers(0, 5, (6, 7), dtype=np.uint8)
    rows = [r.tobytes() for r in idx]
    for trns in (b"", _chunk(b"tRNS", bytes([0, 128, 255]))):
        p = tmp_path / "pal.png"
        p.write_bytes(_handmade(7, 6, 8, 3, rows, [0] * 6,
                                _chunk(b"PLTE", plte.tobytes()) + trns))
        ref = cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
        got = png.read_png(str(p))
        chans = (2, 1, 0, 3) if trns else (2, 1, 0)
        np.testing.assert_array_equal(got[:, :, chans], ref)
    for depth in (1, 2, 4):
        v = rng.integers(0, 1 << depth, (5, 11), dtype=np.uint8)
        per = 8 // depth
        pad = np.zeros((5, -(-11 // per) * per), np.uint8)
        pad[:, :11] = v
        packed = [bytes(int(sum(int(q) << (8 - depth * (i + 1))
                                for i, q in enumerate(pad[r, c:c + per])))
                        for c in range(0, pad.shape[1], per))
                  for r in range(5)]
        p = tmp_path / f"g{depth}.png"
        p.write_bytes(_handmade(11, 5, depth, 0, packed, [0] * 5))
        np.testing.assert_array_equal(
            png.read_png(str(p)), cv2.imread(str(p), cv2.IMREAD_UNCHANGED))
    # every filter type, RGB 8-bit: encode each row by its filter
    img = rng.integers(0, 256, (5, 9, 3), dtype=np.uint8)
    flat = img.reshape(5, -1).astype(np.int16)
    enc, prev = [], np.zeros(27, np.int16)
    for f, row in enumerate(flat):
        a = np.concatenate([np.zeros(3, np.int16), row[:-3]])
        c = np.concatenate([np.zeros(3, np.int16), prev[:-3]])
        pr = [np.zeros(27, np.int16), a, prev, (a + prev) // 2][f] \
            if f < 4 else None
        if f == 4:
            pp = a + prev - c
            pa, pb, pc = abs(pp - a), abs(pp - prev), abs(pp - c)
            pr = np.where((pa <= pb) & (pa <= pc), a,
                          np.where(pb <= pc, prev, c))
        enc.append(((row - pr) % 256).astype(np.uint8).tobytes())
        prev = row
    p = tmp_path / "filters.png"
    p.write_bytes(_handmade(9, 5, 8, 2, enc, range(5)))
    np.testing.assert_array_equal(png.read_png(str(p)), img)
    np.testing.assert_array_equal(cv2.imread(str(p))[:, :, ::-1], img)
    p.write_bytes(_handmade(9, 5, 8, 2, enc, range(5), interlace=1))
    with pytest.raises(png.PNGError, match="interlaced"):
        png.read_png(str(p))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_dataload_png_matches_jax(tmp_path, channels):
    """dataload(.png): JAX's cv2.imread(IMREAD_UNCHANGED) with BGR(A)
    reversed, dtype and channel order, 8 and 16 bits."""
    for dtype in (np.uint8, np.uint16):
        shape = (9, 11) + ((channels,) if channels > 1 else ())
        p = str(tmp_path / "x.png")
        png.write_png(p, _img(shape, dtype, channels))
        ref, got = j_io.dataload(p), t_io.dataload(p)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(FileNotFoundError):
        t_io.dataload(str(tmp_path / "missing.png"))


# ---------------------------------------------------------- visualization
def _triplet(seed=4):
    rng = np.random.default_rng(seed)
    hr = rng.random((24, 32, 3)).astype(np.float32)
    lr = np.clip(hr + rng.normal(0, 0.1, hr.shape), 0, 1).astype(np.float32)
    dn = np.clip(hr + rng.normal(0, 0.02, hr.shape), 0, 1).astype(np.float32)
    return lr, dn, hr


def test_quality_assess_and_helpers_match_jax():
    lr, dn, hr = _triplet()
    for args in ((dn, hr, 1.0), (j_viz.scale_up(dn), j_viz.scale_up(hr))):
        ref, got = j_viz.quality_assess(*args), t_viz.quality_assess(*args)
        for key in ("PSNR", "SSIM"):
            assert abs(got[key] - ref[key]) < 1e-4, key
    np.testing.assert_array_equal(t_viz.scale_up(dn), j_viz.scale_up(dn))
    np.testing.assert_array_equal(t_viz.scale_down(j_viz.scale_up(dn)),
                                  j_viz.scale_down(j_viz.scale_up(dn)))
    b = np.stack([dn, hr])
    for video in (False, True):
        np.testing.assert_array_equal(
            t_viz.tensor2im(torch.from_numpy(b), video),
            j_viz.tensor2im(b, video))


def test_plot_sample_matches_jax(tmp_path):
    """The same (psnr, ssim, filename), the denoised PNG's pixels equal
    to those JAX writes through cv2, and the triptych JPEG written."""
    lr, dn, hr = _triplet(5)
    ref = j_viz.plot_sample(lr, dn, hr, "s", epoch=3,
                            save_path=str(tmp_path / "j"))
    got = t_viz.plot_sample(lr, dn, hr, "s", epoch=3,
                            save_path=str(tmp_path / "t"))
    assert got[2] == ref[2] == "s"
    np.testing.assert_allclose(got[0], ref[0], atol=1e-4)
    np.testing.assert_allclose(got[1], ref[1], atol=1e-4)
    np.testing.assert_array_equal(
        png.read_png(str(tmp_path / "t" / "s_denoised.png")),
        cv2.imread(str(tmp_path / "j" / "s_denoised.png"))[:, :, ::-1])
    assert os.path.getsize(tmp_path / "t" / "s-Epoch3.jpg") > 0
    res = (20.0, 0.5, 30.0, 0.9)
    assert t_viz.plot_sample(lr, dn, hr, save_plot=False, res=res,
                             save_path=str(tmp_path / "n"))[:2] == \
        ([20.0, 30.0, -1], [0.5, 0.9, -1])


def test_plot_sample_without_matplotlib_raises_first(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    lr, dn, hr = _triplet(6)
    with pytest.raises(ImportError, match="matplotlib"):
        t_viz.plot_sample(lr, dn, hr, save_path=str(tmp_path / "p"))
    assert os.listdir(tmp_path / "p") == []


# --------------------------------------------------------------- debugger
def test_algo_debugger_sweep_matches_jax(tmp_path):
    """The same results dict and the same PNG pixels (cv2 takes a colour
    result's channels as BGR), for a gray and a colour function."""
    img = np.random.default_rng(7).random((16, 20, 3)).astype(np.float32)

    def color(x, gain, off):
        return x * gain + off

    def gray(x, gain, off):
        return (x[..., 0] * gain + off) * 3.0        # over 1.5: rescaled

    for fn in (color, gray):
        grid = {"gain": [1, 2], "off": [0, 1]}
        scale = {"off": 0.25}
        outs = {}
        for side, cls in (("j", j_debugger.AlgoDebugger),
                          ("t", t_debugger.AlgoDebugger)):
            d = cls(fn, img, {"gain": (4, 1), "off": (4, 0)}, scale)
            outs[side] = d.sweep(grid, out_dir=str(tmp_path / side /
                                                   fn.__name__))
        assert list(outs["t"]) == list(outs["j"])
        for k in outs["j"]:
            np.testing.assert_array_equal(outs["t"][k], outs["j"][k])
        names = sorted(os.listdir(tmp_path / "j" / fn.__name__))
        assert names == sorted(os.listdir(tmp_path / "t" / fn.__name__))
        assert len(names) == 4
        for n in names:
            a = cv2.imread(str(tmp_path / "j" / fn.__name__ / n),
                           cv2.IMREAD_UNCHANGED)
            b = png.read_png(str(tmp_path / "t" / fn.__name__ / n))
            np.testing.assert_array_equal(b, a[:, :, ::-1] if a.ndim == 3
                                          else a)


def test_algo_debugger_interactive_needs_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    d = t_debugger.AlgoDebugger(lambda x: x, np.zeros((4, 4)), {})
    with pytest.raises(ImportError, match="cv2"):
        d.interactive()


# -------------------------------------------------------------- profiling
def test_profiling_counters_and_trace(tmp_path):
    """A span is a no-op with no profiler running and lands in trace's
    CPU Chrome-trace JSON as `yondx.<name>`, beside the ops it holds;
    trace raises for the card where there is none."""
    with t_prof.span("idle"):
        pass
    with t_prof.trace(str(tmp_path / "tr"), device="cpu") as d:
        with t_prof.span("stage"):
            torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    assert d == str(tmp_path / "tr")
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(d, files[0])) as fh:
        text = fh.read()
    assert "aten::mm" in text and "yondx.stage" in text
    assert "yondx.idle" not in text
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="card"):
            with t_prof.trace(str(tmp_path / "c")):
                pass


def test_set_logfile_matches_jax(tmp_path, capsys):
    for side, mod in (("j", j_logging), ("t", t_logging)):
        path = str(tmp_path / side / "log.txt")
        mod.set_logfile(path)
        try:
            mod.log("line one", notime=True)
            mod.log("line two", logfile=str(tmp_path / side / "other.txt"),
                    notime=True)
        finally:
            mod.set_logfile(None)
        mod.log("line three", notime=True)
    for name in ("log.txt", "other.txt"):
        a = (tmp_path / "j" / name).read_text()
        assert (tmp_path / "t" / name).read_text() == a
    assert (tmp_path / "t" / "log.txt").read_text() == "line one\n"


# ------------------------------------------------------------ trainer dump
def test_trainer_sample_dump_matches_jax(tmp_path):
    """One training sample (RGGB planes of a CFA turned by 1, float32 wb
    and CCM, as the train step hands it): the PNG of the port's
    _dump_temp_sample equal to JAX's."""
    rng = np.random.default_rng(9)
    hr = rng.random((16, 20, 4)).astype(np.float32)
    noisy = np.clip(hr + rng.normal(0, 0.05, hr.shape), 0, 1).astype(
        np.float32)
    pred = np.clip(hr + rng.normal(0, 0.01, hr.shape), 0, 1).astype(
        np.float32)
    wb = np.array([2.1, 1.0, 1.0, 1.7], np.float32)
    ccm = (np.eye(3) + rng.normal(0, 0.1, (3, 3))).astype(np.float32)
    for side, cls, conv in (
            ("j", j_trainer.AWGNTrainer, jnp.asarray),
            ("t", t_trainer.AWGNTrainer, torch.from_numpy)):
        me = types.SimpleNamespace(sample_dir=str(tmp_path / side),
                                   logfile=str(tmp_path / f"{side}.log"))
        sample = tuple(conv(a) for a in (noisy, pred, hr, wb, ccm,
                                         np.array(1, np.int32)))
        cls._dump_temp_sample(me, sample, epoch=7, pf=5)
    j_file = tmp_path / "j" / "temp" / "temp_0005.png"
    t_file = tmp_path / "t" / "temp" / "temp_0005.png"
    got = png.read_png(str(t_file))
    assert got.shape == (120, 32, 3)     # the mosaic turned back by 3
    np.testing.assert_array_equal(got, cv2.imread(str(j_file))[:, :, ::-1])
    assert not (tmp_path / "t.log").exists()       # nothing was skipped


# ------------------------------------------------------------- SIDD sRGB
def test_sidd_srgb_branch_matches_jax(tmp_path, monkeypatch):
    """_score_scene with save_plot and metadata: psnr_rgb / ssim_rgb per
    round and their means within 1e-3 of JAX's, and every PNG's pixels
    equal to those JAX writes."""
    rng = np.random.default_rng(10)
    hr = (rng.random((3, 32, 32)) * 0.6 + 0.2).astype(np.float32)
    dns = [np.clip(hr + rng.normal(0, s, hr.shape), 0, 1).astype(np.float32)
           for s in (0.03, 0.01)]
    meta = {"bayer_2by2": [[2, 3], [1, 2]], "wb": [0.45, 1.0, 0.7],
            "cst2": np.eye(3) * 0.85 + 0.05}
    hs = {}
    for side, cls in (("j", j_sidd.SIDDEvalHarness),
                      ("t", t_sidd.SIDDEvalHarness)):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        h = cls(None, None, "srgb", max_iter=1, save_plot=True,
                sample_dir=str(tmp_path / side / "img"),
                logfile=str(tmp_path / side / "log"))
        h._score_scene("0007_x", dns, dns[0], hr, meta)
        hs[side] = h
    rj, rt = hs["j"].metrics["0007_x"], hs["t"].metrics["0007_x"]
    for key in ("psnr_rgb", "ssim_rgb", "psnr", "ssim"):
        np.testing.assert_allclose(rt[key], rj[key], rtol=0, atol=1e-3)
    for it in (0, 1, -1):
        assert abs(hs["t"].psnrs_rgb[it].avg - hs["j"].psnrs_rgb[it].avg) \
            < 1e-3
    names = sorted(os.listdir(tmp_path / "j" / "img"))
    assert names == sorted(os.listdir(tmp_path / "t" / "img"))
    for n in names:
        np.testing.assert_array_equal(
            png.read_png(str(tmp_path / "t" / "img" / n)),
            cv2.imread(str(tmp_path / "j" / "img" / n))[:, :, ::-1])


# ----------------------------------------------------------------- native
def test_native_filters_bit_equal():
    rng = np.random.default_rng(11)
    x = rng.random((37, 41, 3)).astype(np.float32)
    g = rng.random((30, 20)).astype(np.float32)
    for img, k in ((x, 7), (g, 29)):
        np.testing.assert_array_equal(t_native.box_mean(img, k),
                                      j_native.box_mean(img, k))
        for a, b in zip(t_native.local_moments(img, k),
                        j_native.local_moments(img, k)):
            np.testing.assert_array_equal(a, b)
    s = (rng.random(100) * 30).astype(np.float32)
    np.testing.assert_array_equal(t_native.bilateral_row(s, 25, 10.0, 2.0),
                                  j_native.bilateral_row(s, 25, 10.0, 2.0))


# ----------------------------------------------------------------- blocks
def _flax_vs_port(fmod, tmod, x_nhwc, *extra):
    """flax init on x, its weights converted into the port's module, both
    forwards: port (NCHW) against flax (NHWC)."""
    params = fmod.init(jax.random.PRNGKey(0), jnp.asarray(x_nhwc),
                       *(jnp.asarray(e) for e in extra))
    ref = np.asarray(fmod.apply(params, jnp.asarray(x_nhwc),
                                *(jnp.asarray(e) for e in extra)))
    sd = params_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    missing = tmod.load_state_dict(sd, strict=True)
    assert not missing.missing_keys and not missing.unexpected_keys
    with torch.no_grad():
        got = tmod(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2))
    return got.permute(0, 2, 3, 1).numpy(), ref


def test_attention_and_upsample_blocks_match_flax():
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 12, 10, 32)).astype(np.float32)
    cases = [(j_blocks.ChannelAttention(), t_blocks.ChannelAttention(32)),
             (j_blocks.SpatialAttention(), t_blocks.SpatialAttention()),
             (j_blocks.CBAM(), t_blocks.CBAM(32)),
             (j_blocks.UpsampleBlock(16, 2, "bilinear"),
              t_blocks.UpsampleBlock(32, 16, 2, "bilinear")),
             (j_blocks.UpsampleBlock(16, 3, "pixel_shuffle"),
              t_blocks.UpsampleBlock(32, 16, 3, "pixel_shuffle"))]
    for fmod, tmod in cases:
        got, ref = _flax_vs_port(fmod, tmod, x)
        assert got.shape == ref.shape, type(tmod).__name__
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5,
                                   err_msg=type(tmod).__name__)
    mask = rng.random((2, 12, 10, 3)).astype(np.float32)
    for sf in (1, 2):
        ref = np.asarray(j_blocks.mask_mul(jnp.asarray(x),
                                           jnp.asarray(mask), sf)) \
            if sf == 1 else None
        tx = torch.from_numpy(x).permute(0, 3, 1, 2)
        tm = torch.from_numpy(mask).permute(0, 3, 1, 2)
        if sf == 1:
            got = t_blocks.mask_mul(tx, tm, 1).permute(0, 2, 3, 1).numpy()
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
        else:
            xs = x[:, ::2, ::2]
            ref = np.asarray(j_blocks.mask_mul(jnp.asarray(xs),
                                               jnp.asarray(mask), 2))
            got = t_blocks.mask_mul(tx[:, :, ::2, ::2], tm, 2)
            np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                                       rtol=0, atol=1e-6)

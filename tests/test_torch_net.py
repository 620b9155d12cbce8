"""yondx_torch checkpoint reader, weight conversion and SNR-Net against
flax (CPU, fp32), plus the no-silent-CPU rule of the port's entry points.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import msgpack
import pytest
import torch
from flax import serialization

from yondx.models import build_model

import yondx_torch
from yondx_torch.io import ckpt as t_ckpt
from yondx_torch.models.convert import params_to_state_dict
from yondx_torch.models.unets import (S2DT16_ARCH, GuidedResUnetS2D,
                                      _d2s2, _s2d2, load_guided_s2d)
from torch_test_util import _two_torch_threads  # noqa: F401

CKPT_DIR = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                        "Gaussian")
S2DT = os.path.join(CKPT_DIR,
                    "Gaussian_GRUS2DT_mix_1to50c_norm_best_model.ckpt")
EST = os.path.join(CKPT_DIR, "EstPGE_d3nf16_last_model.ckpt")


def _assert_trees_byte_equal(a, b, path=""):
    assert isinstance(a, dict) and isinstance(b, dict), path
    assert set(a) == set(b), path
    for key in a:
        if isinstance(b[key], dict):
            _assert_trees_byte_equal(a[key], b[key], f"{path}/{key}")
        else:
            ra, rb = np.asarray(a[key]), np.asarray(b[key])
            assert ra.dtype == rb.dtype and ra.shape == rb.shape, path + key
            assert ra.tobytes() == rb.tobytes(), path + key


@pytest.mark.parametrize("path", [S2DT, EST], ids=["s2dt16", "estpge"])
def test_reader_gives_flax_params_byte_equal(path):
    with open(path, "rb") as f:
        ref = serialization.msgpack_restore(f.read())
    got = t_ckpt.load_checkpoint(path)
    assert "opt_state" not in got                 # skipped, not decoded
    _assert_trees_byte_equal(got["params"], ref["params"])
    assert got["epoch"] == ref["epoch"]
    assert got["best_psnr"] == ref["best_psnr"]


def test_reader_decodes_opt_state_when_not_skipped():
    with open(EST, "rb") as f:
        ref = serialization.msgpack_restore(f.read())
    with open(EST, "rb") as f:
        got = t_ckpt.read_msgpack(f.read())
    _assert_trees_byte_equal(got["opt_state"], ref["opt_state"])


def test_decoder_covers_the_msgpack_types():
    obj = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
                 2 ** 63 + 5, -1, -32, -33, -128, -129, -32768, -32769,
                 -2 ** 31 - 1, -2 ** 62],
        "floats": [0.5, -1.25e-30, 3.141592653589793],
        "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000],
        "bins": [b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 70000],
        "long": list(range(20)), "big": list(range(70000)),
        "map16": {str(i): i for i in range(20)},
        "none": None, "yes": True, "no": False,
    }
    blob = msgpack.packb(obj, use_bin_type=True)
    assert t_ckpt.read_msgpack(blob) == obj
    skipped = t_ckpt.read_msgpack(blob, skip_keys=("big", "bins", "map16"))
    assert set(skipped) == set(obj) - {"big", "bins", "map16"}
    f32 = msgpack.packb(1.5, use_single_float=True)
    assert t_ckpt.read_msgpack(f32) == 1.5
    arrays = {"a": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
              "b": np.array([[1, -2]], np.int64), "s": np.float32(2.5),
              "e": np.zeros((0, 3), np.float16)}
    got = t_ckpt.read_msgpack(serialization.msgpack_serialize(arrays))
    for key, val in arrays.items():
        assert np.asarray(got[key]).dtype == np.asarray(val).dtype
        np.testing.assert_array_equal(got[key], val)


def test_find_checkpoint_order(tmp_path):
    assert t_ckpt.find_checkpoint(str(tmp_path), "m") is None
    (tmp_path / "m_last_model.ckpt").write_bytes(b"")
    assert t_ckpt.find_checkpoint(str(tmp_path), "m").endswith("_last_model"
                                                               ".ckpt")
    (tmp_path / "m_best_model.ckpt").write_bytes(b"")
    assert t_ckpt.find_checkpoint(str(tmp_path), "m").endswith("_best_model"
                                                               ".ckpt")


def test_s2d_channel_order_matches_nhwc():
    x = np.random.default_rng(0).random((2, 8, 12, 3)).astype(np.float32)
    ref = x.reshape(2, 4, 2, 6, 2, 3).transpose(0, 1, 3, 2, 4, 5) \
        .reshape(2, 4, 6, 12)
    got = _s2d2(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), ref)
    back = _d2s2(_s2d2(torch.from_numpy(x).permute(0, 3, 1, 2)))
    np.testing.assert_array_equal(back.permute(0, 2, 3, 1).numpy(), x)


def _net_vs_flax(variables, arch, seed):
    model = build_model(dict(arch))
    net = GuidedResUnetS2D(arch)
    net.load_state_dict(params_to_state_dict(variables), strict=True)
    net.eval()
    rng = np.random.default_rng(seed)
    x = rng.random((2, 64, 96, 4)).astype(np.float32)
    t = np.array([0.03, 0.11], np.float32)
    ref = np.asarray(model.apply(variables, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    return got, ref


def _random_init(model, seed):
    """flax random init (at a 32x32 dummy input) as numpy leaves."""
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                    np.zeros((1, 32, 32, 4), np.float32),
                                    np.full((1,), 0.1, np.float32))
    return jax.tree_util.tree_map(np.array, variables)


def _randomized(tree, rng):
    """The same flax tree with every leaf redrawn (He-like scale)."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _randomized(val, rng)
        else:
            fan_in = int(np.prod(val.shape[:-1])) if val.ndim > 1 else 64
            out[key] = rng.normal(0, (1.0 / fan_in) ** 0.5,
                                  val.shape).astype(np.float32)
    return out


def test_net_matches_flax_on_committed_checkpoint():
    variables = t_ckpt.load_checkpoint(S2DT)["params"]
    got, ref = _net_vs_flax(variables, S2DT16_ARCH, 1)
    # fp32 convs summed in a different order (oneDNN vs XLA), 14 layers
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_net_matches_flax_on_random_weights():
    """Random weights in the flax layout: the committed tree with every
    leaf redrawn (the tail's zero-init conv included), and a flax random
    init of the 1x1-head, tail-less variant (out_k=1)."""
    rng = np.random.default_rng(4)
    variables = _randomized(t_ckpt.load_checkpoint(S2DT)["params"], rng)
    got, ref = _net_vs_flax(variables, S2DT16_ARCH, 2)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    arch1 = {k: v for k, v in S2DT16_ARCH.items()
             if k not in ("tail_nf", "out_k")}
    arch1["nf"] = 16
    got, ref = _net_vs_flax(_random_init(build_model(arch1), 5), arch1, 3)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    from yondx_torch.pipeline.fused import make_fused_blind_denoiser
    from yondx_torch.vst.lut import BiasLUT
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        yondx_torch.resolve_device()
    with pytest.raises(RuntimeError):
        yondx_torch.resolve_device("cuda")
    assert yondx_torch.resolve_device("cpu").type == "cpu"
    lut = BiasLUT().lut
    with pytest.raises(RuntimeError):
        make_fused_blind_denoiser(torch.nn.Identity(), lut)
    with pytest.raises(RuntimeError):
        load_guided_s2d(S2DT)
    fn = make_fused_blind_denoiser(torch.nn.Identity(), lut, device="cpu",
                                   guided=False)
    assert callable(fn)

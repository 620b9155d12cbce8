"""The port's orbax checkpoints (yondx_torch/train/orbax_ckpt.py), its
OCDBT store (io/ocdbt.py) and its zstd decoder (csrc/zstd_host.cpp through
native.zstd_decompress), held to the JAX package, orbax, tensorstore and
zstandard on the CPU.

- the decoder byte for byte against `zstandard`'s compressor at levels 1,
  3 and 19 on random float32, zeros (RLE blocks), text, a payload over
  128 KiB (many blocks) and a frame with a checksum; two concatenated
  frames; a streamed frame without its content size; a hand-made frame
  with RLE literals; a corrupted byte, a dictionary ID and a skippable
  frame raise;
- OCDBT stores written by tensorstore (zstd nodes with interior levels,
  uncompressed nodes over 40 versions) read key for key, and a store the
  port writes read by tensorstore;
- a checkpoint of `yondx.train.orbax_ckpt.save` (params, an optax Adam
  state after one step, meta) loads in the port bit-equal, in the tree
  shape and leaf types of JAX's `load`, with and without a template; a
  checkpoint the port writes loads in JAX bit-equal, with and without a
  template;
- the committed fixture (scripts/torch_port_fixtures.py) loads bit-equal
  to its `.npz`, and the script's arrays still equal the committed ones.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import tensorstore as ts
import torch
import zstandard

from yondx.train import orbax_ckpt as j_orbax

from yondx_torch import native
from yondx_torch.io import ocdbt
from yondx_torch.train import orbax_ckpt as t_orbax

from torch_test_util import _one_torch_thread  # noqa: F401

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
FIXTURES = os.path.join(REPO, "tests", "data", "torch_port")
sys.path.insert(0, os.path.join(REPO, "scripts"))
import torch_port_fixtures as fixtures  # noqa: E402


def _payloads():
    rng = np.random.default_rng(3)
    with open(os.path.join(REPO, "README.md"), "rb") as f:
        text = f.read()
    return {"f32": rng.standard_normal(20000).astype(np.float32).tobytes(),
            "zeros": bytes(200000),
            "text": text,
            "big": rng.standard_normal(60000).astype(np.float32).tobytes()
            + text * 2,
            "binary": rng.integers(0, 4, 150000).astype(np.uint8).tobytes(),
            "tiny": b"hello"}


@pytest.mark.parametrize("level", [1, 3, 19])
def test_zstd_decoder_matches_zstandard(level):
    assert len(_payloads()["big"]) > 128 * 1024
    for name, p in _payloads().items():
        for kw in ({}, {"write_checksum": True},
                   {"write_content_size": False}):
            c = zstandard.ZstdCompressor(level=level, **kw).compress(p)
            assert native.zstd_decompress(c) == p, (name, kw)


def test_zstd_frames_streams_and_rle_literals():
    p = _payloads()
    two = zstandard.ZstdCompressor(level=3).compress(p["text"]) + \
        zstandard.ZstdCompressor(level=19, write_checksum=True).compress(
            p["f32"])
    assert native.zstd_decompress(two) == p["text"] + p["f32"]
    obj = zstandard.ZstdCompressor(level=5).compressobj()
    streamed = obj.compress(p["big"]) + obj.flush()
    assert native.zstd_decompress(streamed) == p["big"]
    # one compressed block: RLE literals "A" x 10, no sequences
    frame = b"\x28\xb5\x2f\xfd\x20\x0a\x1d\x00\x00\x51\x41\x00"
    assert native.zstd_decompress(frame) == \
        zstandard.ZstdDecompressor().decompress(frame) == b"A" * 10
    assert native.zstd_decompress(zstandard.compress(b"")) == b""


def test_zstd_decoder_raises_on_corrupt_and_unsupported_frames():
    c = bytearray(zstandard.ZstdCompressor(level=3, write_checksum=True)
                  .compress(_payloads()["text"]))
    for i in (0, 5, len(c) // 2, len(c) - 2):
        bad = bytearray(c)
        bad[i] ^= 0x5A
        with pytest.raises(ValueError, match="zstd"):
            native.zstd_decompress(bytes(bad))
    with pytest.raises(ValueError, match="truncated"):
        native.zstd_decompress(bytes(c[:-7]))
    samples = [f"sample {i} of a dictionary corpus {i * 7}".encode() * 3
               for i in range(400)]
    d = zstandard.train_dictionary(1024, samples)
    framed = zstandard.ZstdCompressor(dict_data=d).compress(samples[5])
    with pytest.raises(ValueError, match="dictionary"):
        native.zstd_decompress(framed)
    skip = b"\x50\x2a\x4d\x18\x04\x00\x00\x00abcd"
    with pytest.raises(ValueError, match="skippable"):
        native.zstd_decompress(skip + zstandard.compress(b"x"))


def _ts_read(root):
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{root}/"}).result()
    return {k: kv.read(k).result().value for k in kv.list().result()}


@pytest.mark.parametrize("config", ["zstd-interior", "none-versions"])
def test_ocdbt_reads_tensorstore_stores(tmp_path, config):
    root = str(tmp_path / "s")
    rng = np.random.default_rng(4)
    if config == "zstd-interior":
        cfg = {"max_decoded_node_bytes": 400, "max_inline_value_bytes": 16,
               "compression": {"id": "zstd", "level": 3}}
    else:
        cfg = {"compression": None}
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/",
                          "config": cfg}).result()
    if config == "zstd-interior":
        with ts.Transaction() as txn:
            for i in range(120):
                v = rng.integers(0, 256, int(rng.integers(1, 60)))
                kv.with_transaction(txn)[f"key{i:04d}/.zarray".encode()] = \
                    v.astype(np.uint8).tobytes()
    else:
        for i in range(40):
            kv.write(f"k{i:03d}".encode(), bytes([i]) * (i * 10)).result()
    store = ocdbt.Store(root)
    want = _ts_read(root)
    assert store.keys() == sorted(want)
    assert ocdbt.read_all(root, store) == want
    if config == "zstd-interior":
        assert store.config.compression_method == 1
        assert store.config.zstd_level == 3
    else:
        assert store.generation >= 40


def test_ocdbt_writer_is_read_by_tensorstore(tmp_path):
    rng = np.random.default_rng(5)
    items = {f"p.{i}/.zarray".encode(): rng.integers(
        0, 256, int(rng.integers(0, 400))).astype(np.uint8).tobytes()
        for i in range(60)}
    items[b"empty"] = b""
    root = str(tmp_path / "w")
    ocdbt.write(root, items)
    assert _ts_read(root) == items
    assert ocdbt.read_all(root) == items
    with pytest.raises(FileExistsError):
        ocdbt.write(root, items)
    with open(os.path.join(root, "manifest.ocdbt"), "r+b") as f:
        f.seek(20)
        b = f.read(1)
        f.seek(20)
        f.write(bytes([b[0] ^ 1]))
    with pytest.raises(ocdbt.OcdbtError, match="CRC-32C"):
        ocdbt.Store(root)


# ----------------------------------------------------------- checkpoints
def _equal(a, b, where="tree"):
    """The same tree shape, leaf types, dtypes and bytes."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (where, type(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}/{i}")
    elif a is None:
        assert b is None, where
    elif isinstance(a, (bool, int, float)):
        assert type(a) is type(b) and a == b, (where, a, b)
    else:
        assert type(b) is np.ndarray, (where, type(b))
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where


def _jax_state():
    params = fixtures.conv_params(seed=21)
    state = fixtures.adam_state(params)
    return params, state


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    params, state = _jax_state()
    path = str(tmp_path / "ck")
    j_orbax.save(path, jax.tree_util.tree_map(jnp.asarray, params), state,
                 epoch=3, best_psnr=30.5)
    ref, got = j_orbax.load(path), t_orbax.load(path)
    _equal(ref, got)
    assert isinstance(got["opt_state"], list) and got["opt_state"][1] is None
    assert set(got["opt_state"][0]) == {"count", "mu", "nu"}
    assert type(got["meta"]["epoch"]) is int
    # with a template: the template's structure (optax's NamedTuples)
    tmpl = {"params": params, "opt_state": state,
            "meta": {"epoch": 0, "best_psnr": 0.0}}
    ref_t, got_t = j_orbax.load(path, tmpl), t_orbax.load(path, tmpl)
    _equal(ref_t, got_t)
    assert type(got_t["opt_state"][0]) is type(state[0])
    # torch leaves in a template come back as host tensors
    tt = t_orbax.load(path, {"params": jax.tree_util.tree_map(
        torch.from_numpy, params)})
    w = tt["params"]["conv_in"]["kernel"]
    assert isinstance(w, torch.Tensor) and w.device.type == "cpu"
    assert w.numpy().tobytes() == params["conv_in"]["kernel"].tobytes()


def test_port_checkpoint_loads_in_jax(tmp_path):
    params, state = _jax_state()
    ref_path = str(tmp_path / "jax")
    j_orbax.save(ref_path, params, state, epoch=3, best_psnr=30.5)
    path = str(tmp_path / "port")
    os.makedirs(path)                                 # save removes it
    t_orbax.save(path, jax.tree_util.tree_map(torch.from_numpy, params),
                 state, epoch=3, best_psnr=30.5)
    with open(os.path.join(path, "_METADATA")) as f:
        meta = f.read()
    with open(os.path.join(ref_path, "_METADATA")) as f:
        assert meta == f.read()                      # key types included
    _equal(j_orbax.load(ref_path), j_orbax.load(path))
    tmpl = {"params": params, "opt_state": state,
            "meta": {"epoch": 0, "best_psnr": 0.0}}
    _equal(j_orbax.load(ref_path, tmpl), j_orbax.load(path, tmpl))
    _equal(j_orbax.load(path), t_orbax.load(path))
    # no optimizer state: None, as JAX writes and reads it
    t_orbax.save(path, params, epoch=1)
    assert j_orbax.load(path)["opt_state"] is None is \
        t_orbax.load(path)["opt_state"]


def _get(tree, key):
    for k in key.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def test_committed_orbax_fixture_loads_bit_equal(tmp_path):
    want = np.load(os.path.join(FIXTURES, "expected.npz"))
    got = t_orbax.load(os.path.join(FIXTURES, "orbax"))
    keys = [k for k in want.files if not k.startswith("dnd/")]
    assert len(keys) == 21
    for k in keys:
        a = np.asarray(_get(got, k))
        assert a.dtype == want[k].dtype and a.tobytes() == want[k].tobytes()
    _equal(j_orbax.load(os.path.join(FIXTURES, "orbax")), got)
    # the script still makes the committed arrays
    params = fixtures.conv_params()
    fresh = fixtures.expected(params, fixtures.adam_state(params))
    assert sorted(fresh) == sorted(want.files)
    for k in want.files:
        assert fresh[k].dtype == want[k].dtype, k
        assert np.asarray(fresh[k]).tobytes() == want[k].tobytes(), k

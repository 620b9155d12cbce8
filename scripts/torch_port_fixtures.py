"""Write the small files that let the port's readers be checked where
neither JAX nor h5py is installed (the card machine):

    python3 scripts/torch_port_fixtures.py [--out tests/data/torch_port]

- `orbax/`: a checkpoint written by `yondx.train.orbax_ckpt.save` (JAX,
  orbax): a three-layer conv net's params, optax Adam's state after one
  step, and meta. Its chunks are zstd frames (orbax's zarr compressor).
- `dnd/`: a DND-layout tree of MATLAB v7.3 files, each HDF5 behind a
  512-byte MATLAB user block: `images_raw/0001.mat` (key `Inoisy`,
  chunked with deflate), `images_raw/0002.mat` (contiguous) and
  `info.mat`, whose `info/boundingboxes` holds object references to each
  image's boxes in `#refs#`.
- `expected.npz`: every array of both, as numpy gives it (`params/...`,
  `opt_state/0/{count,mu,nu}/...`, `meta/{epoch,best_psnr}`,
  `dnd/{0001,0002}` as the reader returns them, `dnd/boxes_{0,1}`).

Everything is drawn from SEED, so a second run writes the same arrays
(tests/test_torch_orbax.py and tests/test_torch_hdf5.py check the
committed files against a fresh run). Needs JAX, optax, orbax and h5py.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "torch_port")
SEED = 16
DND_SHAPE = (160, 224)          # H, W of each frame (DND's are 3472x4624)
DND_BOX = 64                    # box side (DND's are 512)
EPOCH, BEST_PSNR = 7, 38.25


def conv_params(seed: int = SEED) -> dict:
    """A three-layer conv net's params (flax's HWIO kernels), float32."""
    rng = np.random.default_rng(seed)
    shapes = {"conv_in": (3, 3, 4, 16), "conv_mid": (3, 3, 16, 16),
              "conv_out": (3, 3, 16, 4)}
    out = {}
    for name, s in shapes.items():
        fan_in = s[0] * s[1] * s[2]
        out[name] = {"kernel": (rng.standard_normal(s) / np.sqrt(fan_in))
                     .astype(np.float32),
                     "bias": (0.01 * rng.standard_normal(s[-1]))
                     .astype(np.float32)}
    return out


def dnd_arrays(seed: int = SEED):
    """Two noisy frames in [0, 1] (float32 [H, W]) and each frame's boxes
    (float64 [2, 4], 1-indexed [y0, x0, y1, x1], as DND's info.mat)."""
    rng = np.random.default_rng(seed + 1)
    H, W = DND_SHAPE
    yy, xx = np.mgrid[0:H, 0:W] / np.array([H, W])[:, None, None]
    frames, boxes = [], []
    for i in range(2):
        clean = 0.15 + 0.5 * (0.5 + 0.5 * np.sin(6 * xx + 3 * i) * yy)
        noisy = clean + rng.normal(0, np.sqrt(2e-3 * clean + 5e-5))
        frames.append(np.clip(noisy, 0, 1).astype(np.float32))
        b = DND_BOX
        boxes.append(np.array([[17 + 8 * i, 33, 16 + 8 * i + b, 32 + b],
                               [81, 97 + 16 * i, 80 + b, 96 + 16 * i + b]],
                              np.float64))
    return frames, boxes


def matlab_userblock() -> bytes:
    """MATLAB v7.3's 512-byte user block: the text header, version 0x0200
    and the 'IM' endian mark at bytes 124-127 (scipy.io.loadmat reads
    them and raises NotImplementedError), then zeros."""
    text = (b"MATLAB 7.3 MAT-file, Platform: GLNXA64, Created on: Thu Jan  1"
            b" 00:00:00 1970 HDF5 schema 1.00 .")
    head = text.ljust(116, b" ") + b"\x00" * 8 + b"\x00\x02" + b"IM"
    return head.ljust(512, b"\x00")


def _stamp(path: str) -> None:
    with open(path, "r+b") as f:
        f.write(matlab_userblock())


def write_dnd(root: str) -> None:
    import h5py
    frames, boxes = dnd_arrays()
    os.makedirs(os.path.join(root, "images_raw"), exist_ok=True)
    for i, frame in enumerate(frames):
        path = os.path.join(root, "images_raw", f"{i + 1:04d}.mat")
        kw = dict(chunks=(56, 40), compression="gzip", compression_opts=3) \
            if i == 0 else {}
        with h5py.File(path, "w", userblock_size=512) as f:
            d = f.create_dataset("Inoisy", data=frame.T, **kw)
            d.attrs["MATLAB_class"] = np.bytes_("single")
        _stamp(path)
    path = os.path.join(root, "info.mat")
    with h5py.File(path, "w", userblock_size=512) as f:
        refs_group = f.create_group("#refs#")
        refs = []
        for i, b in enumerate(boxes):
            d = refs_group.create_dataset("ab"[i], data=b.T)   # MATLAB's
            d.attrs["MATLAB_class"] = np.bytes_("double")      # layout
            refs.append(d.ref)
        info = f.create_group("info")
        info.attrs["MATLAB_class"] = np.bytes_("struct")
        info.create_dataset("boundingboxes", data=np.array(
            refs, dtype=h5py.ref_dtype).reshape(1, len(refs)))
    _stamp(path)


def adam_state(params: dict):
    """optax.adam(1e-3)'s state after one step from `params`, with the
    gradient 0.1 * params + 0.01."""
    import jax
    import jax.numpy as jnp
    import optax
    p = jax.tree_util.tree_map(jnp.asarray, params)
    tx = optax.adam(1e-3)
    state = tx.init(p)
    grads = jax.tree_util.tree_map(lambda x: 0.1 * x + 0.01, p)
    _, state = tx.update(grads, state, p)
    return jax.tree_util.tree_map(np.asarray, state)


def write_orbax(path: str):
    sys.path.insert(0, REPO)
    from yondx.train import orbax_ckpt
    params = conv_params()
    state = adam_state(params)
    orbax_ckpt.save(path, params, state, epoch=EPOCH, best_psnr=BEST_PSNR)
    return params, state


def expected(params: dict, state) -> dict:
    out = {}
    for name, layer in params.items():
        for k, v in layer.items():
            out[f"params/{name}/{k}"] = v
    adam = state[0]
    out["opt_state/0/count"] = np.asarray(adam.count)
    for part in ("mu", "nu"):
        for name, layer in getattr(adam, part).items():
            for k, v in layer.items():
                out[f"opt_state/0/{part}/{name}/{k}"] = np.asarray(v)
    out["meta/epoch"] = np.asarray(EPOCH, np.int64)
    out["meta/best_psnr"] = np.asarray(BEST_PSNR, np.float64)
    frames, boxes = dnd_arrays()
    for i, (f, b) in enumerate(zip(frames, boxes)):
        out[f"dnd/{i + 1:04d}"] = f
        out[f"dnd/boxes_{i}"] = b
    return out


def write_all(out: str) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    if os.path.exists(out):
        shutil.rmtree(out)
    os.makedirs(out)
    params, state = write_orbax(os.path.join(out, "orbax"))
    write_dnd(os.path.join(out, "dnd"))
    np.savez_compressed(os.path.join(out, "expected.npz"),
                        **expected(params, state))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=OUT)
    write_all(os.path.abspath(ap.parse_args().out))

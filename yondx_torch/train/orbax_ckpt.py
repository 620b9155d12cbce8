"""Orbax checkpoints, read and written without orbax (port of
yondx/train/orbax_ckpt.py).

`save(path, params, opt_state, epoch, best_psnr)` writes the tree
{"params", "opt_state", "meta": {"epoch", "best_psnr"}} as orbax's
StandardCheckpointer lays it out: `_CHECKPOINT_METADATA`, `_METADATA`
(the tree's keys, `key_type` 1 for a sequence index and 2 for a dict key,
and each leaf's value type) and an OCDBT store (`io/ocdbt.py`) holding one
zarr v2 array per leaf, `<keys joined by ".">/.zarray` and its chunk, with
no compressor. `load(path, template=None)` reads a checkpoint that orbax
or this module wrote; orbax's chunks are zstd frames, which the port's own
decoder (`native.zstd_decompress`) reads.

Leaves are numpy arrays, torch tensors (copied to the host) and Python
scalars; None and empty containers are kept as orbax keeps them. Without
a template `load` returns what orbax's restore returns: dicts, lists for
sequences (a tuple or NamedTuple comes back as a list or dict), None for
an empty state, numpy arrays and Python scalars as leaves. With a
template it returns the template's structure, each leaf of the kind of
the template's (numpy array, torch tensor on the host or Python scalar).
Host I/O only, as in the JAX package: nothing goes to a device.
"""
from __future__ import annotations

import itertools
import json
import os
import shutil
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..io import ocdbt

_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
            "StandardCheckpointHandler")
_EMPTY = {"None": None, "Dict": dict, "List": list, "Tuple": tuple,
          "NamedTuple": None}
SEQUENCE, DICT = 1, 2


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, keys: Tuple = ()):
    """-> [(keys, key_types, leaf or empty-type name)] in orbax's order."""
    if _is_namedtuple(tree) and tree:
        items = [(f, DICT, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict) and tree:
        items = [(str(k), DICT, tree[k]) for k in sorted(tree)]   # as JAX
    elif isinstance(tree, (list, tuple)) and tree and \
            not _is_namedtuple(tree):
        items = [(str(i), SEQUENCE, v) for i, v in enumerate(tree)]
    else:
        return [(keys, tree)]
    out = []
    for k, kt, v in items:
        out += _flatten(v, keys + ((k, kt),))
    return out


def _empty_type(x) -> Optional[str]:
    if x is None:
        return "None"
    if _is_namedtuple(x) and not x:
        return "None"
    for name, t in (("List", list), ("Tuple", tuple), ("Dict", dict)):
        if isinstance(x, t) and not x:
            return name
    return None


def _as_array(x) -> Tuple[np.ndarray, str]:
    """(host array, orbax value type) of a leaf."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise TypeError("bfloat16 leaves are not written (numpy has no "
                            "bfloat16)")
        return x.detach().cpu().contiguous().numpy(), "np.ndarray"
    if isinstance(x, (bool, int, float)) and not isinstance(x, np.generic):
        dt = np.bool_ if isinstance(x, bool) else \
            np.int64 if isinstance(x, int) else np.float64
        return np.asarray(x, dt), "scalar"
    if isinstance(x, (np.ndarray, np.generic)):
        return np.asarray(x), "np.ndarray"
    raise TypeError(f"unsupported checkpoint leaf {type(x).__name__}")


def _zarray(a: np.ndarray) -> bytes:
    dt = a.dtype
    if dt.kind not in "biuf" or dt.byteorder == ">":
        raise TypeError(f"unsupported dtype {dt}")
    meta = {"chunks": list(a.shape), "compressor": None,
            "dimension_separator": ".", "dtype": dt.str,
            "fill_value": None, "filters": None, "order": "C",
            "shape": list(a.shape), "zarr_format": 2}
    return json.dumps(meta, separators=(",", ":"), sort_keys=True).encode()


def _chunk_key(idx, sep: str = ".") -> str:
    """zarr v2's key of the chunk at grid index `idx` ("0" for a 0-d
    array)."""
    return sep.join(str(i) for i in idx) if len(idx) else "0"


def save(path: str, params: Any, opt_state: Any = None, epoch: int = 0,
         best_psnr: float = 0.0) -> None:
    path = os.path.abspath(path)
    state = {"params": params, "opt_state": opt_state,
             "meta": {"epoch": epoch, "best_psnr": best_psnr}}
    t0 = time.time_ns()
    items, tree_meta = {}, {}
    for keys, leaf in _flatten(state):
        names = tuple(k for k, _ in keys)
        km = [{"key": k, "key_type": kt} for k, kt in keys]
        empty = _empty_type(leaf)
        if empty is not None:
            vm = {"value_type": empty, "skip_deserialize": True}
        else:
            arr, vtype = _as_array(leaf)
            name = ".".join(names)
            items[f"{name}/.zarray".encode()] = _zarray(arr)
            items[f"{name}/{_chunk_key((0,) * arr.ndim)}".encode()] = \
                np.ascontiguousarray(arr).tobytes()
            vm = {"value_type": vtype, "skip_deserialize": False}
        tree_meta[str(names)] = {"key_metadata": km, "value_metadata": vm}
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    ocdbt.write(path, items)
    meta = {"tree_metadata": tree_meta, "use_ocdbt": True,
            "use_zarr3": False, "store_array_data_equal_to_fill_value": True,
            "custom_metadata": None}
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump(meta, f)
    ck = {"item_handlers": _HANDLER, "metrics": {},
          "performance_metrics": {}, "init_timestamp_nsecs": t0,
          "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {}}
    with open(os.path.join(path, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump(ck, f)


def _read_array(store: ocdbt.Store, name: str) -> np.ndarray:
    meta = json.loads(store.read(f"{name}/.zarray".encode()))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr_format {meta.get('zarr_format')} "
                         "(only 2 is read)")
    if meta.get("filters"):
        raise ValueError(f"{name}: zarr filters {meta['filters']} are not "
                         "read")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{name}: zarr order {meta['order']} is not read")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{name}: zarr compressor {comp.get('id')} (none "
                         "and zstd are read)")
    try:
        dt = np.dtype(meta["dtype"])
    except TypeError as e:
        raise ValueError(f"{name}: zarr dtype {meta['dtype']} is not "
                         "read") from e
    if dt.kind not in "biuf":
        raise ValueError(f"{name}: zarr dtype {meta['dtype']} is not read")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value")
    out = np.full(shape, 0 if fill is None else fill, dt)
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        key = f"{name}/{_chunk_key(idx, sep)}".encode()
        if key not in store:
            continue
        raw = store.read(key)
        if comp is not None:
            from .. import native
            raw = native.zstd_decompress(raw)
        block = np.frombuffer(raw, dt)
        if block.size != int(np.prod(chunks)):
            raise ValueError(f"{key.decode()}: {block.size} values, chunk "
                             f"holds {int(np.prod(chunks))}")
        block = block.reshape(chunks)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
    return out


def _leaf(store: ocdbt.Store, names, vtype: str):
    if vtype in _EMPTY:
        t = _EMPTY[vtype]
        return None if t is None else t()
    if vtype not in ("np.ndarray", "jax.Array", "scalar"):
        raise ValueError(f"{'.'.join(names)}: value type {vtype} is not "
                         "read")
    arr = _read_array(store, ".".join(names))
    return arr.item() if vtype == "scalar" else arr


def load(path: str, template: Optional[Dict[str, Any]] = None):
    path = os.path.abspath(path)
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"{path}: only OCDBT with zarr v2 is read "
                         f"(use_ocdbt {meta.get('use_ocdbt')}, use_zarr3 "
                         f"{meta.get('use_zarr3')})")
    store = ocdbt.Store(path)
    entries = [v for v in meta["tree_metadata"].values()]
    if template is not None:
        types = {tuple(k["key"] for k in e["key_metadata"]):
                 e["value_metadata"]["value_type"] for e in entries}
        return _fill(template, (), store, types)
    root: Dict = {}
    for e in entries:
        km = e["key_metadata"]
        names = tuple(k["key"] for k in km)
        value = _leaf(store, names, e["value_metadata"]["value_type"])
        node = root
        for i, k in enumerate(km):
            last = i == len(km) - 1
            nxt = None if last else \
                ([] if km[i + 1]["key_type"] == SEQUENCE else {})
            if k["key_type"] == SEQUENCE:
                j = int(k["key"])
                node.extend([None] * (j + 1 - len(node)))
                if last:
                    node[j] = value
                else:
                    if node[j] is None:
                        node[j] = nxt
                    node = node[j]
            else:
                if last:
                    node[k["key"]] = value
                else:
                    node = node.setdefault(k["key"], nxt)
    return root


def _fill(t, names: Tuple, store: ocdbt.Store, types: Dict):
    """The template `t` with each leaf read from the checkpoint."""
    if _is_namedtuple(t) and t:
        return type(t)(*[_fill(getattr(t, f), names + (f,), store, types)
                         for f in t._fields])
    if isinstance(t, dict) and t:
        return type(t)((k, _fill(v, names + (str(k),), store, types))
                       for k, v in t.items())
    if isinstance(t, (list, tuple)) and t and not _is_namedtuple(t):
        return type(t)(_fill(v, names + (str(i),), store, types)
                       for i, v in enumerate(t))
    if _empty_type(t) is not None:
        return t
    if names not in types:
        raise KeyError(f"{'.'.join(names)}: not in the checkpoint")
    value = _leaf(store, names, types[names])
    if isinstance(t, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(value))
    if isinstance(t, (bool, int, float)) and not isinstance(t, np.generic):
        return np.asarray(value).item()
    return np.asarray(value)

"""The port's HDF5 reader (yondx_torch/io/hdf5.py) against h5py, and the
two readers built on it against the JAX package's, on the CPU:

- files the test writes with h5py, with and without a 512-byte user block:
  float64, float32, big-endian float64, int32, uint16 and int64 arrays and
  a scalar, contiguous, chunked, chunked with deflate, chunked with
  shuffle and deflate, and compact, at the root and in a nested group,
  plus an object-reference dataset dereferenced; every array equal to
  h5py's in dtype, shape and bytes;
- what the reader does not take raises naming it: superblock version 3,
  an lzf filter, a string datatype;
- `DNDDataset` (data/eval_datasets.py) item for item against JAX's on a
  DND tree of MATLAB-stamped files, one image chunked with deflate and one
  contiguous;
- `core/io.dataload` against JAX's on a v7.3 `.mat` (key `x`; the user
  block's MATLAB header makes scipy raise NotImplementedError as on a real
  file);
- the committed DND fixture (scripts/torch_port_fixtures.py) read
  bit-equal to its `.npz` and to h5py, and the script's arrays unchanged.
"""
import os
import sys

import h5py
import numpy as np
import pytest
import scipy.io as sio

from yondx.core import io as j_io
from yondx.data import eval_datasets as j_eval

from yondx_torch.core import io as t_io
from yondx_torch.data import eval_datasets as t_eval
from yondx_torch.io import hdf5

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
FIXTURES = os.path.join(REPO, "tests", "data", "torch_port")
sys.path.insert(0, os.path.join(REPO, "scripts"))
import torch_port_fixtures as fixtures  # noqa: E402


def _arrays():
    rng = np.random.default_rng(0)
    return {"f64": rng.standard_normal((37, 53)),
            "f32": rng.standard_normal((24, 40, 3)).astype(np.float32),
            "bef": rng.standard_normal((8, 9)).astype(">f8"),
            "i32": rng.integers(-1000, 1000, (17, 9)).astype(np.int32),
            "u16": rng.integers(0, 65535, (50, 70)).astype(np.uint16),
            "i64": rng.integers(-10 ** 12, 10 ** 12, (5,)),
            "scalar": np.float64(3.5)}


def _compact(f, name, v):
    sid = h5py.h5s.create_simple(np.shape(v))
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    ds = h5py.h5d.create(f.id, name.encode(),
                         h5py.h5t.py_create(np.asarray(v).dtype), sid,
                         dcpl=dcpl)
    ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.ascontiguousarray(v))


@pytest.mark.parametrize("userblock", [0, 512])
@pytest.mark.parametrize("layout", ["contiguous", "chunked", "deflate",
                                    "shuffle", "compact"])
def test_reader_matches_h5py(tmp_path, userblock, layout):
    path = str(tmp_path / "f.h5")
    arrs = _arrays()
    with h5py.File(path, "w", userblock_size=userblock) as f:
        g = f.create_group("grp/sub")
        for k, v in arrs.items():
            kw = {}
            if np.ndim(v) and layout == "chunked":
                kw = dict(chunks=tuple(max(1, s // 3) for s in np.shape(v)))
            elif np.ndim(v) and layout == "deflate":
                kw = dict(chunks=True, compression="gzip")
            elif np.ndim(v) and layout == "shuffle":
                kw = dict(chunks=True, compression="gzip", shuffle=True)
            if layout == "compact" and np.ndim(v):
                _compact(f, k, v)
            else:
                f.create_dataset(k, data=v, **kw)
            g.create_dataset(k, data=v, **kw)
        f["f64"].attrs["MATLAB_class"] = np.bytes_("double")
        refs = [f[k].ref for k in ("f64", "i32", "grp/sub/f32")]
        f.create_dataset("refs", data=np.array(
            refs, dtype=h5py.ref_dtype).reshape(1, 3))
    with h5py.File(path, "r") as hf, hdf5.File(path) as mf:
        assert mf.keys() == sorted(hf.keys())
        assert mf["grp"].keys() == ["sub"] and "grp/sub/i64" in mf
        for name in list(arrs) + [f"grp/sub/{k}" for k in arrs]:
            a, b = np.array(hf[name]), mf[name][()]
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert a.tobytes() == b.tobytes(), name
        r = mf["refs"][()]
        assert r.shape == (1, 3) and r.dtype == object
        for i, ref in enumerate(r[0]):
            a, b = np.array(hf[hf["refs"][0, i]]), mf[ref][()]
            assert a.shape == b.shape and a.tobytes() == b.tobytes()


def test_reader_raises_naming_what_it_does_not_read(tmp_path):
    p = str(tmp_path / "v3.h5")
    with h5py.File(p, "w", libver="latest") as f:
        f.create_dataset("x", data=np.ones(3))
    with pytest.raises(hdf5.Hdf5Error, match="superblock version 3"):
        hdf5.File(p)
    p = str(tmp_path / "lzf.h5")
    with h5py.File(p, "w") as f:
        f.create_dataset("x", data=np.ones(300), compression="lzf")
    with pytest.raises(hdf5.Hdf5Error, match="filter 32000"):
        hdf5.File(p)["x"]
    p = str(tmp_path / "str.h5")
    with h5py.File(p, "w") as f:
        f.create_dataset("x", data=np.array([b"ab", b"cd"]))
    with pytest.raises(hdf5.Hdf5Error, match="string datatype"):
        hdf5.File(p)["x"]
    with pytest.raises(hdf5.Hdf5Error, match="no HDF5 signature"):
        hdf5.File(os.path.join(FIXTURES, "expected.npz"))


def test_dnd_dataset_matches_jax(tmp_path):
    root = str(tmp_path / "dnd")
    fixtures.write_dnd(root)
    got, ref = t_eval.DNDDataset(root), j_eval.DNDDataset(root)
    assert len(got) == len(ref) == 2
    for i in range(2):
        g, r = got[i], ref[i]
        assert sorted(g) == sorted(r)
        for k in r:
            if isinstance(r[k], np.ndarray):
                assert g[k].dtype == r[k].dtype and g[k].shape == r[k].shape
                assert g[k].tobytes() == r[k].tobytes(), k
            else:
                assert g[k] == r[k], k
        assert g["boxes"].shape == (2, 4)


def test_dataload_matches_jax_on_v73_mat(tmp_path):
    path = str(tmp_path / "frame.mat")
    x = np.random.default_rng(6).random((48, 64)).astype(np.float32)
    with h5py.File(path, "w", userblock_size=512) as f:
        f.create_dataset("x", data=x.T, chunks=(16, 16), compression="gzip")
        f.create_dataset("aux", data=np.arange(4.0))
    with open(path, "r+b") as f:
        f.write(fixtures.matlab_userblock())
    with pytest.raises(NotImplementedError):
        sio.loadmat(path)
    got, ref = t_io.dataload(path), j_io.dataload(path)
    assert got.dtype == ref.dtype and got.shape == ref.shape == (48, 64)
    assert got.tobytes() == ref.tobytes()
    np.testing.assert_array_equal(got, x)


def test_committed_dnd_fixture_reads_bit_equal():
    want = np.load(os.path.join(FIXTURES, "expected.npz"))
    root = os.path.join(FIXTURES, "dnd")
    ds = t_eval.DNDDataset(root)
    for i in range(2):
        item = ds[i]
        assert item["lr"].tobytes() == want[f"dnd/{i + 1:04d}"].tobytes()
        np.testing.assert_array_equal(item["boxes"], want[f"dnd/boxes_{i}"])
        with h5py.File(ds.paths[i], "r") as hf:
            assert np.array(hf["Inoisy"]).T.tobytes() == \
                item["lr"].tobytes()
    with hdf5.File(ds.paths[0]) as f:               # chunked with deflate
        assert f["Inoisy"]._filters[0][0] == 1
    frames, boxes = fixtures.dnd_arrays()
    for i in range(2):
        assert frames[i].tobytes() == want[f"dnd/{i + 1:04d}"].tobytes()
        assert boxes[i].tobytes() == want[f"dnd/boxes_{i}"].tobytes()

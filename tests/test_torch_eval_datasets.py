"""The port's eval-set readers against the JAX package's (CPU), on fixture
files each test writes in the reader's own layout:

- `isp/metadata.read_sidd_metadata` on *_METADATA_*.MAT structs written
  by `scipy.io.savemat`: the Bayer tag at each of its three locations and
  at none, the S6 override to GBRG, the ISO at both of its places;
- `SIDDValDataset` in eval and test mode, with and without
  SIDD_Benchmark_Data (names, metadata and CFA from it; f"{i:04d}" and
  RGGB past its scenes);
- `LRIDDataset` by its info pickle and by a scan of the subset folder;
- `ELDDataset` on .npy (and .mat) frames, the GT the nearer of ids 1, 16;
- `DNDDataset` on MATLAB v7.3 files written with h5py as
  tests/test_dnd.py writes them, read by the port's own HDF5 reader, also
  with h5py's import refused;
- `MultiDataset`.

Every item dict equals JAX's: the same keys, values of the same type,
arrays of the same dtype and shape and equal element for element.
"""
import importlib.util
import os
import pickle
import sys

import numpy as np
import pytest
import scipy.io as sio

from yondx.data import datasets as j_datasets
from yondx.data import eval_datasets as j_eval
from yondx.isp import metadata as j_metadata

from yondx_torch.data import datasets as t_datasets
from yondx_torch.data import eval_datasets as t_eval
from yondx_torch.isp import metadata as t_metadata

from test_dnd import _make_dnd_root


def _equal(a, b, where="item"):
    """Equal values and types, recursively through dicts, lists, object
    and structured numpy arrays."""
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), (where, list(a), list(b))
        for k in a:
            _equal(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.void):
        assert a.dtype == b.dtype, where
        for name in a.dtype.names:
            _equal(a[name], b[name], f"{where}.{name}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype,
                                                           b.dtype)
        if a.dtype.names or a.dtype == object:
            for i, (x, y) in enumerate(zip(a.ravel(), b.ravel())):
                _equal(x, y, f"{where}.flat[{i}]")
        else:
            np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, (where, a, b)


# ------------------------------------------------------------- metadata
def _tags(bayer=None, n=8, seed=0):
    """An UnknownTags struct array (ID, Type, Value): the noise betas in
    row 7, the CFA tag 33422 in row 1 when `bayer` is given."""
    rng = np.random.default_rng(seed)
    t = np.empty((n, 1), dtype=[("ID", "O"), ("Type", "O"), ("Value", "O")])
    for i in range(n):
        t[i, 0]["ID"] = np.array([[50000.0 + i]])
        t[i, 0]["Type"] = np.array([[3.0]])
        t[i, 0]["Value"] = rng.random((1, 3))
    if bayer is not None:
        t[1, 0]["ID"] = np.array([[33422.0]])
        t[1, 0]["Value"] = np.array([bayer], np.float64)
    t[7, 0]["Value"] = np.array([[2.5e-3 + seed * 1e-4, 6e-5, 1.0]])
    return t


# (Make, where the CFA tag sits, its pattern, where the ISO sits)
META_VARIANTS = {
    "tag_top": ("Apple", 1, (0, 1, 1, 2), "top"),
    "tag_subifd0": ("Google", 2, (1, 0, 2, 1), "top"),
    "tag_subifd1": ("LGE", 3, (2, 1, 1, 0), "digital_camera"),
    "tag_none": ("motorola", 0, None, "top"),
    "s6_override": ("samsung", 1, (0, 1, 1, 2), "digital_camera"),
}


def _write_meta(path, variant, seed=0):
    make, loc, bayer, iso_at = META_VARIANTS[variant]
    m = {"Make": make, "AsShotNeutral": np.array([[0.5, 1.0, 0.6]]),
         "ColorMatrix2": np.arange(9.0).reshape(1, 9) / 9}
    if iso_at == "top":
        m["ISOSpeedRatings"] = np.array([[800.0]])
    else:
        dc = np.empty((1, 1), dtype=[("ISOSpeedRatings", "O")])
        dc[0, 0]["ISOSpeedRatings"] = np.array([[3200.0]])
        m["DigitalCamera"] = dc
    m["UnknownTags"] = _tags(bayer if loc == 1 else None, seed=seed)
    sub = np.empty((1, 2), dtype=[("UnknownTags", "O")])
    cell = np.empty((1, 1), dtype=object)
    cell[0, 0] = _tags(bayer if loc == 2 else None, seed=seed)
    sub[0, 0]["UnknownTags"] = cell
    sub[0, 1]["UnknownTags"] = _tags(bayer if loc == 3 else None, seed=seed)
    m["SubIFDs"] = sub
    sio.savemat(path, {"metadata": m})


@pytest.mark.parametrize("variant", list(META_VARIANTS))
def test_read_sidd_metadata_matches_jax(tmp_path, variant):
    path = str(tmp_path / "x_METADATA_010.MAT")
    _write_meta(path, variant)
    got = t_metadata.read_sidd_metadata(sio.loadmat(path))
    ref = j_metadata.read_sidd_metadata(sio.loadmat(path))
    _equal(got, ref)
    make, loc, bayer, iso_at = META_VARIANTS[variant]
    # each location is the one read: the pattern written there, +1
    # (with no tag both packages add 1 to their RGGB default too)
    if variant == "s6_override":
        want = [[2, 3], [1, 2]]
    elif variant == "tag_none":
        want = [[2, 3], [3, 4]]
    else:
        want = (np.asarray(bayer) + 1).reshape(2, 2).tolist()
    assert got["bayer_2by2"] == want
    assert got["iso"] == (800.0 if iso_at == "top" else 3200.0)
    assert (got["beta1"], got["beta2"]) == (2.5e-3, 6e-5)


def test_camera_file_readers_are_gated():
    """Without rawpy / exifread both packages raise ImportError naming
    the package."""
    for fn, pkg in (("read_wb_ccm", "rawpy"),
                    ("get_iso_exposure", "exifread")):
        if importlib.util.find_spec(pkg):
            continue
        with pytest.raises(ImportError, match=pkg):
            getattr(t_metadata, fn)("frame.ARW")
        with pytest.raises(ImportError, match=pkg):
            getattr(j_metadata, fn)("frame.ARW")


# ----------------------------------------------------------------- SIDD
SIDD_SCENES = ["0001_001_S6_00100_00060_3200_L",
               "0002_001_IP_00800_01000_3200_N",
               "0003_003_GP_00400_00500_4400_L"]


def _write_sidd(root, n=4, crops=3, size=16, bench=True):
    """[n, crops, size, size] blocks in SIDD_Validation_Raw; with `bench`,
    SIDD_Benchmark_Data holds 3 scenes (fewer than the blocks) whose
    metadata put the CFA tag at each of its locations."""
    rng = np.random.default_rng(11)
    val = root / "SIDD_Validation_Raw"
    val.mkdir(parents=True)
    blocks = {k: rng.random((n, crops, size, size)).astype(np.float32)
              for k in ("ValidationNoisyBlocksRaw", "ValidationGtBlocksRaw",
                        "BenchmarkNoisyBlocksRaw")}
    for k, v in blocks.items():
        sio.savemat(val / f"{k}.mat", {k: v})
    if bench:
        for name, variant in zip(SIDD_SCENES, ("s6_override", "tag_top",
                                               "tag_subifd1")):
            d = root / "SIDD_Benchmark_Data" / name
            d.mkdir(parents=True)
            _write_meta(str(d / f"{name}_METADATA_010.MAT"), variant)
            sio.savemat(d / f"{name}_NOISY_010.MAT", {"x": np.zeros((2, 2))})
    return blocks


@pytest.mark.parametrize("bench", [True, False], ids=["bench", "nobench"])
@pytest.mark.parametrize("mode", ["eval", "test"])
def test_sidd_reader_matches_jax(tmp_path, mode, bench):
    blocks = _write_sidd(tmp_path, bench=bench)
    got = t_datasets.SIDDValDataset(str(tmp_path), mode=mode)
    ref = j_datasets.SIDDValDataset(str(tmp_path), mode=mode)
    assert len(got) == len(ref) == 4
    for i in range(len(ref)):
        _equal(got[i], ref[i], f"scene {i}")
    items = [got[i] for i in range(4)]
    assert ("hr" in items[0]) == (mode == "eval")
    np.testing.assert_array_equal(
        items[2]["lr"], blocks["ValidationNoisyBlocksRaw" if mode == "eval"
                               else "BenchmarkNoisyBlocksRaw"][2])
    if bench:
        assert [it["name"] for it in items] == SIDD_SCENES + ["0003"]
        assert [it["cfa"] for it in items] == [
            [[2, 3], [1, 2]], [[1, 2], [2, 3]], [[3, 2], [2, 1]],
            [[1, 2], [2, 3]]]
    else:
        assert [it["name"] for it in items] == ["0000", "0001", "0002",
                                                "0003"]
        assert all(it["meta"] is None and it["cfa"] == [[1, 2], [2, 3]]
                   for it in items)


def test_sidd_reader_raises_without_its_file(tmp_path):
    for mod in (t_datasets, j_datasets):
        with pytest.raises(FileNotFoundError):
            mod.SIDDValDataset(str(tmp_path), mode="eval")


# ----------------------------------------------------------------- LRID
def _write_lrid(root, info):
    rng = np.random.default_rng(12)
    frames = {}
    for scene, n in (("scene_a", 3), ("scene_b", 1)):
        d = root / "indoor" / scene
        d.mkdir(parents=True)
        for j in range(n):
            x = rng.integers(0, 1024, (12, 20)).astype(np.uint16)
            np.save(d / f"{j:03d}.npy", x)
            frames[scene, j] = x
    if info:
        (root / "infos").mkdir()
        with open(root / "infos" / "indoor.info", "wb") as f:
            # one entry with its folder, one found under root by name
            pickle.dump([{"name": "scene_a",
                          "dir": str(root / "indoor" / "scene_a")},
                         {"name": "indoor/scene_b"}], f)
    return frames


@pytest.mark.parametrize("info", [True, False], ids=["info", "scan"])
def test_lrid_reader_matches_jax(tmp_path, info):
    frames = _write_lrid(tmp_path, info)
    got = t_eval.LRIDDataset(str(tmp_path), subset="indoor")
    ref = j_eval.LRIDDataset(str(tmp_path), subset="indoor")
    assert len(got) == len(ref) == 2
    for i in range(2):
        _equal(got[i], ref[i], f"scene {i}")
    a, b = got[0], got[1]
    assert "hr" in a and "hr" not in b
    np.testing.assert_array_equal(
        a["hr"], (frames["scene_a", 2].astype(np.float32) - 64) / 959)


def test_lrid_reader_raises_without_data(tmp_path):
    for mod in (t_eval, j_eval):
        with pytest.raises(FileNotFoundError):
            mod.LRIDDataset(str(tmp_path), subset="outdoor")


# ------------------------------------------------------------------ ELD
def test_eld_reader_matches_jax(tmp_path):
    rng = np.random.default_rng(13)
    for s, ids in ((1, (1, 4, 9, 14, 16)), (2, (1, 4, 9, 14, 16))):
        d = tmp_path / "SonyA7S2" / f"scene-{s}"
        d.mkdir(parents=True)
        for i in ids:
            x = rng.integers(512, 16384, (10, 14)).astype(np.uint16)
            if s == 2 and i == 9:
                sio.savemat(d / f"IMG_{i:04d}.mat", {"x": x})
            else:
                np.save(d / f"IMG_{i:04d}.npy", x)
    kw = {"camera_suffix": ("SonyA7S2", ".ARW"), "scenes": [1, 2]}
    got = t_eval.ELDDataset(str(tmp_path), **kw)
    ref = j_eval.ELDDataset(str(tmp_path), **kw)
    assert len(got) == len(ref) == 6
    for i in range(6):
        _equal(got[i], ref[i], f"item {i}")
    # id 9 takes GT 16 (nearer than 1), id 4 takes GT 1
    d1 = tmp_path / "SonyA7S2" / "scene-1"
    np.testing.assert_array_equal(
        got[1]["hr"], (np.load(d1 / "IMG_0016.npy").astype(np.float32)
                       - 512) / (16383 - 512))
    np.testing.assert_array_equal(
        got[0]["hr"], (np.load(d1 / "IMG_0001.npy").astype(np.float32)
                       - 512) / (16383 - 512))
    assert got[4]["name"] == "SonyA7S2_s02_0009"
    for mod in (t_eval, j_eval):
        with pytest.raises(FileNotFoundError):
            mod.ELDDataset(str(tmp_path), scenes=[3])[0]
        with pytest.raises(FileNotFoundError):
            mod.ELDDataset(str(tmp_path), camera_suffix=("NikonD850",
                                                         ".NEF"))


# ------------------------------------------------------------------ DND
def test_dnd_reader_matches_jax(tmp_path):
    root, frames, boxes = _make_dnd_root(tmp_path)
    got = t_eval.DNDDataset(str(root))
    ref = j_eval.DNDDataset(str(root))
    assert len(got) == len(ref) == 2
    for i in range(2):
        _equal(got[i], ref[i], f"image {i}")
    np.testing.assert_array_equal(got[1]["boxes"], boxes[1])
    os.remove(root / "info.mat")
    got, ref = t_eval.DNDDataset(str(root)), j_eval.DNDDataset(str(root))
    _equal(got[0], ref[0])
    assert "boxes" not in got[0]


def test_dnd_reader_needs_h5py(tmp_path, monkeypatch):
    """The reader no longer needs h5py: with its import refused (as on the
    card machine) the port's own HDF5 reader gives JAX's items."""
    root, _, _ = _make_dnd_root(tmp_path)
    ref = j_eval.DNDDataset(str(root))
    want = [ref[i] for i in range(len(ref))]
    monkeypatch.setitem(sys.modules, "h5py", None)     # import refused
    got = t_eval.DNDDataset(str(root))
    assert len(got) == len(want)
    for i, w in enumerate(want):
        _equal(got[i], w, f"image {i}")


# --------------------------------------------------------------- Multi
def test_multi_dataset_matches_jax(tmp_path):
    _write_lrid(tmp_path / "lrid", info=False)
    root, _, _ = _make_dnd_root(tmp_path)
    got = t_eval.MultiDataset([t_eval.LRIDDataset(str(tmp_path / "lrid")),
                               t_eval.DNDDataset(str(root))])
    ref = j_eval.MultiDataset([j_eval.LRIDDataset(str(tmp_path / "lrid")),
                               j_eval.DNDDataset(str(root))])
    assert len(got) == len(ref) == 4
    for i in range(4):
        _equal(got[i], ref[i], f"item {i}")
    for ds in (got, ref):
        with pytest.raises(IndexError):
            ds[4]

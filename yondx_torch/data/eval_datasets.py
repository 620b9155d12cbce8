"""Full-frame eval datasets: LRID, ELD and DND (port of
yondx/data/eval_datasets.py, numpy and the file layouts copied).

Each item is {'name', 'lr' (bayer [H, W] in [0, 1]), optional 'hr',
'cfa', 'wp', 'bl', 'ratio'}, the schema `eval/fullframe.py`'s harness and
`eval/dnd.py` consume. Frames stored as .npy/.mat load with numpy and
scipy; camera raws need rawpy (core.io.dataload): where it is absent
they raise ImportError. DND's MATLAB v7.3 files (HDF5) are read by the
port's own reader, `io/hdf5.py`.
"""
from __future__ import annotations

import glob
import os
import pickle
from typing import List, Optional, Sequence

import numpy as np

from ..core.io import dataload
from ..io import hdf5


def _norm(raw, wp, bl, ratio=1.0):
    x = (np.asarray(raw, np.float32) - bl) / (wp - bl)
    return np.clip(x * ratio, 0.0, 1.0) if ratio != 1.0 else x


class LRIDDataset:
    """LRID (IMX686) full-resolution eval: 3472x4624 frames, wp 1023,
    bl 64.

    Layout: {root}/{subset}/{scene}/ with the noisy frame first and the
    long-exposure GT last in name order ({npy|mat|dng}); the index is the
    pickle {root}/infos/{subset}.info when present, else a scan of
    {root}/{subset}/*.
    """
    WP, BL = 1023, 64

    def __init__(self, root_dir: str, subset: str = "indoor",
                 ratio_list: Sequence[int] = (1,)):
        self.root = root_dir
        self.ratio_list = list(ratio_list)
        info_path = os.path.join(root_dir, "infos", f"{subset}.info")
        if os.path.exists(info_path):
            with open(info_path, "rb") as f:
                self.infos = pickle.load(f)
        else:
            scenes = sorted(glob.glob(os.path.join(root_dir, subset, "*")))
            if not scenes:
                raise FileNotFoundError(
                    f"no LRID data under {root_dir}/{subset}")
            self.infos = [{"name": os.path.basename(s), "dir": s}
                          for s in scenes]

    def __len__(self):
        return len(self.infos)

    def __getitem__(self, idx: int) -> dict:
        info = self.infos[idx]
        d = info.get("dir", os.path.join(self.root, info["name"]))
        frames = sorted(glob.glob(os.path.join(d, "*")))
        if not frames:
            raise FileNotFoundError(d)
        lr = _norm(dataload(frames[0]), self.WP, self.BL)
        data = {"name": info["name"], "lr": lr, "wp": self.WP,
                "bl": self.BL, "ratio": 1.0,
                "cfa": [[1, 2], [2, 3]]}
        if len(frames) > 1:
            data["hr"] = _norm(dataload(frames[-1]), self.WP, self.BL)
        return data


class ELDDataset:
    """ELD eval grid of one camera: scene x image id, each noisy frame
    with the nearer of the long-exposure GT frames (ids 1 and 16).

    Layout: {basedir}/{camera}/scene-{s}/IMG_{id:04d}{suffix}; a frame
    converted to .npy or .mat with the same stem loads too.
    camera_suffix: e.g. ('SonyA7S2', '.ARW').
    """
    CAM_META = {
        "SonyA7S2": {"wp": 16383, "bl": 512},
        "NikonD850": {"wp": 16383, "bl": 512},
        "CanonEOS70D": {"wp": 16383, "bl": 2048},
        "CanonEOS700D": {"wp": 16383, "bl": 2048},
    }
    GT_IDS = (1, 16)

    def __init__(self, basedir: str, camera_suffix=("SonyA7S2", ".ARW"),
                 scenes: Optional[Sequence[int]] = None,
                 img_ids: Optional[Sequence[int]] = None):
        self.cam, self.suffix = camera_suffix
        self.basedir = os.path.join(basedir, self.cam)
        self.scenes = list(scenes) if scenes else list(range(1, 11))
        self.img_ids = list(img_ids) if img_ids else [4, 9, 14]
        meta = self.CAM_META.get(self.cam, {"wp": 16383, "bl": 512})
        self.wp, self.bl = meta["wp"], meta["bl"]
        if not os.path.isdir(self.basedir):
            raise FileNotFoundError(f"no ELD data under {self.basedir}")
        self.items: List[dict] = []
        for s in self.scenes:
            sdir = os.path.join(self.basedir, f"scene-{s}")
            for i in self.img_ids:
                self.items.append({"scene": s, "img_id": i, "dir": sdir})

    def _find(self, d: str, img_id: int) -> str:
        for ext in (self.suffix, ".npy", ".mat"):
            cands = glob.glob(os.path.join(d, f"IMG_{img_id:04d}{ext}")) or \
                glob.glob(os.path.join(d, f"*{img_id:04d}{ext}"))
            if cands:
                return cands[0]
        raise FileNotFoundError(f"{d}: id {img_id}")

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int) -> dict:
        it = self.items[idx]
        lr_path = self._find(it["dir"], it["img_id"])
        gt_id = min(self.GT_IDS, key=lambda g: abs(g - it["img_id"]))
        hr_path = self._find(it["dir"], gt_id)
        lr = _norm(dataload(lr_path), self.wp, self.bl)
        hr = _norm(dataload(hr_path), self.wp, self.bl)
        return {"name": f"{self.cam}_s{it['scene']:02d}_{it['img_id']:04d}",
                "lr": lr, "hr": hr, "wp": self.wp, "bl": self.bl,
                "ratio": 1.0, "cfa": [[1, 2], [2, 3]]}


class DNDDataset:
    """The DND raw benchmark (dnd_2017 release):
    {root}/images_raw/{0001..0050}.mat (key 'Inoisy', MATLAB v7.3) and
    {root}/info.mat with each image's bounding boxes. No ground truth
    (server-scored); items carry the 20 crop boxes (1-indexed rows
    [y0, x0, y1, x1]) for eval/dnd.py. Reads the HDF5 files with
    `io/hdf5.py`: each box array through info/boundingboxes' object
    references, transposed to [20, 4]."""

    def __init__(self, root_dir: str):
        self.root = root_dir
        img_dir = os.path.join(root_dir, "images_raw")
        self.paths = sorted(glob.glob(os.path.join(img_dir, "*.mat")))
        if not self.paths:
            raise FileNotFoundError(f"no DND images under {img_dir}")
        self.boxes = None
        info_path = os.path.join(root_dir, "info.mat")
        if os.path.exists(info_path):
            with hdf5.File(info_path) as f:
                info = f["info"]
                self.boxes = [f[ref][()].T
                              for ref in info["boundingboxes"][()][0]]

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx: int) -> dict:
        with hdf5.File(self.paths[idx]) as f:
            noisy = f["Inoisy"][()].T.astype(np.float32)
        data = {"name": os.path.basename(self.paths[idx])[:-4],
                "lr": noisy, "wp": 1, "bl": 0, "ratio": 1.0,
                "cfa": [[1, 2], [2, 3]]}
        if self.boxes is not None:
            data["boxes"] = self.boxes[idx]
        return data


class MultiDataset:
    """Several datasets read as one, in order."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.lengths = [len(d) for d in self.datasets]

    def __len__(self):
        return sum(self.lengths)

    def __getitem__(self, idx: int):
        for d, n in zip(self.datasets, self.lengths):
            if idx < n:
                return d[idx]
            idx -= n
        raise IndexError(idx)

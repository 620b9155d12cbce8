"""DND raw-benchmark submission harness (port of yondx/eval/dnd.py).

The DND benchmark is server-scored: each of the 50 raw images carries 20
bounding boxes (info.mat); a submission denoises the 20 boxed crops of
each image and uploads them in the official bundle layout:

  out_dir/bundled/%04d_%02d.mat   key 'Idenoised_crop'  (float32 [h, w])
  -> bundle_submissions_raw() ->  out_dir/bundled/%04d.mat per image with
     'Idenoised' (1x20 object row of crops), 'israw' = True,
     'eval_version' = '1.0'

Boxes are 1-indexed MATLAB rows [y0, x0, y1, x1]. Files are written and
read with scipy.io only.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..core.logging import log


def denoise_dnd(engine, dataset, out_dir: str,
                limit: Optional[int] = None,
                logfile: Optional[str] = None) -> str:
    """Denoise every boxed crop of a DND dataset with the full iterative
    engine (one iter_denoise a crop, on the engine's device) and write
    the per-crop .mat files. Returns the bundle directory."""
    import scipy.io as sio
    bundled = os.path.join(out_dir, "bundled")
    os.makedirs(bundled, exist_ok=True)
    n = len(dataset) if limit is None else min(limit, len(dataset))
    for i in range(n):
        data = dataset[i]
        if "boxes" not in data:
            raise ValueError("a DND submission needs info.mat's bounding "
                             "boxes")
        noisy = np.asarray(data["lr"], np.float32)
        boxes = np.asarray(data["boxes"])
        for k in range(boxes.shape[0]):
            y0, x0, y1, x1 = (int(boxes[k, 0] - 1), int(boxes[k, 1] - 1),
                              int(boxes[k, 2]), int(boxes[k, 3]))
            crop = noisy[y0:y1, x0:x1]
            # DND raws are normalized to [0, 1] already (wp 1, bl 0)
            p = {"wp": data.get("wp", 1), "bl": data.get("bl", 0),
                 "ratio": data.get("ratio", 1.0), "scale": 1.0,
                 "gain": 1.0, "sigma": 0.0}
            p["scale"] = float(p["wp"] - p["bl"]) / p["ratio"]
            res = engine.iter_denoise({"lr": crop}, p)
            dn = np.clip(res["raw_dns"][-1], 0.0, 1.0).astype(np.float32)
            sio.savemat(
                os.path.join(bundled, f"{i + 1:04d}_{k + 1:02d}.mat"),
                {"Idenoised_crop": dn})
        log(f"[dnd] image {i + 1}/{n}: {boxes.shape[0]} crops denoised",
            logfile=logfile)
    return bundled


def bundle_submissions_raw(folder: str) -> int:
    """Collect the per-crop files into the per-image bundles the DND
    server expects. Returns the number of bundles written."""
    import scipy.io as sio
    written = 0
    for i in range(50):
        crops = []
        for k in range(20):
            p = os.path.join(folder, f"{i + 1:04d}_{k + 1:02d}.mat")
            if not os.path.exists(p):
                break
            crops.append(sio.loadmat(p)["Idenoised_crop"])
        if not crops:
            continue
        idenoised = np.empty((1, len(crops)), dtype=object)
        for k, c in enumerate(crops):
            idenoised[0, k] = c
        sio.savemat(os.path.join(folder, f"{i + 1:04d}.mat"),
                    {"Idenoised": idenoised, "israw": True,
                     "eval_version": "1.0"})
        written += 1
    return written

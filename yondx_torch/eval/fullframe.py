"""The ANY-camera single-frame path (port of yondx/eval/fullframe.py:
127-163, `denoise_any`, on one card)."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.io import dataload
from ..isp.bayer import rot_bayer


def denoise_any(engine, path_or_array, wp: int = 1023, bl: int = 64,
                ratio: float = 1.0, cfa=None, tile: int = 1024,
                halo: int = 64, out_path: Optional[str] = None,
                mesh=None):
    """Blind-denoise one raw frame from any camera with the full iterated
    pipeline (self NLE -> tiled denoise -> collab NLE -> tiled second
    pass when the rescue gate fires) on the engine's device.

    Takes a file path (any format core.io.dataload reads) or a bayer
    array; values > 1.5 are DN and normalized by (wp, bl). Returns the
    denoised bayer in [0, 1] (numpy); saves it as .npy to out_path."""
    if mesh is not None:
        raise NotImplementedError(
            "row-sharding a frame over a mesh (--mesh) is not ported yet "
            "(ROADMAP item 9)")
    raw = dataload(path_or_array) if isinstance(path_or_array, str) \
        else np.asarray(path_or_array)
    raw = raw.astype(np.float32)
    if raw.max() > 1.5:
        raw = (raw - bl) / (wp - bl)
    raw = np.clip(raw * ratio, 0.0, 1.0)
    rotate = cfa is not None and cfa != [[1, 2], [2, 3]]
    if rotate:
        raw = rot_bayer(torch.from_numpy(raw), cfa).numpy()
    p = {"wp": wp, "bl": bl, "ratio": ratio, "scale": (wp - bl) / ratio,
         "gain": 1.0, "sigma": 0.0}
    res = engine.iter_denoise_tiled({"lr": raw}, p, tile=tile, halo=halo)
    dn = np.clip(res["raw_dns"][-1], 0.0, 1.0)
    if rotate:
        dn = rot_bayer(torch.from_numpy(dn), cfa, rev=True).numpy()
    if out_path:
        np.save(out_path, dn)
    return dn

"""Full-frame eval harness for ELD / LRID / DND and the ANY-camera
single-frame path (port of yondx/eval/fullframe.py, on one card).

`FullFrameHarness` runs the full iterated pipeline (self NLE -> denoise
-> collab NLE -> second pass) on each whole frame of a dataset, whole or
through the overlap-tiled runner by frame size; ELD adds the illuminance
alignment against the GT exposure before scoring. `denoise_any` is the
`--input` path.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.io import dataload
from ..core.logging import log
from ..core.meters import AverageMeter, MetricsRecorder
from ..data.augment import illuminance_correct
from ..isp.bayer import rot_bayer
from .metrics import matlab_ssim, psnr

_MESH_ERROR = ("row-sharding a frame over a mesh (--mesh) is not ported "
               "yet (ROADMAP item 9)")


class FullFrameHarness:
    """Evaluate the engine on full-resolution frames.

    dataset yields {'name', 'lr' [H, W], 'hr'?, 'cfa', 'wp', 'bl',
    'ratio'}. tile: 0 = by frame size (whole below AUTO_TILE_MP,
    overlap-tiled at AUTO_TILE from it), > 0 = always tiled at that
    size, -1 = always whole. Scores on the engine's device.
    """

    AUTO_TILE_MP = 16.0
    AUTO_TILE = 1024

    def __init__(self, engine, dataset, method_name: str,
                 tile: int = 0, halo: int = 64,
                 illum_correct: bool = False,
                 logfile: Optional[str] = None,
                 mesh=None):
        if mesh is not None:
            raise NotImplementedError(_MESH_ERROR)
        self.engine = engine
        self.dataset = dataset
        self.method_name = method_name
        self.tile = tile
        self.halo = halo
        self.illum_correct = illum_correct
        self.logfile = logfile or f"./logs/log_{method_name}.log"
        self.metrics = MetricsRecorder(
            f"./metrics/{method_name}_metrics.pkl")
        self.psnr_m = AverageMeter("PSNR")
        self.ssim_m = AverageMeter("SSIM")

    def _route(self, lr: np.ndarray) -> int:
        """-> the tile size for this frame (0 = whole frame)."""
        if self.tile == -1:
            return 0
        if self.tile > 0:
            return self.tile
        mp = lr.shape[-2] * lr.shape[-1] / 1e6
        return self.AUTO_TILE if mp >= self.AUTO_TILE_MP else 0

    def _denoise_frame(self, lr: np.ndarray, p: Dict[str, Any]):
        tile = self._route(lr)
        if tile:
            res = self.engine.iter_denoise_tiled({"lr": lr}, p, tile=tile,
                                                 halo=self.halo)
        else:
            res = self.engine.iter_denoise({"lr": lr}, p)
        return res["raw_dns"], res["regs"]

    def run(self, limit: Optional[int] = None) -> Dict[str, Any]:
        n = len(self.dataset) if limit is None else min(limit,
                                                        len(self.dataset))
        dev = self.engine.device
        for k in range(n):
            data = self.dataset[k]
            name = data["name"]
            wp, bl = data.get("wp", 1023), data.get("bl", 64)
            ratio = data.get("ratio", 1.0)
            p = {"wp": wp, "bl": bl, "ratio": ratio,
                 "scale": (wp - bl) / ratio, "gain": 1.0, "sigma": 0.0,
                 "cfa": data.get("cfa", [[1, 2], [2, 3]])}
            lr = np.asarray(data["lr"], np.float32)
            if p["cfa"] != [[1, 2], [2, 3]]:
                p["rot_cfa"] = True
            raw_dns, regs = self._denoise_frame(lr, p)
            rec = {"reg": regs}
            if "hr" in data:
                dn = torch.as_tensor(raw_dns[-1], device=dev)
                hr = torch.as_tensor(np.asarray(data["hr"], np.float32),
                                     device=dev)
                if self.illum_correct:
                    dn = illuminance_correct(dn[None, ..., None],
                                             hr[None, ..., None])[0, ..., 0]
                pv = float(psnr(dn, hr, data_range=1.0))
                sv = float(matlab_ssim(dn * 255, hr * 255))
                self.psnr_m.update(pv)
                self.ssim_m.update(sv)
                rec.update({"psnr": pv, "ssim": sv})
                log(f"{name}: PSNR={pv:.2f}, SSIM={sv:.4f}",
                    logfile=self.logfile)
            self.metrics[name] = rec
        if self.psnr_m.count:
            log(f"{self.method_name}: PSNR={self.psnr_m.avg:.2f}, "
                f"SSIM={self.ssim_m.avg:.4f}", logfile=self.logfile)
        self.metrics.save()
        return {"psnr": self.psnr_m.avg, "ssim": self.ssim_m.avg}


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
        raise NotImplementedError(_MESH_ERROR)
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

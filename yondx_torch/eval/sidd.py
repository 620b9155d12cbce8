"""SIDD evaluation / benchmark harness (port of yondx/eval/sidd.py).

Per scene: the iterative engine on the scene's [32, 256, 256] crop stack
(on the engine's device), then raw PSNR (data_range 1) and MATLAB SSIM
(x255) per 256x256 crop per iteration, meaned over the crops; per-scene
log lines, the per-scene record in metrics/{method}_metrics.pkl and the
outputs cached to npy/{method}/{k:03d}.npy. Scoring runs on a 4-thread
pool, off the path of the next scene's denoise, on the engine's device
(as the JAX package scores on its default device): on the host, torch's
SSIM of a scene's 64 crops took ~1.5 thread-s and slowed the card's
loop sevenfold.

The sRGB branch (`save_plot` with the scene's bayer_2by2, wb and cst2
metadata) renders the noisy, GT and each round's crop strips through
`isp/render.process_sidd_image` on the engine's device, scores sRGB
PSNR (data_range 255) and MATLAB SSIM per 256-px crop there, and writes
each strip as a PNG (core/png.py) from the pool: only the PNG's pixels
come to the host. Without GT (the benchmark split) it renders the PNGs
alone.
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.logging import log
from ..core.meters import AverageMeter, MetricsRecorder
from .metrics import matlab_ssim, psnr


def crop_means(dn, hr, device=None):
    """Per-crop PSNR (data_range 1) and MATLAB SSIM (x255) of [N, H, W]
    crop stacks, each meaned over the N crops (not one PSNR over the
    stack, a different statistic), on `device`."""
    d = torch.as_tensor(np.asarray(dn, np.float32), device=device)
    h = torch.as_tensor(np.asarray(hr, np.float32), device=device)
    return (float(torch.mean(psnr(d, h, dim=(-2, -1)))),
            float(matlab_ssim(d * 255, h * 255)))


def srgb_crop_means(img_dn, img_hr, n: int):
    """sRGB PSNR (data_range 255) and MATLAB SSIM (per channel) of each
    of the n 256-px crops of two [H, n*W, 3] uint8 strips, each meaned
    over the crops, on the strips' device."""
    def crops(img):
        H, NW, C = img.shape
        return img.to(torch.float32).reshape(H, n, NW // n, C) \
            .permute(1, 3, 0, 2)                     # [n, C, H, W]
    a, b = crops(img_dn), crops(img_hr)
    return (float(torch.mean(psnr(a, b, data_range=255.0,
                                  dim=(-3, -2, -1)))),
            float(matlab_ssim(a, b)))


class SIDDEvalHarness:
    def __init__(self, engine, dataset, method_name: str,
                 max_iter: int = 1, save_plot: bool = False,
                 sample_dir: str = "images", logfile: Optional[str] = None,
                 cache_npy: bool = True):
        self.engine = engine
        self.dataset = dataset
        self.method_name = method_name
        self.max_iter = max_iter
        self.save_plot = save_plot
        self.sample_dir = sample_dir
        self.logfile = logfile or f"./logs/log_{method_name}.log"
        self.cache_npy = cache_npy
        self.device = getattr(engine, "device", None)
        self.metrics = MetricsRecorder(
            f"./metrics/{method_name}_metrics.pkl")
        self.psnrs = [AverageMeter("PSNR") for _ in range(max_iter + 2)]
        self.ssims = [AverageMeter("SSIM") for _ in range(max_iter + 2)]
        self.psnrs_rgb = [AverageMeter("PSNR_RGB")
                          for _ in range(max_iter + 2)]
        self.ssims_rgb = [AverageMeter("SSIM_RGB")
                          for _ in range(max_iter + 2)]
        # seconds spent scoring in the last run, summed over the pool's
        # threads
        self.score_s = 0.0

    def _score_scene(self, name: str, raw_dns, lr, hr, meta=None):
        """Metric work for one scene (on the thread pool): per 256x256
        crop, PSNR at data_range 1 and SSIM at x255, meaned over the
        crops (not one PSNR over the stack, a different statistic). An
        iteration whose output is not positive updates -1. With save_plot
        and the metadata, the sRGB branch too (see the module). Returns
        its seconds."""
        t = time.perf_counter()
        rec = {"psnr": [], "ssim": []}
        srgb = self._srgb(meta)
        img_hr = None
        if srgb:
            rec["psnr_rgb"], rec["ssim_rgb"] = [], []
            os.makedirs(self.sample_dir, exist_ok=True)
            self._render_png(lr, meta, f"{name[:4]}_noisy.png")
            if hr is not None:
                img_hr = self._render_png(hr, meta, f"{name[:4]}_gt.png")
        last = (0.0, 0.0)
        for it, dn in enumerate(raw_dns):
            if np.max(dn) <= 0:
                self.psnrs[it].update(-1)
                self.ssims[it].update(-1)
                continue
            p, s = crop_means(dn, hr, self.device)
            self.psnrs[it].update(p)
            self.ssims[it].update(s)
            rec["psnr"].append(p)
            rec["ssim"].append(s)
            last = (p, s)
            if srgb:
                img_dn = self._render_png(dn, meta, f"{name[:4]}_{it}.png")
                if img_hr is not None:
                    p_rgb, s_rgb = srgb_crop_means(img_dn, img_hr,
                                                   len(dn))
                    self.psnrs_rgb[it].update(p_rgb)
                    self.ssims_rgb[it].update(s_rgb)
                    rec["psnr_rgb"].append(p_rgb)
                    rec["ssim_rgb"].append(s_rgb)
        self.psnrs[-1].update(last[0])
        self.ssims[-1].update(last[1])
        self.metrics[name] = {**self.metrics.data.get(name, {}), **rec}
        log(f"{name}: PSNR={last[0]:.2f}, SSIM={last[1]:.4f}",
            logfile=self.logfile)
        if srgb and rec.get("psnr_rgb"):
            self.psnrs_rgb[-1].update(rec["psnr_rgb"][-1])
            self.ssims_rgb[-1].update(rec["ssim_rgb"][-1])
            log(f"PSNR(sRGB)={rec['psnr_rgb'][-1]:.2f}, "
                f"SSIM(sRGB)={rec['ssim_rgb'][-1]:.4f}",
                logfile=self.logfile)
        return time.perf_counter() - t

    def _srgb(self, meta) -> bool:
        return bool(self.save_plot and meta is not None
                    and all(k in meta for k in ("bayer_2by2", "wb", "cst2")))

    def _render_benchmark(self, name: str, raw_dns, lr, meta):
        """The benchmark split (no GT): the noisy and each round's PNG.
        Returns its seconds."""
        t = time.perf_counter()
        os.makedirs(self.sample_dir, exist_ok=True)
        self._render_png(lr, meta, f"{name[:4]}_noisy.png")
        for it, dn in enumerate(raw_dns):
            self._render_png(dn, meta, f"{name[:4]}_{it}.png")
        return time.perf_counter() - t

    def _render_png(self, crops, meta, fname: str):
        """[N, 256, 256] crop stack -> the [256, N*256] bayer strip ->
        sRGB BGR uint8 [256, N*256, 3] on the engine's device, written as
        a PNG."""
        from ..isp.render import process_sidd_image
        c = torch.as_tensor(np.asarray(crops, np.float32),
                            device=self.device)
        strip = c.permute(1, 0, 2).reshape(c.shape[1], -1)
        return process_sidd_image(
            strip, meta["bayer_2by2"], meta["wb"], meta["cst2"],
            save_file_rgb=os.path.join(self.sample_dir, fname))

    def run(self, wp: int = 1023, bl: int = 64, ratio: float = 1.0,
            limit: Optional[int] = None) -> Dict[str, Any]:
        """Every scene (the first `limit`) through engine.iter_denoise;
        returns the per-iteration means {'psnr': [...], 'ssim': [...]}
        (max_iter + 2 entries: each round, then the last), and
        'psnr_rgb' / 'ssim_rgb' where the sRGB branch scored."""
        pool = ThreadPoolExecutor(max_workers=4)
        futures = []
        n = len(self.dataset) if limit is None else min(limit,
                                                        len(self.dataset))
        for k in range(n):
            data = self.dataset[k]
            name = data["name"]
            p = {"wp": wp, "bl": bl, "ratio": ratio,
                 "scale": (wp - bl) / ratio, "gain": 1.0, "sigma": 0.0}
            # SIDD scenes are denoised in their own CFA layout: the
            # pattern goes along, no rotation is asked for
            if "cfa" in data:
                p["cfa"] = data["cfa"]
            res = self.engine.iter_denoise(data, p, img_id=k)
            self.metrics[name] = {"reg": res["regs"]}
            if "hr" in data:
                futures.append(pool.submit(
                    self._score_scene, name, res["raw_dns"], data["lr"],
                    data["hr"], data.get("meta")))
            elif self._srgb(data.get("meta")):
                futures.append(pool.submit(
                    self._render_benchmark, name, res["raw_dns"],
                    data["lr"], data["meta"]))
            if self.cache_npy:
                os.makedirs(f"npy/{self.method_name}", exist_ok=True)
                np.save(f"npy/{self.method_name}/{k:03d}.npy",
                        np.stack(res["raw_dns"]))
        self.score_s = sum(f.result() for f in futures)
        pool.shutdown()

        for it in range(self.max_iter + 1):
            log(f"Iter{it}: PSNR={self.psnrs[it].avg:.2f}, "
                f"SSIM={self.ssims[it].avg:.4f}", logfile=self.logfile)
            if self.psnrs_rgb[it].count:
                log(f"Iter{it}: PSNR(sRGB)={self.psnrs_rgb[it].avg:.2f}, "
                    f"SSIM(sRGB)={self.ssims_rgb[it].avg:.4f}",
                    logfile=self.logfile)
        log(f"Iter_last: PSNR={self.psnrs[-1].avg:.2f}, "
            f"SSIM={self.ssims[-1].avg:.4f}", logfile=self.logfile)
        self.metrics.save()
        out = {"psnr": [m.avg for m in self.psnrs],
               "ssim": [m.avg for m in self.ssims]}
        if self.psnrs_rgb[0].count:
            out["psnr_rgb"] = [m.avg for m in self.psnrs_rgb]
            out["ssim_rgb"] = [m.avg for m in self.ssims_rgb]
        return out

    def write_submission(self, results: np.ndarray,
                         out_dir: str = "submits") -> str:
        """The SIDD benchmark's SubmitRaw.mat (key 'results'), results
        [n_scenes, 32, 256, 256]."""
        import scipy.io as sio
        path = os.path.join(out_dir, self.method_name)
        os.makedirs(path, exist_ok=True)
        out = os.path.join(path, "SubmitRaw.mat")
        sio.savemat(out, {"results": np.asarray(results, np.float32)})
        return out

"""Procedural sRGB crops for data-free training and evaluation (port of
yondx/data/datasets.py:115-289: `SyntheticSRGBDataset` and
`_bilinear_resize`, numpy, copied).

Multi-octave smooth fields, flat rectangles, band-limited textures,
sharp edges, block-mosaic charts and thin strokes, deterministic per
index. `python -m yondx_torch.cli.eval_synth --content texture` builds
its scenes from it.
"""
from __future__ import annotations

import numpy as np


class SyntheticSRGBDataset:
    """Procedural sRGB crops: multi-octave smooth fields + flat rectangles
    + band-limited textures + sharp edges, per-index deterministic (the
    eval-mode setup_seed(idx) contract). Items are memoized in RAM (the
    JAX package's optional .npy disk cache is left out)."""

    def __init__(self, length: int = 1024, size: int = 256, seed: int = 1997,
                 cache: bool = True, version: int = 6):
        self.length = length
        self.size = size
        self.seed = seed
        # content version: 6 = round-3 mix (12% thin strokes); 7 =
        # stroke-emphasis mix (30% stroke crops, denser stroke counts,
        # an axis-aligned angle mode)
        self.version = version
        self._cache = {} if cache else None

    def __len__(self):
        return self.length

    def __getitem__(self, idx: int) -> np.ndarray:
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        return self._generate(idx)

    def _generate(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        S = self.size
        # ~12% of crops: thin random strokes (arbitrary-angle segments,
        # 1-4 px) on a flat ground — stroke preservation at low noise is
        # the one held-out class the round-3 nets still lose on
        # (glyphs_lo, docs/STATUS.md). Construction deliberately differs
        # from the held-out suite's axis-aligned cell glyphs.
        stroke_p = 0.30 if self.version >= 7 else 0.12
        if rng.random() < stroke_p:
            bg = rng.random(3) * 0.7 + 0.15
            fg = np.clip(bg + (0.5 if bg.mean() < 0.5 else -0.5), 0, 1)
            img = np.ones((S, S, 3), np.float32) * bg
            yy, xx = np.mgrid[0:S, 0:S].astype(np.float32)
            n_strokes = int(rng.integers(30, 240)) if self.version >= 7 \
                else int(rng.integers(20, 60))
            for _ in range(n_strokes):
                x0, y0 = rng.random(2) * S
                # v7: 30% of strokes axis-aligned — a 1-2 px axis-aligned
                # stroke lands in a SINGLE RGGB plane row/column after the
                # mosaic (the hardest to tell from noise); v6's uniform
                # angle draw made that case measure-zero
                if self.version >= 7 and rng.random() < 0.3:
                    ang = 0.0 if rng.random() < 0.5 else np.pi / 2
                else:
                    ang = rng.random() * np.pi
                ln = rng.integers(S // 20, S // 2)
                w = 0.5 + rng.random() * 1.5          # half-width 0.5-2 px
                dx, dy = np.cos(ang), np.sin(ang)
                t = (xx - x0) * dx + (yy - y0) * dy
                dist = np.abs(-(xx - x0) * dy + (yy - y0) * dx)
                m = (dist < w) & (t > 0) & (t < ln)
                col = fg if rng.random() < 0.8 else rng.random(3)
                img[m] = col
            img = np.clip(img * (0.4 + rng.random()), 0, 1)
            img = (img * 255.0 + 0.5).astype(np.uint8)
            if self._cache is not None:
                self._cache[idx] = img
            return img
        # ~1 in 5 crops: a hard block-mosaic "chart" — adjoining flat
        # rectangles spanning the full brightness range incl. saturated
        # blocks next to dark ones. Real SIDD validation scenes are such
        # charts; round-2 diagnosis showed the nets scored a content-
        # dependent ~22 dB floor on this class at ANY sigma because the
        # smooth-field generator never produced it.
        if rng.random() < 0.35:
            gy, gx = rng.integers(2, 9, 2)
            levels = rng.random((gy, gx, 3)).astype(np.float32)
            if rng.random() < 0.5:   # force saturated + near-black blocks
                levels[rng.integers(gy), rng.integers(gx)] = 1.0
                levels[rng.integers(gy), rng.integers(gx)] = 0.02
            img = np.kron(levels, np.ones((-(-S // gy), -(-S // gx), 1),
                                          np.float32))[:S, :S]
            if rng.random() < 0.5:   # mild vignette so blocks aren't DC
                yy, xx = np.mgrid[0:S, 0:S].astype(np.float32) / S - 0.5
                img = img * (1.0 - 0.3 * rng.random()
                             * (yy * yy + xx * xx))[..., None]
            img = np.clip(img, 0.0, 1.0)
            img = (img * 255.0 + 0.5).astype(np.uint8)
            if self._cache is not None:
                self._cache[idx] = img
            return img
        img = np.zeros((S, S, 3), np.float32)
        # multi-octave smooth background per channel (Perlin-like)
        for c in range(3):
            acc = np.zeros((S, S), np.float32)
            amp, total = 1.0, 0.0
            for g in (3, 7, 17, 41):
                acc += amp * _bilinear_resize(rng.random((g, g)), S)
                total += amp
                amp *= 0.5
            img[..., c] = acc / total
        # random flat rectangles with distinct colors (flat regions for NLE)
        for _ in range(rng.integers(3, 10)):
            y0, x0 = rng.integers(0, S, 2)
            h, w = rng.integers(S // 16, S // 2, 2)
            img[y0:y0 + h, x0:x0 + w] = rng.random(3)
        # band-limited texture patch
        if rng.random() < 0.7:
            y0, x0 = rng.integers(0, S // 2, 2)
            h = int(rng.integers(S // 8, S // 2))
            freq = rng.random() * 0.3 + 0.02
            yy, xx = np.mgrid[0:h, 0:h]
            tex = 0.5 + 0.25 * np.sin(2 * np.pi * freq * (xx + yy)
                                      + rng.random() * 6.28)
            img[y0:y0 + h, x0:x0 + h] *= tex[..., None].astype(np.float32)
        # occasional hard diagonal edge (gradient-direction diversity)
        if rng.random() < 0.5:
            yy, xx = np.mgrid[0:S, 0:S]
            a, b = rng.normal(size=2)
            mask = (a * (yy - S / 2) + b * (xx - S / 2)) > 0
            img[mask] = img[mask] * rng.random() + rng.random(3) * 0.3
        # saturated highlights: real unprocessed raw keeps blown regions at
        # the white point (safe_invert_gains' highlight mask,
        # unprocess.py:115-121) — the denoiser must learn to preserve them
        if rng.random() < 0.6:
            for _ in range(rng.integers(1, 4)):
                y0, x0 = rng.integers(0, S - 8, 2)
                h, w = rng.integers(S // 16, S // 3, 2)
                img[y0:y0 + h, x0:x0 + w] = 1.0
        # global brightness jitter (occasionally pushing into clipping),
        # stored as uint8 (4x less host -> device transfer)
        img = np.clip(img * (0.4 + rng.random() * (1.2 if rng.random() < 0.3
                                                   else 1.0)), 0.0, 1.0)
        img = (img * 255.0 + 0.5).astype(np.uint8)
        if self._cache is not None:
            self._cache[idx] = img
        return img



def _bilinear_resize(g: np.ndarray, S: int) -> np.ndarray:
    gh, gw = g.shape
    yi = np.linspace(0, gh - 1, S)
    xi = np.linspace(0, gw - 1, S)
    y0 = np.floor(yi).astype(int).clip(0, gh - 2)
    x0 = np.floor(xi).astype(int).clip(0, gw - 2)
    wy = (yi - y0)[:, None]
    wx = (xi - x0)[None, :]
    a = g[y0][:, x0]
    b = g[y0][:, x0 + 1]
    c = g[y0 + 1][:, x0]
    d = g[y0 + 1][:, x0 + 1]
    return ((1 - wy) * ((1 - wx) * a + wx * b)
            + wy * ((1 - wx) * c + wx * d)).astype(np.float32)

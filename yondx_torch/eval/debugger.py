"""AlgoDebugger: a parameter tuner for an algorithm func(img, **params)
with integer-range parameters (port of yondx/eval/debugger.py).

- `sweep()`: a headless grid sweep; each result is written as a PNG
  through core/png.py, and all are returned;
- `interactive()`: a cv2 window with trackbars, which needs cv2 and a
  display (ImportError naming cv2 where it is absent).
"""
from __future__ import annotations

import itertools
import os
from typing import Callable, Dict, Sequence, Tuple

import numpy as np

from ..core.png import write_png


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class AlgoDebugger:
    def __init__(self, func: Callable, img: np.ndarray,
                 params: Dict[str, Tuple[int, int]],
                 scale: Dict[str, float] | None = None):
        """params: name -> (max_int, default_int); scale: name -> factor
        applied to the integer slider value before calling func."""
        self.func = func
        self.img = img
        self.params = params
        self.scale = scale or {}

    def _call(self, vals: Dict[str, int]) -> np.ndarray:
        kwargs = {k: v * self.scale.get(k, 1) for k, v in vals.items()}
        return _np(self.func(self.img, **kwargs))

    def sweep(self, grid: Dict[str, Sequence[int]],
              out_dir: str = "worklog/algo_debug") -> Dict[tuple, np.ndarray]:
        """func over the cartesian grid: each result (clipped to [0, 1],
        or scaled by its max where that passes 1.5) written as
        out_dir/<name><value>_....png, the image's channels taken as BGR
        as the JAX package's cv2.imwrite takes them; returns {param
        tuple: result}. A result that cannot be written is skipped."""
        os.makedirs(out_dir, exist_ok=True)
        names = list(grid)
        results = {}
        for combo in itertools.product(*(grid[n] for n in names)):
            vals = dict(zip(names, combo))
            out = self._call(vals)
            results[combo] = out
            tag = "_".join(f"{n}{v}" for n, v in vals.items())
            try:
                vis = np.clip(out, 0, 1) if out.max() <= 1.5 else \
                    out / max(out.max(), 1e-8)
                u8 = (vis * 255).astype(np.uint8)
                if u8.ndim == 3 and u8.shape[2] not in (1, 3, 4):
                    continue        # cv2 writes 1, 3 or 4 channels only
                if u8.ndim == 3 and u8.shape[2] in (3, 4):
                    u8 = u8[:, :, (2, 1, 0, 3)[:u8.shape[2]]]  # BGR(A)
                write_png(os.path.join(out_dir, f"{tag}.png"), u8)
            except Exception:
                pass
        return results

    def interactive(self, winname: str = "AlgoDebugger"):
        """cv2 trackbar loop (blocking; needs cv2 and a display)."""
        try:
            import cv2
        except ImportError as e:
            raise ImportError("AlgoDebugger.interactive needs cv2 (OpenCV) "
                              "with a GUI, which is not installed") from e
        cv2.namedWindow(winname)
        for name, (vmax, default) in self.params.items():
            cv2.createTrackbar(name, winname, default, vmax, lambda v: None)
        while True:
            vals = {name: cv2.getTrackbarPos(name, winname)
                    for name in self.params}
            out = self._call(vals)
            cv2.imshow(winname, np.clip(out, 0, 1))
            if cv2.waitKey(50) & 0xFF in (27, ord("q")):
                break
        cv2.destroyWindow(winname)

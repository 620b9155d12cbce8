"""Metric meters with persisted history (port of yondx/core/meters.py,
copied): `AverageMeter` with its pkl epoch history (the curve figure is
drawn only where matplotlib imports) and `MetricsRecorder`, the
per-scene record the eval harnesses write to
metrics/{method}_metrics.pkl."""
from __future__ import annotations

import os
import pickle
import threading
from typing import Dict, List


class AverageMeter:
    """Running average with pkl-backed epoch history; thread-safe
    update."""

    def __init__(self, name: str = "", fmt: str = ":f", last_epoch: int = 0):
        self.name = name
        self.fmt = fmt
        self.history: List[float] = []
        self.last_epoch = last_epoch
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        with self._lock:
            self.val = float(val)
            self.sum += float(val) * n
            self.count += n
            self.avg = self.sum / max(self.count, 1)

    def plot_history(self, savefile: str | None = None, logfile: str | None = None):
        """Append current avg to history; persist to pkl; optional curve png."""
        if logfile and os.path.exists(logfile) and not self.history:
            with open(logfile, "rb") as f:
                self.history = list(pickle.load(f))[: self.last_epoch]
        self.history.append(self.avg)
        if logfile:
            with open(logfile, "wb") as f:
                pickle.dump(self.history, f)
        if savefile:
            try:
                import matplotlib
                matplotlib.use("Agg")
                import matplotlib.pyplot as plt
                plt.figure(figsize=(8, 4))
                plt.plot(self.history)
                plt.xlabel("epoch")
                plt.ylabel(self.name)
                plt.grid(True)
                plt.tight_layout()
                plt.savefig(savefile)
                plt.close()
            except Exception:
                pass
        return self.history

    def __str__(self):
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(name=self.name, val=self.val, avg=self.avg)


class MetricsRecorder:
    """Per-scene metric dict persisted to a pickle; an existing file is
    read back, so a rerun adds to it."""

    def __init__(self, path: str):
        self.path = path
        self.data: Dict[str, dict] = {}
        if os.path.exists(path):
            with open(path, "rb") as f:
                self.data = pickle.load(f)

    def __getitem__(self, k):
        return self.data[k]

    def __setitem__(self, k, v):
        self.data[k] = v

    def __contains__(self, k):
        return k in self.data

    def save(self):
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "wb") as f:
            pickle.dump(self.data, f)

"""Timestamped tee-to-file logging (port of yondx/core/logging.py)."""
from __future__ import annotations

import os
import time
from typing import Optional

# False on the ranks of a mesh but rank 0: one log a run (parallel/)
_ENABLED = [True]


def set_enabled(on: bool) -> None:
    """Turn this process's log lines on or off."""
    _ENABLED[0] = bool(on)


def log(msg: str, logfile: Optional[str] = None, notime: bool = False) -> None:
    """Print a timestamped line and append it to `logfile` when given
    (nothing where `set_enabled(False)` was called)."""
    if not _ENABLED[0]:
        return
    line = msg if notime else f"{time.strftime('%Y-%m-%d %H:%M:%S')} {msg}"
    print(line, flush=True)
    if logfile:
        os.makedirs(os.path.dirname(logfile) or ".", exist_ok=True)
        with open(logfile, "a") as f:
            f.write(line + "\n")


def timestamp(points: list, idx: int) -> float:
    """Stage timer: record now at points[idx], return the time since
    points[idx - 1]."""
    points[idx] = time.time()
    return points[idx] - points[idx - 1]

"""LR schedules, stepped once per epoch (port of yondx/train/schedule.py,
pure Python, copied).

`get_cos_lr` is SGDR warm restarts: linear warmup over `peak` epochs, then
cosine from lr to ratio*lr over the remaining period; each restart halves
the amplitude (decay 2^T). `get_multistep_lr` steps down at two
milestones; `lr_lambda_from_hyper` builds the epoch -> lr function of a
runfile's hyper block.
"""
from __future__ import annotations

import math
from typing import Callable, Dict


def get_cos_lr(step: int, period: int = 1000, peak: int = 20,
               lr: float = 1e-4, ratio: float = 0.4,
               coldstart: bool = False) -> float:
    T = step // period
    decay = 2 ** T
    step = step % period
    if period <= peak:
        # degenerate tiny run (period shorter than the warmup): no schedule
        return lr / decay
    if step <= peak and (not coldstart or T > 0):
        mul = step / peak
    else:
        mul = (1 - ratio) * (math.cos((step - peak) / (period - peak)
                                      * math.pi) * 0.5 + 0.5) + ratio
    return lr * mul / decay


def get_multistep_lr(step: int, period: int = 1000, lr: float = 1e-4,
                     milestone=(500, 900), gamma=(0.5, 0.1),
                     decay_base: float = 1) -> float:
    decay = decay_base ** (step // period)
    step = step % period
    mul = 1.0
    for i in range(len(milestone), 0, -1):
        if step > milestone[i - 1]:
            mul = gamma[i - 1]
            break
    return lr * mul / decay


def lr_lambda_from_hyper(hyper: Dict) -> Callable[[int], float]:
    """Build the epoch->lr function from the YAML hyper block (reference
    get_lr_lambda_func, trainer_base.py:34-46)."""
    # last_epoch == -1 means auto-resume; the schedule period is the full
    # run in that case
    num_epochs = hyper["stop_epoch"] - max(hyper.get("last_epoch", 0), 0)
    step_size = hyper.get("step_size", 20)
    T = hyper.get("T", 1)
    coldstart = hyper.get("coldstart", True)
    name = hyper.get("lr_scheduler", "WarmupCosine").lower()
    lr = hyper["learning_rate"]
    # debug/tiny runs can make num_epochs < T; a 0 period would divide by 0
    period = max(num_epochs // T, 1)
    if "cos" in name:
        return lambda e: get_cos_lr(e, period=period, lr=lr,
                                    peak=step_size, coldstart=coldstart)
    if "multi" in name:
        return lambda e: get_multistep_lr(
            e, period=period, decay_base=1,
            milestone=[step_size, step_size * 9 // 5], gamma=[0.5, 0.1],
            lr=lr)
    return lambda e: lr

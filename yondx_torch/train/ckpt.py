"""Checkpoints with the JAX package's naming and file format (port of
yondx/train/ckpt.py).

Rolling {name}_last_model.ckpt and {name}_best_model.ckpt under fast_ckpt,
epoch archives {name}_e{epoch:04d}.ckpt under the checkpoint directory;
each file is the flax msgpack map {params, opt_state, epoch, best_psnr}
that `yondx.train.ckpt.load_checkpoint` reads, written to a .tmp file and
moved into place. The optimizer state is optax's
`inject_hyperparams(adam)` state:
  count, hyperparams/{b1, b2, eps, eps_root, learning_rate},
  hyperparams_states (empty), inner_state/0/{count, mu, nu},
  inner_state/1 (empty),
with mu and nu laid out like params; `optax_adam_state` and
`load_optax_adam_state` map it to and from torch.optim.Adam's per
parameter step, exp_avg and exp_avg_sq.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..io.ckpt import load_checkpoint as _read
from ..io.ckpt import write_msgpack
from ..models.convert import params_to_state_dict, state_dict_to_params

ADAM_HYPER = {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0}


def save_checkpoint(path: str, params: Any, opt_state: Any = None,
                    epoch: int = 0, best_psnr: float = 0.0) -> None:
    """params: the flax variable dict of numpy leaves; opt_state: the
    optax state dict (or None, written as an empty map)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    blob = write_msgpack({"params": params,
                          "opt_state": opt_state if opt_state is not None
                          else {},
                          "epoch": int(epoch),
                          "best_psnr": float(best_psnr)})
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """{params, opt_state, epoch, best_psnr} with numpy leaves."""
    return _read(path, opt_state=True)


def find_checkpoint(fast_ckpt: str, model_name: str,
                    prefer: str = "best") -> Optional[str]:
    """Search order best -> last -> bare for inference; prefer='last'
    for resuming a run (resuming from 'best' would rewind a run whose
    eval metric has plateaued)."""
    order = ("_best_model", "_last_model", "") if prefer == "best" \
        else ("_last_model", "_best_model", "")
    for suffix in order:
        p = os.path.join(fast_ckpt, f"{model_name}{suffix}.ckpt")
        if os.path.exists(p):
            return p
    return None


def resume_checkpoint(fast_ckpt: str, model_name: str,
                      model: torch.nn.Module, optimizer: torch.optim.Adam,
                      epoch: int):
    """Resume a run from `model_name`'s last checkpoint under fast_ckpt
    (else its best, else the bare name): its weights into `model`, its
    optax Adam state into `optimizer`. -> (epoch, path, state): the epoch
    the run continues after (the file's when `epoch` is -1), the file's
    path and contents; (max(epoch, 0), None, None) when there is none."""
    path = find_checkpoint(fast_ckpt, model_name, prefer="last")
    if not path:
        return max(epoch, 0), None, None
    state = load_checkpoint(path)
    model.load_state_dict(params_to_state_dict(state["params"]))
    if state.get("opt_state"):
        load_optax_adam_state(optimizer, model, state["opt_state"])
    if epoch == -1:
        epoch = int(state.get("epoch", 0))
    return epoch, path, state


def optax_adam_state(optimizer: torch.optim.Adam, net: torch.nn.Module
                     ) -> Dict[str, Any]:
    """torch.optim.Adam's state for `net` as optax's
    inject_hyperparams(adam) state dict (numpy leaves)."""
    mu, nu, count = {}, {}, 0
    for name, p in net.named_parameters():
        st = optimizer.state.get(p, {})
        if st:
            count = int(st["step"])
            mu[name], nu[name] = st["exp_avg"], st["exp_avg_sq"]
        else:
            mu[name] = nu[name] = torch.zeros_like(p)
    lr = optimizer.param_groups[0]["lr"]
    hyper = dict(ADAM_HYPER, learning_rate=lr)
    return {
        "count": np.asarray(count, np.int32),
        "hyperparams": {k: np.asarray(v, np.float32)
                        for k, v in hyper.items()},
        "hyperparams_states": {},
        "inner_state": {"0": {"count": np.asarray(count, np.int32),
                              "mu": state_dict_to_params(mu),
                              "nu": state_dict_to_params(nu)},
                        "1": {}},
    }


def load_optax_adam_state(optimizer: torch.optim.Adam, net: torch.nn.Module,
                          opt_state: Dict[str, Any]) -> int:
    """Load an optax inject_hyperparams(adam) state dict into the torch
    optimizer's per-parameter state; returns its step count."""
    inner = opt_state["inner_state"]["0"]
    count = int(inner["count"])
    mu = params_to_state_dict(inner["mu"])
    nu = params_to_state_dict(inner["nu"])
    for name, p in net.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": mu[name].to(device=p.device, dtype=p.dtype),
            "exp_avg_sq": nu[name].to(device=p.device, dtype=p.dtype)}
    return count

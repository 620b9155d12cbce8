"""Noise-estimation net trainer (port of yondx/train/pg_trainer.py).

The Poisson-Gaussian transform runs on the device (data/pg_dataset.py)
and the flavour follows the arch:
- EstUnet ('map'): std-map regression from the feature stack
  [lr_std | lr_blur | lr], a flat-masked L1 against the analytic
  sqrt(beta1 blur(hr) + beta2);
- est_UNet ('pge'): scalar [beta1, sqrt(beta2)] regression from the raw
  frame, L1 in log space (the prior spans ~2.5 decades); the engine's
  'pge' est_type reads (pred[0], pred[1]**2).

As in the JAX package: fresh weights are flax's default init from
PRNGKey(0) (models/registry.py flax_init_params), the data are the
synthetic sRGB set, the key chain is PRNGKey(hyper.seed or 0) split once
a step, the learning rate is the epoch's `lr_lambda_from_hyper`, Adam
has optax's constants, and `{fast_ckpt}/{model_name}_last_model.ckpt` is
written every save_freq epochs in the JAX package's format with optax's
Adam state. The port also resumes a run (hyper.last_epoch >= 1, or -1
for the checkpoint's own epoch) from a checkpoint either package wrote,
with its Adam count. The Poisson and Gaussian fields of the training
steps come from `field` ("torch" on the card, "jax" bit-equal to
jax.random for the parity tests).
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core import rng
from ..core.logging import log
from ..core.meters import AverageMeter
from ..data.datasets import BatchLoader, SyntheticSRGBDataset, to_unit
from ..data.pg_dataset import pg_est_features, pg_training_batch
from ..models.convert import state_dict_to_params
from ..models.registry import build_model, flax_init_params
from .ckpt import (optax_adam_state, resume_checkpoint,
                   save_checkpoint)
from .draws import FieldSource
from .schedule import lr_lambda_from_hyper

LOG_EPS = 1e-6


def pge_loss(pred, beta1, beta2):
    """Mean |log(pred + eps) - log([beta1, sqrt(beta2)] + eps)| of the
    est_UNet output pred [B, 2] (or [2] for one crop)."""
    pred = pred.reshape(beta1.shape[0], -1)
    target = torch.stack([beta1, torch.sqrt(beta2)], dim=-1)
    return torch.mean(torch.abs(torch.log(pred + LOG_EPS)
                                - torch.log(target + LOG_EPS)))


class PGEstTrainer:
    def __init__(self, args: Dict[str, Any], device=None, *, field: str):
        """args: the parsed runfile (arch/hyper/dst_train blocks); device:
        "cuda" unless "cpu" is asked for; field: the source of the
        training steps' Poisson and Gaussian fields, "torch" or "jax"."""
        self.args = args
        self.device = resolve_device(device)
        self.arch = args["arch"]
        self.hyper = args["hyper"]
        self.dst = args.get("dst_train", {})
        self.model_name = args.get("model_name", "estnet")
        self.fast_ckpt = args.get("fast_ckpt", "checkpoints")
        self.k = self.arch.get("k", 19)
        self.flavor = "pge" if self.arch.get("name") == "est_UNet" \
            else "map"
        self.field = FieldSource(field, self.device,
                                 seed=self.hyper.get("seed", 0))
        self.model = build_model(self.arch)
        self.model.load_state_dict(flax_init_params(self.model))
        self.model.to(self.device)
        if self.device.type == "cuda":
            self.model.to(memory_format=torch.channels_last)
        self.lr_fn = lr_lambda_from_hyper(self.hyper)
        self.optimizer = torch.optim.Adam(self.model.parameters(),
                                          lr=self.lr_fn(1),
                                          betas=(0.9, 0.999), eps=1e-8)
        self.meter = AverageMeter("loss")
        self.epoch = self.hyper.get("last_epoch", 0)
        if self.epoch:
            self.epoch, path, state = resume_checkpoint(
                self.fast_ckpt, self.model_name, self.model, self.optimizer,
                self.epoch)
            log(f"[est] Resumed from {path} @ epoch {state.get('epoch')}"
                if path else "[est] No checkpoint file!!!")
        # per-step record of the last train() call: epoch, loss and the
        # loader and step seconds (the step's ends in the loss read)
        self.steps = []

    # --------------------------------------------------------------- step
    def inputs(self, x, key) -> Dict[str, torch.Tensor]:
        """The net's input and the loss's terms of one batch x [B, H, W,
        3] in [0, 1] on the device, with the batch's key: 'pge' {x =
        clip(lr, 0, 1), beta1, beta2}, 'map' {x = features, target,
        mask}."""
        lr, hr, meta = pg_training_batch(key, x, field=self.field)
        if self.flavor == "pge":
            return {"x": torch.clamp(lr, 0.0, 1.0), "beta1": meta["beta1"],
                    "beta2": meta["beta2"]}
        out = pg_est_features(lr, hr, meta["beta1"], meta["beta2"],
                              k=self.k)
        return {"x": out["features"], "target": out["target"],
                "mask": out["mask"]}

    def loss(self, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The flavour's loss of the net on `inputs`."""
        pred = self.model(inputs["x"])
        if self.flavor == "pge":
            return pge_loss(pred, inputs["beta1"], inputs["beta2"])
        err = torch.abs(pred - inputs["target"]) * inputs["mask"]
        return torch.sum(err) / torch.clamp(torch.sum(inputs["mask"]),
                                            min=1.0)

    def step(self, inputs: Dict[str, torch.Tensor],
             lr_value: float) -> torch.Tensor:
        """One Adam step on prepared `inputs` -> the loss (a 0-d device
        tensor)."""
        self.model.train()
        loss = self.loss(inputs)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for group in self.optimizer.param_groups:
            group["lr"] = float(lr_value)
        self.optimizer.step()
        return loss.detach()

    def train_step(self, batch, key, lr_value: float) -> torch.Tensor:
        """One Adam step on a host batch of sRGB crops."""
        return self.step(self.inputs(to_unit(batch, self.device), key),
                         lr_value)

    # -------------------------------------------------------------- train
    def train(self, epochs: Optional[int] = None,
              steps_per_epoch: Optional[int] = None) -> float:
        hyper = self.hyper
        stop = epochs or hyper["stop_epoch"]
        ds = SyntheticSRGBDataset(length=self.dst.get("synthetic_len", 512),
                                  size=self.dst.get("patch_size", 256))
        loader = BatchLoader(ds, hyper["batch_size"])
        keys = rng.rng_seq(hyper.get("seed", 0))
        self.steps = []
        for epoch in range(self.epoch + 1, stop + 1):
            self.meter.reset()
            lr_value = self.lr_fn(epoch)
            n = 0
            t0 = time.perf_counter()
            for batch in loader.epoch(epoch):
                t1 = time.perf_counter()
                loss = float(self.train_step(batch, next(keys), lr_value))
                t2 = time.perf_counter()
                self.meter.update(loss)
                self.steps.append({"epoch": epoch, "loss": loss,
                                   "loader_s": t1 - t0, "step_s": t2 - t1})
                t0 = t2
                n += 1
                if steps_per_epoch and n >= steps_per_epoch:
                    break
            log(f"[est] Epoch {epoch}: loss={self.meter.avg:.5f}")
            self.epoch = epoch
            if epoch % hyper.get("save_freq", 10) == 0:
                save_checkpoint(
                    f"{self.fast_ckpt}/{self.model_name}_last_model.ckpt",
                    state_dict_to_params(self.model.state_dict()),
                    optax_adam_state(self.optimizer, self.model), epoch)
        return self.meter.avg


def pge_eval_batches(device=None, n_crops: int = 64, size: int = 256,
                     batch_size: int = 16, seed: int = 2024):
    """The fixed eval set of the 'pge' flavour: the first n_crops
    synthetic crops of `size` px (seed 2024), corrupted by
    pg_training_batch with keys from PRNGKey(seed) split once a batch and
    the "jax" fields (JAX's draws) -> [(clip(lr, 0, 1), beta1, beta2)]
    on `device`, in batches of batch_size."""
    dev = resolve_device(device)
    ds = SyntheticSRGBDataset(length=n_crops, size=size, seed=2024)
    field = FieldSource("jax", dev)
    keys = rng.rng_seq(seed)
    out = []
    for s in range(0, n_crops - batch_size + 1, batch_size):
        x = to_unit(np.stack([ds[i] for i in range(s, s + batch_size)]), dev)
        lr, _, meta = pg_training_batch(next(keys), x, field=field)
        out.append((torch.clamp(lr, 0.0, 1.0), meta["beta1"],
                    meta["beta2"]))
    return out


@torch.no_grad()
def eval_pge(net, batches) -> float:
    """The 'pge' loss of an est_UNet over pge_eval_batches: the mean over
    the batches (of equal size)."""
    net.eval()
    return float(np.mean([float(pge_loss(net(x), b1, b2))
                          for x, b1, b2 in batches]))

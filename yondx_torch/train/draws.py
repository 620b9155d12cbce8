"""The trainer's random streams (the key chain of yondx/train/trainer.py).

The JAX trainer draws everything from `jax.random` keys: training from
PRNGKey(hyper.seed or 1997) with one split per step and then split(sub, 3)
into the data, noise and consistency keys; eval from PRNGKey(2024) with
split(key, 3) per batch. The port walks the same chain with the numpy
threefry of core/rng.py on the host, so every scalar and per-crop draw
(cameras, CFA patterns, sigmas, chroma gains, the consistency strength)
equals JAX's bit for bit.

The large draws are the fields normal(k, [B, h, w, C]), uniform and
poisson(k, lam), and the caller names their source:
- "jax": core.rng.normal / core.rng.poisson on the host, bit-equal to
  jax.random.normal / jax.random.poisson (about 3 s per [64,128,128,4]
  normal field and 2.5 s per [32,128,128,4] Poisson field on one CPU
  core). The parity tests use it, and so does eval, so that the eval set
  is JAX's eval set exactly.
- "torch": torch.randn / torch.rand / torch.poisson from a
  torch.Generator on the device, seeded from the run's seed. The
  training steps on the card use it: these fields, and nothing else,
  make the card's training batches differ from JAX's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import rng

FIELD_SOURCES = ("jax", "torch")


class FieldSource:
    """Gaussian, uniform and Poisson fields for the noise draws, from
    `kind` ("jax" or "torch") onto `device`."""

    def __init__(self, kind: str, device, seed: int = 0):
        if kind not in FIELD_SOURCES:
            raise ValueError(f"field source {kind!r} not in {FIELD_SOURCES}")
        self.kind = kind
        self.device = torch.device(device)
        self.gen = None
        if kind == "torch":
            self.gen = torch.Generator(device=self.device)
            self.gen.manual_seed(int(seed))

    def normal(self, key, shape) -> torch.Tensor:
        """N(0, 1) float32 field of `shape`; `key` is the JAX key of the
        draw (used by the "jax" source only)."""
        if self.kind == "jax":
            return torch.from_numpy(rng.normal(key, tuple(shape))).to(
                self.device)
        return torch.randn(tuple(shape), generator=self.gen,
                           device=self.device)

    def uniform(self, key, shape, minval: float = 0.0,
                maxval: float = 1.0) -> torch.Tensor:
        """U[minval, maxval) float32 field of `shape`."""
        if self.kind == "jax":
            return torch.from_numpy(rng.uniform(key, tuple(shape), minval,
                                                maxval)).to(self.device)
        u = torch.rand(tuple(shape), generator=self.gen, device=self.device)
        return u * (float(maxval) - float(minval)) + float(minval)

    def poisson(self, key, lam) -> torch.Tensor:
        """Poisson counts (float32) of the rate tensor `lam`, on `device`;
        `key` is the JAX key of the draw (used by the "jax" source only)."""
        if self.kind == "jax":
            lam = lam.detach().to("cpu", torch.float32).numpy()
            return torch.from_numpy(rng.poisson(key, lam).astype(
                np.float32)).to(self.device)
        return torch.poisson(lam.to(self.device, torch.float32),
                             generator=self.gen)


def train_keys(seed: int):
    """The training chain: yields (k_data, k_noise, k_cons) per step."""
    key = rng.PRNGKey(seed)
    while True:
        key, sub = rng.split(key)
        k_data, k_noise, k_cons = rng.split(sub, 3)
        yield k_data, k_noise, k_cons


def eval_keys(seed: int = 2024):
    """The eval chain: yields (k_unprocess, k_noise) per batch."""
    key = rng.PRNGKey(seed)
    while True:
        key, k1, k2 = rng.split(key, 3)
        yield k1, k2

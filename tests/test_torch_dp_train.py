"""The port's data-parallel AWGN trainer (DistributedDataParallel over a
spawned 2-rank gloo group) against its single-process step and against
the JAX trainer's step on a 2-device mesh (CPU, fp32).

GuidedResUnet nf=4 on a global batch of 4 crops of 32 px (16x16 RGGB
planes), the fresh init (equal to JAX's), the "jax" field source, so
every rank draws JAX's cameras, sigmas and fields over the global batch
and keeps its 2 rows. The rank side is `train.trainer.step_record`.
Tolerances:
- 2 ranks against 1 on the same global batch: tests/test_parallel.py's
  bounds for JAX (loss 1e-5 relative, weights rtol 2e-5 and atol 2e-6);
- the ranks' weights after the step: bit-equal;
- 2 ranks against JAX's jitted `_train_step` on a 2-device mesh:
  tests/test_torch_train.py's `_check_step` (loss and PSNR rtol 1e-5;
  gradients and moments within 1e-4 / 2e-4 of each tensor's max;
  weights within the move Adam's first step allows for the gradient
  error, at most 0.5% of the entries apart by more than 3e-8).
"""
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yondx.train.trainer as j_trainer_mod
from yondx.parallel.mesh import make_mesh, replicate, shard_batch
from yondx.train import AWGNTrainer as JTrainer

from yondx_torch.core import rng
from yondx_torch.models.registry import build_model
from yondx_torch.parallel import spawn
from yondx_torch.train.trainer import step_record
from test_torch_train import GRU4, LR, _args, _batch, _check_step
from torch_test_util import _one_torch_thread  # noqa: F401


KEY = np.asarray(jax.random.PRNGKey(21))


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return str(tmp_path_factory.mktemp("dp"))


@pytest.fixture(scope="module")
def steps(work):
    """(one process's record, [rank 0's, rank 1's]) of the same step."""
    args = _args(os.path.join(work, "port"))
    batch, keys = _batch(3), rng.split(KEY, 3)
    old = os.getcwd()
    os.chdir(work)
    try:
        one = step_record(None, args, batch, keys, LR, field="jax",
                          device="cpu")
        ranks = spawn(2, step_record, args, batch, keys, LR, field="jax",
                      device="cpu")
    finally:
        os.chdir(old)
    return one, ranks


def test_two_ranks_equal_one(steps):
    one, (r0, r1) = steps
    assert abs(r0["loss"] - one["loss"]) < 1e-5 * max(1.0, abs(one["loss"]))
    assert abs(r0["psnr"] - one["psnr"]) < 1e-5 * abs(one["psnr"])
    for n, w in one["p"].items():
        np.testing.assert_allclose(r0["p"][n], w, rtol=2e-5, atol=2e-6,
                                   err_msg=n)
    # a real step: gradients are not zero
    assert max(float(np.abs(g).max()) for g in r0["g"].values()) > 0


def test_ranks_hold_equal_weights(steps):
    _, (r0, r1) = steps
    assert r0["loss"] == r1["loss"] and r0["psnr"] == r1["psnr"]
    for n in r0["p"]:
        np.testing.assert_array_equal(r0["p"][n], r1["p"][n], err_msg=n)
        np.testing.assert_array_equal(r0["g"][n], r1["g"][n], err_msg=n)


def _as_port(rec):
    """A trainer-shaped view of a step record for _check_step."""
    model = build_model(dict(GRU4))
    state = {}
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(rec["p"][n]))
            p.grad = torch.from_numpy(rec["g"][n])
            state[p] = {"exp_avg": torch.from_numpy(rec["mu"][n]),
                        "exp_avg_sq": torch.from_numpy(rec["nu"][n])}
    return types.SimpleNamespace(
        model=model, optimizer=types.SimpleNamespace(state=state),
        _frozen=frozenset())


def test_two_ranks_match_jax_two_devices(steps, work):
    _, (r0, _) = steps
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_trainer_mod, "SyntheticSRGBDataset", functools.partial(
            j_trainer_mod.SyntheticSRGBDataset,
            disk_cache=os.path.join(work, "jax_synth")))
        mp.chdir(work)
        tr = JTrainer(_args(os.path.join(work, "jax")), mesh=make_mesh(2))
    params = replicate(tr.mesh, tr.params)
    out = tr._train_step(params, tr.opt_state, jnp.asarray(KEY),
                         shard_batch(tr.mesh, jnp.asarray(_batch(3))),
                         jnp.float32(LR), params, jnp.float32(0.0))
    new_p, new_s, loss, m, _ = out
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(
        (new_p, new_s)))
    _check_step(_as_port(r0), (tree[0], tree[1], float(loss), float(m)),
                (r0["loss"], r0["psnr"]))

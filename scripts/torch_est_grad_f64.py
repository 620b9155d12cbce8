"""Which side is nearer the exact gradient of EstUnet nf64's map loss?

    python scripts/torch_est_grad_f64.py [--card] [--jax]

On the inputs of `chip_smoke.py` phase 11a (a "jax"-field batch of 4
synthetic crops of 64 px, its EstUnet features built on the CPU, flax's
default init at nf 64, depth 3, in_nc 12, out_nc 4), the gradient of the
masked L1 map loss with respect to every weight is read in float32 by
the PyTorch port on the CPU, by the JAX package on the CPU (--jax, in this
repository's JAX environment) and by the port on the CUDA card (--card),
and each is held against the port's modules run in float64 on the same
weights and inputs. Printed per side: the worst error over each tensor's
max, its tensor, and down1_1's bias error (the tensor where card and CPU
were seen to differ most).
"""
from __future__ import annotations

import argparse
import copy
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

EST_MAP_ARCH = {"name": "EstUnet", "in_nc": 12, "out_nc": 4, "pge": False}
HELD = "down1_1.bias"


def inputs_11a():
    """The port's est trainer (CPU, "jax" fields) and phase 11a's inputs."""
    from yondx_torch.config import load_runfile
    from yondx_torch.core import rng
    from yondx_torch.data.datasets import SyntheticSRGBDataset, to_unit
    from yondx_torch.train.pg_trainer import PGEstTrainer
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    args = load_runfile(os.path.join(repo, "runfiles", "Gaussian",
                                     "EstPGE.yml"), mode="train")
    args["arch"] = dict(EST_MAP_ARCH)
    ds = SyntheticSRGBDataset(length=4, size=64, seed=1997, cache=False)
    x = to_unit(np.stack([ds[i] for i in range(4)]), "cpu")
    tr = PGEstTrainer(args, device="cpu", field="jax")
    return tr, tr.inputs(x, next(rng.rng_seq(0)))


def torch_grads(tr, inputs, device, dtype):
    """{name: gradient} of the map loss, the net on `device` in `dtype`."""
    net = copy.deepcopy(tr.model).to(device=device, dtype=dtype)
    inp = {k: v.to(device=device, dtype=dtype) for k, v in inputs.items()}
    pred = net(inp["x"])
    err = torch.abs(pred - inp["target"]) * inp["mask"]
    loss = torch.sum(err) / torch.clamp(torch.sum(inp["mask"]), min=1.0)
    loss.backward()
    return {n: p.grad.detach().cpu().double().numpy()
            for n, p in net.named_parameters()}


def jax_grads(tr, inputs):
    """The same gradient by the JAX package's EstUnet on the CPU."""
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    from yondx.models import build_model
    from yondx_torch.models.convert import (params_to_state_dict,
                                            state_dict_to_params)
    model = build_model(dict(EST_MAP_ARCH))
    params = state_dict_to_params(tr.model.state_dict())
    feats, target, mask = (jnp.asarray(inputs[k].numpy())
                           for k in ("x", "target", "mask"))

    def loss(p):
        err = jnp.abs(model.apply(p, feats) - target) * mask
        return jnp.sum(err) / jnp.maximum(jnp.sum(mask), 1.0)

    g = jax.jit(jax.grad(loss))(params)
    return {n: t.double().numpy() for n, t in params_to_state_dict(
        jax.tree.map(np.asarray, g)).items()}


def report(label, got, exact) -> None:
    rel = {n: float(np.abs(got[n] - exact[n]).max())
           / max(float(np.abs(exact[n]).max()), 1e-300) for n in exact}
    worst = max(rel, key=rel.get)
    print(f"{label}: worst error over the tensor's max {rel[worst]:.3e} "
          f"(at {worst}); {HELD} {rel[HELD]:.3e}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--card", action="store_true",
                    help="also read the port's float32 gradient on cuda")
    ap.add_argument("--jax", action="store_true",
                    help="also read the JAX package's float32 gradient")
    opts = ap.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    tr, inputs = inputs_11a()
    exact = torch_grads(tr, inputs, "cpu", torch.float64)
    print(f"EstUnet nf64 d3 in12, phase 11a's inputs "
          f"{list(inputs['x'].shape)}; float64 {HELD} max "
          f"{np.abs(exact[HELD]).max():.6e}", flush=True)
    report("port cpu float32", torch_grads(tr, inputs, "cpu",
                                           torch.float32), exact)
    if opts.jax:
        report("jax cpu float32", jax_grads(tr, inputs), exact)
    if opts.card:
        report(f"port {torch.cuda.get_device_name(0)} float32",
               torch_grads(tr, inputs, "cuda", torch.float32), exact)


if __name__ == "__main__":
    main()

"""Does torch's intra-op worker thread compute elementwise ops right?

Runs the port's VST and inverse VST (the inputs of
tests/test_torch_modules.py::test_vst_and_inverse_match_jax) and the
device unprocess chain (the inputs of
tests/test_torch_train_data.py::test_device_srgb_to_pseudo_raw_matches_jax)
with torch's default thread count, in fresh processes, and holds them to
a float64 numpy reference (the VST) and to the same process's one-thread
run (the chain). Each process also runs the VST on a 4M-element vector,
which torch splits over its worker threads.

    python3 scripts/torch_thread_check.py [--runs 200] [--jobs 6]
        [--with-jax] [--reps 20] [--json out.json]

`--with-jax` makes each process import JAX and run one jitted op first.
Prints one JSON line: runs, failures, the worst relative VST error and the
worst chain difference, and the first failing run's details. Exits 1 if a
run failed. `--child` is the per-process body.

    python3 scripts/torch_thread_check.py --first-call none|threads|sqrt|exp|port

runs the bare first call instead: each fresh process imports torch, does
nothing first ("none"), sets torch's thread count to its own value
("threads"), takes the sqrt or exp of 16 elements ("sqrt", "exp") or
imports yondx_torch ("port", whose import starts MKL's vector math on
one thread: yondx_torch/core/vml.py), then takes its first
multi-threaded sqrt (32768 elements) against float64; a failure is any
element more than 1e-6 (relative) off.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VST_RTOL = 1e-5        # fp32 against float64: a few ulps; the fault was 2.8e-4
CHAIN_ATOL = 1e-6      # the unprocess test's own bound; the fault was 1.1e-5


def _vst64(x, K, sig):
    fz = np.maximum(K * x + 0.375 * K * K + sig * sig, 0.0)
    return (2.0 / K) * np.sqrt(fz)


def child(with_jax: bool, reps: int) -> dict:
    if with_jax:
        import jax
        import jax.numpy as jnp
        jax.jit(lambda a: a * 2.0 + 1.0)(jnp.ones(8)).block_until_ready()
    import torch
    from yondx_torch.data import unprocess
    from yondx_torch.vst import vst as tv
    threads = torch.get_num_threads()
    K, sig = np.float32(8.74), np.float32(12.81)
    x_small = (np.random.default_rng(2).random(4096) * 900).astype(np.float32)
    x_big = (np.random.default_rng(3).random(1 << 22) * 900).astype(np.float32)
    worst_vst, bad = 0.0, []
    for x in (x_small, x_big):
        ref = _vst64(x.astype(np.float64), float(K), float(sig))
        for r in range(reps if x is x_small else max(1, reps // 4)):
            z = tv.vst(torch.from_numpy(x), torch.tensor(sig),
                       gain=torch.tensor(K)).numpy()
            err = np.abs(z - ref) / np.abs(ref)
            worst_vst = max(worst_vst, float(err.max()))
            if err.max() > VST_RTOL:
                idx = np.flatnonzero(err > VST_RTOL)
                bad.append({"case": f"vst n={x.size}", "rep": r,
                            "n_bad": int(idx.size), "first": int(idx[0]),
                            "last": int(idx[-1]), "max": float(err.max())})
            inv = tv.inverse_vst(torch.from_numpy(z), torch.tensor(sig),
                                 gain=torch.tensor(K), exact=True).numpy()
            if not np.isfinite(inv).all():
                bad.append({"case": "inverse_vst", "rep": r})
    imgs = np.random.default_rng(5).random((6, 32, 32, 3), np.float32)
    imgs[0, :8, :8] = 1.0
    key = np.array([0, 11], np.uint32)

    def chain():
        out = unprocess.srgb_to_pseudo_raw_device(
            key, torch.from_numpy(imgs), bayer_aug_enabled=False)
        return out[0].numpy().copy()

    many = [chain() for _ in range(reps)]
    torch.set_num_threads(1)
    one = chain()
    torch.set_num_threads(threads)
    worst_chain = max(float(np.abs(m - one).max()) for m in many)
    if worst_chain > CHAIN_ATOL:
        bad.append({"case": "unprocess", "max": worst_chain})
    return {"threads": threads, "with_jax": with_jax, "vst_rel": worst_vst,
            "chain_abs": worst_chain, "bad": bad}


def first_call(mode: str) -> dict:
    import torch
    if mode == "threads":
        torch.set_num_threads(torch.get_num_threads())
    elif mode in ("sqrt", "exp"):
        getattr(torch, mode)(torch.ones(16))
    elif mode == "port":
        import yondx_torch  # noqa: F401
    x = (np.random.default_rng(2).random(32768) * 900 + 1).astype(np.float32)
    ref = np.sqrt(x.astype(np.float64))
    err = np.abs(torch.sqrt(torch.from_numpy(x)).numpy() - ref) / ref
    bad = np.flatnonzero(err > 1e-6)
    return {"threads": torch.get_num_threads(), "vst_rel": float(err.max()),
            "chain_abs": 0.0, "with_jax": False,
            "bad": [{"case": f"first sqrt after {mode}", "n_bad": int(
                bad.size), "first": int(bad[0]), "max": float(err.max())}]
            if bad.size else []}


def run(runs: int, jobs: int, with_jax: bool, reps: int,
        mode: str = None) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("OMP_NUM_THREADS", "MKL_NUM_THREADS")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    cmd = [sys.executable, os.path.abspath(__file__), "--child",
           "--reps", str(reps)] + (["--with-jax"] if with_jax else []) \
        + (["--first-call", mode] if mode else [])

    def one(_):
        res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             timeout=600)
        if res.returncode != 0:
            return {"error": res.stderr[-2000:]}
        return json.loads(res.stdout.strip().splitlines()[-1])

    with ThreadPoolExecutor(jobs) as pool:
        outs = list(pool.map(one, range(runs)))
    failed = [o for o in outs if "error" in o or o["bad"]]
    ok = [o for o in outs if "error" not in o]
    return {"runs": runs, "jobs": jobs, "with_jax": with_jax, "reps": reps,
            "first_call": mode,
            "threads": sorted({o["threads"] for o in ok}),
            "failures": len(failed),
            "worst_vst_rel": max((o["vst_rel"] for o in ok), default=None),
            "worst_chain_abs": max((o["chain_abs"] for o in ok),
                                   default=None),
            "first_failure": failed[0] if failed else None}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=200)
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--with-jax", action="store_true")
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--json", default=None)
    ap.add_argument("--first-call", default=None,
                    choices=("none", "threads", "sqrt", "exp", "port"))
    a = ap.parse_args()
    if a.child:
        print(json.dumps(first_call(a.first_call) if a.first_call
                         else child(a.with_jax, a.reps)))
        sys.exit(0)
    out = run(a.runs, a.jobs, a.with_jax, a.reps, a.first_call)
    line = json.dumps(out)
    print(line)
    if a.json:
        with open(a.json, "w") as f:
            f.write(line + "\n")
    sys.exit(1 if out["failures"] else 0)

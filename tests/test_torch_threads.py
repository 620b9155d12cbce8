"""Torch's intra-op worker threads on the port's elementwise ops, in fresh
processes that never import JAX, with torch's default thread count
(scripts/torch_thread_check.py):

- a process's first multi-threaded sqrt after `import yondx_torch`, in
  24 fresh processes, within 1e-6 (relative) of float64. Without the
  import's warm-up (core/vml.py) about one such process in eleven got a
  worker's chunk up to 3.2e-4 off (27 of 300, CPU run, PR 16), so this
  check failed with odds of about nine in ten before the repair;
- the VST and inverse VST on the inputs of
  tests/test_torch_modules.py::test_vst_and_inverse_match_jax (and on 4M
  elements, which torch splits over its workers) within 1e-5 (relative)
  of a float64 reference, and the device unprocess chain within 1e-6 of
  the same process's one-thread run. Before the port warmed MKL's vector
  math at import (core/vml.py), about one fresh process in a hundred got
  a worker's 2048-element sqrt chunk up to 2.77e-4 off on its first call,
  with or without JAX in the process (CHANGES.md, PR 16);
- importing yondx_torch has made one call of every op that torch routes
  to MKL's VML, in float32 and float64, on the calling thread: the list
  in core/vml.py holds each `IMPLEMENT_VML_MKL` op of the installed
  torch's ATen/cpu/vml.h.
"""
import json
import os
import re
import subprocess
import sys

import torch

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("OMP_NUM_THREADS", "MKL_NUM_THREADS")}
    env["PYTHONPATH"] = REPO
    return env


def _check(*args):
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "torch_thread_check.py"), *args],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=600)
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert res.returncode == 0 and out["failures"] == 0, out
    assert out["with_jax"] is False and out["threads"][0] >= 1
    return out


def test_first_call_after_importing_the_port():
    out = _check("--first-call", "port", "--runs", "24", "--jobs", "8")
    assert out["worst_vst_rel"] <= 1e-6


def test_thread_check_without_jax():
    out = _check("--runs", "2", "--jobs", "2", "--reps", "3")
    assert out["worst_vst_rel"] <= 1e-5 and out["worst_chain_abs"] <= 1e-6


def test_importing_the_port_warms_mkl_vml():
    code = ("import sys, yondx_torch\n"
            "from yondx_torch.core import vml\n"
            "assert vml._done\n"
            "assert not any(m.split('.')[0] in ('jax', 'jaxlib') "
            "for m in sys.modules)\n"
            "print(' '.join(vml.OPS))")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    ops = set(res.stdout.split())
    header = os.path.join(os.path.dirname(torch.__file__), "include", "ATen",
                          "cpu", "vml.h")
    if os.path.exists(header):
        with open(header) as f:
            mkl = set(re.findall(r"^IMPLEMENT_VML_MKL\((\w+),", f.read(),
                                 re.M))
        assert mkl and mkl <= ops, sorted(mkl - ops)

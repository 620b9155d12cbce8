"""The card machine has torch, numpy and scipy but no jax, flax, msgpack,
PyYAML, cv2 or h5py, and the port must never reach the JAX package. In a
fresh interpreter whose import system refuses those packages, every
module of yondx_torch and chip_smoke.py must import (readers that need
h5py import it when called, and raise naming it where it is absent).
"""
import os
import pkgutil
import subprocess
import sys

import yondx_torch

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

SCRIPT = r"""
import importlib, importlib.util, pkgutil, sys

REFUSED = {"jax", "jaxlib", "flax", "msgpack", "yaml", "yondx", "cv2",
           "h5py"}


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"refused: {name}")
        return None


sys.meta_path.insert(0, Refuse())
for name in REFUSED:
    try:
        importlib.import_module(name)
    except ImportError:
        continue
    raise SystemExit(f"the guard let {name} through")

import yondx_torch
names = ["yondx_torch"] + [m.name for m in pkgutil.walk_packages(
    yondx_torch.__path__, "yondx_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
if leaked:
    raise SystemExit(f"refused modules present: {leaked}")
print(" ".join(names))
"""


def test_port_imports_without_jax_flax_msgpack_yaml_or_yondx():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    # every module of the package was imported
    want = ["yondx_torch"] + [m.name for m in pkgutil.walk_packages(
        yondx_torch.__path__, "yondx_torch.")]
    assert res.stdout.split() == want


TRAINING = ["yondx_torch.train", "yondx_torch.train.trainer",
            "yondx_torch.train.losses", "yondx_torch.train.schedule",
            "yondx_torch.train.ckpt", "yondx_torch.train.draws",
            "yondx_torch.train.s2d_port", "yondx_torch.cli.trainer_awgn",
            "yondx_torch.core.meters", "yondx_torch.data.noise",
            "yondx_torch.data.augment", "yondx_torch.train.pg_trainer",
            "yondx_torch.cli.train_est", "yondx_torch.data.pg_dataset",
            "yondx_torch.data.raw_dataset", "yondx_torch.data.video"]


def test_training_modules_are_in_the_refused_import_run():
    """The training slice's modules are among those the guarded run
    imports, and none of their sources names a refused package."""
    names = [m.name for m in pkgutil.walk_packages(yondx_torch.__path__,
                                                   "yondx_torch.")]
    assert set(TRAINING) <= set(names)
    for name in TRAINING:
        path = os.path.join(REPO, *name.split(".")) + ".py"
        if not os.path.exists(path):
            path = os.path.join(REPO, *name.split("."), "__init__.py")
        with open(path) as f:
            src = f.read()
        for pkg in ("jax", "flax", "optax", "msgpack", "yondx."):
            assert f"import {pkg}" not in src and f"from {pkg}" not in src, \
                (name, pkg)


PARALLEL = ["yondx_torch.parallel", "yondx_torch.parallel.mesh",
            "yondx_torch.parallel.spatial", "yondx_torch.parallel.product"]


def test_parallel_modules_are_in_the_refused_import_run():
    """The mesh, spatial and product modules are among those the guarded
    run imports (jax, cv2 and h5py refused), and none of their sources
    names jax or the JAX package."""
    names = [m.name for m in pkgutil.walk_packages(yondx_torch.__path__,
                                                   "yondx_torch.")]
    assert set(PARALLEL) <= set(names)
    for name in PARALLEL:
        path = os.path.join(REPO, *name.split(".")) + ".py"
        if not os.path.exists(path):
            path = os.path.join(REPO, *name.split("."), "__init__.py")
        with open(path) as f:
            src = f.read()
        for pkg in ("jax", "flax", "yondx.", "cv2", "h5py"):
            assert f"import {pkg}" not in src and f"from {pkg}" not in src, \
                (name, pkg)

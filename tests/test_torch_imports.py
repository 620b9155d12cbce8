"""The card machine has torch, numpy and scipy but no jax, flax, msgpack,
PyYAML, cv2, h5py, matplotlib, PIL, zstandard, tensorstore or orbax, and
the port must never reach the JAX package. In a fresh interpreter whose
import system refuses those packages, every module of yondx_torch and
chip_smoke.py must import (readers and figures that need cv2 or
matplotlib import it when called, and raise naming it where it is
absent). No source of the port names h5py: its HDF5 reader is its own.
"""
import os
import pkgutil
import re
import subprocess
import sys

import yondx_torch

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

SCRIPT = r"""
import importlib, importlib.util, pkgutil, sys

REFUSED = {"jax", "jaxlib", "flax", "msgpack", "yaml", "yondx", "cv2",
           "h5py", "matplotlib", "PIL", "zstandard", "tensorstore", "orbax"}


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
    # the ISP and the figure tools are among them
    for name in ("core.png", "core.profiling", "isp.demosaic", "isp.render",
                 "isp.raw_io", "isp.filters", "eval.visualization",
                 "eval.debugger", "io.ocdbt", "io.hdf5",
                 "train.orbax_ckpt"):
        assert f"yondx_torch.{name}" in want


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


def test_no_port_source_names_h5py_zstandard_tensorstore_or_orbax():
    """The DND reader and dataload's v7.3 branch read HDF5 with the port's
    own reader, and orbax checkpoints go through its own OCDBT store and
    zstd decoder: no source of the port or chip_smoke.py names h5py, and
    none imports zstandard, tensorstore or orbax."""
    pkg = os.path.dirname(yondx_torch.__file__)
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, files in os.walk(pkg):
        paths += [os.path.join(d, f) for f in files
                  if f.endswith((".py", ".cpp", ".c", ".cu"))]
    for path in paths:
        with open(path) as f:
            src = f.read()
        assert "h5py" not in src, path
        for pkg_name in ("zstandard", "tensorstore", "orbax"):
            assert not re.search(rf"^\s*(import|from)\s+{pkg_name}\b", src,
                                 re.M), (path, pkg_name)


ONE_OFF_CLIS = ["yondx_torch.cli." + n for n in (
    "bench_loader", "bench_robust_overhead", "chroma_probe", "unet_roofline",
    "train_gru", "train_unet", "train_chunked")]


def test_one_off_clis_are_in_the_refused_import_run():
    """The seven one-off benches and trainers (the port's last slice) are
    among the modules the guarded run imports, and none of their sources
    names jax or the JAX package."""
    names = [m.name for m in pkgutil.walk_packages(yondx_torch.__path__,
                                                   "yondx_torch.")]
    assert set(ONE_OFF_CLIS) <= set(names)
    for name in ONE_OFF_CLIS:
        with open(os.path.join(REPO, *name.split(".")) + ".py") as f:
            src = f.read()
        for pkg in ("jax", "flax", "yondx."):
            assert f"import {pkg}" not in src and f"from {pkg}" not in src, \
                (name, pkg)

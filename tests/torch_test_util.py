"""Fixtures shared by the port's test files (tests/test_torch_*.py).

A file pulls a fixture in with one import, e.g.
`from torch_test_util import _one_torch_thread  # noqa: F401`.
"""
import dataclasses
import importlib.util
import os
import re
import sys

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run the importing module's torch ops on the calling thread alone.

    The suite runs in parallel workers, and torch's default of one thread
    per core in every worker oversubscribes the machine. One thread also
    kept every op off torch's intra-op worker threads, whose chunk of an
    elementwise op (the second 2048 elements of a 4096-element sqrt, the
    second half of a batch's sin/asin) came out up to 2.8e-4 (relative)
    off in sqrt and 1.1e-5 off after the unprocess chain in some of the
    suite's processes. The cause was a process's first call into MKL's
    vector math running on several threads at once, with or without JAX
    in the process; importing yondx_torch now makes that first call on
    one thread (yondx_torch/core/vml.py, tests/test_torch_threads.py).
    """
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def refine_planes_data():
    """(z_dn, z_noisy, nsr) [2, 96, 144, 4] float32 for the Wiener refine:
    piecewise-flat planes with a textured half the 'denoiser' smoothed
    away, a near-white strip, and quieter noise there (clipped)."""
    rng = np.random.default_rng(8)
    levels = np.kron(rng.random((2, 4, 6, 1)) * 0.9 + 0.05,
                     np.ones((1, 24, 24, 4))).astype(np.float32)
    yy, xx = np.mgrid[0:96, 0:144]
    tex = (0.06 * np.sin(0.9 * xx + 0.4 * yy) * (xx < 72))[None, :, :, None]
    clean = np.clip(levels + tex, 0, 1).astype(np.float32)
    clean[:, :10] = 0.99
    nsr = 0.03
    noise = rng.normal(0, nsr, clean.shape) * np.where(clean > 0.9, 0.3, 1.0)
    z_noisy = (clean + noise).astype(np.float32)
    z_dn = (levels + rng.normal(0, nsr * 0.2, clean.shape)).astype(
        np.float32)
    z_dn[:, :10] = 0.99
    return z_dn, z_noisy, nsr


class BoxBlur3(torch.nn.Module):
    """A 3x3 reflect-101 box mean per channel of [B, h, w, C] planes: the
    port's stand-in for tests/test_product_50mp.py's _BlurModel (a weak
    denoiser with a 1-px receptive field). It lives here, beside no JAX
    import, so that the ranks of a spawned test group can unpickle it."""

    def forward(self, x, t=None):
        from yondx_torch.nle.boxfilter import box_mean
        return box_mean(x, 3)


def run_fullframe(mesh, engine, dataset, name):
    """FullFrameHarness(engine, dataset, name, mesh=mesh).run() on one rank
    of a spawned test group (a module-level function, so that it pickles)."""
    from yondx_torch.eval.fullframe import FullFrameHarness
    return FullFrameHarness(engine, dataset, name, mesh=mesh).run()


# ---------------------------------------------------------------------------
# The probe CLIs (yondx_torch/cli/probe_*.py, bench_matrix.py) against the
# JAX scripts they port, loaded from scripts/ and run on the CPU.
REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
_NUM = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:e[-+]?\d+)?|nan|inf")
_STAMP = re.compile(r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d ")


def load_jax_script(monkeypatch, tmp_path, name, argv, cut=None):
    """scripts/<name>.py loaded as a module, ready for its main(): run
    from the repo root with sys.argv = [name, *argv], its XLA cache in
    tmp_path, flax's init templates abstract (each leaf is then the
    checkpoint's; flax's eager init costs ~22 s a net here), and, with
    cut = (size, n_crops), every held-out scene it builds cut to that
    size and crop count."""
    import jax
    from yondx.eval import heldout as j_heldout
    from yondx.models import registry as j_registry
    monkeypatch.chdir(REPO)
    real = j_registry.init_params
    monkeypatch.setattr(j_registry, "init_params", lambda *a, **k:
                        jax.eval_shape(lambda: real(*a, **k)))
    if cut is not None:
        build = j_heldout.build_scene
        monkeypatch.setattr(j_heldout, "build_scene",
                            lambda spec, n_crops=None: build(
                                dataclasses.replace(spec, size=cut[0]),
                                cut[1]))
    update = jax.config.update

    def redirect(key, value):
        if key == "jax_compilation_cache_dir":
            value = str(tmp_path / "xla_cache")
        return update(key, value)

    monkeypatch.setattr(jax.config, "update", redirect)
    monkeypatch.setattr(sys, "argv", [name, *argv])
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def record(monkeypatch, owner, attr, store):
    """Wrap owner.attr so that each call appends its result to `store`:
    a float, or a float64 array of a tuple result."""
    real = getattr(owner, attr)

    def wrapped(*a, **k):
        out = real(*a, **k)
        store.append(np.asarray(out, np.float64)
                     if isinstance(out, tuple) else float(out))
        return out

    monkeypatch.setattr(owner, attr, wrapped)


def cut_scenes(suite, names, size, n_crops=1, key=None):
    """The port's held-out scenes `names` of `suite` cut to `size` px and
    n_crops crops, keyed (name, key) as the probes' scene dicts."""
    from yondx_torch.eval import heldout as t_heldout
    specs = {s.name: s for s in t_heldout.SUITES[suite]}
    return {(n, key): t_heldout.build_scene(
        dataclasses.replace(specs[n], size=size), n_crops) for n in names}


def printed(text, pattern):
    """The printed lines that match `pattern` (re.match), timestamps
    stripped."""
    lines = [_STAMP.sub("", ln) for ln in text.splitlines()]
    return [ln for ln in lines if re.match(pattern, ln)]


def layout(line):
    """A printed line with every number replaced by '#'."""
    return _NUM.sub("#", line)

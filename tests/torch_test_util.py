"""Fixtures shared by the port's test files (tests/test_torch_*.py).

A file pulls a fixture in with one import, e.g.
`from torch_test_util import _one_torch_thread  # noqa: F401`.
"""
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

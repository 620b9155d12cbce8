"""The port's product path against the JAX `make_fused_blind_denoiser` on
the 36x128 Bayer frame `_frame(40, 128, 3)` of test_torch_fused.py, RGGB
[1,18,64,4]: planes of 18 rows, fewer than the 23-sample texture halo.

There the self estimate collapses to the beta1 clamp on both sides, and
at K = 1e-4 the fp32 VST and its inverse cancel, so the collab round
turns on rounding: JAX's jitted run differs from its own eager run by
~90% in the collab regs and 0.16 in the output. The port runs op by op,
as JAX's eager run does, and is held to that run at the tolerances of
test_torch_fused.py (regs rtol 1e-3, output atol 2e-4); the round-0
regs, which come before the cancellation, are held to the jitted run
too. Its own file, since the eager JAX run takes ~40 s on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from yondx.pipeline.fused import make_fused_blind_denoiser as j_make
from yondx.vst.lut import BiasLUT as JBiasLUT

from yondx_torch.pipeline.fused import make_fused_blind_denoiser as t_make
from yondx_torch.vst.lut import BiasLUT

from test_torch_fused import PRODUCT, _frame, assert_regs_close, nets  # noqa: F401
from torch_test_util import _two_torch_threads  # noqa: F401


def test_slice_matches_jax_eager_36x128(nets):
    model, variables, net = nets
    rggb = _frame(40, 128, 3)
    assert rggb.shape == (1, 18, 64, 4)
    ft = t_make(net, BiasLUT().lut, device="cpu", **PRODUCT)
    dn_t, regs_t = (t.numpy() for t in ft(torch.from_numpy(rggb.copy()),
                                          959.0))
    fj = j_make(model, variables, JBiasLUT().lut, **PRODUCT)
    regs_jit = np.asarray(fj(jnp.asarray(rggb), jnp.float32(959.0))[1])
    with jax.disable_jit():
        fe = j_make(model, variables, JBiasLUT().lut, **PRODUCT)
        dn_e, regs_e = (np.asarray(a) for a in
                        fe(jnp.asarray(rggb), jnp.float32(959.0)))
    assert float(regs_e[0, 0]) < 1e-6                   # the beta1 clamp
    assert_regs_close(regs_t[0], regs_jit[0])
    assert_regs_close(regs_t, regs_e)
    np.testing.assert_allclose(dn_t, dn_e, atol=2e-4)

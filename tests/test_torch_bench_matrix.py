"""The port's bench_matrix CLI (yondx_torch/cli/bench_matrix.py) against
scripts/bench_matrix.py, loaded from its file, on the CPU, with the
committed Gaussian_GRU_mix_5to50_norm, both on bench.py's make_frame cut
to 256 x 256 (252 x 256: the frame's 12 level rows divide 252).

On the CPU, JAX's 'pallas-hist' row does not reach the Pallas kernel:
fused_moments takes its plain XLA reference there with the Pallas band
margins, and the port's plain box moments are held to that. Per fp32
configuration and for the orchestrated fp32 engine: PSNR out within 0.01
dB (JAX's psnr wrapped, so read at full precision), the regs at rtol 1e-3
(the robust NLE's parity bound; JAX's read from its timed call's output
and its engine's result). The bf16 rows (the card's setting; bf16 on two
CPU backends is not a parity check) run and gain on the port's side;
JAX's run in fp32 here (jnp.bfloat16 reads None in the script's
namespace, its fp32 setting) through the fp32 rows' jitted entries:
JAX's six fused compiles and the engine's took ~63 s of this CPU, the
bf16 three ~26 s of it.
Each row prints in the script's layout (the orchestrated row adds its
K_est).
"""
import jax.numpy as jnp
import numpy as np

import bench as j_bench
from yondx.pipeline import YONDEngine as JYONDEngine

from yondx_torch import bench as t_bench
from yondx_torch.cli import bench_matrix as bm
from torch_test_util import _one_torch_thread  # noqa: F401
from torch_test_util import layout, load_jax_script, printed, record

FRAME = (256, 256)


class _NoBF16:
    """jax.numpy with bfloat16 read as None."""
    bfloat16 = None

    def __getattr__(self, name):
        return getattr(jnp, name)


def test_bench_matrix_matches_jax(monkeypatch, tmp_path, capsys):
    frame = j_bench.make_frame
    monkeypatch.setattr(j_bench, "make_frame", lambda: frame(*FRAME))
    results = []
    real = JYONDEngine.iter_denoise

    def iter_denoise(self, *a, **k):
        res = real(self, *a, **k)
        results.append(res)
        return res

    monkeypatch.setattr(JYONDEngine, "iter_denoise", iter_denoise)
    mod = load_jax_script(monkeypatch, tmp_path, "bench_matrix", [])
    assert mod.benchmod is j_bench
    monkeypatch.setattr(mod, "jnp", _NoBF16())
    made, make = {}, mod.make_fused_blind_denoiser

    def make_once(model, params, lut, **kw):
        key = tuple(sorted(kw.items()))
        if key not in made:
            made[key] = make(model, params, lut, **kw)
        return made[key]

    monkeypatch.setattr(mod, "make_fused_blind_denoiser", make_once)
    psnrs, outs = [], []
    record(monkeypatch, mod, "psnr", psnrs)
    timeit = mod.timeit

    def timed(fn, *a, **k):
        # one timed call after the warm-up: JAX's timings are not compared
        dt, out = timeit(fn, *a, reps=1)
        outs.append(np.asarray(out[1]))
        return dt, out

    monkeypatch.setattr(mod, "timeit", timed)
    mod.main()
    pattern = r"(frame|fp32/|bf16/|orchestrated)"
    want = printed(capsys.readouterr().out, pattern)
    t_frame = t_bench.make_frame
    monkeypatch.setattr(t_bench, "make_frame", lambda: t_frame(*FRAME))
    got = bm.main(["--cpu"])
    lines = printed(capsys.readouterr().out, pattern)
    assert [layout(x) for x in lines[:-1]] == [layout(x) for x in want[:-1]]
    assert layout(lines[-1]).startswith(layout(want[-1]))
    keys = [f"{t}/{n}" for t, _ in bm.DTYPES for n, _, _ in bm.MATRIX]
    assert list(got["matrix"]) == keys and len(outs) == len(keys)
    # JAX's psnr calls: the noisy frame, each configuration, the engine
    p_in = psnrs[0]
    for key, p, regs in zip(keys, psnrs[1:], outs):
        r = got["matrix"][key]
        assert abs(r["psnr_in"] - p_in) <= 1e-4, key
        assert np.isfinite(r["regs"]).all() and r["psnr_out"] > p_in, key
        assert r["calls"] == bm.REPS + 1 and r["second_passes"] <= r["calls"]
        if key.startswith("fp32"):
            assert abs(r["psnr_out"] - p) <= 0.01, key
            np.testing.assert_allclose(r["regs"], regs, rtol=1e-3,
                                       err_msg=key)
    o = got["orchestrated"]
    assert abs(o["psnr_out"] - psnrs[-1]) <= 0.01
    np.testing.assert_allclose(o["k_est"] / 959.0, results[-1]["regs"][0][0],
                               rtol=1e-3)

"""The plain reference against yondx_torch's fused entry on the CPU, where
the entry runs its plain PyTorch paths: both nets in float32, frames the
traffic generator makes (one large enough for the NLE's row bands), and
the rescue gate's second pass forced on."""
import json
import os

import pytest
import torch

from perfbench import frames
from perfbench.reference import fused as ref_fused
from perfbench.run import build_program, build_reference

CONFIGS = ("s2dt16-bf16", "gru32-fp32")


def _config(root, name):
    with open(os.path.join(root, "perfbench", "configs", name + ".json")) as f:
        cfg = json.load(f)
    return dict(cfg, net_dtype="float32")


def _mix(root, h, w, n=2):
    with open(os.path.join(root, "perfbench", "traffic", "imx686.json")) as f:
        mix = json.load(f)
    mix["cameras"][0].update(height=h, width=w, frames=n)
    return mix


def _both(root, cfg, frame):
    fn, _ = build_program(cfg, root, "cpu")
    ref, _ = build_reference(cfg, root, "cpu")
    passes = fn.stats["second_passes"]
    dn, regs = fn(frame.rggb, frame.scale)
    fired = fn.stats["second_passes"] > passes
    return (dn, regs, fired), ref.run(frame.rggb, frame.scale)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_equals_entry(root, name):
    cfg = _config(root, name)
    pool, _ = frames.make_pool(_mix(root, 200, 328), 2 ** 31 + 7, "cpu")
    for f in pool:
        (dn, regs, fired), (r_dn, r_regs, r_fired) = _both(root, cfg, f)
        assert fired == r_fired
        torch.testing.assert_close(regs, r_regs, rtol=1e-6, atol=0)
        torch.testing.assert_close(dn, r_dn, rtol=0, atol=1e-6)


def test_reference_equals_entry_on_row_bands(root):
    """A 2048 x 2624 Bayer frame: 1024 packed rows, over 2^22 samples, so
    both NLE fits sample row bands."""
    cfg = _config(root, "s2dt16-bf16")
    from perfbench.reference.nle import band_plan
    assert band_plan((1, 1024, 1312, 4), ref_fused.MAX_PX, ref_fused.BAND,
                     ref_fused.M_SELF) is not None
    pool, _ = frames.make_pool(_mix(root, 2048, 2624, 1), 11, "cpu")
    (dn, regs, fired), (r_dn, r_regs, r_fired) = _both(root, cfg, pool[0])
    assert fired == r_fired
    torch.testing.assert_close(regs, r_regs, rtol=1e-6, atol=0)
    torch.testing.assert_close(dn, r_dn, rtol=0, atol=1e-6)


def test_reference_equals_entry_when_the_gate_fires(root, monkeypatch):
    """The gate's thresholds lowered on both sides (tolerance 1e-4,
    floor fraction -1) so that the second pass and the blend run."""
    import yondx_torch.pipeline.fused as port_fused
    monkeypatch.setattr(port_fused, "DEFAULT_FLOOR_FRAC", -1.0)
    monkeypatch.setattr(port_fused, "DEFAULT_TOL", 1e-4)
    monkeypatch.setattr(ref_fused, "FLOOR_FRAC", -1.0)
    monkeypatch.setattr(ref_fused, "TOL", 1e-4)
    cfg = _config(root, "gru32-fp32")
    pool, _ = frames.make_pool(_mix(root, 200, 328, 4), 5, "cpu")
    n_fired = 0
    for f in pool:
        (dn, regs, fired), (r_dn, r_regs, r_fired) = _both(root, cfg, f)
        assert fired == r_fired
        n_fired += fired
        torch.testing.assert_close(regs, r_regs, rtol=1e-6, atol=0)
        torch.testing.assert_close(dn, r_dn, rtol=0, atol=1e-6)
    assert n_fired > 0

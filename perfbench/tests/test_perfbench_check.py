"""`correct` comes out false when the timed path is broken underneath
and when the control (the reference one precision step down) takes the
program's place. CPU runs drive the harness with its look for a card
skipped, on small frames of each cell's own traffic, the net in float32
(where the port and the reference agree exactly on the CPU); the card
test runs the program and the control at the cell's own size.

Faults a cell can have: the denoising step returns its state unchanged
(the net hands back its input); a part of the frame left out (the net
denoises the upper half only; a call holds one frame, so there is no
batch to halve); an answer altered where it is produced (an output
value, the self noise model, the gate's decision). One card, so no
exchange between chips to leave out."""
import math
import time

import pytest
import torch

from perfbench import check, run
from perfbench.calibrate import calibrate
from perfbench.spec import load_cell

CELLS = ("s2dt16.imx686", "gru32.imx686", "s2dt16.anycam")


def _small_cell(root, name, n=2):
    cell = load_cell(root, name)
    cell.config = dict(cell.config, net_dtype="float32")
    for c in cell.traffic["cameras"]:
        c.update(height=c["height"] // 16 // 2 * 2,
                 width=c["width"] // 16 // 2 * 2, frames=n)
    return cell


def _run(root, cell, wrap=None):
    return run.run(cell, 2 ** 31 + 99, 0.01, 0, root, device="cpu",
                   wrap=wrap, t_start=time.perf_counter())[0]


def _wrap(fault):
    def wrap(fn):
        def broken(x, scale):
            dn, regs = fn(x, scale)
            return fault(fn, x, dn, regs)
        broken.stats = fn.stats
        return broken
    return wrap


def _net_fault(monkeypatch, make_forward):
    """Build the program as the harness does, then break its net."""
    real = run.build_program

    def build(cfg, root, device):
        fn, net = real(cfg, root, device)
        net.forward = make_forward(net)
        return fn, net

    monkeypatch.setattr(run, "build_program", build)


def _net_unchanged(net):
    """The denoising step returns its input unchanged."""
    return lambda x, t: x


def _net_half(net):
    """The net denoises the upper half of the frame only."""
    def forward(x, t):
        out = type(net).forward(net, x, t)
        h = x.shape[1] // 2
        return torch.cat([out[:, :h], x[:, h:]], dim=1)
    return forward


def _pixel_altered(fn, x, dn, regs):
    """One output value altered where it is produced: set to the other
    end of the range."""
    dn = dn.clone()
    v = dn[0, 3, 5, 1]
    dn[0, 3, 5, 1] = torch.where(v < 0.5, 1.0, 0.0)
    return dn, regs


def _noise_model_altered(fn, x, dn, regs):
    """The self noise model's beta1 off by 10%."""
    regs = regs.clone()
    regs[0, 0] *= 1.1
    return dn, regs


def _noise_model_altered_on_one_shape():
    """The self noise model's beta1 off by 10% on the frames of one shape
    (the first the entry sees) and right on the others."""
    first = []

    def fault(fn, x, dn, regs):
        first[:] = first or [tuple(x.shape)]
        return _noise_model_altered(fn, x, dn, regs) \
            if tuple(x.shape) == first[0] else (dn, regs)
    return fault


def _gate_altered(fn, x, dn, regs):
    """The rescue gate reported as fired when it did not fire."""
    fn.stats["second_passes"] += 1
    return dn, regs


FAULTS = (_pixel_altered, _noise_model_altered, _gate_altered)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(root, name):
    res = _run(root, _small_cell(root, name))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__[1:])
@pytest.mark.parametrize("name", CELLS)
def test_altered_answer_is_not_correct(root, name, fault):
    res = _run(root, _small_cell(root, name), _wrap(fault))
    assert res["correct"] is False, res["checks"]


def test_noise_model_fault_on_one_shape_is_not_correct(root, monkeypatch):
    """A third of the frames, all of one shape, faulted: the window runs
    one whole cycle of the pool, so that every frame is compared."""
    whole = run.Window.run
    monkeypatch.setattr(run.Window, "run", lambda self, seconds: whole(
        self, 1e9, len(self.order)))
    cell = _small_cell(root, "s2dt16.anycam")
    res = _run(root, cell, _wrap(_noise_model_altered_on_one_shape()))
    assert res["attempted"] == 6
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_net_returning_its_input_is_not_correct(root, monkeypatch, name):
    _net_fault(monkeypatch, _net_unchanged)
    res = _run(root, _small_cell(root, name))
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_half_frame_left_out_is_not_correct(root, monkeypatch, name):
    _net_fault(monkeypatch, _net_half)
    res = _run(root, _small_cell(root, name))
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(root, name):
    cell = _small_cell(root, name)
    summary, _ = calibrate(cell, [], [5, 6, 7], root, "cpu")
    ok, table = check.verdict(summary["control"], cell.limits)
    assert not ok, table


def test_nan_output_fails():
    x = torch.full((1, 4, 4, 4), 0.5)
    regs = torch.tensor([[1e-3, 1e-6], [1e-3, 1e-6]])
    dn = x.clone()
    dn[0, 0, 0, 0] = float("nan")
    nums = check.frame_numbers(dn, regs, False, x, regs, False, x)
    assert math.isinf(nums["dn_rms"]) and math.isinf(nums["dn_max"])
    assert not check.verdict(nums, {n: 1.0 for n in check.NAMES})[0]


@pytest.mark.card
@pytest.mark.parametrize("name", ("s2dt16.imx686", "gru32.imx686",
                                  "s2dt16.anycam"))
def test_control_fails_at_the_cells_size(root, card, name):
    cell = load_cell(root, name)
    summary, _ = calibrate(cell, [17, 18, 19], [17, 18, 19], root, card)
    limits = cell.limits
    assert check.verdict(summary["program"], limits)[0], summary
    assert not check.verdict(summary["control"], limits)[0], summary

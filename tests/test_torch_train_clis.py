"""The port's one-off trainer CLIs (yondx_torch/cli/{train_gru,train_unet,
train_chunked}.py) against the JAX scripts they port, loaded from
scripts/, on the CPU, each package's AWGNTrainer replaced by a recorder
(no step is trained here; tests/test_torch_train.py holds the trainers).

- train_gru, train_unet: the runfile dict each hands its trainer is
  JAX's, but for fast_ckpt, checkpoint and result_dir, which lie under
  --out; the port's trainer is built and run with --out as the working
  directory (its ./logs/); the calls are JAX's: train(), then
  eval(epoch=-1).
- train_chunked: JAX's CHILD and the port's child, with the recorder
  resumed below, at and above `stop`: the same args, the same
  train(stop_epoch=...) and eval calls, DONE printed in the same cases.
- the chunk loop: it stops after a chunk that prints DONE; a chunk silent
  for STALL_SECS is killed (the poll shortened from 15 s) and the next
  chunk runs.
"""
import copy
import os
import sys

import pytest

import yondx.train as j_train

from yondx_torch.cli import train_chunked as t_chunked
from yondx_torch.cli import train_gru as t_gru
from yondx_torch.cli import train_unet as t_unet
from torch_test_util import REPO, load_jax_script

PATHS = ("fast_ckpt", "checkpoint", "result_dir")


def recorder(calls, epoch0=0):
    """An AWGNTrainer stand-in that records its args, the working
    directory it was built in and every train / eval call."""

    class Recorder:
        def __init__(self, args, *a, **k):
            calls.append(("init", copy.deepcopy(args), os.getcwd(), k))
            self.epoch = epoch0

        def train(self, *a, **k):
            calls.append(("train", a, k, os.getcwd()))
            self.epoch = k.get("stop_epoch") or self.epoch

        def eval(self, *a, **k):
            calls.append(("eval", a, k, os.getcwd()))
            return 0.0, 0.0

    return Recorder


def _split(args):
    rest = {k: v for k, v in args.items() if k not in PATHS}
    return rest, [args[k] for k in PATHS]


@pytest.mark.parametrize("name,cli,stop", [("train_gru", t_gru, "3"),
                                           ("train_unet", t_unet, None)])
def test_trainer_cli_matches_jax_script(monkeypatch, tmp_path, name, cli,
                                        stop):
    argv = [stop] if stop else []
    want, got = [], []
    monkeypatch.setattr(j_train, "AWGNTrainer", recorder(want))
    load_jax_script(monkeypatch, tmp_path, name, argv)
    # train_unet runs train_gru's recipe
    monkeypatch.setattr(t_gru, "AWGNTrainer", recorder(got))
    out = tmp_path / "out"
    res = cli.main([*argv, "--out", str(out), "--cpu"])
    (_, j_args, _, _), (_, t_args, cwd, kw) = want[0], got[0]
    j_rest, _ = _split(j_args)
    t_rest, paths = _split(t_args)
    assert t_rest == j_rest
    assert j_args["fast_ckpt"] == "checkpoints/Gaussian"
    assert paths == [str(out / "ckpt"), str(out / "saved"),
                     str(out / "images")]
    assert cwd == str(out) and kw == {"device": "cpu", "field": "torch"}
    assert [c[:3] for c in got[1:]] == [c[:3] for c in want[1:]] == [
        ("train", (), {}), ("eval", (), {"epoch": -1})]
    assert {c[3] for c in got[1:]} == {str(out)}
    assert res["eval"] == (0.0, 0.0) and res["out"] == str(out)
    assert os.getcwd() == REPO or os.path.samefile(os.getcwd(), REPO)


def _jax_child(monkeypatch, capsys, runfile, stop, chunk, epoch0):
    from importlib.util import spec_from_file_location
    spec = spec_from_file_location("jax_train_chunked", os.path.join(
        REPO, "scripts", "train_chunked.py"))
    calls = []
    monkeypatch.setattr(j_train, "AWGNTrainer", recorder(calls, epoch0))
    monkeypatch.setattr(sys, "argv", ["train_chunked.py"])
    source = spec.loader.get_source(spec.name)
    scope = {"__name__": "jax_train_chunked"}
    exec(compile(source, spec.origin, "exec"), scope)
    monkeypatch.setattr(sys, "argv", ["-c", runfile, str(stop), str(chunk)])
    try:
        exec(scope["CHILD"], {"__name__": "__main__"})
    except SystemExit as e:
        assert e.code == 0
    return calls, capsys.readouterr().out


@pytest.mark.parametrize("epoch0,stop,chunk", [(0, 10, 10), (0, 30, 10),
                                               (20, 30, 20), (30, 30, 10),
                                               (40, 30, 10)])
def test_chunked_child_matches_jax(monkeypatch, tmp_path, capsys, epoch0,
                                   stop, chunk):
    monkeypatch.chdir(REPO)
    runfile = "runfiles/Gaussian/GRU_5to50_norm_mix.yml"
    want, j_out = _jax_child(monkeypatch, capsys, runfile, stop, chunk,
                             epoch0)
    got = []
    monkeypatch.setattr(t_chunked, "AWGNTrainer", recorder(got, epoch0))
    out = tmp_path / "out"
    rec = t_chunked.child(runfile, stop, chunk, str(out), cpu=True)
    t_out = capsys.readouterr().out
    j_rest, _ = _split(want[0][1])
    t_rest, paths = _split(got[0][1])
    assert t_rest == j_rest and t_rest["hyper"]["last_epoch"] == -1
    assert paths[0] == str(out / "ckpt") and got[0][2] == str(out)
    assert [c[:3] for c in got[1:]] == [c[:3] for c in want[1:]]
    done = epoch0 >= stop or epoch0 + chunk >= stop
    assert ("DONE" in j_out) == ("DONE" in t_out) == rec["done"] == done
    assert t_out.splitlines() == j_out.splitlines()
    assert rec["epoch0"] == epoch0
    assert rec["epoch"] == (epoch0 if epoch0 >= stop
                            else min(epoch0 + chunk, stop))


def test_chunk_loop_stops_at_done_and_kills_a_silent_chunk(
        monkeypatch, tmp_path, capsys):
    stubs = [[sys.executable, "-c", "import time; time.sleep(60)"],
             [sys.executable, "-c", "print('chunk finished at epoch 10');"
              "print('DONE')"],
             [sys.executable, "-c", "raise SystemExit('never run')"]]
    made = []

    def command(opts):
        made.append(opts)
        return stubs[len(made) - 1]

    monkeypatch.setattr(t_chunked, "child_command", command)
    monkeypatch.setattr(t_chunked, "STALL_SECS", 1)
    monkeypatch.setattr(t_chunked, "POLL_SECS", 0.2)
    res = t_chunked.main(["runfiles/x.yml", "10", "10", "--out",
                          str(tmp_path)])
    out = capsys.readouterr().out
    assert len(made) == 2 and made[0].out == str(tmp_path)
    (rc0, t0), (rc1, t1) = ((c["rc"], c["text"]) for c in res["chunks"])
    assert rc0 != 0 and t0 == "" and "[watchdog] no output for 1s" in out
    assert rc1 == 0 and t1.split() == ["chunk", "finished", "at", "epoch",
                                       "10", "DONE"]
    assert "[chunk 0] rc=" in out and "[chunk 1] rc=0\n  chunk finished " \
        "at epoch 10\n  DONE" in out


def test_chunk_child_imports_the_port_from_any_directory(monkeypatch,
                                                         tmp_path):
    """A chunk's interpreter finds yondx_torch from another working
    directory: the parent puts the package's root on its PYTHONPATH."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("PYTHONPATH", raising=False)
    rc, text = t_chunked.run_chunk_with_watchdog(
        [sys.executable, "-c", "import yondx_torch.cli.train_chunked as m; "
         "print(m.__file__)"])
    assert rc == 0, text
    assert os.path.samefile(text.strip(), t_chunked.__file__)

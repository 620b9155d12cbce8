"""No module that the benchmark loads is jax, jaxlib, flax or the JAX
package yondx (whole top-level names: yondx_torch is the port), and the
reference loads nothing of yondx_torch. Each check runs a child
interpreter in which those imports raise, drives the code, and lists
what it loaded."""
import ast
import json
import os
import subprocess
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "yondx")

_CHILD = r'''
import importlib.abc, json, sys
BLOCK = set(sys.argv[1].split(","))

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".", 1)[0] in BLOCK:
            raise ImportError(f"refused import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
sys.path.insert(0, sys.argv[2])
import torch
torch.set_num_threads(2)
exec(sys.argv[3])
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
'''

_RUN = r'''
import glob, os, time
import perfbench.calibrate, perfbench.check, perfbench.counts
import perfbench.frames, perfbench.trace
from perfbench import run
from perfbench.spec import load_cell, metric_reader
root = sys.argv[2]
for p in glob.glob(os.path.join(root, "perfbench", "metrics", "*.py")):
    metric_reader(os.path.basename(p)[:-3])
for name in ("s2dt16.imx686", "gru32.imx686"):
    cell = load_cell(root, name)
    cell.traffic["cameras"][0].update(height=96, width=128, frames=1)
    run.run(cell, 3, 0.01, 0, root, device="cpu", t_start=time.perf_counter())
'''

_REFERENCE = r'''
import os, torch
from perfbench.reference import ckpt, fused, nets, nle, refine, vst
root = sys.argv[2]
arch = {"name": "GuidedResUnet", "in_nc": 4, "out_nc": 4, "nf": 32}
net = nets.load_net(arch, os.path.join(
    root, "checkpoints/Gaussian/Gaussian_GRU_mix_1to50c_norm_best_model.ckpt"),
    "cpu")
lut, ext = (torch.as_tensor(t) for t in vst.load_tables(root))
x = torch.rand(1, 48, 64, 4) * 0.5 + 0.2
fused.Reference(net, lut, ext).run(x, 959.0)
'''


def _child(root, block, code):
    out = subprocess.run([sys.executable, "-c", _CHILD, ",".join(block), root,
                          code], capture_output=True, text=True, cwd=root,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax(root):
    loaded = _child(root, FORBIDDEN, _RUN)
    assert not loaded & set(FORBIDDEN)
    assert "yondx_torch" in loaded


def test_reference_loads_nothing_of_the_port(root):
    loaded = _child(root, FORBIDDEN + ("yondx_torch",), _REFERENCE)
    assert not loaded & set(FORBIDDEN + ("yondx_torch",))


def test_reference_sources_import_no_port(root):
    ref = os.path.join(root, "perfbench", "reference")
    for name in sorted(os.listdir(ref)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(ref, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for m in mods:
                top = m.split(".", 1)[0]
                assert top in ("torch", "numpy", "math", "os", "struct",
                               "__future__"), (name, m)

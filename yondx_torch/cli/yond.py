"""`python -m yondx_torch.cli.yond`: blind raw denoising on the GPU (port
of yondx/cli/yond.py): one frame with --input, or the runfile's eval /
test mode over a dataset.

    python -m yondx_torch.cli.yond -f runfiles/YOND/ANY_simple+full_pre_grumix.yml \
        --input frame.npy --output dn.npy
    python -m yondx_torch.cli.yond -f runfiles/YOND/SIDD_simple+full_pre_grumix.yml \
        [-m eval|test] [--limit N] [--device cuda|cpu]

The runfile's `arch` and checkpoint build the net (guided, or unguided
as UNetSeeInDark, the 'unetn' denoiser), each `est_*` block a
noise-estimation net the engine's est_type 'pge' calls from
`iter_denoise`, the denoiser (a VSTDenoiser with the pipeline block's
refine / sigma_corr extras, or with `denoiser_type: bm3d` and the
pipeline key `allow_experimental_bm3d: true` the host BM3D in VST
space), the committed bias LUT and a YONDEngine; the frame then runs self
NLE -> tiled denoise -> collab NLE -> tiled second pass (when the rescue
gate fires), whatever est_type says, as in JAX. Runs on `--device`
("cuda" by default; JAX's --cpu means --device cpu).

Without --input the runfile's mode runs over the dataset of its
`dst_{mode}` block (`root_dir` relative to the working directory, in the
reader's layout): 'eval' scores SIDD crop blocks with `eval/sidd.py`
(iter_denoise per scene) and ELD / LRID / DND frames with
`eval/fullframe.py` (whole or tiled by frame size; ELD aligned to the GT
exposure), writing ./metrics/{method}_metrics.pkl; 'test' writes the
SIDD benchmark's npy cache (npy/{method}/) or DND's submission bundle
(submits/test/{method}/bundled/).

--mesh N runs N ranks, one process each on its own card (NCCL), or on
the CPU under gloo with --device cpu; each builds the engine on its
device. `--input` and the eval mode of the full-frame datasets (ELD,
LRID, DND) shard each frame's rows over the ranks
(parallel.iter_denoise_frame_sharded); the SIDD harness and the test
modes run on rank 0 alone, as JAX's CLI does not shard them. Rank 0
writes the .npy, the logs and the metrics. Under torchrun the ranks
join its group; otherwise the CLI starts them itself.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

from .. import resolve_device
from ..config import load_runfile
from ..core import logging as core_logging
from ..core.logging import log
from ..eval.fullframe import denoise_any
from ..io.ckpt import find_checkpoint
from ..models.registry import is_guided
from ..models.unets import load_model
from ..pipeline.denoiser import BM3DVSTDenoiser, VSTDenoiser
from ..pipeline.engine import PipelineConfig, YONDEngine
from ..pipeline.estnet import EstNet
from ..vst.lut import BiasLUT


def build_parser():
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--runfile", "-f",
                   default="runfiles/YOND/SIDD_simple+full_pre_grumix.yml")
    p.add_argument("--mode", "-m", default="eval")
    p.add_argument("--debug", action="store_true", default=False)
    p.add_argument("--nofig", action="store_true", default=True)
    p.add_argument("--nohost", action="store_true", default=False)
    p.add_argument("--limit", type=int, default=None,
                   help="evaluate only the first N scenes")
    p.add_argument("--device", default="cuda",
                   help="torch device the pipeline runs on")
    p.add_argument("--cpu", action="store_true", default=False,
                   help="same as --device cpu")
    p.add_argument("--input", default=None,
                   help="ANY mode: blind-denoise one raw file "
                        "(npy/mat/png/raw; camera raws need rawpy)")
    p.add_argument("--output", default=None, help="ANY mode output npy")
    p.add_argument("--wp", type=int, default=1023)
    p.add_argument("--bl", type=int, default=64)
    p.add_argument("--ratio", type=float, default=1.0)
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="row-shard the frame over N ranks, one card each "
                        "(gloo ranks with --device cpu)")
    p.add_argument("--tile", type=int, default=1024,
                   help="ANY mode: overlap-tile size in bayer px")
    return p


def load_model_params(arch, model_name, fast_ckpt, device=None):
    """The runfile's net with its checkpoint (search order best -> last
    -> bare). A missing checkpoint raises: random weights cannot be made
    to match the JAX package's flax init."""
    path = find_checkpoint(fast_ckpt, model_name)
    if path is None:
        raise FileNotFoundError(f"no checkpoint {model_name}[_best_model|"
                                f"_last_model].ckpt under {fast_ckpt!r}")
    model = load_model(arch, path, device=device)
    log(f"Loaded weights from {path}")
    return model


class YOND:
    """The runfile-driven application object; with `mesh` (a
    parallel.Mesh) one rank's, on the rank's device."""

    def __init__(self, argv=None, mesh=None):
        self.parser = build_parser().parse_args(argv)
        self.mesh = mesh
        self.device = str(mesh.device) if mesh is not None else \
            "cpu" if self.parser.cpu else self.parser.device
        self.args = load_runfile(self.parser.runfile, mode=self.parser.mode)
        self.mode = self.args["mode"]
        self.arch = self.args["arch"]
        self.pipe = PipelineConfig.from_dict(self.args["pipeline"])
        self.model_name = self.args["model_name"]
        self.method_name = self.args["method_name"]
        self.fast_ckpt = self.args["fast_ckpt"]
        self.save_plot = not self.parser.nofig
        self.sample_dir = os.path.join(self.args.get("result_dir", "images"),
                                       self.method_name)
        os.makedirs(self.sample_dir, exist_ok=True)
        os.makedirs("./logs", exist_ok=True)
        os.makedirs("./metrics", exist_ok=True)
        self.logfile = f"./logs/log_{self.method_name}.log"
        # the runfiles' nets and the scoring run in float32: no TF32 in
        # cuDNN's convolutions (on by torch's default) or in matmuls. Set
        # once, before any work, and never toggled later: the flags are
        # process-wide, and the SIDD harness scores on threads beside the
        # engine
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.model = load_model_params(self.arch, self.model_name,
                                       self.fast_ckpt, device=self.device)
        n = sum(p.numel() for p in self.model.parameters())
        for line in (f"Method Name:\t{self.method_name}",
                     f"Model Name:\t{self.model_name}",
                     f"Architecture:\t{self.arch['name']}",
                     f"Parameters:\t{n / 1e6:.2f}M",
                     f"Device:\t{self.device}",
                     "Precision:\tfloat32 (TF32 off)"):
            log(line, logfile=self.logfile, notime=True)
        # noise-estimation nets of the est_* blocks, weights from
        # fast_ckpt/<weights or the block's key>
        self.est_models = {}
        for key, est in self.args.items():
            if not key.startswith("est_") or not isinstance(est, dict):
                continue
            emodel = load_model_params(est, est.get("weights", key),
                                       self.fast_ckpt, device=self.device)
            self.est_models[key] = EstNet(emodel, resolve_device(self.device))
        ex = self.pipe.extras
        if self.pipe.denoiser_type.lower() == "bm3d":
            # the host BM3D is held to an independent numpy oracle of the
            # published algorithm in the JAX package, not to the pip bm3d
            # wheel the reference calls: opt in explicitly, as there
            if not ex.get("allow_experimental_bm3d", False):
                raise RuntimeError(
                    "denoiser_type: BM3D is algorithm-validated (vs an "
                    "independent oracle, tests/test_bm3d_oracle.py) but "
                    "UNCERTIFIED against the pip bm3d wheel's exact "
                    "output. Set 'allow_experimental_bm3d: true' in the "
                    "pipeline block to use it, or use a network denoiser "
                    "(gru32n/unetn).")
            self.denoiser = BM3DVSTDenoiser(bias_corr=self.pipe.bias_corr,
                                            vst_type=self.pipe.vst_type,
                                            device=self.device)
        else:
            self.denoiser = VSTDenoiser(
                self.model, guided=is_guided(self.arch),
                bias_corr=self.pipe.bias_corr, vst_type=self.pipe.vst_type,
                refine=bool(ex.get("refine", False)),
                refine_floor=ex.get("refine_floor", "bucket"),
                refine_shrink=bool(ex.get("refine_shrink", True)),
                refine_shrink_lam=float(ex.get("refine_shrink_lam", 1.0)),
                refine_shrink_full_alpha=float(
                    ex.get("refine_shrink_full_alpha", 1.0)),
                refine_shrink_mode=str(ex.get("refine_shrink_mode",
                                              "oriented")),
                sigma_corr=ex.get("sigma_corr"), device=self.device)
        self.engine = YONDEngine(self.denoiser, self.pipe, biaslut=BiasLUT(),
                                 est_models=self.est_models,
                                 logfile=self.logfile)

    def denoise_any(self, path: str, out: str | None = None):
        return denoise_any(self.engine, path, wp=self.parser.wp,
                           bl=self.parser.bl, ratio=self.parser.ratio,
                           tile=self.parser.tile, out_path=out,
                           mesh=self.mesh)

    def _dataset(self, mode):
        dst = self.args.get(f"dst_{mode}", self.args.get("dst", {}))
        name = dst.get("dataset", "")
        root = dst.get("root_dir", "")
        if name == "SIDD_Dataset":
            from ..data.datasets import SIDDValDataset
            return SIDDValDataset(root, mode=dst.get("mode", mode))
        if name == "LRID_Dataset":
            from ..data.eval_datasets import LRIDDataset
            return LRIDDataset(root, subset=dst.get("subset", "indoor"))
        if name == "DND_Dataset":
            from ..data.eval_datasets import DNDDataset
            return DNDDataset(root)
        if name in ("ELD_Full_Dataset", "ELD_Dataset"):
            from ..data.eval_datasets import ELDDataset
            return ELDDataset(root,
                              camera_suffix=tuple(dst.get(
                                  "camera_suffix", ("SonyA7S2", ".ARW"))))
        raise NotImplementedError(
            f"dataset {name!r}: provide data under {root!r} or use "
            "the synthetic self-test via bench.py")

    def _sidd_harness(self, mode):
        from ..eval.sidd import SIDDEvalHarness
        return SIDDEvalHarness(
            self.engine, self._dataset(mode), self.method_name,
            max_iter=self.pipe.max_iter, save_plot=self.save_plot,
            sample_dir=self.sample_dir, logfile=self.logfile)

    def eval(self, limit=None):
        """The runfile's eval set: SIDD crop blocks, else whole frames
        (ELD, LRID, DND); returns the harness's mean metrics."""
        limit = limit or self.parser.limit
        if self.pipe.data_type == "SIDD":
            return self._sidd_harness("eval").run(limit=limit)
        from ..eval.fullframe import FullFrameHarness
        harness = FullFrameHarness(
            self.engine, self._dataset("eval"), self.method_name,
            tile=int(self.pipe.extras.get("tile", 0)),
            halo=int(self.pipe.extras.get("halo", 64)),
            illum_correct=(self.pipe.data_type == "ELD"),
            logfile=self.logfile, mesh=self.mesh)
        return harness.run(limit=limit)

    def benchmark(self, limit=None):
        """The runfile's test set: DND's submission bundle, else the SIDD
        benchmark blocks (npy cache, no scores)."""
        limit = limit or self.parser.limit
        if self.pipe.data_type == "DND":
            from ..eval.dnd import bundle_submissions_raw, denoise_dnd
            out_dir = os.path.join("submits", self.mode, self.method_name)
            bundled = denoise_dnd(self.engine, self._dataset("test"),
                                  out_dir, limit=limit,
                                  logfile=self.logfile)
            n = bundle_submissions_raw(bundled)
            log(f"DND submission bundle: {n} images under {bundled}",
                logfile=self.logfile)
            return bundled
        return self._sidd_harness("test").run(limit=limit)


def _run(app):
    """The run the parsed flags ask for; with a mesh, on every rank."""
    if app.parser.input:
        out = app.parser.output or (os.path.splitext(
            app.parser.input)[0] + "_denoised.npy")
        app.denoise_any(app.parser.input, out)
        log(f"Denoised frame saved to {out}")
        return app
    main_rank = app.mesh is None or app.mesh.is_main
    if "eval" in app.mode and (app.pipe.data_type != "SIDD" or main_rank):
        app.eval()
        log(f"Metrics saved in ./metrics/{app.method_name}_metrics.pkl")
    if "test" in app.mode and main_rank:
        app.benchmark()
    return app


def _rank_main(mesh, argv):
    """One rank of a --mesh run: logs from rank 0 only."""
    core_logging.set_enabled(mesh.is_main)
    _run(YOND(argv, mesh=mesh))


def main(argv=None):
    """Run the CLI; returns the YOND object, or None where --mesh started
    the ranks as new processes."""
    argv = sys.argv[1:] if argv is None else list(argv)
    opts = build_parser().parse_args(argv)
    if not opts.mesh:
        return _run(YOND(argv))
    from ..parallel.mesh import make_mesh, spawn
    import torch.distributed as dist
    device = "cpu" if opts.cpu else opts.device
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        mesh = make_mesh(opts.mesh, device=device)
        core_logging.set_enabled(mesh.is_main)
        return _run(YOND(argv, mesh=mesh))
    spawn(opts.mesh, _rank_main, argv, device=device)
    return None


if __name__ == "__main__":
    main()

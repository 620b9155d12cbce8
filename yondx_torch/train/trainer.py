"""AWGN trainer: the full training harness (port of yondx/train/trainer.py).

One step: uint8 sRGB crops to the device, /255, the unprocess chain to
pseudo-raw RGGB (per-crop cameras drawn on the host), optional raw chroma
gain jitter, AWGN with log-uniform sigma, clip, the guided net's forward
and backward (autograd), L1 loss (plus the distillation and consistency
terms), and torch.optim.Adam at the epoch's SGDR learning rate. Adam is
optax's adam (b1 0.9, b2 0.999, eps 1e-8, eps_root 0); the checkpoints are
the JAX package's files, optimizer state included, so each package
resumes the other's runs.

The random draws walk the JAX trainer's key chain (train/draws.py): every
camera, pattern, sigma and gain equals JAX's. The Gaussian fields of the
training steps come from `field` ("torch": a torch.Generator on the device,
seeded from the run's seed; "jax": bit-equal to jax.random.normal, used by
the parity tests); eval always draws JAX's fields, so its eval set is the
JAX package's.

Around the loop: SGDR cosine LR stepped per epoch, the loader and net
shares of each epoch, the PSNR meter with its pkl history, rolling
last/epoch/best checkpoints, a fast eval at sigma_list[1] every plot_freq
epochs, the epoch-start snapshot consistency branch ('consistency' in
dst.command, from epoch 101), distillation from a frozen teacher with
frozen student stages, and `hyper.remat` through torch.utils.checkpoint.

Data parallel: given a mesh (parallel.Mesh), the net trains wrapped in
DistributedDataParallel over the mesh's ranks. Every rank draws the
GLOBAL batch's cameras, sigmas and fields from the same keys or
generator (as JAX draws them inside its step over the whole batch) and
keeps its rows of it; DDP's gradient mean over equal shards is the
global batch's gradient, so a step of n ranks is the step of one. The
reported loss and PSNR are the ranks' mean. Every rank resumes from the
same file; rank 0 writes checkpoints, plots and logs.
"""
from __future__ import annotations

import copy
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core import rng
from ..core.logging import log, timestamp
from ..core.meters import AverageMeter
from ..data.augment import data_aug8
from ..data.datasets import (BatchLoader, NpyFolderDataset,
                             SyntheticSRGBDataset, to_unit)
from ..data.noise import (awgn_log_uniform, awgn_log_uniform_lowmix,
                          awgn_uniform)
from ..data.unprocess import srgb_to_pseudo_raw_device
from ..io.ckpt import load_checkpoint as read_params
from ..models.convert import params_to_state_dict, state_dict_to_params
from ..models.registry import build_model, init_params, is_guided
from .ckpt import (find_checkpoint, optax_adam_state, resume_checkpoint,
                   save_checkpoint)
from .draws import FieldSource, eval_keys, train_keys
from .losses import psnr_loss, unet_loss
from .schedule import lr_lambda_from_hyper

_F32 = np.float32


class _Checkpointed(torch.nn.Module):
    """A net whose forward runs under torch.utils.checkpoint (hyper.remat):
    activations are recomputed in the backward pass."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, *args):
        from torch.utils.checkpoint import checkpoint
        return checkpoint(self.net, *args, use_reentrant=False)


class AWGNTrainer:
    def __init__(self, args: Dict[str, Any], device=None, *, field: str,
                 mesh=None):
        """args: the parsed YAML runfile dict (dst*/arch/hyper blocks);
        device: "cuda" unless "cpu" is asked for; field: the source of the
        training steps' Gaussian fields, "torch" or "jax"; mesh: a
        parallel.Mesh to train data-parallel on (its device replaces
        `device`; batch_size must split over its ranks)."""
        self.args = args
        if mesh is not None:
            from ..parallel.mesh import check_mesh
            device = check_mesh(mesh).device
            if args["hyper"]["batch_size"] % mesh.size:
                raise ValueError(f"batch_size {args['hyper']['batch_size']} "
                                 f"does not split over {mesh.size} ranks")
        self.mesh = mesh
        self.is_main = mesh is None or mesh.is_main
        self.device = resolve_device(device)
        self.arch = args["arch"]
        self.hyper = args["hyper"]
        self.dst = args.get("dst_train", args.get("dst", {}))
        self.dst_eval = args.get("dst_eval", self.dst)
        self.model_name = args.get("model_name", "model")
        self.fast_ckpt = args.get("fast_ckpt", "checkpoints")
        self.model_dir = args.get("checkpoint", "saved_model")
        self.sample_dir = os.path.join(args.get("result_dir", "images"),
                                       f"samples-{self.model_name}")
        self.guided = is_guided(self.arch)
        # RGB_Img_Dataset mode: plain sRGB AWGN training, no unprocess,
        # uniform sigma, 8-way aug
        self.rgb_mode = (self.dst.get("dataset") == "RGB_Img_Dataset"
                         or self.arch.get("in_nc") == 3)
        self.logfile = f"./logs/log_{self.model_name}.log"
        self.field = FieldSource(field, self.device,
                                 seed=self.hyper.get("seed", 1997))

        # fresh weights equal to the JAX package's (N(0, 0.02) on every
        # conv); a resume below overwrites them from the checkpoint
        self.model = build_model(self.arch)
        self.model.load_state_dict(init_params(self.model))
        self._place(self.model)

        self.lr_fn = lr_lambda_from_hyper(self.hyper)
        self.optimizer = torch.optim.Adam(
            self.model.parameters(),
            lr=self.lr_fn(max(self.hyper.get("last_epoch", 0), 1)),
            betas=(0.9, 0.999), eps=1e-8)
        self.best_psnr = float(self.hyper.get("best_psnr", 0.0))
        self.epoch = self.hyper.get("last_epoch", 0)

        # resume; last_epoch == -1 continues from the checkpoint's epoch
        if self.epoch:
            self.epoch, path, state = resume_checkpoint(
                self.fast_ckpt, self.model_name, self.model, self.optimizer,
                self.epoch)
            if path:
                self.best_psnr = float(state.get("best_psnr",
                                                 self.best_psnr))
                log(f"Resumed from {path} @ epoch {state.get('epoch')}",
                    logfile=self.logfile)
            else:
                log("No checkpoint file!!!", logfile=self.logfile)

        self.train_psnr = AverageMeter("PSNR", ":2f")
        self.eval_psnr = AverageMeter("PSNR", ":2f")
        self.eval_ssim = AverageMeter("SSIM", ":4f")

        self.sigma_min = float(self.dst.get("sigma_min", 5))
        self.sigma_max = float(self.dst.get("sigma_max", 50))
        self.clip = bool(self.dst.get("clip", True))
        command = self.dst.get("command", "")
        self.consistency = "consistency" in command
        self.bayeraug = "no_bayeraug" not in command
        # 'chroma_aug': per-sample raw R/B gain jitter after the unprocess
        # chain, so that strongly coloured flats occur in training
        self.chroma_aug = "chroma_aug" in command
        # 'low_sigma': half the sigmas log-uniform in [smin, 8]
        self.low_sigma = "low_sigma" in command
        self.remat = bool(self.hyper.get("remat", False))

        # optional distillation: a frozen teacher's output as (part of)
        # the target, with frozen student stages
        #   distill: {teacher_arch, teacher_ckpt, weight: 1.0,
        #             gt_weight: 0.0, freeze: 'ported'|[names]}
        self.distill = args.get("distill")
        self.teacher = None
        self._frozen = frozenset()
        if self.distill:
            self.teacher = build_model(self.distill["teacher_arch"])
            t_ck = find_checkpoint(self.fast_ckpt,
                                   self.distill["teacher_ckpt"])
            assert t_ck, f"teacher ckpt {self.distill['teacher_ckpt']}"
            self.teacher.load_state_dict(
                params_to_state_dict(read_params(t_ck)["params"]))
            self._place(self.teacher)
            self.teacher.eval().requires_grad_(False)
            if mesh is not None:
                from ..parallel.mesh import replicate
                replicate(mesh, self.teacher)
            frz = self.distill.get("freeze", [])
            if frz == "ported":
                from .s2d_port import S2D_PORT_MAP
                frz = list(S2D_PORT_MAP)
            self._frozen = frozenset(frz or [])
            log(f"distill: teacher={t_ck} w={self.distill.get('weight', 1.0)}"
                f" gt_w={self.distill.get('gt_weight', 0.0)}"
                f" frozen={len(self._frozen)} stages",
                logfile=self.logfile)
        self._frozen_params = [p for n, p in self.model.named_parameters()
                               if n.split(".")[0] in self._frozen]
        # per-step record of the last train() call: epoch, loss, PSNR and
        # the loader and step seconds (synchronised by the PSNR read)
        self.steps = []
        # the module the training forward runs: checkpointed with remat,
        # under DDP (which starts from rank 0's weights) with a mesh
        self.net = _Checkpointed(self.model) if self.remat else self.model
        if mesh is not None:
            from torch.nn.parallel import DistributedDataParallel
            self.net = DistributedDataParallel(
                self.net, device_ids=([self.device.index]
                                      if self.device.type == "cuda" else None),
                process_group=mesh.group)

    def _place(self, net):
        net.to(self.device)
        if self.device.type == "cuda":
            net.to(memory_format=torch.channels_last)

    # ------------------------------------------------------------ weights
    def params(self) -> Dict[str, Any]:
        """The net's weights as the flax variable dict (numpy)."""
        return state_dict_to_params(self.model.state_dict())

    def load_params(self, params: Dict[str, Any]) -> None:
        with torch.no_grad():
            for name, t in params_to_state_dict(params).items():
                self.model.get_parameter(name).copy_(t)

    # -------------------------------------------------------------- steps
    def _forward(self, net, x, t):
        return net(x, t) if self.guided else net(x)

    def _rows(self, B: int) -> slice:
        """This rank's rows of a global batch of B."""
        if self.mesh is None:
            return slice(None)
        b = B // self.mesh.size
        return slice(self.mesh.rank * b, (self.mesh.rank + 1) * b)

    def train_step(self, batch, keys, lr_value: float,
                   use_consistency: float = 0.0, ema=None):
        """One optimizer step on a host batch of sRGB crops.

        keys: (k_data, k_noise, k_cons) of the step; ema: the epoch-start
        snapshot net of the consistency branch. Returns (loss, psnr, sample)
        with loss and psnr 0-d device tensors (the ranks' mean with a
        mesh) and sample the first crop's (noisy, pred, hr, wb, cam2rgb,
        pattern) of this rank's rows. With a mesh, `batch` is the global
        batch: the draws cover all of it and the net takes this rank's
        rows."""
        k_data, k_noise, k_cons = keys
        x = to_unit(batch, self.device)
        B = x.shape[0]
        smin, smax = self.sigma_min, self.sigma_max
        if self.rgb_mode:
            modes = torch.from_numpy(rng.randint(k_data, (B,), 0, 8))
            hr = data_aug8(x, modes)
            wb = torch.ones((B, 4), device=self.device)
            cam2rgb = torch.eye(3, device=self.device).expand(B, 3, 3)
            pattern = torch.zeros((B,), dtype=torch.int32)
            noisy, sigma = awgn_uniform(k_noise, hr, smin, smax,
                                        field=self.field)
        else:
            hr, wb, cam2rgb, pattern = srgb_to_pseudo_raw_device(
                k_data, x, bayer_aug_enabled=self.bayeraug)
            if self.chroma_aug:
                # R/B gains log-uniform in [1/2.5, 2.5] on half the batch;
                # G anchors exposure
                k_c, k_g, k_noise = rng.split(k_noise, 3)
                gains = rng.exp_f32(rng.uniform(k_c, (B, 2), -np.log(2.5),
                                                np.log(2.5)))
                on = (rng.uniform(k_g, (B, 1)) < _F32(0.5)).astype(_F32)
                g = _F32(1.0) + on * (gains - _F32(1.0))
                ones = np.ones((B, 1), _F32)
                g4 = np.concatenate([g[:, :1], ones, ones, g[:, 1:]], axis=1)
                g4 = torch.from_numpy(g4).to(self.device)[:, None, None, :]
                hr = torch.clamp(hr * g4, 0.0, 1.0)
            awgn = awgn_log_uniform_lowmix if self.low_sigma \
                else awgn_log_uniform
            noisy, sigma = awgn(k_noise, hr, smin, smax, field=self.field)
        if self.clip:
            noisy = torch.clamp(noisy, 0.0, 1.0)
            hr = torch.clamp(hr, 0.0, 1.0)

        d_w = float(self.distill.get("weight", 1.0)) if self.distill else 0.0
        gt_w = float(self.distill.get("gt_weight", 0.0)) \
            if self.distill else 1.0
        rows = self._rows(B)
        self.net.train()
        pred = self._forward(self.net, noisy[rows], sigma[rows])
        loss = gt_w * unet_loss(pred, hr[rows])
        if self.teacher is not None:
            with torch.no_grad():
                t_pred = self._forward(self.teacher, noisy[rows], sigma[rows])
            loss = loss + d_w * torch.mean(torch.abs(pred - t_pred))
        if self.consistency and use_consistency:
            # a second noisy view through the epoch-start snapshot; with
            # use_consistency 0 the JAX term is 0 * ... and adds nothing
            k1, k2 = rng.split(k_cons)
            st = float(rng._fma(rng.uniform(k1), _F32(0.25), _F32(0.7)))
            bshape = (B,) + (1,) * (hr.ndim - 1)
            noise = self.field.normal(k2, hr.shape) * sigma.reshape(bshape)
            with torch.no_grad():
                pred2 = self._forward(ema, (hr + noise * st)[rows],
                                      (sigma * st)[rows])
            loss = loss + use_consistency * 0.1 * torch.mean(
                torch.abs(pred - pred2))

        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for group in self.optimizer.param_groups:
            group["lr"] = float(lr_value)
        frozen = [p.detach().clone() for p in self._frozen_params]
        self.optimizer.step()
        if frozen:
            # frozen stages: their moments advance, their weights do not
            with torch.no_grad():
                for p, p0 in zip(self._frozen_params, frozen):
                    p.copy_(p0)
        with torch.no_grad():
            hr, noisy = hr[rows], noisy[rows]
            m = psnr_loss(torch.clamp(pred, 0, 1), torch.clamp(hr, 0, 1))
            sample = (torch.clamp(noisy[0], 0, 1), torch.clamp(pred[0], 0, 1),
                      hr[0], wb[rows][0], cam2rgb[rows][0], pattern[rows][0])
            loss = loss.detach()
            if self.mesh is not None:
                import torch.distributed as dist
                both = torch.stack([loss, m])
                dist.all_reduce(both, group=self.mesh.group)
                loss, m = both / self.mesh.size
        return loss, m, sample

    @torch.no_grad()
    def _eval_step(self, lr, hr, sigma):
        self.model.eval()
        pred = torch.clamp(self._forward(self.model, lr, sigma), 0, 1)
        return pred, psnr_loss(pred, torch.clamp(hr, 0, 1))

    # --------------------------------------------------------------- data
    def _make_loader(self, mode: str) -> BatchLoader:
        dst = self.dst if mode == "train" else self.dst_eval
        bs = self.hyper["batch_size"] if mode == "train" else \
            max(4, self.hyper["batch_size"] // 8)
        dataset_name = dst.get("dataset", "SyntheticSRGBDataset")
        root = dst.get("root_dir", "")
        ds = None
        if dataset_name in ("RGB_Img2Raw_Dataset", "NpyFolderDataset",
                            "DIV2K_Img2Raw_Dataset",
                            "RGB_Img_Dataset") and root:
            try:
                ds = NpyFolderDataset(root, mode=dst.get("mode", mode),
                                      subname=dst.get("subname"))
            except OSError:
                ds = None          # no crops under root_dir: synthetic set
        if ds is None:
            n = dst.get("synthetic_len", 512 if mode == "train" else 32)
            ds = SyntheticSRGBDataset(
                length=n, size=dst.get("patch_size", 256),
                seed=1997 if mode == "train" else 2024,
                version=dst.get("content_version", 6))
        # a batch never exceeds the dataset (that would give no step)
        bs = max(1, min(bs, len(ds)))
        return BatchLoader(ds, bs, shuffle=(mode == "train"),
                           seed=self.hyper.get("seed", 0))

    # -------------------------------------------------------------- train
    def train(self, stop_epoch: Optional[int] = None,
              steps_per_epoch: Optional[int] = None):
        hyper = self.hyper
        stop = stop_epoch or hyper["stop_epoch"]
        pf = hyper.get("plot_freq", 25)
        loader = self._make_loader("train")
        keys = train_keys(hyper.get("seed", 1997))
        self.steps = []
        for epoch in range(self.epoch + 1, stop + 1):
            self.train_psnr.reset()
            lr_value = self.lr_fn(epoch)
            use_cons = 1.0 if (self.consistency and epoch > 100) else 0.0
            ema = None
            if use_cons:                      # the epoch-start snapshot
                ema = copy.deepcopy(self.model).eval().requires_grad_(False)
            runtime = {"dataloader": 0.0, "net": 0.0, "total": 1e-9}
            tp = [time.time()] * 4
            n_steps = 0
            for batch in loader.epoch(epoch):
                load_s = timestamp(tp, 1)
                runtime["dataloader"] += load_s
                loss, m, sample = self.train_step(batch, next(keys),
                                                  lr_value, use_cons, ema)
                m = float(m)
                if n_steps % 100 == 0:
                    self._dump_temp_sample(sample, epoch, pf)
                net_s = timestamp(tp, 2)
                runtime["net"] += net_s
                self.train_psnr.update(m)
                self.steps.append({"epoch": epoch, "loss": float(loss),
                                   "psnr": m, "loader_s": load_s,
                                   "step_s": net_s})
                n_steps += 1
                tp[0] = time.time()
                if steps_per_epoch and n_steps >= steps_per_epoch:
                    break
            del ema
            runtime["total"] = max(runtime["dataloader"] + runtime["net"],
                                   1e-9)
            log(f"Epoch {epoch}: lr={lr_value:.2e} "
                f"PSNR={self.train_psnr.avg:.2f} "
                f"loader={100 * runtime['dataloader'] / runtime['total']:.0f}% "
                f"net={100 * runtime['net'] / runtime['total']:.0f}%",
                logfile=self.logfile)
            self.epoch = epoch

            if epoch % hyper.get("save_freq", 10) == 0 and self.is_main:
                self._save("last", epoch)
                self._save(f"e{epoch // pf * pf:04d}", epoch,
                           directory=self.model_dir)
                os.makedirs(self.sample_dir, exist_ok=True)
                self.train_psnr.plot_history(
                    savefile=os.path.join(
                        self.sample_dir, f"{self.model_name}_train_psnr.jpg"),
                    logfile=os.path.join(
                        self.sample_dir, f"{self.model_name}_train_psnr.pkl"))
            if epoch % pf == 0:
                self.eval(epoch=epoch)

    def _save(self, tag: str, epoch: int, directory: Optional[str] = None):
        if not self.is_main:
            return
        if tag.startswith("e"):
            path = os.path.join(directory or self.model_dir,
                                f"{self.model_name}_{tag}.ckpt")
        else:
            path = os.path.join(self.fast_ckpt,
                                f"{self.model_name}_{tag}_model.ckpt")
        save_checkpoint(path, self.params(),
                        optax_adam_state(self.optimizer, self.model), epoch,
                        self.best_psnr)

    def _dump_temp_sample(self, sample, epoch: int, pf: int):
        """The periodic training triptych (noisy | prediction | GT of the
        first crop, `sample`) needs the ISP renderer, which the port does
        not have yet (isp/render, ROADMAP item 7): it logs that it
        skipped, as the JAX package does where cv2 is missing."""
        log(f"sample dump skipped (epoch {epoch // pf * pf:04d}): the ISP "
            "renderer is not ported", logfile=self.logfile)

    def predict(self, raw_bayer, tile: int = 1024, halo: int = 64,
                t: float = 0.0):
        """Tiled full-frame inference with the trained net: bayer [H, W] in
        [0,1] -> denoised bayer (numpy), tiles of `tile` with `halo`."""
        from ..core.tiling import np_tile_overlap, tile_grid
        from ..pipeline.denoiser import SimpleDenoiser
        self.model.eval()
        den = SimpleDenoiser(self.model, guided=self.guided,
                             device=self.device)
        raw = np.asarray(raw_bayer, np.float32)
        H, W = raw.shape
        tiles, _ = np_tile_overlap(raw, tile, halo)
        tiles = np.concatenate([den(tiles[s:s + 8], t).cpu().numpy()
                                for s in range(0, tiles.shape[0], 8)], 0)
        ny, nx, _, _ = tile_grid(H, W, tile, halo)
        out = np.empty((ny * tile, nx * tile), np.float32)
        for iy in range(ny):
            for ix in range(nx):
                out[iy * tile:(iy + 1) * tile, ix * tile:(ix + 1) * tile] = \
                    tiles[iy * nx + ix, halo:halo + tile, halo:halo + tile]
        return out[:H, :W]

    # --------------------------------------------------------------- eval
    def eval(self, epoch: int = -1, sigma: Optional[float] = None):
        """Mean PSNR and SSIM over the eval set at `sigma` (default
        sigma_list[1]), with JAX's eval draws; saves `best` on a record."""
        from ..eval.metrics import matlab_ssim
        self.eval_psnr.reset()
        self.eval_ssim.reset()
        sigma_list = self.dst_eval.get("sigma_list", [10, 25, 50])
        sig = (sigma if sigma is not None else sigma_list[1]) / 255.0
        sig32 = float(_F32(sig))
        loader = self._make_loader("eval")
        field = FieldSource("jax", self.device)
        for batch, (k1, k2) in zip(loader.epoch(0), eval_keys()):
            b = to_unit(batch, self.device)
            if self.rgb_mode:
                hr = b
            else:
                hr = srgb_to_pseudo_raw_device(k1, b,
                                               bayer_aug_enabled=False)[0]
            noise = field.normal(k2, hr.shape) * sig32
            lr = torch.clamp(hr + noise, 0, 1) if self.clip else hr + noise
            hr = torch.clamp(hr, 0, 1) if self.clip else hr
            t = torch.full((hr.shape[0],), sig32, device=self.device)
            pred, m = self._eval_step(lr, hr, t)
            self.eval_psnr.update(float(m))
            # channels to a leading dim so matlab_ssim sees [..., H, W]
            self.eval_ssim.update(float(matlab_ssim(
                pred.movedim(-1, 1) * 255, hr.movedim(-1, 1) * 255)))
        if self.eval_psnr.avg >= self.best_psnr and epoch > 0:
            self.best_psnr = self.eval_psnr.avg
            log(f"Best PSNR is {self.best_psnr} now!!", logfile=self.logfile)
            self._save("best", epoch)
        log(f"Epoch {epoch}: eval PSNR={self.eval_psnr.avg:.2f}, "
            f"SSIM={self.eval_ssim.avg:.4f} (sigma={sig * 255:.0f})",
            logfile=self.logfile)
        return self.eval_psnr.avg, self.eval_ssim.avg


def step_record(mesh, args: Dict[str, Any], batch, keys, lr_value: float,
                field: str = "torch", device=None) -> Dict[str, Any]:
    """One step of a fresh trainer (data parallel on `mesh`, or alone on
    `device` when mesh is None) on the global `batch` with the step's
    `keys`; returns its loss and PSNR and, per parameter (flax-free
    torch names), the weights after the step, the gradient and both Adam
    moments as numpy arrays: what the ranks' and the single trainer's
    steps are compared by."""
    tr = AWGNTrainer(args, device=device, field=field, mesh=mesh)
    loss, m, _ = tr.train_step(batch, keys, lr_value)
    st = tr.optimizer.state
    rec = {"loss": float(loss), "psnr": float(m),
           "p": {}, "g": {}, "mu": {}, "nu": {}}
    for n, p in tr.model.named_parameters():
        rec["p"][n] = p.detach().cpu().numpy()
        rec["g"][n] = p.grad.detach().cpu().numpy()
        rec["mu"][n] = st[p]["exp_avg"].cpu().numpy()
        rec["nu"][n] = st[p]["exp_avg_sq"].cpu().numpy()
    return rec

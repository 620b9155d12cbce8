"""YOND iterative engine: self-calibration -> VST denoise -> collaborative
re-calibration -> denoise again (port of yondx/pipeline/engine.py).

Same pipeline-config surface (the YAML `pipeline:` block) and guards as
the JAX engine:
- beta2 < 0 in a collab round -> fall back to beta1^2;
- beta1 < 0 -> stop iterating, keep the round-0 result;
- the rescue policy skips the second denoise pass when its blend weight
  is exactly 0.

Frames stay on the denoiser's device from the first NLE to the last
round; each round's result comes back as a numpy array, as in JAX.
Crops are a leading batch dim [N, H, W] (bayer).
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.logging import log
from ..isp.bayer import bayer2rggb, rot_bayer
from ..nle.nlf import collab_nlf, self_nlf
from ..nle.robust import (collab_nlf_robust, flat_floor_stats,
                          mad_noise_floor, self_nlf_robust)
from ..vst.lut import FULL_X_GRID, BiasLUT
from .denoiser import SimpleDenoiser
from .policy import (DEFAULT_FLOOR_FRAC, DEFAULT_POLICY, DEFAULT_TOL,
                     combine_rounds, reg_agreement)
from .runner import TiledRunner

@dataclasses.dataclass
class PipelineConfig:
    """The YAML `pipeline:` block."""
    full_est: bool = True
    est_type: str = "simple+full"
    k: int = 29
    full_dn: bool = False
    vst_type: str = "exact"
    bias_corr: Optional[str] = "pre"
    denoiser_type: str = "gru32n"
    iter: str = "iter"
    max_iter: int = 1
    clip: bool = False
    data_type: str = "SIDD"
    cal_est: Optional[str] = None
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PipelineConfig":
        d = dict(d)
        if d.get("bias_corr") == "none":
            d["bias_corr"] = None
        fields = {f.name for f in dataclasses.fields(cls)}
        known = {k: v for k, v in d.items() if k in fields}
        known["extras"] = {k: v for k, v in d.items() if k not in fields}
        return cls(**known)


class YONDEngine:
    """Orchestrates NLE + denoise rounds for one scene.

    denoiser: VSTDenoiser or BM3DVSTDenoiser (its device is the
    engine's); pipe: PipelineConfig; biaslut: BiasLUT (default: the
    committed table); est_models: optional {'est_net': callable(lr) ->
    (beta1, sigma)} for est_type 'pge' (the est_UNet scalar estimator, in
    [0, 1] units; lr is the [N, H, W] bayer tensor on the engine's
    device). Without an est_net, est_types 'cal_est', 'foi', 'liu', 'zou'
    and 'pge' read precomputed estimates from files (_file_based_est).
    """

    def __init__(self, denoiser, pipe: PipelineConfig,
                 biaslut: Optional[BiasLUT] = None,
                 est_models: Optional[Dict[str, Any]] = None,
                 logfile: Optional[str] = None):
        self.denoiser = denoiser
        self.device = denoiser.device
        self.pipe = pipe
        self.biaslut = biaslut or BiasLUT()
        self.est_models = est_models or {}
        self.logfile = logfile

    def _tensor(self, a):
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    # ---------------------------------------------------------------- NLE
    def _estimate_self(self, raw_bayer) -> tuple:
        """Self NLE on a bayer frame or crop stack; with `robust_nle`
        (pipeline extras, default on) cross-checked against the wavelet
        MAD."""
        rggb = bayer2rggb(self._tensor(raw_bayer))
        if self.pipe.extras.get("robust_nle", True):
            b1, b2 = self_nlf_robust(rggb, k=self.pipe.k)
        else:
            b1, b2 = self_nlf(rggb, k=self.pipe.k)
        return float(b1), float(b2)

    def _estimate_collab(self, lr_bayer, dn_bayer, self_reg=None) -> tuple:
        rggb_lr = bayer2rggb(self._tensor(lr_bayer))
        rggb_dn = bayer2rggb(self._tensor(dn_bayer))
        if self.pipe.extras.get("robust_nle", True):
            b1, b2 = collab_nlf_robust(rggb_lr, rggb_dn, k=self.pipe.k,
                                       self_reg=self_reg)
        else:
            b1, b2 = collab_nlf(rggb_lr, rggb_dn, k=self.pipe.k)
        return float(b1), float(b2)

    def _file_based_est(self, data, img_id: int, p) -> tuple:
        """Precomputed estimates (yondx/pipeline/engine.py:111-145):
        'cal_est' (or a pipeline cal_est path) -> the pkl record's
        sfrn[f"{camera}_{iso:05d}"] point, else its per-camera beta1 /
        beta2 polynomials at the ISO (camera and ISO from data['name']);
        'foi'/'liu' -> row img_id of {Foi,Liu}Est_fullPict.mat's
        return_params; 'zou'/'pge' -> row img_id of Zou_ / PGE_fullPict.npy
        (pge's second entry is sigma, squared to beta2). The files sit in
        data['root_dir']/SIDD_Validation_Raw."""
        pipe = self.pipe
        root = data.get("root_dir", "")
        if "cal_est" in pipe.est_type or pipe.cal_est:
            path = pipe.cal_est or data["cal_est"]
            with open(path, "rb") as f:
                record = pickle.load(f)
            name = data["name"]
            ct, iso = name.split("_")[2], int(name.split("_")[3])
            key = f"{ct}_{iso:05d}"
            if key in record["sfrn"]:
                return tuple(record["sfrn"][key])
            return (float(np.poly1d(record["beta1"][ct])(iso)),
                    float(np.poly1d(record["beta2"][ct])(iso)))
        base = os.path.join(root, "SIDD_Validation_Raw")
        if "foi" in pipe.est_type or "liu" in pipe.est_type:
            import scipy.io as sio
            tag = "FoiEst" if "foi" in pipe.est_type else "LiuEst"
            reg = sio.loadmat(os.path.join(
                base, f"{tag}_fullPict.mat"))["return_params"][img_id]
            return float(reg[0]), float(reg[1])
        if "zou" in pipe.est_type:
            reg = np.load(os.path.join(base, "Zou_fullPict.npy"))[img_id]
            return float(reg[0]), float(reg[1])
        reg = np.load(os.path.join(base, "PGE_fullPict.npy"))[img_id]
        return float(reg[0]), float(reg[1]) ** 2

    # ------------------------------------------------------------ denoise
    def _curve(self, p):
        p["gain"] = max(p["gain"], 1e-4)
        return self.biaslut.curve(p["gain"], p["sigma"]) \
            if self.pipe.bias_corr \
            else np.zeros(len(FULL_X_GRID), np.float32)

    def _denoise_round(self, lr, p):
        """One denoise pass over the crop batch / frame -> (output, raw
        net output); the raw one feeds the next round's collab NLE."""
        curve = self._curve(p)
        x = self._tensor(lr)
        if "rot_cfa" in p:
            x = rot_bayer(x, p["cfa"])
        dn, dn_raw = self.denoiser.denoise_pair(x, curve, p["gain"],
                                                p["sigma"], p["scale"])
        if "rot_cfa" in p:
            dn = rot_bayer(dn, p["cfa"], rev=True)
            dn_raw = rot_bayer(dn_raw, p["cfa"], rev=True)
        return dn, dn_raw

    def _dn0_noise_frac(self, dn_raw_bayer, collab_reg, mu: float) -> float:
        """Noise floor of the round-0 raw output as a fraction of the
        collab noise model (telemetry, in the `signals` rows)."""
        rggb = bayer2rggb(self._tensor(dn_raw_bayer))
        floor = float(mad_noise_floor(rggb))
        v_col = collab_reg[0] * mu + collab_reg[1]
        return floor ** 2 / max(v_col, 1e-30)

    def _input_floor_frac(self, lr_bayer, self_reg) -> float:
        """The noisy input's content-free noise floor against the self
        noise model at the floor's mid-tone intensity, as a variance
        ratio: the rescue policy's gate."""
        rggb = bayer2rggb(self._tensor(lr_bayer))
        floor, mu_mid = flat_floor_stats(rggb)
        v_self = self_reg[0] * float(mu_mid) + max(self_reg[1], 0.0)
        return float(floor) ** 2 / max(v_self, 1e-30)

    def _collab_rounds(self, lr, p, regs, dn, dn_raw, second_pass,
                       raw_dns, signals, tag: str):
        """Rounds 1..max_iter: collab re-estimate, guards, rescue gate;
        second_pass(p) -> (output, raw net output) of one more pass."""
        pipe = self.pipe
        policy = pipe.extras.get("iter_policy", DEFAULT_POLICY)
        tol = float(pipe.extras.get("iter_policy_tol", DEFAULT_TOL))
        ff_tol = float(pipe.extras.get("iter_policy_floor_frac",
                                       DEFAULT_FLOOR_FRAC))
        ffrac = self._input_floor_frac(lr, regs[0])
        for epoch in range(1, pipe.max_iter + 1):
            reg = self._estimate_collab(lr, dn_raw, self_reg=regs[0])
            if reg[1] < 0:
                log(f"Warning!!! b={reg[1]:.4f} is backup to "
                    f"{reg[0] ** 2:.4f}", logfile=self.logfile)
                reg = (reg[0], reg[0] ** 2)
            p["gain"] = reg[0] * (p["wp"] - p["bl"])
            p["sigma"] = float(np.sqrt(reg[1])) * (p["wp"] - p["bl"])
            log(f"Iter {epoch} Est{tag}: K={p['gain']:.4f}, "
                f"sigma={p['sigma']:.4f} (beta1={reg[0]:.3e}, "
                f"beta2={reg[1]:.3e})", logfile=self.logfile)
            if reg[0] < 0:
                log("Warning!!! Wrong noise level! Backup to iter_0 "
                    "result.", logfile=self.logfile)
                break
            prev, prev_raw = dn, dn_raw
            mu = float(torch.mean(prev_raw))
            agree = float(reg_agreement(regs[-1], reg, mu))
            frac = self._dn0_noise_frac(prev_raw, reg, mu)
            # the rescue blend weight is exactly 0 unless collab signals
            # an under-estimate AND the input's floor certifies the self
            # model low: skip the dead second pass then
            fire = policy != "rescue" or (agree > tol and ffrac > ff_tol)
            if fire:
                dn, dn_raw = second_pass(p)
                dn = combine_rounds(prev, dn, agree, policy=policy, tol=tol,
                                    floor_frac=ffrac if policy == "rescue"
                                    else None, floor_frac_tol=ff_tol)
            log(f"Iter {epoch} policy={policy} disagree={agree:+.3f} "
                f"(tol {tol}) input_floor_frac={ffrac:.3f} ({ff_tol}) "
                f"dn0_noise_frac={frac:.3f}"
                + ("" if fire else " [second pass skipped]"),
                logfile=self.logfile)
            raw_dns.append(dn.cpu().numpy())
            regs.append(reg)
            signals.append({"agree": agree, "frac": frac, "ffrac": ffrac,
                            "fired": bool(fire)})

    # -------------------------------------------------------------- main
    def iter_denoise(self, data: Dict[str, Any], p: Dict[str, Any],
                     img_id: int = 0) -> Dict[str, Any]:
        """The full iterative pipeline for one scene.

        data: {'lr': [N,H,W] or [H,W] bayer in [0,1], optional 'lr_full'
        (full-res frame for the self estimate), 'cfa'}. p: {'wp', 'bl',
        'ratio', 'scale', optional 'cfa', 'rot_cfa'; 'gain'/'sigma' for
        est_type 'manual'}. Returns {'raw_dns': [round0, ...] numpy
        arrays shaped as lr, 'regs': [(beta1, beta2), ...], 'signals'}.
        """
        pipe = self.pipe
        lr = self._tensor(np.asarray(data["lr"], np.float32))
        if not pipe.full_est:
            # per-crop estimation without full_est: the non-VST path
            simple = SimpleDenoiser(self.denoiser.model, guided=False,
                                    pad_base=self.denoiser.pad_base,
                                    device=self.device)
            return {"raw_dns": [simple(lr).cpu().numpy()],
                    "regs": [(0.0, 0.0)]}
        if "manual" in pipe.est_type:
            reg = (p["gain"] / (p["wp"] - p["bl"]),
                   (p["sigma"] / (p["wp"] - p["bl"])) ** 2)
        elif "simple" in pipe.est_type or "ours" in pipe.est_type:
            reg = self._estimate_self(data.get("lr_full", lr))
        elif "pge" in pipe.est_type and "est_net" in self.est_models:
            # the net's second scalar is sigma, squared to beta2
            r = self.est_models["est_net"](lr)
            reg = (float(r[0]), float(r[1]) ** 2)
        elif any(t in pipe.est_type for t in
                 ("cal_est", "foi", "liu", "zou", "pge")):
            reg = self._file_based_est(data, img_id, p)
        else:
            raise NotImplementedError(
                f"est_type {pipe.est_type!r} needs precomputed files "
                "(foi/liu/zou) or an est_net")
        p["gain"] = reg[0] * (p["wp"] - p["bl"])
        p["sigma"] = float(np.sqrt(max(reg[1], 0.0))) * (p["wp"] - p["bl"])
        log(f"Self Est: K={p['gain']:.4f}, b={p['sigma']:.4f} "
            f"(beta1={reg[0]:.3e}, beta2={reg[1]:.3e})",
            logfile=self.logfile)
        regs: List[tuple] = [reg]
        signals: List[dict] = []
        dn, dn_raw = self._denoise_round(lr, p)
        raw_dns = [dn.cpu().numpy()]
        if pipe.iter == "iter":
            self._collab_rounds(lr, p, regs, dn, dn_raw,
                                lambda pp: self._denoise_round(lr, pp),
                                raw_dns, signals, "")
        return {"raw_dns": raw_dns, "regs": regs, "signals": signals}

    def iter_denoise_tiled(self, data: Dict[str, Any], p: Dict[str, Any],
                           tile: int = 1024, halo: int = 64,
                           batch: int = 8) -> Dict[str, Any]:
        """The full iterative pipeline on ONE large frame through the
        overlap-tiled runner: NLE on the WHOLE frame, denoise tiled,
        collab NLE on the whole (noisy, round-0 raw) pair, tiled second
        pass, same guards and policy as iter_denoise.

        data: {'lr': [H, W] bayer in [0, 1]}; p as in iter_denoise.
        """
        lr = self._tensor(np.asarray(data["lr"], np.float32))
        if "rot_cfa" in p:
            lr = rot_bayer(lr, p["cfa"])
        runner = TiledRunner(self.denoiser, tile=tile, halo=halo,
                             batch=batch)

        def one_pass(pp):
            curve = self._curve(pp)
            return runner.run_pair(lr, curve, pp["gain"], pp["sigma"],
                                   pp["scale"])

        reg = self._estimate_self(lr)
        p["gain"] = reg[0] * (p["wp"] - p["bl"])
        p["sigma"] = float(np.sqrt(max(reg[1], 0.0))) * (p["wp"] - p["bl"])
        log(f"Self Est (tiled frame): K={p['gain']:.4f}, "
            f"b={p['sigma']:.4f} (beta1={reg[0]:.3e}, beta2={reg[1]:.3e})",
            logfile=self.logfile)
        regs: List[tuple] = [reg]
        signals: List[dict] = []
        dn, dn_raw = one_pass(p)
        raw_dns = [dn.cpu().numpy()]
        if self.pipe.iter == "iter":
            self._collab_rounds(lr, p, regs, dn, dn_raw, one_pass, raw_dns,
                                signals, " (tiled)")
        if "rot_cfa" in p:
            raw_dns = [rot_bayer(torch.from_numpy(d), p["cfa"],
                                 rev=True).numpy() for d in raw_dns]
        return {"raw_dns": raw_dns, "regs": regs, "signals": signals}

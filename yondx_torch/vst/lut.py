"""Bias LUT grids, tables and the gather-free Chebyshev lookup (port of
yondx/vst/lut.py).

The tables are `checkpoints/bias_lut_2d.npy` (X_LUT x SG_LUT) and
`checkpoints/bias_lut_sgext.npy` (X_LUT x SG_EXT, the device path's
extension past sg = 10 e-). Both are committed; when one is missing,
`BiasLUT` and `load_sgext_lut` build it with the exact separable
evaluator (`bias.bias_points`) and write it to the path asked for (next
to the main table for the extension), as the JAX package does: about
8 s for the extension, a few minutes for the 2-D table.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from .bias import bias_points, close_form_bias

# --- grids (yondx/vst/lut.py:37-65) -----------------------------------------
_SP = 128
X_LIN_STEP = 2.0 ** -4 / _SP                      # 2^-11
X_LUT = np.concatenate((
    np.linspace(0, 2 ** -4, _SP, endpoint=False),
    np.exp(np.linspace(np.log(2 ** -4), np.log(2 ** 10), 14 * _SP + 1)),
))                                                # 1921
SG_LUT = np.concatenate((
    np.linspace(0, 1, 200, endpoint=False),
    np.linspace(1, 10, 901),
))                                                # 1101
_N_EXT = 256
X_EXT = np.exp(np.linspace(np.log(2 ** 10), np.log(2 ** 16), _N_EXT + 1))[1:]
FULL_X_GRID = np.concatenate((X_LUT, X_EXT))      # 2177
SG_EXT = np.exp(np.linspace(np.log(10.0), np.log(160.0), 65))

_LOG_A = math.log(2 ** -4)
_LOG_D = (math.log(2 ** 10) - _LOG_A) / (14 * _SP)      # log-grid step
_EXT_A = math.log(2 ** 10)
_EXT_D = (math.log(2 ** 16) - _EXT_A) / _N_EXT

_PKG_CHECKPOINTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "checkpoints")


def _save(path: str | None, lut: np.ndarray) -> None:
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.save(path, lut)


def bias_lut_columns(lo: int, hi: int) -> np.ndarray:
    """Columns lo:hi of the 2-D table: the bias at (X_LUT e-, SG_LUT[lo:hi]
    e-), gain 1, float64."""
    return bias_points(X_LUT, SG_LUT[lo:hi])


def build_bias_lut(path: str | None = None, block: int = 256) -> np.ndarray:
    """The 2-D bias table [len(X_LUT), len(SG_LUT)] (float32), built
    `block` sg columns at a time, saved to `path` when given."""
    lut = np.empty((len(X_LUT), len(SG_LUT)), np.float64)
    for s in range(0, len(SG_LUT), block):
        lut[:, s:s + block] = bias_lut_columns(s, s + block)
    lut = lut.astype(np.float32)
    _save(path, lut)
    return lut


def build_bias_lut_sgext(path: str | None = None) -> np.ndarray:
    """The exact bias table over (X_LUT, SG_EXT) for the device sg > 10
    path (float32), saved to `path` when given."""
    lut = bias_points(X_LUT, SG_EXT).astype(np.float32)
    _save(path, lut)
    return lut


def _sgext_path_for(lut_path: str | None) -> str | None:
    """The extension table's path: next to the main table."""
    if lut_path:
        return os.path.join(os.path.dirname(lut_path) or ".",
                            "bias_lut_sgext.npy")
    return None


def _default_lut_path() -> str | None:
    """Search order: $YONDX_BIAS_LUT, ./checkpoints/bias_lut_2d.npy, then
    the checkpoints/ folder of the checkout this package sits in."""
    cands = [os.environ.get("YONDX_BIAS_LUT"),
             os.path.join("checkpoints", "bias_lut_2d.npy"),
             os.path.join(_PKG_CHECKPOINTS, "bias_lut_2d.npy")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    return None


# tables read or built in this process, by absolute path ("__sgext__" /
# "__built__" for tables built without one)
_LUT_CACHE: dict = {}


def load_sgext_lut(lut_path: str | None = None) -> np.ndarray:
    """The sg-extension table [len(X_LUT), len(SG_EXT)] next to the main
    table (`lut_path`, else the default one): read, or built and written
    there when missing."""
    path = _sgext_path_for(lut_path or _default_lut_path())
    key = os.path.abspath(path) if path else "__sgext__"
    if key not in _LUT_CACHE:
        if path and os.path.exists(path):
            _LUT_CACHE[key] = np.load(path)
        else:
            _LUT_CACHE[key] = build_bias_lut_sgext(path)
    lut = _LUT_CACHE[key]
    if lut.shape != (len(X_LUT), len(SG_EXT)):
        raise ValueError(f"bad sg-extension table shape {lut.shape}")
    return lut


class BiasLUT:
    """Holder of the 2-D bias table [len(X_LUT), len(SG_LUT)]: `lut`, or
    the table at `lut_path` (else the default one), built and written
    there when missing."""

    def __init__(self, lut_path: str | None = None,
                 lut: np.ndarray | None = None):
        if lut is None:
            lut_path = lut_path or _default_lut_path()
            if lut_path and os.path.exists(lut_path):
                key = os.path.abspath(lut_path)
                if key not in _LUT_CACHE:
                    _LUT_CACHE[key] = np.load(lut_path)
                lut = _LUT_CACHE[key]
            elif lut_path:
                lut = build_bias_lut(lut_path)
            else:
                if "__built__" not in _LUT_CACHE:
                    _LUT_CACHE["__built__"] = build_bias_lut()
                lut = _LUT_CACHE["__built__"]
        if lut.shape != (len(X_LUT), len(SG_LUT)):
            raise ValueError(f"bad bias table shape {lut.shape}")
        self.lut = np.asarray(lut, np.float32)

    def curve(self, K: float, sigma: float) -> np.ndarray:
        """Host bias curve over FULL_X_GRID (float32, len 2177) for shot
        gain K and read sigma (DN)."""
        return bias_curve_for(K, sigma, self.lut)


def _sg_frac_index(sg: float) -> float:
    """Analytic fractional index of sg in SG_LUT (piecewise linear)."""
    if sg < 1.0:
        return sg / 0.005
    return 200.0 + (sg - 1.0) / 0.01


def bias_curve_for(K: float, sigma: float, lut: np.ndarray) -> np.ndarray:
    """Host per-call bias curve over FULL_X_GRID (float32, len 2177): in
    the table's sg range (sg = sigma / K <= 10 e-) a blend of two sg
    columns, beyond it the exact evaluation of the whole column; the
    closed form past 2^10 e-."""
    sg = float(sigma) / float(K)
    if sg <= SG_LUT[-1]:
        pos = min(max(_sg_frac_index(sg), 0.0), len(SG_LUT) - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(SG_LUT) - 1)
        w = pos - lo
        base = lut[:, lo] * (1.0 - w) + lut[:, hi] * w
    else:
        base = bias_points(X_LUT, np.array([sg]))[:, 0].astype(np.float32)
    ext = close_form_bias(X_EXT, sigGs=sg, K=1.0).astype(np.float32)
    return np.concatenate((base.astype(np.float32), ext))


def frac_index_x(xe):
    """Analytic fractional index of electron values in FULL_X_GRID
    (linear segment, log segment to 2^10, log extension to 2^16)."""
    xe = torch.clamp(xe, min=0.0)
    pos_lin = xe / X_LIN_STEP

    def log_pos(x, a, d, base_idx):
        j = torch.floor((torch.log(torch.clamp(x, min=1e-30)) - a) / d)
        g0 = torch.exp(a + j * d)
        g1 = torch.exp(a + (j + 1) * d)
        return base_idx + j + (x - g0) / (g1 - g0)

    pos_log = log_pos(xe, _LOG_A, _LOG_D, _SP)
    pos_ext = log_pos(xe, _EXT_A, _EXT_D, len(X_LUT) - 1)
    pos = torch.where(xe < 2 ** -4, pos_lin,
                      torch.where(xe <= 2 ** 10, pos_log, pos_ext))
    return torch.clamp(pos, 0.0, len(FULL_X_GRID) - 1)


# --- gather-free Chebyshev path (yondx/vst/lut.py:238-288) -----------------
CHEB_M = 65


def _cheb_static(M: int = CHEB_M):
    """Chebyshev node positions on [0, L-1] and the DCT matrix mapping node
    samples to series coefficients (float32 numpy)."""
    L = len(FULL_X_GRID)
    k = np.arange(M)
    s = np.cos(np.pi * (k + 0.5) / M)
    pos_nodes = (s + 1.0) / 2.0 * (L - 1)
    T = np.cos(np.outer(np.arccos(s), np.arange(M)))
    dct = (2.0 / M) * T.T
    dct[0] *= 0.5
    return pos_nodes.astype(np.float32), dct.astype(np.float32)


_CHEB_POS_NODES, _CHEB_DCT = _cheb_static()


def interp_curve(curve, pos):
    """The [2177] curve linearly interpolated at fractional indices pos."""
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=curve.shape[0] - 1)
    w = pos - lo
    return curve[lo] * (1.0 - w) + curve[hi] * w


def lookup_bias_curve(x_dn, curve, K):
    """Per-pixel bias by a fractional gather of the per-call curve
    (yondx/vst/lut.py:215-232): x_dn pixel values in DN (>= 0), curve
    [2177] from `bias_curve_for`, K the shot gain. In VST units."""
    return interp_curve(curve, frac_index_x(x_dn / K))


def cheb_fit_curve(curve):
    """Sample the [2177] curve at the Chebyshev nodes -> coefficients [M]."""
    pos = torch.as_tensor(_CHEB_POS_NODES, device=curve.device)
    return torch.as_tensor(_CHEB_DCT, device=curve.device) @ interp_curve(
        curve, pos)


def lookup_bias_curve_cheb(x_dn, coeffs, K):
    """Per-pixel bias by Clenshaw evaluation of the Chebyshev series at
    s = 2*pos/(L-1) - 1."""
    L = len(FULL_X_GRID)
    pos = frac_index_x(x_dn / K)
    s = pos * (2.0 / (L - 1)) - 1.0
    b1 = torch.zeros_like(s)
    b2 = torch.zeros_like(s)
    two_s = 2.0 * s
    for i in range(coeffs.shape[0] - 1, 0, -1):   # highest order first
        b1, b2 = two_s * b1 - b2 + coeffs[i], b1
    return s * b1 - b2 + coeffs[0]

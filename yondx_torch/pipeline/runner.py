"""Overlap-tiled full-frame runner (port of yondx/pipeline/runner.py).

The frame is cut on its device into a static grid of halo-padded tiles
(core.tiling.tile_overlap), the tile batch goes through the VST denoiser
in chunks of a fixed size (the last chunk padded with copies of the last
tile), and the halos are cropped on merge, on the device. Per-pixel
results equal whole-frame inference wherever the net's receptive field
fits in the halo.
"""
from __future__ import annotations

import torch

from ..core.tiling import tile_overlap, untile_overlap
from ..isp.bayer import bayer2rggb
from .denoiser import adaptive_sigma_corr


class TiledRunner:
    """Run a VSTDenoiser over an arbitrarily large bayer frame.

    tile/halo are in bayer pixels and must be even (RGGB phase).
    """

    def __init__(self, denoiser, tile: int = 1024, halo: int = 64,
                 batch: int = 8):
        if tile % 2 or halo % 2:
            raise ValueError(f"tile {tile} and halo {halo} must be even")
        self.denoiser = denoiser
        self.tile = tile
        self.halo = halo
        self.batch = batch

    def __call__(self, bayer, curve, K, sigma, scale):
        return self.run_pair(bayer, curve, K, sigma, scale)[0]

    @torch.no_grad()
    def run_pair(self, bayer, curve, K, sigma, scale):
        """[H, W] bayer (array or tensor) -> (output, raw net output)
        [H, W] tensors on the denoiser's device; the raw one feeds the
        whole-frame collab NLE of an iterated tiled run."""
        dev = self.denoiser.device
        bayer = torch.as_tensor(bayer, dtype=torch.float32, device=dev)
        tiles, plan = tile_overlap(bayer, self.tile, self.halo)
        n = tiles.shape[0]
        # adaptive sigma_corr is resolved once at frame scope: a rule read
        # per tile batch could step the guidance between neighbouring
        # tiles (a seam)
        corr = None
        if getattr(self.denoiser, "sigma_corr", None) == "adaptive":
            def f32(v):
                return torch.as_tensor(v, dtype=torch.float32, device=dev)
            corr = float(adaptive_sigma_corr(bayer2rggb(bayer), f32(K),
                                             f32(sigma), f32(scale)))
        # pad the batch to a multiple of self.batch (static shapes)
        nb = -(-n // self.batch) * self.batch
        if nb != n:
            tiles = torch.cat([tiles, tiles[-1:].expand(nb - n, -1, -1)])
        outs, raws = [], []
        for s in range(0, nb, self.batch):
            dn, dn_raw = self.denoiser.denoise_pair(
                tiles[s:s + self.batch], curve, K, sigma, scale, corr=corr)
            outs.append(dn)
            raws.append(dn_raw)
        return (untile_overlap(torch.cat(outs), plan, self.halo),
                untile_overlap(torch.cat(raws), plan, self.halo))

"""The frozen work counts of counts.py tied to the port: the SNR-Nets'
operations to a forward-hook count of the port's modules, and K1's bytes
to the planes the port's fused entry hands to K1's wrapper."""
import json
import os

import numpy as np
import pytest
import torch
from torch import nn

from perfbench import counts

ARCHS = {
    "s2dt16-bf16": (256, 352),
    "gru32-fp32": (160, 224),
}


def _arch(root, name):
    with open(os.path.join(root, "perfbench", "configs", name + ".json")) as f:
        return json.load(f)["arch"]


def _hook_count(net, x, t):
    seen = {}

    def hook(mod, inp, out):
        i = inp[0]
        if isinstance(mod, nn.ConvTranspose2d):
            f = 2 * i.shape[2] * i.shape[3] * mod.in_channels \
                * mod.out_channels * mod.kernel_size[0] * mod.kernel_size[1]
        elif isinstance(mod, nn.Conv2d):
            f = 2 * out.shape[2] * out.shape[3] * mod.in_channels \
                * mod.out_channels * mod.kernel_size[0] * mod.kernel_size[1]
        else:
            f = 2 * mod.in_features * mod.out_features * i.shape[0]
        seen[names[mod]] = seen.get(names[mod], 0) + f

    names = {m: n for n, m in net.named_modules()}
    hs = [m.register_forward_hook(hook) for m in net.modules()
          if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear))]
    with torch.no_grad():
        net(x, t)
    for h in hs:
        h.remove()
    return seen


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_net_flops_match_a_hook_count(root, name):
    from yondx_torch.models.registry import build_model
    arch = _arch(root, name)
    h, w = ARCHS[name]
    hp, wp = counts.padded(h, w)
    net = build_model(arch).eval()
    seen = _hook_count(net, torch.rand(1, hp, wp, 4), torch.ones(1))
    layers = {l["name"]: l["flops"] for l in counts.net_layers(arch, hp, wp)}
    assert layers == seen
    assert counts.net_work(arch, h, w, 4)[0] == sum(seen.values())


@pytest.mark.parametrize("hw", [(200, 328), (2048, 2624)])
def test_k1_bytes_match_the_entrys_planes(root, monkeypatch, hw):
    import yondx_torch.pipeline.fused as port_fused
    from yondx_torch.vst.lut import BiasLUT
    calls = []
    real = port_fused.nle_moments

    def spy(x, k, inner, texture=True, mean=True):
        calls.append(4 * x.numel() * (1 + (texture + mean + 1)))
        assert (k, inner) == (29, 19)
        return real(x, k, inner, texture=texture, mean=mean)

    monkeypatch.setattr(port_fused, "nle_moments", spy)
    fn = port_fused.make_fused_blind_denoiser(
        lambda x, t: x, BiasLUT().lut, guided=True, sigma_corr="adaptive",
        max_iter=1, refine=True, device="cpu")
    h, w = hw
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((1, h // 2, w // 2, 4), np.float32)
                         * 0.5 + 0.2)
    fn(x, 959.0)
    assert calls == counts.k1_launch_bytes(h // 2, w // 2)

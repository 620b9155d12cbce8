"""Frozen work counts: the SNR-Net's operations and bytes per forward, and
kernel K1's bytes per launch, from the configuration's widths and the
frame's shape alone (nothing is read from the program's modules).

A convolution of cin -> cout channels with a k x k kernel does
2 * cin * cout * k^2 operations per output pixel (per input pixel for a
transposed one); a dense layer 2 * in * out per row. Its bytes are its
input read once, its output written once and its weights read once, in
the net's storage type. Element-wise work (activations, the FiLM affine,
the residual adds) is not counted.
"""
from __future__ import annotations

from .reference.fused import BAND, M_COLLAB, M_SELF, MAX_PX
from .reference.nle import band_plan

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet


def _conv(name, h, w, cin, cout, k, stride=1):
    ho, wo = (h + stride - 1) // stride, (w + stride - 1) // stride
    return {"name": name, "flops": 2 * ho * wo * cin * cout * k * k,
            "in": h * w * cin, "out": ho * wo * cout,
            "weights": cin * cout * k * k + cout}


def _deconv(name, h, w, cin, cout):
    return {"name": name, "flops": 2 * h * w * cin * cout * 4,
            "in": h * w * cin, "out": 4 * h * w * cout,
            "weights": cin * cout * 4 + cout}


def _dense(name, fin, fout):
    return {"name": name, "flops": 2 * fin * fout, "in": fin, "out": fout,
            "weights": fin * fout + fout}


def _block(name, h, w, cin, f):
    out = []
    if cin != f:
        out.append(_conv(f"{name}.short_cut.conv", h, w, cin, f, 1))
    out += [_conv(f"{name}.conv1", h, w, f, f, 3),
            _dense(f"{name}.guide.gamma_in", 1, f),
            _dense(f"{name}.guide.gamma_out", f, f),
            _dense(f"{name}.guide.beta_out", f, f),
            _conv(f"{name}.conv2", h, w, f, f, 3)]
    return out


def _unet(layers, pre, h, w, nf, in_nc, depth):
    """conv_in, `depth` encoder levels, the bottleneck, the decoder and the
    head, at input size h x w (divisible by 2^depth)."""
    layers.append(_conv(f"{pre}conv_in", h, w, in_nc, nf, 3))
    feats = [nf * 2 ** i for i in range(depth)]
    cin = nf
    for i, f in enumerate(feats):
        s = 2 ** i
        layers += _block(f"{pre}conv{i + 1}", h // s, w // s, cin, f)
        cin = feats[i + 1] if i + 1 < depth else 2 * feats[-1]
        layers.append(_conv(f"{pre}pool{i + 1}.conv", h // s, w // s, f, cin,
                            3, stride=2))
    s = 2 ** depth
    layers += _block(f"{pre}conv{depth + 1}", h // s, w // s, cin, cin)
    for i, f in enumerate(reversed(feats)):
        s = 2 ** (depth - i)
        layers.append(_deconv(f"{pre}upv{depth + 2 + i}.deconv", h // s,
                              w // s, cin, f))
        layers += _block(f"{pre}conv{depth + 2 + i}", 2 * h // s, 2 * w // s,
                         2 * f, f)
        cin = f
    return layers


def net_layers(arch, hp, wp):
    """Every conv, transposed conv and dense layer of one forward on a
    padded [1, hp, wp, in_nc] input."""
    nf, in_nc, out_nc = arch["nf"], arch["in_nc"], arch["out_nc"]
    if arch["name"] == "GuidedResUnet":
        layers = _unet([], "unet.", hp, wp, nf, in_nc, 4)
        layers.append(_conv("unet.conv10", hp, wp, nf, out_nc, 1))
        return layers
    if arch["name"] == "GuidedResUnetS2D":
        h, w = hp // 2, wp // 2
        layers = _unet([], "", h, w, nf, 4 * in_nc, 3)
        layers.append(_conv("conv_out", h, w, nf, 4 * out_nc, arch["out_k"]))
        if arch.get("tail_nf"):
            layers += [_conv("tail_1", hp, wp, 2 * out_nc, arch["tail_nf"], 3),
                       _conv("tail_2", hp, wp, arch["tail_nf"], out_nc, 3)]
        return layers
    raise KeyError(f"no count for net {arch['name']!r}")


def padded(h, w, base=32):
    return h + (-h) % base, w + (-w) % base


def net_work(arch, h, w, elem_bytes):
    """(operations, [(operations, bytes) of each layer]) of one forward
    on a [1, h, w, 4] frame, padded as the entry pads it."""
    hp, wp = padded(h, w)
    layers = net_layers(arch, hp, wp)
    per = [(l["flops"], (l["in"] + l["out"] + l["weights"]) * elem_bytes)
           for l in layers]
    return sum(f for f, _ in per), per


def net_bound_s(per_layer, peak_flops):
    """Least time of one forward: each layer's larger bound, summed."""
    return sum(max(f / peak_flops, b / HBM_BYTES_PER_S) for f, b in per_layer)


def k1_launch_bytes(h, w, c=4):
    """Bytes of each K1 launch of one frame's fused call, in launch order:
    the self fit (one plane set read, mean, var and texture written),
    the collab fit's noisy frame (var) and denoised frame (mean, var).
    Planes are the NLE row bands of the band plan (the whole frame when
    the plan is None), float32."""
    out = []
    for margin, writes in ((M_SELF, (3,)), (M_COLLAB, (1, 2))):
        plan = band_plan((1, h, w, c), MAX_PX, BAND, margin)
        elems = h * w * c if plan is None else plan[1] * BAND * w * c
        out += [4 * elems * (1 + n) for n in writes]
    return out


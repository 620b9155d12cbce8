"""The comparison and self-supervised zoo of the port (models/comp.py),
its registry entries, VSTDenoiser(fbi=True) and the reference .pth
converters (models/torch_port.py) against the JAX package, on the CPU.

Tolerances: flax's fresh weights (`flax_init_params`, and `init_params`
after the reference's N(0, 0.02)) bit for bit; each net's forward from
weights in flax's tree carried by models/convert.py to rtol 1e-5, atol
1e-5 (fp32 convolutions summed in other orders), DnCNN's train-mode
BatchNorm to rtol 1e-4, atol 5e-5 (batch variances of 2048 samples in
float32); the blind spot to 1e-5 (JAX's own test); the FBI denoiser to
atol 1e-5; the .pth converters exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yondx.vst.lut import FULL_X_GRID
from yondx.models import build_model as j_build
from yondx.models import torch_port as j_port
from yondx.models.registry import init_params as j_init
from yondx.models.registry import initialize_weights as j_initialize
from yondx.pipeline import VSTDenoiser as JVSTDenoiser

from yondx_torch.models import torch_port as t_port
from yondx_torch.models.convert import params_to_state_dict
from yondx_torch.models.registry import (build_model, flax_init_params,
                                         init_params, is_guided)
from yondx_torch.pipeline.denoiser import VSTDenoiser
from torch_test_util import _one_torch_thread  # noqa: F401

FBI = {"name": "FBI_Net", "nf": 16, "num_of_layers": 4, "mul": 1,
       "channel": 1, "output_channel": 2, "case": "FBI_Net",
       "output_type": "linear", "sigmoid_value": 0.1, "res": True,
       "in_nc": 1, "out_nc": 2}
DNCNN_BN = {"name": "DnCNN", "in_nc": 4, "out_nc": 4, "nf": 16, "depth": 5,
            "use_bn": True, "res": True}
# the JAX package's test widths (tests/test_models.py)
ARCHS = {
    "DnCNN": {"name": "DnCNN", "in_nc": 4, "out_nc": 4, "nf": 16,
              "depth": 5, "use_bn": False, "res": True},
    "SelfSupUNet": {"name": "SelfSupUNet", "in_nc": 4, "out_nc": 4,
                    "nf": 16, "depth": 3},
    "SelfResUNet": {"name": "SelfResUNet", "in_nc": 4, "out_nc": 4, "nf": 8,
                    "depth": 3},
    "N2NF_Unet": {"name": "N2NF_Unet", "in_nc": 4, "out_nc": 4},
    "FBI_Net": FBI,
    "GuidedSelfUnet": {"name": "GuidedSelfUnet", "guided": True,
                       "in_nc": 4, "out_nc": 4, "nf": 8, "nframes": 1,
                       "res": False, "norm": True, "depth": 3},
}
# heads and options beyond those widths
VARIANTS = {
    "FBI_Net-sigmoid-mul2": {**FBI, "output_type": "sigmoid", "mul": 2},
    "SelfResUNet-res-norm": {**ARCHS["SelfResUNet"], "res": True,
                             "norm": True},
}


def _np_tree(variables):
    return jax.tree.map(np.asarray, dict(variables))


def _random_variables(model, x, *extra, seed=6, std=0.2):
    """flax's variable tree of `model` (abstract init: no compile) filled
    with N(0, std) numpy draws."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.asarray(x), *extra)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: rng.normal(0, std, a.shape).astype(np.float32),
        dict(shapes))


_INITS = {}


def _pair(arch, S=32):
    """(flax model, its fresh variables (flax's eager init, as the JAX
    package's registry runs it; once per arch and size), the port's net,
    input)."""
    model = j_build(arch)
    key = (repr(sorted(arch.items())), S)
    if key not in _INITS:
        _INITS[key] = j_init(model, jax.random.PRNGKey(0),
                             (1, S, S, arch["in_nc"]),
                             guided=is_guided(arch))
    x = np.random.default_rng(0).random((2, S, S, arch["in_nc"]),
                                        np.float32)
    return model, _INITS[key], build_model(arch), x


def _forward_both(model, variables, net, x, guided):
    t = np.array([0.1, 0.3], np.float32)
    if guided:
        want = jax.jit(model.apply)(variables, jnp.asarray(x), jnp.asarray(t))
        got = net(torch.from_numpy(x), torch.from_numpy(t))
    else:
        want = jax.jit(model.apply)(variables, jnp.asarray(x))
        got = net(torch.from_numpy(x))
    return got.detach().numpy(), np.asarray(want)


@pytest.mark.parametrize("name", [n for n in ARCHS if n != "DnCNN"])
def test_flax_init_params_bit_equal(name):
    """flax_init_params == flax's eager init, every leaf (PReLU alphas,
    Dense and transposed-conv kernels too); DnCNN's is held with its
    BatchNorm in test_init_params_bit_equal."""
    _, variables, net, _ = _pair(ARCHS[name])
    got = flax_init_params(net, 0)
    want = params_to_state_dict(_np_tree(variables))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)


@pytest.mark.parametrize("arch", [DNCNN_BN, FBI], ids=["DnCNN-bn",
                                                       "FBI_Net"])
def test_init_params_bit_equal(arch):
    """init_params == initialize_weights' N(0, 0.02) over flax's variables
    in their sorted order: batch stats first, PReLU alphas and BatchNorm
    scales kept, each leaf taking its own split of the key; and the
    BatchNorm DnCNN's flax_init_params bit-equal too."""
    _, variables, net, _ = _pair(arch)
    if arch is DNCNN_BN:
        got = flax_init_params(net, 0)
        for k, v in params_to_state_dict(_np_tree(variables)).items():
            np.testing.assert_array_equal(got[k].numpy(), v.numpy(),
                                          err_msg=k)
    got = init_params(net, 42)
    want = params_to_state_dict(_np_tree(j_initialize(
        variables, jax.random.PRNGKey(42))))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)


@pytest.mark.parametrize("name", list(ARCHS) + list(VARIANTS))
def test_forward_matches_flax(name):
    """Each net's forward from N(0, 0.05) weights in flax's tree, carried
    by models/convert.py."""
    arch = {**ARCHS, **VARIANTS}[name]
    model, net = j_build(arch), build_model(arch)
    x = np.random.default_rng(0).random((2, 32, 32, arch["in_nc"]),
                                        np.float32)
    guided = is_guided(arch)
    variables = _random_variables(
        model, x[:1], *((jnp.full((1,), 0.1),) if guided else ()),
        std=0.05)
    net.load_state_dict(params_to_state_dict(variables))
    got, want = _forward_both(model, variables, net, x, guided)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_dncnn_batchnorm_eval_and_train_match_flax():
    """DnCNN with non-trivial batch stats and BatchNorm params: eval
    normalises by the stats; train by the batch, moving the stats with
    flax's momentum 0.95."""
    model, variables, net, x = _pair(DNCNN_BN)
    rng = np.random.default_rng(5)
    v = _np_tree(variables)
    for i in range(1, 4):
        bn = f"bn{i}"
        v["params"][bn]["scale"] = rng.uniform(0.5, 1.5, 16).astype(
            np.float32)
        v["params"][bn]["bias"] = rng.normal(0, 0.1, 16).astype(np.float32)
        v["batch_stats"][bn]["mean"] = rng.normal(0, 0.2, 16).astype(
            np.float32)
        v["batch_stats"][bn]["var"] = rng.uniform(0.5, 2.0, 16).astype(
            np.float32)
    net.load_state_dict(params_to_state_dict(v))
    got, want = _forward_both(model, v, net, x, False)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    want_t, upd = model.apply(v, jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
    got_t = net(torch.from_numpy(x), train=True)
    # train mode: each channel's batch variance is E[x^2] - E[x]^2 over
    # 2048 samples in float32 on both sides, summed in other orders;
    # measured 1.4e-5 apart at most on outputs up to ~1.5
    np.testing.assert_allclose(got_t.detach().numpy(), np.asarray(want_t),
                               rtol=1e-4, atol=5e-5)
    for i in range(1, 4):
        for stat in ("mean", "var"):
            np.testing.assert_allclose(
                getattr(getattr(net, f"bn{i}"), stat).numpy(),
                np.asarray(upd["batch_stats"][f"bn{i}"][stat]),
                rtol=1e-5, atol=1e-6)


def test_guided_self_unet_res_branch_fails_as_in_jax():
    """res=True adds the last features (2 nf channels) to the output:
    flax fails (already at init) unless out_nc == 2 nf, the port raises
    with that reason; with out_nc == 2 nf both add."""
    arch = {**ARCHS["GuidedSelfUnet"], "res": True}
    x = np.random.default_rng(0).random((2, 32, 32, 4), np.float32)
    t = np.array([0.1, 0.3], np.float32)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(j_build(arch).init, jax.random.PRNGKey(0),
                       jnp.asarray(x[:1]), jnp.asarray(t[:1]))
    with pytest.raises(ValueError, match="out_nc != 2 nf"):
        build_model(arch)(torch.from_numpy(x), torch.from_numpy(t))
    arch = {**arch, "out_nc": 16}
    model, net = j_build(arch), build_model(arch)
    variables = _random_variables(model, x[:1], jnp.asarray(t[:1]))
    net.load_state_dict(params_to_state_dict(variables))
    got, want = _forward_both(model, variables, net, x, True)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_fbi_blind_spot():
    """Changing only x[i, j] leaves output[i, j] unchanged
    (tests/test_models.py::test_fbi_net_blind_spot's net)."""
    arch = {**FBI, "nf": 8, "num_of_layers": 3, "output_channel": 1,
            "res": False, "out_nc": 1}
    net = build_model(arch)
    net.load_state_dict(flax_init_params(net, 0))
    x = torch.from_numpy(np.random.default_rng(1).random((1, 16, 16, 1),
                                                         np.float32))
    with torch.no_grad():
        y0 = net(x)
        x2 = x.clone()
        x2[0, 8, 8, 0] += 10.0
        y1 = net(x2)
    assert abs(float(y1[0, 8, 8, 0] - y0[0, 8, 8, 0])) < 1e-5
    assert float((y1 - y0).abs().max()) > 1e-3       # neighbours see it


@pytest.mark.parametrize("bias_corr", [None, "pre"])
def test_vst_denoiser_fbi_matches_jax(bias_corr):
    """VSTDenoiser(fbi=True): min/max normalisation of the VST output and
    the blind-spot net on the Bayer mosaic
    (tests/test_pipeline.py::test_fbi_variant_runs's setting)."""
    from yondx.vst.lut import BiasLUT as JBiasLUT
    arch = {**FBI, "nf": 8, "num_of_layers": 3, "output_channel": 1,
            "res": False, "out_nc": 1}
    model, net = j_build(arch), build_model(arch)
    variables = _random_variables(model, np.zeros((1, 64, 64, 1),
                                                  np.float32))
    net.load_state_dict(params_to_state_dict(variables))
    curve = np.zeros(len(FULL_X_GRID), np.float32) if bias_corr is None \
        else JBiasLUT().curve(8.0, 10.0)
    x = np.random.default_rng(2).random((2, 64, 64)).astype(np.float32)
    kw = dict(guided=False, bias_corr=bias_corr, vst_type="asym", fbi=True)
    want = np.asarray(JVSTDenoiser(model, variables, **kw)(
        jnp.asarray(x), curve, 8.0, 10.0, 959.0))
    got = VSTDenoiser(net, device="cpu", **kw)(x, curve, 8.0, 10.0,
                                               959.0).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


GRU8 = {"name": "GuidedResUnet", "guided": True, "in_nc": 4, "out_nc": 4,
        "nf": 8, "nframes": 1, "res": True, "norm": True}
UNET8 = {"name": "UNetSeeInDark", "in_nc": 4, "out_nc": 4, "nf": 8,
         "nframes": 1, "res": True, "norm": True}


@pytest.mark.parametrize("arch", [GRU8, UNET8], ids=["GuidedResUnet",
                                                     "UNetSeeInDark"])
def test_reference_pth_round_trip(arch, tmp_path):
    """A reference-layout state_dict that the test writes (random weights
    in flax's tree, through the JAX package's *_to_torch) as a .pth: the
    port's converters give the JAX package's tree and state_dict both
    ways, and the .pth loads into the port's net as exactly those
    weights; pth_transfer extracts a wrapped one."""
    model, net = j_build(arch), build_model(arch)
    variables = _random_variables(
        model, np.zeros((1, 32, 32, 4), np.float32),
        *((jnp.full((1,), 0.1),) if is_guided(arch) else ()), seed=4,
        std=0.1)
    to_j, to_t = {"GuidedResUnet": (j_port.guidedresunet_to_torch,
                                    t_port.guidedresunet_to_torch),
                  "UNetSeeInDark": (j_port.unetseeindark_to_torch,
                                    t_port.unetseeindark_to_torch)
                  }[arch["name"]]
    ref_sd = to_j(variables)
    sd_t = to_t(variables)
    assert set(sd_t) == set(ref_sd)
    for k in ref_sd:
        np.testing.assert_array_equal(sd_t[k], ref_sd[k])
    path = str(tmp_path / "net.pth")
    torch.save({"module." + k: torch.from_numpy(np.array(v))
                for k, v in ref_sd.items()}, path)
    got_tree = t_port.port_checkpoint(arch["name"], path)
    want_tree = j_port.port_checkpoint(arch["name"], path)
    got_leaves = jax.tree_util.tree_flatten_with_path(got_tree)[0]
    want_leaves = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (_, g), (_, w) in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(g, w)
    t_port.load_reference_pth(net, arch["name"], path)
    want_sd = params_to_state_dict(variables)
    got_sd = net.state_dict()
    assert set(got_sd) == set(want_sd)
    for k in want_sd:
        np.testing.assert_array_equal(got_sd[k].numpy(), want_sd[k].numpy(),
                                      err_msg=k)
    wrapped, out = str(tmp_path / "eld.pth"), str(tmp_path / "netG.pth")
    torch.save({"netG": torch.load(path), "epoch": 3}, wrapped)
    t_port.pth_transfer(wrapped, out)
    assert set(t_port.load_pth(out)) == set(torch.load(path))

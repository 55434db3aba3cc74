"""Every SS2D forward type of the port on the CPU against the JAX package:
the layer (the v2 body's base types, postfixes, out-norms and d_conv, the
unidi / bidi / cascade2d scans, the xv family, m0's out-norms), its forward
type parsers, the d_state-1 route of the unidi and bidi scans, and the new
ops and layers under it (the associative selective scan, the one-by-one
cross-scans, ``directional_scan_2d``, PatchMerging2D, flax's "SAME"
padding, the spatial softmax).

Inputs and parameters are numpy arrays from a seed handed to both sides
(``test_torch_parity.jax_variables``); JAX runs under ``jax.jit`` on the
CPU, where its SS2D scans with the XLA associative scan.  float32, the
tolerances of the SS2D parity tests of ``tests/test_torch_ssd.py``: the
output within 1e-5 and every input and parameter gradient within 1e-4 of
its tensor's largest magnitude (summation orders differ: the port's CPU
route runs the plain twins of kernels 2/7, 11/12 or 13/14).

The JAX package's ``ss2d_core_cascade2d`` indexes its weights with a
Python list, which the installed JAX refuses; the ``jax_cascade`` fixture
hands it the weights wrapped so that such an index becomes an array index
(the function itself runs unchanged).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xfmamba_tpu.models.ss2d as jax_ss2d
from test_torch_parity import jax_variables
from xfmamba_tpu.models.layers import Conv2dSame as JaxConv2dSame
from xfmamba_tpu.models.layers import PatchMerging2D as JaxPatchMerging2D
from xfmamba_tpu.models.layers import softmax_spatial as jax_softmax_spatial
from xfmamba_tpu_torch.checkpoint.convert import (
    export_jax_variables, jax_paths, load_jax_variables)
from xfmamba_tpu_torch.models import layers, ss2d
from xfmamba_tpu_torch.models.ss2d import SS2D
from xfmamba_tpu_torch.ops import cross_scan, selective_scan
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# the modules (``xfmamba_tpu.ops`` exports functions of the same names)
jax_cs = importlib.import_module("xfmamba_tpu.ops.cross_scan")
jax_ss = importlib.import_module("xfmamba_tpu.ops.selective_scan")
T = torch.from_numpy
D_MODEL = 16


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _leaf(tree, path):
    for name in path:
        tree = tree[name]
    return tree


class _ListIndexable:
    """An array whose ``[list]`` is an array index (and whose other indices
    are the array's own)."""

    def __init__(self, a):
        self.a, self.shape = a, a.shape

    def __getitem__(self, k):
        return self.a[jnp.asarray(k)] if isinstance(k, list) else self.a[k]


@pytest.fixture
def jax_cascade(monkeypatch):
    original = jax_ss2d.ss2d_core_cascade2d
    monkeypatch.setattr(jax_ss2d, "ss2d_core_cascade2d",
                        lambda x, xp, dw, *a, **kw: original(x, _ListIndexable(xp),
                                                             _ListIndexable(dw), *a, **kw))


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

# (forward type, d_state, d_conv, map): every postfix, out-norm kind, d_conv
# 1 / 2 / 4 and scan mode (the base types of one scan mode share one code
# path: their parsing is tested below), the xv family's bases and tags, m0's
# out-norm and _oact; 8 x 8 maps give the unidi / bidi / N=16 cross2d cores
# an nk group (kernels 2/7's plain twins), 6 x 7 maps send them to 13/14's
CASES = [
    ("v0", 16, 3, (8, 8)),                  # vanilla VMamba: SiLU z-gate, LN
    ("v0seq_onnone_nozact", 4, 3, (6, 7)),
    ("v01_ondwconv3_no32", 4, 2, (6, 7)),
    ("v02_oncnorm", 4, 4, (6, 7)),
    ("v03_onsoftmax", 4, 1, (6, 7)),
    ("v04_onsigmoid_oact", 4, 3, (6, 7)),
    ("v2", 1, 3, (6, 7)),                   # the z-gate over kernels 11/12's twins
    ("v051d_noz", 4, 3, (8, 8)),
    ("v051d_noz", 1, 3, (6, 7)),            # d_state 1: the unidi scan, not cross2d
    ("v052d_noz", 16, 4, (8, 8)),
    ("v052d_noz", 1, 3, (6, 7)),            # d_state 1: the bidi scan, not cross2d
    ("v052dc", 4, 3, (5, 6)),
    ("xv1a_mul_act_ca", 4, 3, (6, 7)),
    ("xv2a_oncnorm_ca1_ocov", 4, 4, (6, 7)),
    ("xv2a_ocov2", 16, 3, (5, 6)),
    ("xv3a_onsigmoid_cpos", 4, 2, (6, 7)),
    ("xv3a_mul", 4, 1, (6, 7)),
    ("m0_onsoftmax_noz_oact", 8, 2, (6, 7)),
]


def _pair(forward_type, d_state, d_conv, seed=0):
    """The JAX layer, its variables and the port layer loaded with them (a
    bare SS2D loads as a block's ``op``)."""
    kw = dict(ssm_ratio=1.0, initialize="v2") if forward_type.startswith("m0") else {}
    jmodel = jax_ss2d.SS2D(d_model=D_MODEL, d_state=d_state, d_conv=d_conv,
                           forward_type=forward_type, **kw)
    variables = jax_variables(jmodel, seed, jnp.zeros((1, 6, 6, D_MODEL)))
    port = SS2D(D_MODEL, d_state=d_state, d_conv=d_conv, forward_type=forward_type, **kw)
    holder = torch.nn.Module()
    holder.op = port
    load_jax_variables(holder, {"params": {"op": variables["params"]}})
    return jmodel, variables, holder


@pytest.mark.parametrize("forward_type,d_state,d_conv,hw", CASES,
                         ids=[f"{c[0]}-N{c[1]}-conv{c[2]}" for c in CASES])
def test_ss2d_matches_jax(forward_type, d_state, d_conv, hw, jax_cascade):
    """The layer on 2 images of ``hw``: output, input gradient and every
    parameter gradient against ``jax.vjp`` of the JAX layer (1e-5 / 1e-4).
    ``load_jax_variables`` would raise on a parameter that one side has and
    the other lacks (xv's missing x_proj_weight, xv2a's dt_projs_weight);
    ``export_jax_variables`` gives the JAX tree back bit for bit."""
    jmodel, variables, holder = _pair(forward_type, d_state, d_conv)
    exported = export_jax_variables(holder)["params"]["op"]
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables["params"]):
        np.testing.assert_array_equal(_leaf(exported, [k.key for k in path]), leaf)
    rng = np.random.default_rng(d_state + d_conv)
    x = rng.standard_normal((2, *hw, D_MODEL)).astype(np.float32)
    gy = rng.standard_normal((2, *hw, D_MODEL)).astype(np.float32)
    y_ref, vjp = jax.vjp(jax.jit(lambda v, x: jmodel.apply({"params": v}, x)),
                         variables["params"], jnp.asarray(x))
    dparams, dx = vjp(jnp.asarray(gy))
    xt = T(x).requires_grad_()
    y = holder.op(xt)
    y.backward(T(gy))
    assert _rel(y, y_ref) <= 1e-5 and _rel(xt.grad, dx) <= 1e-4
    params = dict(holder.named_parameters())
    for key, (jpath, to_port, _) in jax_paths(holder).items():
        want = to_port(np.asarray(_leaf({"params": {"op": dparams}}, jpath)))
        assert _rel(params[key].grad, want) <= 1e-4, key


@pytest.mark.parametrize("forward_type", ["v051d_noz", "v052d_noz"])
def test_d_state_1_keeps_its_scan_mode(forward_type, monkeypatch):
    """A d_state-1 unidi or bidi layer takes `core_dispatch` with its own
    scan mode, never the cross2d core of kernels 11/12; its output differs
    from the same weights' cross2d layer (v05_noz) by more than 1 %."""
    def refuse(*args, **kw):
        raise AssertionError("the cross2d core ran")

    g = torch.Generator().manual_seed(0)
    layer = SS2D(D_MODEL, d_state=1, forward_type=forward_type, generator=g)
    with torch.no_grad():   # B and C large enough for the scans to show
        layer.x_proj_weight.normal_(generator=g)
    cross = SS2D(D_MODEL, d_state=1, forward_type="v05_noz")
    cross.load_state_dict(layer.state_dict())
    x = torch.randn(2, 8, 8, D_MODEL, generator=g)
    with torch.no_grad():
        want = cross(x)
        monkeypatch.setattr(ss2d, "ss2d_core_n1", refuse)
        got = layer(x)
    assert _rel(got, want.numpy()) > 1e-2


def test_m0_leftovers_name_their_item():
    """m0 with its z-gate and with a carried initial state stay refused,
    naming queue item 2.2."""
    for kw in (dict(forward_type="m0"), dict(forward_type="m0_oact"),
               dict(forward_type="m0_noz", with_initial_state=True)):
        with pytest.raises(ValueError, match="item 2.2"):
            SS2D(16, d_state=8, ssm_ratio=1.0, **kw)


@pytest.mark.parametrize("initialize", ["v1", "v2"])
def test_simple_init(initialize):
    """``ssm_init`` v1 / v2 (``simple_init``): Ds ones; v1 A_logs ~ N(0, 1)
    and the dt projection ~ 0.1 N(0, 1); v2 A_logs zero and the dt
    projection in [0, 0.1)."""
    op = SS2D(64, d_state=16, forward_type="v2", initialize=initialize,
              generator=torch.Generator().manual_seed(0))
    assert torch.equal(op.Ds, torch.ones_like(op.Ds))
    w, b, a = op.dt_projs_weight.detach(), op.dt_projs_bias.detach(), op.A_logs.detach()
    if initialize == "v1":
        assert abs(float(a.std()) - 1) < 0.05 and abs(float(w.std()) - 0.1) < 0.01
        assert abs(float(b.std()) - 0.1) < 0.01
    else:
        assert not a.any()
        for t in (w, b):
            assert 0 <= float(t.min()) and float(t.max()) < 0.1 and float(t.mean()) > 0.04


# ---------------------------------------------------------------------------
# the parsers
# ---------------------------------------------------------------------------

def _parsed(fn, *args):
    try:
        return dataclasses.asdict(fn(*args))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("forward_type", [
    "v0", "v0seq", "v01", "v02_no32", "v03", "v04", "v05", "v05_noz", "v051d", "v052d_noz",
    "v052dc", "v2", "v3", "m0", "m0_noz", "v05_oact_noz_no32", "v05_noz_oact", "v2_nozact",
    "v2_onnone", "v2_ondwconv3_noz", "v3_oncnorm_nozact", "v05_onsoftmax", "v05_onsigmoid",
    "v05_onsigmoid_onnone", "v05_noz_onnone", "v4", "xv1a", "", "_noz", "v0_noz_nozact"])
def test_parse_forward_type_matches_jax(forward_type):
    assert _parsed(ss2d.parse_forward_type, forward_type) == \
        _parsed(jax_ss2d.parse_forward_type, forward_type)


@pytest.mark.parametrize("with_dconv", [True, False])
@pytest.mark.parametrize("forward_type", [
    "xv1a", "xv2a", "xv3a", "xv1a_mul", "xv2a_act", "xv3a_mul_act", "xv1a_ca", "xv1a_ca1",
    "xv2a_ocov", "xv2a_ocov2", "xv3a_cpos", "xv1a_cpos_ca", "xv2a_ocov_ca1_mul_onnone",
    "xv1a_oncnorm", "xv3a_onsoftmax_act", "xv1abc", "xv4a", "v05_noz", "xv1"])
def test_parse_xv_type_matches_jax(forward_type, with_dconv):
    assert _parsed(ss2d.parse_xv_type, forward_type, with_dconv) == \
        _parsed(jax_ss2d.parse_xv_type, forward_type, with_dconv)


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scans", [0, 1, 2])
def test_one_by_one_cross_scans_match_jax(scans):
    rng = np.random.default_rng(scans)
    xs = rng.standard_normal((2, 4, 5, 3, 6)).astype(np.float32)
    ys = rng.standard_normal((2, 4, 15, 6)).astype(np.float32)
    np.testing.assert_array_equal(cross_scan.cross_scan_1b1(T(xs), scans).numpy(),
                                  np.asarray(jax_cs.cross_scan_1b1(jnp.asarray(xs), scans)))
    np.testing.assert_array_equal(cross_scan.cross_merge_1b1(T(ys), 5, 3, scans).numpy(),
                                  np.asarray(jax_cs.cross_merge_1b1(jnp.asarray(ys), 5, 3, scans)))


@pytest.mark.parametrize("scans", [0, 1, 2])
def test_directional_scan_2d_matches_jax(scans):
    """A callee that tags each direction and scans (a running sum) in the
    order and direction it is told, on whole numbers: the merges of both
    agree bit for bit."""
    H, W = 4, 5
    rng = np.random.default_rng(10 + scans)
    inputs = [rng.integers(-9, 10, (2, H * W, 3)).astype(np.float32) for _ in range(4)]

    def port_fn(k, x, transposed, reverse):
        x = torch.as_tensor(x) * (k + 1)
        if transposed:
            x = x.reshape(2, H, W, 3).transpose(1, 2).reshape(2, H * W, 3)
        return x.flip(1).cumsum(1).flip(1) if reverse else x.cumsum(1)

    def jax_fn(k, x, transposed, reverse):
        x = jnp.asarray(x) * (k + 1)
        if transposed:
            x = jnp.swapaxes(x.reshape(2, H, W, 3), 1, 2).reshape(2, H * W, 3)
        return jnp.cumsum(x[:, ::-1], 1)[:, ::-1] if reverse else jnp.cumsum(x, 1)

    got = cross_scan.directional_scan_2d(port_fn, H, W, inputs, scans)
    want = jax_cs.directional_scan_2d(jax_fn, H, W, inputs, scans)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _scan_operands(seed, B=2, L=37, K=2, C=3, N=4):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(u=f(B, L, K * C), delta=f(B, L, K * C) - 1, A=-np.exp(0.3 * f(K * C, N)),
                Bmat=f(B, L, K, N), Cmat=f(B, L, K, N), D=f(K * C), delta_bias=0.1 * f(K * C))


@pytest.mark.parametrize("reverse", [False, True])
def test_selective_scan_matches_jax(reverse):
    """The log-step scan against JAX's associative scan, forward and
    ``jax.vjp`` (1e-5 / 1e-4), and against the port's sequential oracle."""
    ops = _scan_operands(int(reverse))
    gy = np.random.default_rng(7).standard_normal(ops["u"].shape).astype(np.float32)
    y_ref, vjp = jax.vjp(lambda *a: jax_ss.selective_scan(*a, reverse=reverse),
                         *map(jnp.asarray, ops.values()))
    grads_ref = vjp(jnp.asarray(gy))
    args = [T(v).requires_grad_() for v in ops.values()]
    y = selective_scan.selective_scan(*args, reverse=reverse)
    y.backward(T(gy))
    assert _rel(y, y_ref) <= 1e-5
    for name, a, want in zip(ops, args, grads_ref):
        assert _rel(a.grad, want) <= 1e-4, name
    seq = selective_scan.selective_scan_seq(*map(T, ops.values()), reverse=reverse)
    assert _rel(y, seq.numpy()) <= 1e-5


def test_selective_scan_torch_layout_matches_jax():
    ops = _scan_operands(3)
    layout = dict(u=ops["u"].transpose(0, 2, 1), delta=ops["delta"].transpose(0, 2, 1),
                  A=ops["A"], Bmat=ops["Bmat"].transpose(0, 2, 3, 1),
                  Cmat=ops["Cmat"].transpose(0, 2, 3, 1), D=ops["D"],
                  delta_bias=ops["delta_bias"])
    got = selective_scan.selective_scan_torch_layout(*map(T, layout.values()))
    want = jax_ss.selective_scan_torch_layout(*map(jnp.asarray, layout.values()))
    assert got.shape == (2, 6, 37) and _rel(got, want) <= 1e-5


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

def _flax(module, x, seed):
    variables = jax_variables(module, seed, jnp.asarray(x[:1]))
    return variables, np.asarray(module.apply(variables, jnp.asarray(x)))


@pytest.mark.parametrize("hw", [(7, 5), (6, 6)])
def test_patch_merging_matches_jax(hw):
    """PatchMerging2D, an odd map padded at its bottom and right."""
    x = np.random.default_rng(0).standard_normal((2, *hw, 8)).astype(np.float32)
    variables, want = _flax(JaxPatchMerging2D(out_dim=12), x, 1)
    port = layers.PatchMerging2D(8, 12)
    load_jax_variables(port, variables)
    assert tuple(port.state_dict()) == ("norm.weight", "norm.bias", "reduction.weight")
    got = port(T(x))
    assert got.shape == (2, -(-hw[0] // 2), -(-hw[1] // 2), 12) and _rel(got, want) <= 1e-5


@pytest.mark.parametrize("k", [2, 3, 4, 5])
def test_conv_same_matches_flax(k):
    """A depthwise k x k conv with flax's "SAME" padding on a 6 x 7 map: an
    even kernel pads (k - 1) // 2 before and k // 2 after."""
    x = np.random.default_rng(k).standard_normal((2, 6, 7, 4)).astype(np.float32)
    variables, want = _flax(JaxConv2dSame(4, (k, k), feature_group_count=4), x, k)
    port = layers.Conv2dSame(4, 4, k, padding="same", groups=4)
    holder = torch.nn.Module()
    holder.c = port
    load_jax_variables(holder, {"params": {"c": variables["params"]}})
    got = port(T(x))
    assert got.shape == (2, 6, 7, 4) and _rel(got, want) <= 1e-5


def test_softmax_spatial_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 3, 5, 4)).astype(np.float32)
    assert _rel(layers.softmax_spatial(T(x)), jax_softmax_spatial(jnp.asarray(x))) <= 1e-6

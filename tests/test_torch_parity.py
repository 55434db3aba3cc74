"""The PyTorch port against the JAX package on the CPU, float32: each module
that holds a CUDA kernel (run here through its plain version, which the
wrapper takes for CPU tensors) and the whole two-view model.

JAX parameters are made with ``jax.eval_shape(model.init, ...)`` and filled
from a numpy generator, then loaded into the port with
``load_jax_variables``; inputs are numpy arrays handed to both sides.
Tolerances are for float32 with different summation orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xfmamba_tpu.checkpoint.convert import (
    convert_xfmamba_state_dict, verify_tree_matches)
from xfmamba_tpu.models.fusion import FusionBlock as JaxFusionBlock
from xfmamba_tpu.models.fusion import ShallowFusionBlock as JaxShallowFusionBlock
from xfmamba_tpu.models.ss2d import ss2d_core_from_projs as jax_core
from xfmamba_tpu.models.tops import TwoViewXFMamba as JaxTwoView
from xfmamba_tpu.models.vssm import VSSBlock as JaxVSSBlock
from xfmamba_tpu.ops.vss_block_pallas import vss_block_ref as jax_vss_block_ref
from xfmamba_tpu_torch.checkpoint.convert import load_jax_variables
from xfmamba_tpu_torch.models.tops import TwoViewXFMamba
from xfmamba_tpu_torch.models import vssm
from xfmamba_tpu_torch.models.vssm import VSSBlock
from xfmamba_tpu_torch.ops import nk_scan, vss_stage
from xfmamba_tpu_torch.ops.vss_block import pack_vss_block_params
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

T = torch.from_numpy
TINY = dict(model_type="tiny", hidden_dim=128, d_state=4,
            backbone_overrides=dict(depths=(2, 2, 2, 2), dims=16))


def _fill(leaf_path, shape_dtype, rng):
    """A float32 value for one JAX parameter, at a scale that keeps
    activations O(1)."""
    return np.asarray(_draw(leaf_path[-1].key, shape_dtype.shape, rng), np.float32)


def _draw(name, shape, rng):
    n = rng.standard_normal(shape).astype(np.float32)
    if name == "kernel":
        return n / np.sqrt(np.prod(shape[:-1]))
    if name in ("scale", "Ds"):
        return 1 + 0.1 * n
    if name == "var":
        return 1 + 0.1 * np.abs(n)
    if name == "A_logs":
        return np.log(np.arange(1, shape[1] + 1, dtype=np.float32)) + 0.1 * n
    if name == "dt_projs_bias":
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), shape))
        return (dt + np.log(-np.expm1(-dt))).astype(np.float32)
    if name == "dt_projs_weight":
        return rng.uniform(-1, 1, shape).astype(np.float32) / np.sqrt(shape[-1])
    if name == "x_proj_weight":
        return n / np.sqrt(shape[-1])
    return 0.1 * n


def jax_variables(module, seed, *inputs):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map_with_path(lambda p, s: _fill(p, s, rng), shapes)
    return {k: v for k, v in tree.items() if k in ("params", "batch_stats")}


def assert_close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


@pytest.fixture(params=["block", "stage"])
def route(request, monkeypatch):
    """The backbone route a float32 model takes: "block", its own (the
    composable VSSBlock with kernels 11 and 12), or "stage", the bfloat16
    route's kernels (1, 4-6) run in float32."""
    monkeypatch.setattr(vssm, "_uses_stage_route", lambda dtype: request.param == "stage")
    return request.param


# ---------------------------------------------------------------------------
# kernel 1: the VSS stage
# ---------------------------------------------------------------------------

def _blocks(conv_bias, depth=2, d=16, H=8, W=8, seed=0):
    jblock = JaxVSSBlock(hidden_dim=d, ssm_d_state=1, ssm_ratio=2.0,
                         ssm_conv_bias=conv_bias, forward_type="v05_noz",
                         mlp_ratio=4.0)
    x = jnp.zeros((1, H, W, d))
    params = [jax_variables(jblock, seed + j, x)["params"] for j in range(depth)]
    ports = []
    for p in params:
        blk = VSSBlock(d, ssm_d_state=1, ssm_ratio=2.0, ssm_conv_bias=conv_bias).eval()
        load_jax_variables(blk, {"params": p})
        ports.append(blk)
    return jblock, params, ports


@pytest.mark.parametrize("conv_bias", [False, True])
def test_vss_stage_matches_jax_block_ref(conv_bias):
    B, H, W, d = 2, 8, 8, 16
    _, params, ports = _blocks(conv_bias)
    x = np.random.default_rng(10).standard_normal((B, H * W, d)).astype(np.float32)
    want = jnp.asarray(x)
    block_ref = jax.jit(jax_vss_block_ref, static_argnums=(2, 3, 4, 5))
    for p in params:
        want = block_ref(want, p, H, W, conv_bias, True)
    packed = [pack_vss_block_params(b, torch.float32) for b in ports]
    got = vss_stage.vss_stage(T(x), packed, H, W)
    assert_close(got, want, 5e-5)


def test_vss_block_module_matches_flax():
    """The composable port VSSBlock (SS2D module path) vs the flax block."""
    jblock, params, ports = _blocks(False, depth=1, seed=5)
    x = np.random.default_rng(11).standard_normal((2, 8, 8, 16)).astype(np.float32)
    want = jax.jit(jblock.apply)({"params": params[0]}, jnp.asarray(x))
    with torch.no_grad():
        got = ports[0](T(x))
    assert_close(got, want, 5e-5)


# ---------------------------------------------------------------------------
# kernels 2 and 3: the nk scans
# ---------------------------------------------------------------------------

def _projs(seed, B=2, H=4, W=8, D=16, K=4, N=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, W, D), np.float32),
            0.3 * rng.standard_normal((B, H, W, K, D), np.float32),
            rng.standard_normal((B, H, W, K, N), np.float32),
            rng.standard_normal((B, H, W, K, N), np.float32),
            -np.exp(0.5 * rng.standard_normal((K, D, N), np.float32)),
            rng.standard_normal((K, D), np.float32),
            0.1 * rng.standard_normal((K, D), np.float32))


@pytest.mark.parametrize("scan_mode", ["cross2d", "unidi", "bidi"])
def test_nk_scan_matches_composable(scan_mode):
    x, dts, Bs, Cs, A, Dmat, bias = args = _projs(3)
    B, H, W, D, K, N = *x.shape, 4, 4
    L = H * W
    want = jax.jit(jax_core, static_argnames="scan_mode")(
        *map(jnp.asarray, args), scan_mode=scan_mode)
    got = nk_scan.nk_scan(
        T(x.reshape(B, L, D)), T(dts.reshape(B, L, K * D)),
        T(Bs.reshape(B, L, K * N)), T(Cs.reshape(B, L, K * N)),
        T(A.transpose(0, 2, 1).reshape(K * N, D)), T(Dmat), T(bias), H, W,
        nk_scan.scan_mode_kinds(scan_mode))
    assert_close(got.reshape(B, H, W, D), want, 2e-4)


def test_nk_scan_shallowfuse_pattern():
    """K=1 row_f calls, one per group, against the grouped JAX scan."""
    from xfmamba_tpu.ops.selective_scan import selective_scan
    rng = np.random.default_rng(4)
    B, H, W, di, N, K = 2, 4, 8, 12, 4, 2
    L = H * W
    u = rng.standard_normal((B, L, K * di), np.float32)
    dts = 0.3 * rng.standard_normal((B, L, K * di), np.float32)
    Bs = rng.standard_normal((B, L, K, N), np.float32)
    Cs = rng.standard_normal((B, L, K, N), np.float32)
    A2 = -np.exp(0.5 * rng.standard_normal((K * di, N), np.float32))
    Ds = rng.standard_normal((K * di,), np.float32)
    bias = 0.1 * rng.standard_normal((K, di), np.float32)
    want = jax.jit(selective_scan, static_argnames="delta_softplus")(
        *map(jnp.asarray, (u, dts, A2, Bs, Cs, Ds, bias.reshape(-1))),
        delta_softplus=True)
    got = torch.cat([nk_scan.nk_scan(
        T(u[..., k * di:(k + 1) * di].copy()), T(dts[..., k * di:(k + 1) * di].copy()),
        T(Bs[:, :, k].copy()), T(Cs[:, :, k].copy()),
        T(A2[k * di:(k + 1) * di].T.copy()), T(Ds[k * di:(k + 1) * di].reshape(1, -1)),
        T(bias[k:k + 1]), H, W, ("row_f",)) for k in range(K)], -1)
    assert_close(got, want, 2e-4)


@pytest.mark.parametrize("scan_mode", ["cross2d", "unidi", "bidi"])
def test_nk_scan_x_rank_form_matches_composable(scan_mode):
    """Rank form + LayerNorm epilogue vs the composable JAX path followed by
    the same LayerNorm (bidi included: the JAX rank-form kernel has no
    test of its own for it)."""
    x, _, Bs, Cs, A, Dmat, bias = _projs(5)
    B, H, W, D, K, N, R = *x.shape, 4, 4, 6
    L = H * W
    rng = np.random.default_rng(77)
    ranks = 0.3 * rng.standard_normal((B, H, W, K, R), np.float32)
    w_dt = 0.2 * rng.standard_normal((K, D, R), np.float32)
    scale = 1 + 0.1 * rng.standard_normal(D).astype(np.float32)
    shift = 0.1 * rng.standard_normal(D).astype(np.float32)
    dts = jnp.einsum("bhwkr,kdr->bhwkd", ranks, w_dt)
    y = jax.jit(jax_core, static_argnames="scan_mode")(jnp.asarray(x), dts, *map(jnp.asarray, (Bs, Cs, A, Dmat, bias)),
                 scan_mode=scan_mode)
    mu = y.mean(-1, keepdims=True)
    var = ((y - mu) ** 2).mean(-1, keepdims=True)
    want = (y - mu) * jax.lax.rsqrt(var + 1e-5) * scale + shift
    got = nk_scan.nk_scan_x(
        T(x.reshape(B, L, D)), T(ranks.reshape(B, L, K * R)),
        T(Bs.reshape(B, L, K * N)), T(Cs.reshape(B, L, K * N)),
        T(w_dt.transpose(0, 2, 1).reshape(K * R, D)),
        T(A.transpose(0, 2, 1).reshape(K * N, D)), T(Dmat), T(bias),
        T(np.stack([scale, shift])), H, W, nk_scan.scan_mode_kinds(scan_mode))
    assert_close(got.reshape(B, H, W, D), want, 3e-4)


# ---------------------------------------------------------------------------
# the fusion blocks and the whole slice
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_models():
    jmodel = JaxTwoView(**TINY)
    x = jnp.zeros((2, 32, 32, 1))
    variables = jax_variables(jmodel, 0, x, x)
    port = TwoViewXFMamba(**TINY).eval()
    load_jax_variables(port, variables)
    return jmodel, variables, port


def test_two_view_logits_match_jax(tiny_models, route):
    jmodel, variables, port = tiny_models
    rng = np.random.default_rng(1)
    xa, xb = (rng.standard_normal((2, 32, 32, 1)).astype(np.float32) for _ in range(2))
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(xa), jnp.asarray(xb))
    with torch.no_grad():
        got = port(T(xa), T(xb))
    assert got.shape == (2, 2)
    assert_close(got, want, 1e-4)


@pytest.mark.parametrize("which", ["shallow", "cssf"])
def test_fusion_blocks_match_jax(tiny_models, which):
    _, variables, port = tiny_models
    P = variables["params"]
    rng = np.random.default_rng(2)
    z1, z2 = (rng.standard_normal((2, 3, 5, 128)).astype(np.float32) for _ in range(2))
    if which == "shallow":
        jax_out = jax.jit(JaxShallowFusionBlock(hidden_dim=128, d_state=4).apply)(
            {"params": P["shallow_mamba_fusion"],
             "batch_stats": variables["batch_stats"]["shallow_mamba_fusion"]},
            jnp.asarray(z1), jnp.asarray(z2))
        module = port.shallow_mamba_fusion
    else:
        jax_out = (jax.jit(JaxFusionBlock(hidden_dim=128, d_state=4).apply)(
            {"params": P["fusemamba"]["block0"]}, jnp.asarray(z1), jnp.asarray(z2)),)
        module = port.fusemamba.blocks[0]
    with torch.no_grad():
        got = module(T(z1), T(z2))
    for g, w in zip(got if isinstance(got, tuple) else (got,), jax_out):
        assert_close(g, w, 1e-4)


def test_state_dict_round_trip_through_reference_converter(tiny_models):
    """port state_dict -> the JAX package's .pth converter -> the same tree
    the port was loaded from, name for name and value for value."""
    _, variables, port = tiny_models
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    conv = convert_xfmamba_state_dict(sd)
    for coll in ("params", "batch_stats"):
        verify_tree_matches(conv[coll], variables[coll])
        got = jax.tree_util.tree_leaves_with_path(conv[coll])
        want = dict(jax.tree_util.tree_leaves_with_path(variables[coll]))
        for path, value in got:
            np.testing.assert_array_equal(value, want[path], err_msg=str(path))


def test_load_jax_variables_rejects_mismatches(tiny_models):
    _, variables, _ = tiny_models
    port = TwoViewXFMamba(**TINY).eval()
    params = jax.tree_util.tree_map(lambda a: a, variables["params"])
    params["final_conv"]["conv"]["kernel"] = params["final_conv"]["conv"]["kernel"][..., :3]
    with pytest.raises(ValueError, match="misshapen"):
        load_jax_variables(port, {"params": params, "batch_stats": variables["batch_stats"]})
    params = jax.tree_util.tree_map(lambda a: a, variables["params"])
    del params["classifier_head"]
    params["extra_head"] = {"kernel": np.zeros((128, 2), np.float32)}
    with pytest.raises(ValueError, match="classifier.head.weight"):
        load_jax_variables(port, {"params": params, "batch_stats": variables["batch_stats"]})

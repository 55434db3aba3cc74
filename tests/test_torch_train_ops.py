"""The port's training kernels (plain versions, CPU, float32) against the
JAX package's gradients: the shared adjoint scan, kernel 7 (the fusion
scans' backward), kernel 6 (a VSSBlock's SS2D-half backward) and kernel 5
(a stage's training forward and its backward).

The oracle is ``jax.vjp`` / ``jax.grad`` of the JAX package's composable
functions on the CPU.  Inputs and weights are numpy arrays from fixed seeds
handed to both sides; block gradients are compared at the parameters of
the port module, reached through the differentiable packing
(``pack_vss_block_train_params``) and mapped to the JAX tree with
``checkpoint.convert.jax_paths``.  Tolerances are for float32 with other
summation orders.  The ``slow`` tests hold the same plain versions against
the JAX Pallas kernels themselves, run in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import _blocks, assert_close
from xfmamba_tpu.models.ss2d import ss2d_core_from_projs as jax_core
from xfmamba_tpu.ops.selective_scan import selective_scan as jax_scan
from xfmamba_tpu.ops.vss_block_pallas import vss_block_ref as jax_vss_block_ref
from xfmamba_tpu_torch.checkpoint.convert import jax_paths
from xfmamba_tpu_torch.ops import nk_scan
from xfmamba_tpu_torch.ops.nk_scan_adjoint import nk_scan_train, nk_scan_train_from_projs
from xfmamba_tpu_torch.ops.vss_block import (
    SS2D_FIELDS, pack_vss_block_train_params)
from xfmamba_tpu_torch.ops.vss_block_train import vss_block_bwd_plain, vss_block_train_op
from xfmamba_tpu_torch.ops.vss_stage_train import vss_stage_train, vss_stage_train_forward
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

T = torch.from_numpy
NAMES = ("x", "dts", "Bs", "Cs", "A", "Dmat", "bias")


def _projs(seed, B=2, H=3, W=4, D=6, K=4, N=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, W, D), np.float32),
            0.3 * rng.standard_normal((B, H, W, K, D), np.float32),
            rng.standard_normal((B, H, W, K, N), np.float32),
            rng.standard_normal((B, H, W, K, N), np.float32),
            -np.exp(0.5 * rng.standard_normal((K, D, N), np.float32)),
            rng.standard_normal((K, D), np.float32),
            0.1 * rng.standard_normal((K, D), np.float32))


def _jax_core_grads(args, wy, scan_mode):
    def loss(*a):
        return jnp.sum(jax_core(*a, scan_mode=scan_mode, scan_impl=jax_scan) * wy)
    return jax.jit(jax.grad(loss, argnums=tuple(range(7))))(*map(jnp.asarray, args))


# ---------------------------------------------------------------------------
# the shared adjoint scan and kernel 7
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scan_mode", ["cross2d", "unidi", "bidi"])
def test_scan_adjoint_plain_matches_jax_grads(scan_mode):
    """`selective_scan_bwd_plain` against jax.grad of ss2d_core_from_projs;
    float32, 2e-4 (sums over positions and states in other orders)."""
    x, dts, Bs, Cs, A, Dmat, bias = args = _projs(1)
    B, H, W, D = x.shape
    K, N, L = 4, 3, H * W
    wy = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    want = _jax_core_grads(args, wy, scan_mode)
    g = nk_scan.selective_scan_bwd_plain(
        T(x).reshape(B, L, D), T(Bs).reshape(B, L, K, N), T(Cs).reshape(B, L, K, N),
        T(A).transpose(1, 2), T(bias), T(Dmat).sum(0), nk_scan.scan_mode_kinds(scan_mode),
        H, W, T(wy).reshape(B, L, D), dts=T(dts).reshape(B, L, K, D))
    got = (g["du"], g["dz"], g["dB"], g["dC"], g["dA"].transpose(1, 2),
           g["dDsum"].expand(K, D), g["dbias"])
    for name, a, w in zip(NAMES, got, want):
        assert_close(a.reshape(w.shape), w, 2e-4)


def test_scan_adjoint_rank_form_matches_autograd():
    """Rank form: the adjoint's dz, mapped through the rank projection,
    against autograd of `selective_scan_plain` with respect to ranks and
    w_dt (the form the block backward uses); float32, 2e-5."""
    rng = np.random.default_rng(3)
    n, H, W, D, K, N, R = 2, 3, 5, 6, 4, 1, 2
    L = H * W
    u, Bs, Cs, ranks = (T(rng.standard_normal(s).astype(np.float32)) for s in
                        [(n, L, D), (n, L, K, N), (n, L, K, N), (n, L, K, R)])
    w_dt = T(0.5 * rng.standard_normal((K, R, D)).astype(np.float32))
    A = T(-np.exp(0.3 * rng.standard_normal((K, N, D))).astype(np.float32))
    bias, Dsum = T(0.1 * rng.standard_normal((K, D)).astype(np.float32)), torch.ones(D)
    gy = T(rng.standard_normal((n, L, D)).astype(np.float32))
    kinds = nk_scan.CROSS2D_KINDS
    leaves = [t.clone().requires_grad_() for t in (u, Bs, Cs, ranks, w_dt, A, bias)]
    y = nk_scan.selective_scan_plain(leaves[0], leaves[1], leaves[2], leaves[5], leaves[6],
                                     Dsum, kinds, H, W, ranks=leaves[3], w_dt=leaves[4])
    want = torch.autograd.grad(y, leaves, gy)
    g = nk_scan.selective_scan_bwd_plain(u, Bs, Cs, A, bias, Dsum, kinds, H, W, gy,
                                         ranks=ranks, w_dt=w_dt)
    got = (g["du"], g["dB"], g["dC"], torch.einsum("nlkd,krd->nlkr", g["dz"], w_dt),
           torch.einsum("nlkr,nlkd->krd", ranks, g["dz"]), g["dA"], g["dbias"])
    for a, w in zip(got, want):
        assert_close(a, w, 2e-5)


@pytest.mark.parametrize("scan_mode", ["cross2d", "unidi", "bidi"])
def test_nk_scan_train_matches_composable_grads(scan_mode):
    """Kernel 7 (plain) through `NKScanTrain` against jax.grad of the
    composable path, every input; float32, 2e-4."""
    args = _projs(4)
    wy = np.random.default_rng(5).standard_normal(args[0].shape).astype(np.float32)
    want = _jax_core_grads(args, wy, scan_mode)
    leaves = [T(a).requires_grad_() for a in args]
    y = nk_scan_train_from_projs(*leaves, scan_mode=scan_mode)
    y.backward(T(wy))
    for name, leaf, w in zip(NAMES, leaves, want):
        assert_close(leaf.grad, w, 2e-4)


def test_nk_scan_train_shallowfuse_pattern():
    """The ShallowFuse form: one K=1 row_f call per group, against jax.grad
    of the grouped JAX scan over both groups; float32, 2e-4."""
    rng = np.random.default_rng(6)
    B, H, W, di, N, K = 2, 3, 4, 5, 3, 2
    L = H * W
    u = rng.standard_normal((B, L, K * di), np.float32)
    dts = 0.3 * rng.standard_normal((B, L, K * di), np.float32)
    Bs = rng.standard_normal((B, L, K, N), np.float32)
    Cs = rng.standard_normal((B, L, K, N), np.float32)
    A2 = -np.exp(0.5 * rng.standard_normal((K * di, N), np.float32))
    Ds = rng.standard_normal((K * di,), np.float32)
    bias = 0.1 * rng.standard_normal((K * di,), np.float32)
    wy = rng.standard_normal((B, L, K * di), np.float32)
    args = (u, dts, A2, Bs, Cs, Ds, bias)

    def loss(*a):
        return jnp.sum(jax_scan(*a, delta_softplus=True) * wy)
    want = jax.jit(jax.grad(loss, argnums=tuple(range(7))))(*map(jnp.asarray, args))
    lu, ldts, lA2, lB, lC, lD, lb = leaves = [T(a).requires_grad_() for a in args]
    ys = []
    for k in range(K):
        sl = slice(k * di, (k + 1) * di)
        ys.append(nk_scan_train(lu[..., sl].contiguous(), ldts[..., sl].contiguous(),
                                lB[:, :, k].contiguous(), lC[:, :, k].contiguous(),
                                lA2[sl].t(), lD[sl].reshape(1, -1), lb[sl].reshape(1, -1),
                                H, W, ("row_f",)))
    torch.cat(ys, -1).backward(T(wy))
    for leaf, w in zip(leaves, want):
        assert_close(leaf.grad, w, 2e-4)


# ---------------------------------------------------------------------------
# kernel 6: the SS2D half's backward
# ---------------------------------------------------------------------------

def _jax_grads_at_port(block, jgrads_tree, skip=()):
    """{port parameter name: JAX gradient in the port's layout}."""
    flat = {}
    for key, (jpath, to_port, _) in jax_paths(block).items():
        if jpath[0] != "params" or key.startswith(skip):
            continue
        node = jgrads_tree
        for name in jpath[1:]:
            node = node[name]
        flat[key] = to_port(np.asarray(node))
    return flat


@pytest.mark.parametrize("conv_bias", [False, True])
def test_block_backward_matches_jax_vjp(conv_bias):
    """Kernel 6 (plain, masks 1) against jax.vjp of vss_block_ref without
    the MLP, with respect to x and every SS2D-half parameter, through the
    differentiable packing; float32, 3e-4."""
    B, H, W, d = 2, 4, 5, 16
    _, params, ports = _blocks(conv_bias, depth=1, d=d, H=H, W=W, seed=3)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, H * W, d)).astype(np.float32)
    g = rng.standard_normal((B, H * W, d)).astype(np.float32)
    f = jax.jit(lambda xx, pp: jax_vss_block_ref(xx, pp, H, W, conv_bias, False))
    y_ref, vjp = jax.vjp(f, jnp.asarray(x), params[0])
    dx_ref, dp_ref = vjp(jnp.asarray(g))
    blk = ports[0]
    p = pack_vss_block_train_params(blk, torch.float32)
    dx, grads = vss_block_bwd_plain(T(x), p, H, W, None, T(g))
    torch.autograd.backward([getattr(p, n) for n in SS2D_FIELDS if getattr(p, n) is not None],
                            [grads[n] for n in SS2D_FIELDS if getattr(p, n) is not None])
    assert_close(dx, dx_ref, 3e-4)
    want = _jax_grads_at_port(blk, dp_ref, skip=("norm2", "mlp"))
    assert len(want) == (13 if conv_bias else 12)
    for key, w in want.items():
        assert_close(blk.get_parameter(key).grad, w, 3e-4)


def test_block_train_op_matches_jax_vjp_with_mask():
    """`VSSBlockTrain` (kernel 4 forward, kernel 6 backward; plain) with a
    drop-path scale against jax.vjp of vss_block_ref with that mask;
    float32, 3e-4."""
    B, H, W, d = 3, 4, 4, 16
    _, params, ports = _blocks(False, depth=1, d=d, H=H, W=W, seed=8)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, H * W, d)).astype(np.float32)
    g = rng.standard_normal((B, H * W, d)).astype(np.float32)
    m1 = np.array([1 / 0.7, 0.0, 1 / 0.7], np.float32)
    m1_j = jnp.broadcast_to(jnp.asarray(m1)[:, None, None], (B, H * W, 1))
    f = jax.jit(lambda xx, pp: jax_vss_block_ref(xx, pp, H, W, False, False, m1=m1_j))
    y_ref, vjp = jax.vjp(f, jnp.asarray(x), params[0])
    dx_ref, dp_ref = vjp(jnp.asarray(g))
    blk = ports[0]
    xt = T(x).requires_grad_()
    y = vss_block_train_op(xt, pack_vss_block_train_params(blk, torch.float32), H, W, T(m1))
    y.backward(T(g))
    assert_close(y.detach(), y_ref, 5e-5)
    assert_close(xt.grad, dx_ref, 3e-4)
    for key, w in _jax_grads_at_port(blk, dp_ref, skip=("norm2", "mlp")).items():
        assert_close(blk.get_parameter(key).grad, w, 3e-4)


# ---------------------------------------------------------------------------
# kernel 5: a stage in training
# ---------------------------------------------------------------------------

def _stage_case(conv_bias, seed, B=2, H=4, W=4, d=16, depth=2, masked=True):
    _, params, ports = _blocks(conv_bias, depth=depth, d=d, H=H, W=W, seed=seed)
    rng = np.random.default_rng(seed + 100)
    x = rng.standard_normal((B, H * W, d)).astype(np.float32)
    g = rng.standard_normal((B, H * W, d)).astype(np.float32)
    if masked:
        m1, m2 = ((rng.random((depth, B)) < 0.7).astype(np.float32) / 0.7 for _ in range(2))
    else:
        m1 = m2 = np.ones((depth, B), np.float32)
    return params, ports, x, g, m1, m2


@pytest.mark.parametrize("conv_bias,masked", [(False, False), (True, True)])
def test_stage_train_matches_chained_jax_blocks(conv_bias, masked):
    """Kernel 5 (plain): the forward outputs y, x_j and mid_j, and every
    gradient of a depth-2 stage, against chained jax vss_block_ref with the
    same masks; float32, 5e-5 forward, 3e-4 gradients."""
    B, H, W, d, depth = 2, 4, 4, 16, 2
    params, ports, x, g, m1, m2 = _stage_case(conv_bias, 11, B, H, W, d, depth, masked)
    L = H * W

    def mask(m):
        return jnp.broadcast_to(jnp.asarray(m)[:, None, None], (B, L, 1))

    def chain(xx, ps):
        xs, mids = [], []
        for j, pp in enumerate(ps):
            xs.append(xx)
            mids.append(jax_vss_block_ref(xx, pp, H, W, conv_bias, False, m1=mask(m1[j])))
            xx = jax_vss_block_ref(xx, pp, H, W, conv_bias, True, m1=mask(m1[j]),
                                   m2=mask(m2[j]))
        return xx, xs, mids

    (y_ref, xs_ref, mids_ref), vjp = jax.vjp(jax.jit(chain), jnp.asarray(x), params)
    dx_ref, dps_ref = vjp((jnp.asarray(g), [jnp.zeros_like(a) for a in xs_ref],
                           [jnp.zeros_like(a) for a in mids_ref]))
    with torch.no_grad():
        packed = [pack_vss_block_train_params(b, torch.float32) for b in ports]
        y, xs, mids = vss_stage_train_forward(T(x), packed, H, W, T(m1), T(m2))
    assert_close(y, y_ref, 5e-5)
    for j in range(depth):
        assert_close(xs[j], xs_ref[j], 5e-5)
        assert_close(mids[j], mids_ref[j], 5e-5)
    xt = T(x).requires_grad_()
    packed = [pack_vss_block_train_params(b, torch.float32) for b in ports]
    vss_stage_train(xt, packed, H, W, T(m1), T(m2)).backward(T(g))
    assert_close(xt.grad, dx_ref, 3e-4)
    for blk, dp in zip(ports, dps_ref):
        want = _jax_grads_at_port(blk, dp)
        assert len(want) == (19 if conv_bias else 18)
        for key, w in want.items():
            assert_close(blk.get_parameter(key).grad, w, 3e-4)


# ---------------------------------------------------------------------------
# against the JAX Pallas kernels themselves (interpret mode)
# ---------------------------------------------------------------------------

def _jax_packed(params, conv_bias, fuse_mlp):
    from xfmamba_tpu.ops.vss_block_pallas import pack_vss_block_params as jax_pack
    return jax_pack(params, jnp.float32, fuse_mlp)


@pytest.mark.slow
def test_block_backward_matches_pallas_adjoint_interpret():
    """Kernel 6 (plain) with a random mask against the TPU kernel
    ``vss_block_bwd_call`` in interpret mode: dx and the packed-operand
    gradients (the port packs w_dt as (4, R, di), the JAX kernel as
    (4R, di)); float32, 3e-4."""
    from xfmamba_tpu.ops.vss_block_v2_adjoint import vss_block_bwd_call
    B, H, W, d = 2, 4, 8, 16
    params, ports, x, g, m1, _ = _stage_case(True, 21, B, H, W, d, depth=1)
    L = H * W
    jp = _jax_packed(params[0], True, False)
    mask = jnp.broadcast_to(jnp.asarray(m1[0])[:, None, None], (B, L, 1))
    outs = vss_block_bwd_call(jnp.asarray(x), *jp, mask, jnp.ones_like(mask), jnp.asarray(g),
                              H=H, W=W, conv_bias=True, fuse_mlp=False, group=2,
                              interpret=True)
    with torch.no_grad():
        p = pack_vss_block_train_params(ports[0], torch.float32)
        dx, grads = vss_block_bwd_plain(T(x), p, H, W, T(m1[0]), T(g))
    assert_close(dx, outs[0], 3e-4)
    d_ln1, d_w_in, d_w_conv, d_b_conv, d_w_xp, d_w_dt, d_b_dt, d_A, d_Dsum, d_lno, d_w_out = outs[1:12]
    di = p.w_in.shape[0]
    R = p.rank
    pairs = [(torch.stack([grads["ln1_w"], grads["ln1_b"]]), d_ln1),
             (grads["w_in"].t(), d_w_in), (grads["w_conv"], d_w_conv),
             (grads["b_conv"][None], d_b_conv), (grads["w_xp"].t(), d_w_xp),
             (grads["w_dt"].reshape(4 * R, di), d_w_dt), (grads["b_dt"], d_b_dt),
             (grads["A"].reshape(4, di), d_A), (grads["Dsum"][None], d_Dsum),
             (torch.stack([grads["lno_w"], grads["lno_b"]]), d_lno), (grads["w_out"].t(), d_w_out)]
    for got, want in pairs:
        assert_close(got, want, 3e-4)


@pytest.mark.slow
def test_stage_train_matches_pallas_stage_interpret():
    """Kernel 5 (plain) forward and backward against the JAX stage-train
    custom VJP with its Pallas kernels in interpret mode (INTERPRET set and
    restored, as tests/test_vss_stage_train.py does); float32, 3e-4."""
    from xfmamba_tpu.ops import vss_stage_train as VST
    B, H, W, d, depth = 2, 4, 8, 16, 2
    params, ports, x, g, m1, m2 = _stage_case(False, 31, B, H, W, d, depth)
    L = H * W
    packed_j = [_jax_packed(p, False, True) for p in params]
    stacked = tuple(jnp.stack(ws) for ws in zip(*packed_j))

    def masks(m):
        return jnp.broadcast_to(jnp.asarray(m)[:, :, None, None], (depth, B, L, 1))

    VST.INTERPRET = True
    try:
        y_ref, vjp = jax.vjp(lambda xx: VST.vss_stage_train(
            H, W, False, 1, 1, xx, masks(m1), masks(m2), *stacked), jnp.asarray(x))
        (dx_ref,) = vjp(jnp.asarray(g))
    finally:
        VST.INTERPRET = False
    xt = T(x).requires_grad_()
    with torch.no_grad():
        packed = [pack_vss_block_train_params(b, torch.float32) for b in ports]
    y = vss_stage_train(xt, packed, H, W, T(m1), T(m2))
    y.backward(T(g))
    assert_close(y.detach(), y_ref, 5e-5)
    assert_close(xt.grad, dx_ref, 3e-4)

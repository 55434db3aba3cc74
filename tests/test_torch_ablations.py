"""Kernels 17-21 (the ablation kernels behind JAX's switches), on the CPU
against the JAX package.

The plain twins of ``xfmamba_tpu_torch/ops/ablations`` (what the CUDA
wrappers take for CPU tensors) against the Pallas kernels in interpret mode
at the smallest geometry each gate admits, and the scans against the
composable ``ss2d_core_from_projs`` over the three scan modes; the port's
route (`nk_scan_route`) against JAX's dispatcher itself, its gates and
tables against JAX's, the callers' image groups, and the seg_ln gradient
against autograd of the erf-GELU LayerNorm (the JAX backward's GELU is
not copied).  Inputs are numpy arrays from a seed.  Tolerances are the JAX
tests' own: scans 2e-4, LayerNorm float32 2e-5 (dx 3e-5, dscale / dbias
1e-4 relative + 3e-4), bfloat16 8e-3 relative + 1.2e-2.
"""

import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from xfmamba_tpu.models.ss2d import ss2d_core_from_projs as jax_core
from xfmamba_tpu.ops import vss_block_pallas as jax_vbp
from xfmamba_tpu.ops import vss_block_pallas_v2 as jax_v2
from xfmamba_tpu.ops.ablations import nk_scan_v4 as jax_v4
from xfmamba_tpu.ops.ablations import nk_scan_wide as jax_wide
from xfmamba_tpu.ops.ablations import pe_fused as jax_pe
from xfmamba_tpu.ops.ablations import seg_ln as jax_seg
from xfmamba_tpu.ops.selective_scan import selective_scan as jax_scan
from xfmamba_tpu_torch.models import fusion, ss2d
from xfmamba_tpu_torch.ops import nk_scan, nk_scan_adjoint
from xfmamba_tpu_torch.ops.ablations import nk_scan_v4, nk_scan_wide, pe_fused, seg_ln

T = torch.from_numpy
KINDS = {"cross2d": ("row_f", "col_f", "row_r", "col_r"), "unidi": ("row_f",) * 4,
         "bidi": ("row_f", "row_f", "row_r", "row_r")}


def _projs(seed, B, H, W, D, K, N):
    """x, dts, Bs, Cs, A (K, D, N), Dmat, bias as float32 numpy (the
    ranges of ``tests/test_nk_scan.py``)."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (r(B, H, W, D), 0.3 * r(B, H, W, K, D), r(B, H, W, K, N), r(B, H, W, K, N),
            -np.exp(0.5 * r(K, D, N)), r(K, D), 0.1 * r(K, D))


def _nk_args(projs):
    """The projections at the nk contract: u (B, L, D), dts (B, L, K*D),
    Bs/Cs (B, L, K*N), A (K*N, D), Dvec, bias (K, D)."""
    x, dts, Bs, Cs, A, Dmat, bias = projs
    B, H, W, D = x.shape
    K, _, N = A.shape
    L = H * W
    return (x.reshape(B, L, D), dts.reshape(B, L, K * D), Bs.reshape(B, L, K * N),
            Cs.reshape(B, L, K * N), np.ascontiguousarray(A.transpose(0, 2, 1).reshape(K * N, D)),
            Dmat, bias)


def _close(got, want, rtol, atol):
    got, want = (t.detach().float() if isinstance(t, torch.Tensor) else t for t in (got, want))
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# kernels 17 and 18: the scans
# ---------------------------------------------------------------------------

def test_v4_plain_matches_the_pallas_kernel():
    """Kernel 17's plain twin against ``nk_scan_call_v4`` in interpret
    mode at its smallest geometry (G = 8: B 8, 2 x 4 maps), cross2d."""
    B, H, W, D, K, N = 8, 2, 4, 16, 4, 4
    args = _nk_args(_projs(0, B, H, W, D, K, N))
    want = jax_v4.nk_scan_call_v4(*map(jnp.asarray, args), H, W, KINDS["cross2d"], group=8,
                                  interpret=True)
    got = nk_scan_v4.nk_scan_v4(*map(T, args), H, W, KINDS["cross2d"], group=8)
    _close(got, want, 2e-4, 2e-4)


def test_v3_plain_matches_the_pallas_kernel():
    """Kernel 18's plain twin against ``nk_scan_call_v3`` in interpret
    mode (B 2, 2 x 4 maps, D 128, N 2, group 2), and the G = 4 group
    isolation case of ``tests/test_nk_scan.py``: groups 1 and 4 agree with
    each other and with the twin."""
    H, W, D, K, N = 2, 4, 128, 4, 2
    kinds = KINDS["cross2d"]
    for B, groups, seed in ((2, (2,), 1), (4, (1, 4), 8)):
        args = _nk_args(_projs(seed, B, H, W, D, K, N))
        got = nk_scan_wide.nk_scan_v3(*map(T, args), H, W, kinds, group=groups[-1])
        for group in groups:
            want = jax_wide.nk_scan_call_v3(*map(jnp.asarray, args), H, W, kinds, group=group,
                                            interpret=True)
            _close(got, want, 2e-4, 2e-4)


@pytest.mark.parametrize("scan_mode", ["cross2d", "unidi", "bidi"])
def test_scan_plains_match_the_composable_core(scan_mode):
    """Kernels 17 and 18's plain twins against JAX ``ss2d_core_from_projs``
    with ``selective_scan`` (the oracle of ``tests/test_nk_scan.py``) on a
    non-square 3 x 5 map, N 4; both in bfloat16 within bfloat16's
    tolerance of the float32 result."""
    B, H, W, D, K, N = 2, 3, 5, 8, 4, 4
    projs = _projs(2, B, H, W, D, K, N)
    want = np.asarray(jax_core(*map(jnp.asarray, projs), scan_mode=scan_mode,
                               scan_impl=jax_scan)).reshape(B, H * W, D)
    args = [T(a) for a in _nk_args(projs)]
    for scan in (nk_scan_v4.nk_scan_v4_plain, nk_scan_wide.nk_scan_v3_plain):
        _close(scan(*args, H, W, KINDS[scan_mode]), want, 2e-4, 2e-4)
        half = [a.to(torch.bfloat16) if i < 4 else a for i, a in enumerate(args)]
        got = scan(*half, H, W, KINDS[scan_mode])
        assert got.dtype == torch.bfloat16
        _close(got, scan(*[h.float() for h in half], H, W, KINDS[scan_mode]), 8e-3, 1.2e-2)


def test_kind_pairs_and_gates_match_jax():
    """The port's pairing rule, kernel 17's and 18's gates and the VMEM
    estimate equal JAX's, unpaired reverse kinds refused."""
    kind_sets = [KINDS["cross2d"], KINDS["unidi"], KINDS["bidi"], ("row_f",), ("row_r",),
                 ("row_f", "col_r"), ("col_f", "col_r"), ("row_r", "row_f"), ("flat_f", "row_r")]
    for kinds in kind_sets:
        try:
            want = jax_v2.nk_scan_v2_kind_pairs(kinds)
        except ValueError:
            with pytest.raises(ValueError):
                nk_scan.kind_pairs(kinds)
            continue
        assert nk_scan.kind_pairs(kinds) == want
    grid = itertools.product(((7, 7), (2, 4), (3, 5), (14, 14), (56, 56)), (1, 2, 4, 8, 16),
                             (16, 128, 1536, 2048), (1, 4, 16), kind_sets)
    for (H, W), G, D, N, kinds in grid:
        L, K = H * W, len(kinds)
        assert nk_scan_v4.nk_scan_v4_supported(L, W, G, kinds) == \
            jax_v4.nk_scan_v4_supported(L, W, G, kinds)
        assert nk_scan_wide.nk_scan_v3_supported(L, W, D, K, N, G, kinds) == \
            jax_wide.nk_scan_v3_supported(L, W, D, K, N, G, kinds)
        assert nk_scan_wide._vmem_estimate_v3(L, W, D, K, N, G, True) == \
            jax_wide._vmem_estimate_v3(L, W, D, K, N, G, True)


class _Route(Exception):
    pass


def _jax_route(B, L, W, D, K, N, group, kinds):
    """The kernel JAX's ``nk_scan_call_v2`` dispatches to: its Python body
    run unjitted with the v4, v3 and v1 calls and ``pallas_call`` (v2)
    replaced by stubs that name them (the stubs are set by the caller)."""
    sd = lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)
    try:
        jax_v2.nk_scan_call_v2.__wrapped__(
            sd(B, L, D), sd(B, L, K * D), sd(B, L, K * N), sd(B, L, K * N), sd(K * N, D),
            jnp.zeros((K, D)), jnp.zeros((K, D)), L // W, W, kinds, group=group)
    except _Route as route:
        return route.args[0]
    raise AssertionError("no route")


def test_nk_scan_route_matches_jax_dispatch(monkeypatch):
    """`nk_scan_route` names kernel 17 or 18 exactly where JAX's
    dispatcher runs v4 or v3, with each switch on and off, over a grid of
    batch, map, width, kinds, d_state and group; where JAX finds no aligned
    group it runs v1, which the port's callers take before `nk_scan`
    (the route is then kernel 2)."""
    def stub(name):
        def call(*args, **kwargs):
            raise _Route(name)
        return call

    monkeypatch.setattr(jax_v4, "nk_scan_call_v4", stub("v4"))
    monkeypatch.setattr(jax_wide, "nk_scan_call_v3", stub("v3"))
    monkeypatch.setattr(jax_vbp, "nk_scan_call", stub("v1"))
    monkeypatch.setattr(jax_v2, "pl", types.SimpleNamespace(
        BlockSpec=lambda *a, **k: None, pallas_call=stub("v2")))
    grid = list(itertools.product(
        (1, 2, 3, 8, 16, 48), ((7, 7), (2, 4), (14, 14), (3, 5)), (16, 128, 1536),
        (("row_f",), KINDS["cross2d"], KINDS["unidi"], KINDS["bidi"], ("row_r",)),
        (4, 16), (8, 4, 2)))
    seen = set()
    for v4_on, v3_on in ((False, False), (True, False), (False, True), (True, True)):
        monkeypatch.setattr(jax_v4, "FUSED_V4", v4_on)
        monkeypatch.setattr(jax_v2, "FUSED_V3", v3_on)
        monkeypatch.setattr(nk_scan_v4, "FUSED_V4", v4_on)
        monkeypatch.setattr(nk_scan, "FUSED_V3", v3_on)
        for B, (H, W), D, kinds, N, group in grid:
            L, K = H * W, len(kinds)
            want = _jax_route(B, L, W, D, K, N, group, kinds)
            got = nk_scan.nk_scan_route(B, L, W, D, K, N, group, kinds)
            assert got == ("v2" if want == "v1" else want), (v4_on, v3_on, B, H, W, D, kinds,
                                                            N, group, want)
            seen.add(want)
    assert seen == {"v1", "v2", "v3", "v4"}


def test_fusion_callers_pass_jax_groups(monkeypatch):
    """ShallowFuse passes `shallow_group` in eval mode and the group of
    `nk_train_supported` in training, and `core_dispatch` passes its group
    (JAX's ``fusion.py:176-177``, ``:204-205``, ``ss2d.py:332-336``): the
    groups that kernel 17's gate reads."""
    groups = []
    scan = nk_scan_adjoint.nk_scan

    def recorded(*args, **kwargs):
        groups.append(args[10] if len(args) > 10 else kwargs.get("group", 8))
        return scan(*args, **kwargs)

    monkeypatch.setattr(nk_scan_adjoint, "nk_scan", recorded)
    layer = fusion.ShallowFuseSS2Dv4(8, d_state=4, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    for B, want_eval in ((8, 8), (4, 4)):
        x, x2 = (torch.randn(B, 2, 4, 8, generator=g) for _ in range(2))
        with torch.no_grad():
            layer.eval()(x, x2)
        layer.train()(x, x2)
        want_train = nk_scan_adjoint.nk_train_supported(B, 8, 4, 16, 1, 4, "unidi")
        assert groups == [want_eval] * 2 + [want_train] * 2, (B, groups)
        groups.clear()
    projs = [T(a) for a in _projs(3, 8, 2, 4, 8, 4, 4)]
    ss2d.core_dispatch(*projs)
    assert groups == [nk_scan_adjoint.nk_train_supported(8, 8, 4, 8, 4, 4, "cross2d")] == [8]


# ---------------------------------------------------------------------------
# kernels 19-21: LayerNorm (+ GELU)
# ---------------------------------------------------------------------------

def _ln_inputs(seed, shape, C, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape + (C,)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("act", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_act_plain_matches_the_pallas_kernel(dtype, act):
    """Kernel 19's plain twin against ``ln_act_fused`` in interpret mode
    at (2, 8, 8, 48), the suite's erf GELU (``GELU_TANH`` off)."""
    assert not jax_vbp.GELU_TANH
    x, scale, bias = _ln_inputs(4, (2, 8, 8), 48)
    jx = jnp.asarray(x).astype(dtype)
    want = jax_pe.ln_act_fused(jx, jnp.asarray(scale), jnp.asarray(bias), act_gelu=act,
                               interpret=True)
    tx = T(x).to(getattr(torch, dtype))
    got = pe_fused.ln_act_fused(tx, T(scale), T(bias), act_gelu=act)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    tol = (2e-5, 2e-5) if dtype == "float32" else (8e-3, 1.2e-2)
    _close(got.float(), np.asarray(want.astype(jnp.float32)), *tol)


@pytest.mark.parametrize("C,shape,act", [(48, (2, 16, 16), True), (96, (2, 8, 8), False)])
def test_seg_ln_plains_match_the_pallas_kernels(C, shape, act):
    """Kernels 20 and 21's plain twins against ``_seg_ln_fwd_call`` and
    ``_seg_ln_bwd_call`` in interpret mode at ``tests/test_seg_ln.py``'s
    gradient cases, float32; JAX's packed (P * C) dscale / dbias rows folded
    back to C."""
    x, scale, bias = _ln_inputs(5, shape, C)
    g = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    x2, P, width = jax_seg._pack2d(jnp.asarray(x), C)
    sb = jnp.stack([jnp.tile(jnp.asarray(scale), P), jnp.tile(jnp.asarray(bias), P)])
    y2 = jax_seg._seg_ln_fwd_call(x2, sb, C, 1e-5, act, interpret=True)
    dx2, dsb = jax_seg._seg_ln_bwd_call(x2, sb, jnp.asarray(g).reshape(x2.shape), C, 1e-5, act,
                                        interpret=True)
    _close(seg_ln.seg_ln_fwd(T(x), T(scale), T(bias), 1e-5, act),
           np.asarray(y2).reshape(x.shape), 0, 2e-5)
    dx, dscale, dbias = seg_ln.seg_ln_bwd(T(x), T(scale), T(bias), T(g), 1e-5, act)
    _close(dx, np.asarray(dx2).reshape(x.shape), 0, 3e-5)
    _close(dscale, np.asarray(dsb[0]).reshape(P, C).sum(0), 1e-4, 3e-4)
    _close(dbias, np.asarray(dsb[1]).reshape(P, C).sum(0), 1e-4, 3e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,act", [(48, True), (96, False), (192, True)])
def test_seg_ln_act_gradient_is_its_own_gelus(C, act, dtype):
    """The port's ``seg_ln_act`` forward and backward against autograd of
    ``F.layer_norm`` + the erf ``F.gelu``: the backward is the derivative
    of the forward's own GELU (JAX's takes the erf derivative under a tanh
    forward, ``seg_ln.py:127-132``; that is not copied).  bfloat16 x and
    upstream gradient against the float32 autograd."""
    x, scale, bias = _ln_inputs(7, (2, 4, 4), C)
    gy = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)
    leaves = [T(x).to(dtype).requires_grad_(), T(scale).requires_grad_(),
              T(bias).requires_grad_()]
    y = seg_ln.seg_ln_act(*leaves, C, 1e-5, act)
    y.backward(T(gy).to(dtype))
    ref_leaves = [T(x).to(dtype).float().requires_grad_(), T(scale).requires_grad_(),
                  T(bias).requires_grad_()]
    ref = F.layer_norm(ref_leaves[0], (C,), ref_leaves[1], ref_leaves[2], 1e-5)
    ref = F.gelu(ref) if act else ref
    ref.backward(T(gy).to(dtype).float())
    tol = (2e-5, 3e-5) if dtype == torch.float32 else (8e-3, 1.2e-2)
    assert y.dtype == dtype and leaves[0].grad.dtype == dtype
    _close(y.detach().float(), ref.detach(), tol[0], tol[0] if dtype == torch.float32 else tol[1])
    _close(leaves[0].grad.float(), ref_leaves[0].grad, *tol)
    for got, want in zip(leaves[1:], ref_leaves[1:]):
        _close(got.grad, want.grad, 1e-4, 3e-4)
    assert leaves[1].grad.dtype == torch.float32


def test_seg_ln_ragged_rows_mask():
    """A row count that fills no whole block of kernel 21 (9000 pixels of
    C 48, blocks of `BWD_ROWS`): dbias is the row count for every channel
    and every gradient is finite (``test_seg_ln_partial_block_masking``)."""
    C, rows = 48, 9000
    assert rows % seg_ln.BWD_ROWS
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((rows, C)).astype(np.float32))
    dx, dscale, dbias = seg_ln.seg_ln_bwd(x, torch.ones(C), torch.zeros(C), torch.ones(rows, C))
    assert torch.isfinite(dx).all() and torch.isfinite(dscale).all()
    torch.testing.assert_close(dbias, torch.full((C,), float(rows)), rtol=1e-6, atol=0)


def test_seg_tables_and_gates_match_jax():
    """`seg_pack` and `seg_ln_supported` equal JAX's (the table of
    ``tests/test_seg_ln.py``), the card's lanes per pixel divide 32 and
    leave no lane idle below C = 128, and `ln_act_supported` refuses CPU
    tensors, float32, and everything with ``PE_FUSED`` off."""
    for C in (8, 24, 36, 48, 96, 100, 192, 384, 768, 1000):
        assert seg_ln.seg_pack(C) == jax_seg.seg_pack(C)
        for shape in ((2, 4, 4, C), (1, 2, 2, C), (3, 7, 7, C), (2, 56, 56, C)):
            assert seg_ln.seg_ln_supported(shape, C) == jax_seg.seg_ln_supported(shape, C)
        s = seg_ln.seg_lanes(C)
        assert 32 % s == 0 and (C >= 128 or C % s == 0)
    assert [seg_ln.seg_lanes(C) for C in (48, 96, 192, 768)] == [16, 32, 32, 32]
    assert seg_ln.SEG_LN and not pe_fused.PE_FUSED
    x = torch.zeros(1, 8, 8, 48, dtype=torch.bfloat16)
    assert not pe_fused.ln_act_supported(x, torch.bfloat16)
    old = pe_fused.PE_FUSED
    try:
        pe_fused.PE_FUSED = True
        assert not pe_fused.ln_act_supported(x, torch.bfloat16)      # a CPU tensor
        assert not pe_fused.ln_act_supported(x.float(), torch.float32)
    finally:
        pe_fused.PE_FUSED = old


def test_switch_defaults_match_jax():
    assert nk_scan_v4.FUSED_V4 is jax_v4.FUSED_V4 is False
    assert nk_scan.FUSED_V3 is jax_v2.FUSED_V3 is False
    assert pe_fused.PE_FUSED is jax_pe.PE_FUSED is False
    assert seg_ln.SEG_LN is jax_seg.SEG_LN is True

"""Each CUDA kernel of the port against its plain PyTorch version, on the
card, in float32 and bfloat16.  Run on an H100 (``--noconftest``: the
suite's conftest imports JAX, which the port and this file do not need):

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q

Every test skips (inside the ``dev`` fixture) where no CUDA device exists.
TF32 is off for the plain versions.  Errors are relative to the largest
magnitude of the plain result: float32 kernels differ from their plain
versions only in summation order (1e-4), bfloat16 ones also in where
rounding flips a last bit (2e-2 per kernel, 4e-2 through a chained stage).
"""

import pytest
import torch

from xfmamba_tpu_torch.data import device_pipeline as dp
from xfmamba_tpu_torch.kernels import build
from xfmamba_tpu_torch.models import vssm
from xfmamba_tpu_torch.models.tops import TwoViewXFMamba
from xfmamba_tpu_torch.models.vssm import VSSBlock
from xfmamba_tpu_torch.models.ss2d import core_dispatch
from xfmamba_tpu_torch.ops import device_preprocess as op
from xfmamba_tpu_torch.ops import (
    cross2d_scan, fused_cross_scan, nk_scan, nk_scan_adjoint, nk_scan_v1, primitives, scan_whole_map,
    selective_scan_grouped, ss2d_core_n1, ssd_chunk, vss_block_train, vss_block_v1, vss_stage,
    vss_stage_train)
from xfmamba_tpu_torch.ops.vss_block import pack_vss_block_params, pack_vss_block_train_params
from xfmamba_tpu_torch.ops.ablations import (
    ablation_scan, nk_scan_v4, nk_scan_wide, pe_fused, seg_ln)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16]
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(params=["block", "stage"])
def route(request, monkeypatch):
    """The float32 backbone's own route ("block": kernels 11 and 12) or the
    bfloat16 route's kernels run in float32 ("stage")."""
    monkeypatch.setattr(vssm, "_uses_stage_route", lambda dtype: request.param == "stage")
    return request.param


def rel_err(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-6))


def randn(g, *shape, dtype=torch.float32, scale=1.0, dev="cuda"):
    return (scale * torch.randn(*shape, generator=g)).to(dev, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("epilogue", ["none", "bias_gelu", "bias_residual"])
def test_gemm(dev, dtype, epilogue):
    g = torch.Generator().manual_seed(0)
    M, N, K = 1003, 200, 96          # ragged tiles on every side
    a, w = randn(g, M, K, dtype=dtype), randn(g, N, K, dtype=dtype, scale=0.1)
    bias = randn(g, N) if epilogue != "none" else None
    res = randn(g, M, N, dtype=dtype) if epilogue == "bias_residual" else None
    gelu = epilogue == "bias_gelu"
    got = primitives.gemm_cuda(a, w, bias, res, gelu)
    torch.cuda.synchronize()
    assert rel_err(got, primitives.gemm_plain(a, w, bias, res, gelu)) < TOL[dtype]


@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.bfloat16)])
def test_layer_norm(dev, dtypes):
    g = torch.Generator().manual_seed(1)
    x = randn(g, 777, 192, dtype=dtypes[0], scale=3.0)
    w, b = 1 + randn(g, 192, scale=0.1), randn(g, 192, scale=0.1)
    got = primitives.layer_norm_cuda(x, w, b, dtypes[1])
    assert got.dtype == dtypes[1]
    assert rel_err(got, primitives.layer_norm_plain(x, w, b, dtypes[1])) < TOL[dtypes[1]]


@pytest.mark.parametrize("dtype", DTYPES)
def test_dwconv3_silu(dev, dtype):
    g = torch.Generator().manual_seed(2)
    x = randn(g, 3, 7, 9, 40, dtype=dtype)
    w9, b = randn(g, 9, 40, scale=0.3), randn(g, 40)
    got = primitives.dwconv3_silu_cuda(x, w9, b)
    assert rel_err(got, primitives.dwconv3_silu_plain(x, w9, b)) < TOL[dtype]
    if dtype == torch.float32:          # the v1 block's bfloat16 copy of u
        got, got16 = primitives.dwconv3_silu_cuda(x, w9, b, copy_bf16=True)
        assert got16.dtype == torch.bfloat16 and torch.equal(got16, got.to(torch.bfloat16))


def test_gemm_residual_of_another_dtype(dev):
    """The v1 block's residual streams: a bfloat16 residual into a float32
    output and a float32 residual into a bfloat16 output."""
    g = torch.Generator().manual_seed(21)
    a, w = randn(g, 300, 64, dtype=torch.bfloat16), randn(g, 48, 64, dtype=torch.bfloat16)
    bias = randn(g, 48)
    for res, out_dtype in ((randn(g, 300, 48, dtype=torch.bfloat16), torch.float32),
                           (randn(g, 300, 48), torch.bfloat16)):
        got = primitives.gemm_ab_cuda(a, w, bias, res, out_dtype=out_dtype)
        want = primitives.gemm_ab_plain(a, w, bias, res, out_dtype=out_dtype)
        assert got.dtype == out_dtype and rel_err(got, want) < TOL[out_dtype]


def decay_rates(K, N, D):
    """A (K, N, D) = -(n + 1), the S4D-real init of A_logs."""
    return -torch.arange(1.0, N + 1).view(1, N, 1).expand(K, N, D).contiguous().cuda()


def _scan_case(g, dtype, n, H, W, D, kinds, N, R):
    K, L = len(kinds), H * W
    args = dict(u=randn(g, n, L, D, dtype=dtype),
                Bs=randn(g, n, L, K, N, dtype=dtype), Cs=randn(g, n, L, K, N, dtype=dtype),
                A=decay_rates(K, N, D),
                bias=randn(g, K, D, scale=0.5), Dsum=randn(g, D), kinds=kinds, H=H, W=W)
    if R:
        args.update(ranks=randn(g, n, L, K, R, dtype=dtype),
                    w_dt=randn(g, K, R, D, scale=R ** -0.5))
    else:
        args.update(dts=randn(g, n, L, K, D, dtype=dtype, scale=0.5))
    return args


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kinds,N,R", [
    (("row_f", "col_f", "row_r", "col_r"), 1, 3),    # backbone stage form
    (("row_f",), 16, 0),                             # ShallowFuse form
    (("row_f", "col_f", "row_r", "col_r"), 16, 5),   # Cross_SS2Dv5 form
    (("row_f", "row_f", "row_r", "row_r"), 4, 0),    # bidi
])
def test_selective_scan(dev, dtype, kinds, N, R):
    g = torch.Generator().manual_seed(3)
    args = _scan_case(g, dtype, 3, 5, 7, 70, kinds, N, R)
    got = nk_scan.selective_scan_cuda(**args)
    assert rel_err(got, nk_scan.selective_scan_plain(**args)) < 5 * TOL[torch.float32]


def _stage_blocks(g, d, depth, dtype, conv_bias=False):
    blocks = [VSSBlock(d, ssm_conv_bias=conv_bias, generator=g).eval().cuda()
              for _ in range(depth)]
    return [pack_vss_block_params(b, dtype) for b in blocks]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("conv_bias", [False, True])
def test_vss_stage(dev, dtype, conv_bias):
    g = torch.Generator().manual_seed(4)
    H, W, d = 8, 6, 32
    packed = _stage_blocks(g, d, 2, dtype, conv_bias)
    x = randn(g, 4, H * W, d, dtype=dtype)
    before = vss_stage.vss_stage.launches
    got = vss_stage.vss_stage(x, packed, H, W)
    assert vss_stage.vss_stage.launches == before + 1
    assert rel_err(got, vss_stage.vss_stage_plain(x, packed, H, W)) < 2 * TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_nk_scan_and_nk_scan_x(dev, dtype):
    g = torch.Generator().manual_seed(5)
    B, H, W, D, K, N, R = 4, 7, 7, 96, 4, 16, 6
    L = H * W
    u = randn(g, B, L, D, dtype=dtype)
    Bs, Cs = randn(g, B, L, K * N, dtype=dtype), randn(g, B, L, K * N, dtype=dtype)
    A = decay_rates(K, N, D).reshape(K * N, D)
    Dvec, bias = randn(g, K, D), randn(g, K, D, scale=0.5)
    kinds = nk_scan.scan_mode_kinds("cross2d")
    dts = randn(g, B, L, K * D, dtype=dtype, scale=0.5)
    got = nk_scan.nk_scan(u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds)
    want = nk_scan.nk_scan_plain(u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds)
    assert rel_err(got, want) < TOL[dtype]
    ranks, w_dt = randn(g, B, L, K * R, dtype=dtype), randn(g, K * R, D, scale=0.4)
    lno = torch.stack([1 + randn(g, D, scale=0.1), randn(g, D, scale=0.1)])
    got = nk_scan.nk_scan_x(u, ranks, Bs, Cs, w_dt, A, Dvec, bias, lno, H, W, kinds)
    want = nk_scan.nk_scan_x_plain(u, ranks, Bs, Cs, w_dt, A, Dvec, bias, lno, H, W, kinds)
    assert rel_err(got, want) < TOL[dtype]


# kernels 2 and 3 at the fusion geometries of XFMamba-S and -B (7 x 7, N 16,
# D 1536 / 2048, dt rank 48 / 64): ShallowFuse's K=1 call at bs images,
# Cross_SS2Dv5's rank-form K=4 call at 3 bs, the step's K=4 dts-form call
FUSION_GEOMETRY = {"small": (1536, 48), "base": (2048, 64)}


def _fusion_call(g, dtype, size, form, n):
    D, R = FUSION_GEOMETRY[size]
    K = 1 if form == "shallow" else 4
    kinds = ("row_f",) if K == 1 else nk_scan.scan_mode_kinds("cross2d")
    u = randn(g, n, 49, D, dtype=dtype)
    Bs, Cs = randn(g, n, 49, K * 16, dtype=dtype), randn(g, n, 49, K * 16, dtype=dtype)
    A = decay_rates(K, 16, D).reshape(K * 16, D)
    Dvec, bias = randn(g, K, D), randn(g, K, D, scale=0.5) - 4.0
    if form == "cross":
        ranks, w_dt = randn(g, n, 49, K * R, dtype=dtype), randn(g, K * R, D, scale=R ** -0.5)
        lno = torch.stack([1 + randn(g, D, scale=0.1), randn(g, D, scale=0.1)])
        return ((u, ranks, Bs, Cs, w_dt, A, Dvec, bias, lno, 7, 7, kinds), nk_scan.nk_scan_x,
                nk_scan.nk_scan_x_plain)
    dts = randn(g, n, 49, K * D, dtype=dtype, scale=0.5)
    return (u, dts, Bs, Cs, A, Dvec, bias, 7, 7, kinds), nk_scan.nk_scan, nk_scan.nk_scan_plain


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("size", ["small", "base"])
@pytest.mark.parametrize("form,bs", [("shallow", 8), ("shallow", 32), ("cross", 8),
                                     ("cross", 32), ("step", 16)])
def test_fusion_scans_at_model_geometries(dev, dtype, size, form, bs):
    """Kernels 2 and 3 (``csrc/nk_scan_fused.cu``) against their plain
    versions at every fusion geometry of both models, in one launch each
    (the whole-map plan), and bitwise equal over two runs."""
    g = torch.Generator().manual_seed(7)
    args, kernel, plain = _fusion_call(g, dtype, size, form, bs * (1 if form == "shallow" else 3))
    before = nk_scan.fusion_scan_cuda.launches
    got = kernel(*args)
    assert nk_scan.fusion_scan_cuda.launches == before + 1
    assert torch.equal(got, kernel(*args))
    assert rel_err(got, plain(*args)) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", ["cross", "step"])
def test_fusion_scan_plans_agree(dev, monkeypatch, dtype, form):
    """The chunked plan (a block per kind, 7 chunks of 7 positions, the
    kinds' parts summed by a second launch) and the whole-map plan with the
    ranks of one kind at a time give the whole-map plan's bits."""
    g = torch.Generator().manual_seed(8)
    args, kernel, _ = _fusion_call(g, dtype, "small", form, 6)
    want = kernel(*args)
    real = nk_scan.fusion_scan_plan
    with monkeypatch.context() as mp:
        mp.setattr(nk_scan, "fusion_scan_plan", lambda *a: (*real(*a)[:2], 1))
        assert torch.equal(kernel(*args), want)
    monkeypatch.setattr(nk_scan, "FUSION_SMEM", 0)
    monkeypatch.setattr(nk_scan, "FUSION_CHUNK", 7)
    nk_scan.fusion_scan_cuda.by_plan.clear()
    assert torch.equal(kernel(*args), want)
    assert list(nk_scan.fusion_scan_cuda.by_plan)[0].startswith("chunked x7")


@pytest.mark.parametrize("form", ["shallow", "cross"])
def test_fusion_scan_phase_clock(dev, form):
    """The kernels' phase clock (``phase_ns``) reads each phase of a block,
    none negative, their sum the block's time, and counts no launch."""
    g = torch.Generator().manual_seed(10)
    args, kernel, _ = _fusion_call(g, torch.bfloat16, "small", form, 6)
    if kernel is nk_scan.nk_scan:
        u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds = args
        deltas = dict(dts=dts.view(6, 49, 1, 1536), out_dtype=u.dtype)
    else:
        u, ranks, Bs, Cs, w_dt, A, Dvec, bias, _, H, W, kinds = args
        deltas = nk_scan._rank_operands(u, ranks, w_dt, kinds)
    before = nk_scan.fusion_scan_cuda.launches
    phases = nk_scan.fusion_scan_cuda(H=H, W=W, phase_ns=True, **deltas,
                                      **nk_scan._nk_operands(u, Bs, Cs, A, Dvec, bias, kinds))
    assert nk_scan.fusion_scan_cuda.launches == before
    assert set(phases) == set(nk_scan.FUSION_PHASES) | {"block"}
    parts = [phases[k] for k in nk_scan.FUSION_PHASES]
    assert min(parts) >= 0 and phases["block"] > 0
    assert abs(sum(parts) - phases["block"]) <= 1e-6 * phases["block"] + 1


def test_fusion_scan_holds_two_blocks_an_sm(dev):
    """A whole-map block of the bs-32 Cross_SS2Dv5 call (512 threads,
    bfloat16 and float32) leaves room for a second on each SM."""
    g = torch.Generator().manual_seed(9)
    for dtype in DTYPES:
        (u, ranks, Bs, Cs, w_dt, A, Dvec, bias, _, H, W, kinds), _, _ = _fusion_call(
            g, dtype, "small", "cross", 96)
        ops = nk_scan._nk_operands(u, Bs, Cs, A, Dvec, bias, kinds)
        blocks = nk_scan.fusion_scan_cuda(H=H, W=W, blocks_per_sm=True, **ops,
                                          **nk_scan._rank_operands(u, ranks, w_dt, kinds))
        assert blocks == 2


def test_tiny_model_card_matches_cpu(dev, route):
    g = torch.Generator().manual_seed(6)
    model = TwoViewXFMamba(model_type="tiny", hidden_dim=128, d_state=4,
                           backbone_overrides=dict(depths=(2, 2, 2, 2), dims=16),
                           generator=g).eval()
    xa, xb = torch.randn(2, 32, 32, 1, generator=g), torch.randn(2, 32, 32, 1, generator=g)
    with torch.no_grad():
        want = model(xa, xb)
        model.cuda()
        fns = (ss2d_core_n1.ss2d_core_n1_fwd, vss_stage.vss_stage, nk_scan.nk_scan,
               nk_scan.nk_scan_x, nk_scan_v1.nk_scan_v1)
        counts = [f.launches for f in fns]
        got = model(xa.cuda(), xb.cuda()).cpu()
    after = [f.launches for f in fns]
    # the 1 x 1 stage 3 has no whole-block kernel (composable, kernel 11);
    # no fusion scan has an aligned image group at 2 views (kernel 9)
    want_counts = [8, 0, 0, 0, 3] if route == "block" else [2, 3, 0, 0, 3]
    assert [b - a for a, b in zip(counts, after)] == want_counts
    assert rel_err(got, want) < 1e-3


# ---------------------------------------------------------------------------
# the training kernels (kernels 4-7 and the backward pieces they launch)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_gemm_gradient_layouts(dev, dtype):
    """dX = dY @ W and dW = dY^T @ X (split along the rows, atomics) into
    float32, and a strided output view, against the plain products."""
    g = torch.Generator().manual_seed(7)
    M, N, K = 20011, 96, 72
    dy, x = randn(g, M, N, dtype=dtype), randn(g, M, K, dtype=dtype)
    w = randn(g, N, K, dtype=dtype, scale=0.1)
    f32 = torch.float32
    for a, b in ((dy, w.t()), (dy.t(), x.t())):
        got = primitives.gemm_ab_cuda(a, b, out_dtype=f32)
        assert got.dtype == f32
        assert rel_err(got, primitives.gemm_ab_plain(a, b, out_dtype=f32)) < TOL[torch.float32]
    out = torch.zeros(M, 3 * K, dtype=f32, device="cuda")
    primitives.gemm_ab_cuda(dy, w.t(), out=out[:, K:2 * K])
    assert rel_err(out[:, K:2 * K], primitives.gemm_ab_plain(dy, w.t(), out_dtype=f32)) < 1e-4
    assert not out[:, :K].any() and not out[:, 2 * K:].any()
    scale = (torch.rand(7, generator=g) < 0.5).float().cuda() / 0.5
    a = randn(g, 7 * 13, K, dtype=dtype)
    res, bias = randn(g, 7 * 13, N, dtype=dtype), randn(g, N)
    got = primitives.gemm_cuda(a, w, bias, res, False, scale)
    assert rel_err(got, primitives.gemm_plain(a, w, bias, res, False, scale)) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_norm_and_dwconv_backward(dev, dtype):
    g = torch.Generator().manual_seed(8)
    x = randn(g, 5003, 192, dtype=dtype, scale=2.0)
    gr, dres = randn(g, 5003, 192), randn(g, 5003, 192)
    w = 1 + randn(g, 192, scale=0.1)
    for got, want in zip(primitives.layer_norm_bwd_cuda(gr, x, w, dres),
                         primitives.layer_norm_bwd_plain(gr, x, w, dres)):
        assert rel_err(got, want) < 1e-4
    xc = randn(g, 3, 9, 11, 40, dtype=dtype)
    du, w9, b = randn(g, 3, 9, 11, 40), randn(g, 9, 40, scale=0.3), randn(g, 40)
    for got, want in zip(primitives.dwconv3_silu_bwd_cuda(du, xc, w9, b),
                         primitives.dwconv3_silu_bwd_plain(du, xc, w9, b)):
        assert rel_err(got, want) < 1e-4


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kinds,N,R", [
    (("row_f", "col_f", "row_r", "col_r"), 1, 3),    # backbone stage form
    (("row_f",), 16, 0),                             # ShallowFuse form
    (("row_f", "col_f", "row_r", "col_r"), 16, 0),   # Cross_SS2Dv5 training form
    (("row_f", "row_f", "row_r", "row_r"), 4, 5),    # bidi, rank form
])
def test_selective_scan_bwd(dev, dtype, kinds, N, R):
    """The adjoint scan against its plain version: float32 sums and
    atomics in another order (1e-4 of each output's largest magnitude, 1e-3
    for the channel sums dB, dC); bfloat16 dz rounds on both sides."""
    g = torch.Generator().manual_seed(9)
    args = _scan_case(g, dtype, 3, 5, 7, 70, kinds, N, R)
    args["gy"] = randn(g, 3, 35, 70)
    got = nk_scan.selective_scan_bwd_cuda(**args)
    want = nk_scan.selective_scan_bwd_plain(**args)
    for name in want:
        tol = 1e-3 if name in ("dB", "dC") else 1e-4
        if name == "dz" and dtype == torch.bfloat16:
            tol = 1e-2
        assert rel_err(got[name], want[name]) < tol, name


def _block_case(g, d, dtype, H=8, W=6, n=4, conv_bias=False):
    blk = VSSBlock(d, ssm_conv_bias=conv_bias, generator=g).cuda()
    p = pack_vss_block_train_params(blk, dtype)
    x = randn(g, n, H * W, d, dtype=dtype)
    m = (torch.rand(n, generator=g) < 0.7).float().cuda() / 0.7
    return p, x, m


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("conv_bias", [False, True])
def test_vss_block_train_and_bwd(dev, dtype, conv_bias):
    """Kernels 4 and 6 against their plain versions (2e-2 relative in
    bfloat16, where rounding flips chain through the sequence)."""
    g = torch.Generator().manual_seed(10)
    H, W, d = 8, 6, 32
    p, x, m1 = _block_case(g, d, dtype, H, W, conv_bias=conv_bias)
    with torch.no_grad():
        n4 = vss_block_train.vss_block_train.launches
        got = vss_block_train.vss_block_train(x, p, H, W, m1)
        assert vss_block_train.vss_block_train.launches == n4 + 1
        assert rel_err(got, vss_block_train.vss_block_train_plain(x, p, H, W, m1)) < TOL[dtype]
        gy = randn(g, *x.shape)
        dx, grads = vss_block_train.vss_block_bwd(x, p, H, W, m1, gy)
        dx_p, grads_p = vss_block_train.vss_block_bwd_plain(x, p, H, W, m1, gy)
    assert rel_err(dx, dx_p) < 2 * TOL[dtype]
    for name, want in grads_p.items():
        if want is not None:
            assert rel_err(grads[name], want) < 2 * TOL[dtype], name


@pytest.mark.parametrize("dtype", DTYPES)
def test_vss_stage_train(dev, dtype):
    """Kernel 5's forward (y, x_j, mid_j) and the stage backward with
    kernel 6 against the plain versions."""
    g = torch.Generator().manual_seed(11)
    H, W, d, depth, n = 8, 6, 32, 2, 4
    blocks = [VSSBlock(d, generator=g).cuda() for _ in range(depth)]
    with torch.no_grad():
        ps = [pack_vss_block_train_params(b, dtype) for b in blocks]
        x = randn(g, n, H * W, d, dtype=dtype)
        m1, m2 = ((torch.rand(depth, n, generator=g) < 0.7).float().cuda() / 0.7
                  for _ in range(2))
        got = vss_stage_train.vss_stage_train_forward(x, ps, H, W, m1, m2)
        want = vss_stage_train.vss_stage_train_forward_plain(x, ps, H, W, m1, m2)
        for a, b in zip(got, want):
            assert rel_err(a, b) < 2 * TOL[dtype]
        gy = randn(g, *x.shape, dtype=dtype)
        dx, grads = vss_stage_train.stage_train_backward(gy, *got[1:], ps, H, W, m1, m2)
        dx_p, grads_p = vss_stage_train.stage_train_backward(
            gy, *got[1:], ps, H, W, m1, m2, block_bwd=vss_block_train.vss_block_bwd_plain)
    assert rel_err(dx, dx_p) < 2 * TOL[dtype]
    for gj, gj_p in zip(grads, grads_p):
        for name, want in gj_p.items():
            if want is not None:
                assert rel_err(gj[name], want) < 2 * TOL[dtype], name


@pytest.mark.parametrize("dtype", DTYPES)
def test_nk_scan_bwd(dev, dtype):
    """Kernel 7 at the Cross_SS2Dv5 training form against its plain
    version."""
    g = torch.Generator().manual_seed(12)
    B, H, W, D, K, N = 6, 7, 7, 96, 4, 16
    L = H * W
    u = randn(g, B, L, D, dtype=dtype)
    Bs, Cs = randn(g, B, L, K * N, dtype=dtype), randn(g, B, L, K * N, dtype=dtype)
    A = decay_rates(K, N, D).reshape(K * N, D)
    Dvec, bias = randn(g, K, D), randn(g, K, D, scale=0.5)
    dts = randn(g, B, L, K * D, dtype=dtype, scale=0.5)
    gy = randn(g, B, L, D, dtype=dtype)
    kinds = nk_scan.scan_mode_kinds("cross2d")
    before = nk_scan_adjoint.nk_scan_bwd.launches
    got = nk_scan_adjoint.nk_scan_bwd(u, dts, Bs, Cs, A, Dvec, bias, gy, H, W, kinds)
    assert nk_scan_adjoint.nk_scan_bwd.launches == before + 1
    want = nk_scan_adjoint.nk_scan_bwd_plain(u, dts, Bs, Cs, A, Dvec, bias, gy, H, W, kinds)
    for a, b in zip(got, want):
        assert rel_err(a, b) < (1e-2 if a.dtype == torch.bfloat16 else 1e-3)


def _nk_bwd_case(g, dtype, B, H, W, D, K, N):
    L = H * W
    kinds = nk_scan.scan_mode_kinds("cross2d") if K == 4 else ("row_f",)
    return (randn(g, B, L, D, dtype=dtype), randn(g, B, L, K * D, dtype=dtype, scale=0.5),
            randn(g, B, L, K * N, dtype=dtype), randn(g, B, L, K * N, dtype=dtype),
            decay_rates(K, N, D).reshape(K * N, D), randn(g, K, D), randn(g, K, D, scale=0.5),
            randn(g, B, L, D), H, W, kinds)


# kernel 7's shapes: each model's ShallowFuse and Cross_SS2Dv5 calls of the
# bs-16 step, and a ragged map with N 4
NK_BWD_CASES = [(16, 7, 7, 1536, 1, 16), (48, 7, 7, 1536, 4, 16), (16, 7, 7, 2048, 1, 16),
                (48, 7, 7, 2048, 4, 16), (3, 5, 7, 70, 4, 4)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,W,D,K,N", NK_BWD_CASES)
def test_nk_scan_bwd_at_the_fusion_shapes(dev, dtype, B, H, W, D, K, N):
    """Kernel 7 against its segment-checkpoint twin, every output (float32
    to summation order, 1e-4; bfloat16 ddts rounds on both sides, 1e-2)."""
    g = torch.Generator().manual_seed(44 + K)
    args = _nk_bwd_case(g, dtype, B, H, W, D, K, N)
    got = nk_scan_adjoint.nk_scan_bwd(*args)
    want = nk_scan_adjoint.nk_scan_bwd_segments_plain(*args)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert rel_err(a, b) < (1e-2 if a.dtype == torch.bfloat16 else 1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_nk_scan_bwd_is_deterministic(dev, dtype):
    """Two runs of kernel 7 give the same bits: no atomics, every sum in a
    fixed order."""
    g = torch.Generator().manual_seed(45)
    args = _nk_bwd_case(g, dtype, 48, 7, 7, 1536, 4, 16)
    for a, b in zip(nk_scan_adjoint.nk_scan_bwd(*args), nk_scan_adjoint.nk_scan_bwd(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_nk_scan_bwd_serial(dev, dtype):
    """The earlier design, the serial adjoint, against the serial plain
    version."""
    g = torch.Generator().manual_seed(46)
    args = _nk_bwd_case(g, dtype, 6, 7, 7, 96, 4, 16)
    for a, b in zip(nk_scan_adjoint.nk_scan_bwd_serial(*args),
                    nk_scan_adjoint.nk_scan_bwd_plain(*args)):
        assert rel_err(a, b) < (1e-2 if a.dtype == torch.bfloat16 else 1e-3)


def test_tiny_model_train_step_card_matches_cpu(dev, route):
    """One float32 train step of the tiny model, card against CPU: loss and
    every parameter gradient (1e-3 of the tensor's largest gradient), with
    the training launch counts, on both backbone routes."""
    g = torch.Generator().manual_seed(13)
    kw = dict(model_type="tiny", hidden_dim=128, d_state=4, drop_path_rate=0.0,
              backbone_overrides=dict(depths=(2, 2, 2, 2), dims=16, drop_path_rate=0.0))
    model = TwoViewXFMamba(generator=g, **kw).train()
    xa, xb = torch.randn(2, 32, 32, 1, generator=g), torch.randn(2, 32, 32, 1, generator=g)
    labels = torch.tensor([0, 1])
    loss = torch.nn.functional.cross_entropy(model(xa, xb), labels)
    loss.backward()
    want = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
    model.zero_grad()
    model.cuda()
    fns = (ss2d_core_n1.ss2d_core_n1_fwd, ss2d_core_n1.ss2d_core_n1_bwd,
           vss_stage_train.vss_stage_train_forward, vss_block_train.vss_block_bwd,
           nk_scan.nk_scan, nk_scan_adjoint.nk_scan_bwd, selective_scan_grouped.grouped_scan_fwd,
           selective_scan_grouped.grouped_scan_bwd)
    before = [f.launches for f in fns]
    loss_c = torch.nn.functional.cross_entropy(model(xa.cuda(), xb.cuda()), labels.cuda())
    loss_c.backward()
    # batch 2 at 1 x 1 maps: no aligned image group, so both fusion scans
    # take the grouped scan (one K=2 call, four K=1 calls)
    want_counts = [8, 8, 0, 0, 0, 0, 5, 5] if route == "block" else [0, 0, 4, 8, 0, 0, 5, 5]
    assert [f.launches - b for f, b in zip(fns, before)] == want_counts
    assert abs(float(loss_c) - float(loss)) < 1e-4
    for k, p in model.named_parameters():
        if k in want:
            assert rel_err(p.grad.cpu(), want[k]) < 1e-3, k


# ---------------------------------------------------------------------------
# kernels 11 and 12: the N=1 SS2D core and its backward
# ---------------------------------------------------------------------------

def _n1_case(g, dtype, B, H, W, D, R):
    """Operands of the N=1 core with the decay and delta ranges of a trained
    model: A in [-1, -e^1.5], deltas about softplus(-4 +- 1)."""
    x = randn(g, B, H, W, D, dtype=dtype)
    xw = randn(g, 4, R + 2, D, scale=D ** -0.5)
    dtw = randn(g, 4, D, R, scale=R ** -0.5)
    bias = randn(g, 4, D, scale=0.5) - 4.0
    A_logs = torch.rand(4 * D, 1, generator=g).cuda() * 1.5
    Ds = randn(g, 4 * D)
    return x, ss2d_core_n1.pack_n1_inputs(x, xw, dtw, bias, A_logs, Ds)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,W,D,R,chunk", [
    (3, 14, 14, 96, 6, None),     # 16 chunks of 13, the last of 1
    (2, 7, 7, 200, 12, None),     # 7 chunks of 7; a ragged channel tile
    (2, 9, 11, 64, 4, 10),        # 10 chunks of 10, the last of 9; H != W
    (2, 5, 6, 32, 2, 64),         # one chunk
])
def test_ss2d_core_n1_fwd_and_bwd(dev, dtype, B, H, W, D, R, chunk):
    """Kernels 11 and 12 against their plain twins on the same operands:
    y, every checkpoint, and every gradient.  The kernels' sums are fixed in
    order but not the twins' order, and the rank products run on the
    tensor cores (3xTF32 in float32; in bfloat16 on bfloat16 operands, dpre
    rounded where the twin keeps float32): 1e-4 of each output's largest
    magnitude in float32, 2e-2 in bfloat16.  No GEMM is launched for the
    rank gradients, and two runs give the same bits."""
    g = torch.Generator().manual_seed(14)
    x, (xdbl, w_dt, A, Ds, bias) = _n1_case(g, dtype, B, H, W, D, R)
    before = (ss2d_core_n1.ss2d_core_n1_fwd.launches, ss2d_core_n1.ss2d_core_n1_bwd.launches)
    y, ck = ss2d_core_n1.ss2d_core_n1_fwd(x, xdbl, w_dt, A, Ds, bias, chunk)
    y_p, ck_p = ss2d_core_n1.ss2d_core_n1_fwd_plain(x, xdbl, w_dt, A, Ds, bias, chunk)
    torch.cuda.synchronize()
    assert rel_err(y, y_p) < TOL[dtype] and rel_err(ck, ck_p) < TOL[dtype]
    gy = randn(g, B, H, W, D)
    gemms = (primitives.gemm_simt_cuda.launches, primitives.gemm_tc_cuda.launches)
    got = ss2d_core_n1.ss2d_core_n1_bwd(x, xdbl, w_dt, A, Ds, bias, ck_p, gy, chunk)
    assert (primitives.gemm_simt_cuda.launches, primitives.gemm_tc_cuda.launches) == gemms
    want = ss2d_core_n1.ss2d_core_n1_bwd_plain(x, xdbl, w_dt, A, Ds, bias, ck_p, gy, chunk)
    torch.cuda.synchronize()
    assert (ss2d_core_n1.ss2d_core_n1_fwd.launches,
            ss2d_core_n1.ss2d_core_n1_bwd.launches) == (before[0] + 1, before[1] + 1)
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        assert rel_err(got[name], w) < TOL[dtype], name
    again = ss2d_core_n1.ss2d_core_n1_bwd(x, xdbl, w_dt, A, Ds, bias, ck_p, gy, chunk)
    assert all(torch.equal(got[k], again[k]) for k in want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,W,D,R", [(4, 14, 14, 768, 24), (4, 7, 7, 1536, 48),
                                       (3, 9, 17, 200, 12), (2, 16, 16, 64, 6)])
def test_ss2d_core_n1_forward_routes_agree(dev, monkeypatch, dtype, B, H, W, D, R):
    """Kernel 11 on maps of at most `FUSE_TILES` tiles is one launch of
    thread-block clusters (an image's tiles); with ``FUSE_TILES = 0`` it
    is three launches (pairs, carries, apply).  Both take the same steps in
    the same order: y and the checkpoints agree bit for bit, and with the
    plain twin within the tolerance of `test_ss2d_core_n1_fwd_and_bwd`."""
    g = torch.Generator().manual_seed(15)
    x, args = _n1_case(g, dtype, B, H, W, D, R)
    assert ss2d_core_n1.tile_plan(B, H, W, D).fused
    y, ck = ss2d_core_n1.ss2d_core_n1_fwd(x, *args)
    monkeypatch.setattr(ss2d_core_n1, "FUSE_TILES", 0)
    y3, ck3 = ss2d_core_n1.ss2d_core_n1_fwd(x, *args)
    y_p, ck_p = ss2d_core_n1.ss2d_core_n1_fwd_plain(x, *args)
    torch.cuda.synchronize()
    assert torch.equal(y, y3) and torch.equal(ck, ck3)
    assert rel_err(y, y_p) < TOL[dtype] and rel_err(ck, ck_p) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_ss2d_core_n1_first_design_matches_plain(dev, dtype):
    """The first design of kernels 11 and 12 (``csrc/ss2d_core_n1_v1.cu``,
    kept for timing beside the tile-parallel kernels) against the plain
    twins, its rank gradients on the port's GEMM, and the stage scans on
    it; each counted only in its own launches."""
    g = torch.Generator().manual_seed(16)
    x, (xdbl, w_dt, A, Ds, bias) = _n1_case(g, dtype, 2, 14, 14, 96, 6)
    before = (ss2d_core_n1.ss2d_core_n1_fwd.launches, ss2d_core_n1.ss2d_core_n1_bwd.launches)
    y, ck = ss2d_core_n1.ss2d_core_n1_fwd_v1(x, xdbl, w_dt, A, Ds, bias)
    y_p, ck_p = ss2d_core_n1.ss2d_core_n1_fwd_plain(x, xdbl, w_dt, A, Ds, bias)
    assert rel_err(y, y_p) < TOL[dtype] and rel_err(ck, ck_p) < TOL[dtype]
    gy = randn(g, *x.shape)
    got = ss2d_core_n1.ss2d_core_n1_bwd_v1(x, xdbl, w_dt, A, Ds, bias, ck_p, gy)
    want = ss2d_core_n1.ss2d_core_n1_bwd_plain(x, xdbl, w_dt, A, Ds, bias, ck_p, gy)
    for name, w in want.items():
        assert rel_err(got[name], w) < TOL[dtype], name
    assert (ss2d_core_n1.ss2d_core_n1_fwd.launches,
            ss2d_core_n1.ss2d_core_n1_bwd.launches) == before
    args = _cross2d_case(g, dtype, 2, 14, 384)
    y, ck = cross2d_scan.cross2d_scan_v1(*args, checkpoints=True)
    y_p, ck_p = cross2d_scan.cross2d_scan_plain(*args, checkpoints=True)
    assert rel_err(y, y_p) < 1e-4 and rel_err(ck, ck_p) < 1e-4
    gy = randn(g, *args[0].shape)
    dx, dx_p = (torch.zeros(args[0].shape[0] * args[0].shape[1], args[1].shape[-1],
                            device="cuda") for _ in range(2))
    got = cross2d_scan.cross2d_scan_bwd_v1(*args, gy, ck_p, dx)
    want = cross2d_scan.cross2d_scan_bwd_plain(*args, gy, ck_p, dx_p)
    for name in got:
        assert rel_err(got[name], want[name]) < TOL[dtype], name
    assert rel_err(dx, dx_p) < TOL[dtype]


def test_ss2d_core_n1_autograd_card_matches_cpu(dev):
    """`ss2d_core_n1` forward and all six gradients, card against the CPU
    plain twins, float32."""
    g = torch.Generator().manual_seed(15)
    B, H, W, D, R = 2, 10, 12, 48, 3
    args = [torch.randn(B, H, W, D, generator=g), 0.2 * torch.randn(4, R + 2, D, generator=g),
            0.3 * torch.randn(4, D, R, generator=g), 0.5 * torch.randn(4, D, generator=g) - 3,
            torch.rand(4 * D, 1, generator=g), torch.randn(4 * D, generator=g)]
    gy = torch.randn(B, H, W, D, generator=g)
    results = []
    for device in ("cpu", "cuda"):
        leaves = [a.detach().to(device).requires_grad_() for a in args]
        y = ss2d_core_n1.ss2d_core_n1(*leaves)
        y.backward(gy.to(device))
        results.append([y.detach().cpu()] + [leaf.grad.cpu() for leaf in leaves])
    for got, want in zip(results[1], results[0]):
        assert rel_err(got, want) < 1e-4


# ---------------------------------------------------------------------------
# kernels 13 and 14: the grouped selective scan and its adjoint
# ---------------------------------------------------------------------------

def _grouped_case(g, dtype, B, L, K, C, N):
    """Operands of the grouped scan with a trained model's ranges: A in
    [-e^1.5, -1] per state, deltas about softplus(-4 +- 1)."""
    return (randn(g, B, L, K * C, dtype=dtype), randn(g, B, L, K * C, dtype=dtype) - 4.0,
            -torch.exp(1.5 * torch.rand(K * C, N, generator=g)).cuda(),
            randn(g, B, L, K, N, dtype=dtype), randn(g, B, L, K, N, dtype=dtype),
            randn(g, K * C), randn(g, K * C, scale=0.5))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B,L,K,C,N", [
    (48, 49, 1, 2048, 16),       # XFMamba-B Cross_SS2Dv5 direction, batch 16
    (12, 49, 2, 1536, 16),       # XFMamba-S ShallowFuse, batch 12
    (2, 3136, 4, 192, 16),       # a 56 x 56 map, 98 chunks
    (2, 3127, 4, 192, 16),       # the last chunk ragged
    (3, 70, 3, 40, 5),           # an idle channel tail, N = 5
])
def test_grouped_scan_fwd_and_bwd(dev, dtype, reverse, B, L, K, C, N):
    """Kernels 13 and 14 (``csrc/grouped_scan_lanes.cu``) against their
    plain twins on the same operands: y, the checkpoints, and every gradient
    from the plain checkpoints, within 2e-5 of each output's largest
    magnitude in both dtypes (kernel and twin do the same float32
    arithmetic on the same operands; they differ only by exp2 against exp
    and by the kernels' fixed order of sums over lanes, chains, warps, slabs
    and images, with no atomics); two runs give the same bits."""
    g = torch.Generator().manual_seed(16)
    args = _grouped_case(g, dtype, B, L, K, C, N)
    ssg = selective_scan_grouped
    before = (ssg.grouped_scan_fwd.launches, ssg.grouped_scan_bwd.launches)
    y, ck = ssg.grouped_scan_fwd(*args, reverse=reverse)
    y_p, ck_p = ssg.grouped_scan_fwd_plain(*args, reverse=reverse)
    torch.cuda.synchronize()
    assert rel_err(y, y_p) < 2e-5 and rel_err(ck, ck_p) < 2e-5
    y2, ck2 = ssg.grouped_scan_fwd(*args, reverse=reverse)
    assert torch.equal(y, y2) and torch.equal(ck, ck2)
    gy = randn(g, B, L, K * C)
    got = ssg.grouped_scan_bwd(*args, ck_p, gy, reverse=reverse)
    want = ssg.grouped_scan_bwd_plain(*args, ck_p, gy, reverse=reverse)
    again = ssg.grouped_scan_bwd(*args, ck_p, gy, reverse=reverse)
    torch.cuda.synchronize()
    assert (ssg.grouped_scan_fwd.launches, ssg.grouped_scan_bwd.launches) == \
        (before[0] + 2, before[1] + 2)
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        assert rel_err(got[name], w) < 2e-5, name
        assert torch.equal(got[name], again[name]), name


@pytest.mark.parametrize("reverse", [False, True])
def test_grouped_scan_first_design(dev, reverse):
    """The first design of kernels 13 and 14 (``grouped_scan_*_v1``, kept
    for timing) against the plain twins, float32, at XFMamba-S's bs-12
    ShallowFuse call (its atomics reorder float32 sums: 1e-4)."""
    g = torch.Generator().manual_seed(18)
    B, L, K, C, N = 12, 49, 2, 1536, 16
    args = _grouped_case(g, torch.float32, B, L, K, C, N)
    ssg = selective_scan_grouped
    y, ck = ssg.grouped_scan_fwd_v1(*args, reverse=reverse)
    y_p, ck_p = ssg.grouped_scan_fwd_plain(*args, reverse=reverse)
    gy = randn(g, B, L, K * C)
    got = ssg.grouped_scan_bwd_v1(*args, ck_p, gy, reverse=reverse)
    want = ssg.grouped_scan_bwd_plain(*args, ck_p, gy, reverse=reverse)
    torch.cuda.synchronize()
    assert rel_err(y, y_p) < 1e-4 and rel_err(ck, ck_p) < 1e-4
    for name, w in want.items():
        assert rel_err(got[name], w) < 1e-4, name


def test_selective_scan_auto_card_matches_cpu(dev):
    """`selective_scan_auto` forward and all seven gradients, card against
    the CPU plain twins, float32, reverse, two chunks."""
    g = torch.Generator().manual_seed(17)
    B, L, K, C, N = 2, 45, 2, 33, 16
    args = [torch.randn(B, L, K * C, generator=g), torch.randn(B, L, K * C, generator=g) - 3,
            -torch.rand(K * C, N, generator=g) - 0.5, torch.randn(B, L, K, N, generator=g),
            torch.randn(B, L, K, N, generator=g), torch.randn(K * C, generator=g),
            0.5 * torch.randn(K * C, generator=g)]
    gy = torch.randn(B, L, K * C, generator=g)
    results = []
    for device in ("cpu", "cuda"):
        leaves = [a.detach().to(device).requires_grad_() for a in args]
        y = selective_scan_grouped.selective_scan_auto(*leaves, reverse=True)
        y.backward(gy.to(device))
        results.append([y.detach().cpu()] + [leaf.grad.cpu() for leaf in leaves])
    for got, want in zip(results[1], results[0]):
        assert rel_err(got, want) < 1e-4


# vanilla VMamba-T's fusion-scan geometries at 224 x 224 (d_state 16, the
# cross2d scan): stages 1-3 take the nk pair with groups 2, 4 and 8 at
# batch 8; stage 0 (56 x 56, d_inner 192) takes no group, one grouped-scan
# call a direction
VANILLA_NK = [(8, 28, 384, 2), (8, 14, 768, 4), (8, 7, 1536, 8)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,D,group", VANILLA_NK)
def test_vanilla_nk_pair(dev, dtype, B, H, D, group):
    """Kernels 2 and 7 at vanilla VMamba-T's stage geometries (K 4 cross2d,
    N 16) against their plain versions: the forward within TOL, every
    gradient within 1e-4 of its largest (1e-2 for bfloat16 ddts); the
    routing rule gives each stage its group."""
    g = torch.Generator().manual_seed(60 + H)
    kinds = nk_scan.scan_mode_kinds("cross2d")
    assert nk_scan_adjoint.nk_train_supported(B, H * H, H, D, 4, 16, "cross2d") == group
    args = _nk_case(g, dtype, B, H, H, D, kinds, 16)
    before = (nk_scan.nk_scan.launches, nk_scan_adjoint.nk_scan_bwd.launches)
    got = nk_scan.nk_scan(*args, group=group)
    assert rel_err(got, nk_scan.nk_scan_plain(*args)) < TOL[dtype]
    gy = randn(g, B, H * H, D)
    grads = nk_scan_adjoint.nk_scan_bwd(*args[:7], gy, H, H, kinds)
    want = nk_scan_adjoint.nk_scan_bwd_segments_plain(*args[:7], gy, H, H, kinds)
    torch.cuda.synchronize()
    assert (nk_scan.nk_scan.launches, nk_scan_adjoint.nk_scan_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    for a, b in zip(grads, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert rel_err(a, b) < (1e-2 if a.dtype == torch.bfloat16 else 1e-4)


@pytest.mark.parametrize("reverse", [False, True])
def test_vanilla_stage0_grouped_scan(dev, reverse):
    """Kernels 13 and 14 at vanilla VMamba-T's stage 0 (56 x 56, d_inner
    192, one direction a call, batch 8, which the routing rule gives no nk
    group) against their plain twins, float32, within 2e-5."""
    g = torch.Generator().manual_seed(62)
    B, L, C = 8, 3136, 192
    assert nk_scan_adjoint.nk_train_supported(B, L, 56, C, 4, 16, "cross2d") is None
    ssg = selective_scan_grouped
    args = _grouped_case(g, torch.float32, B, L, 1, C, 16)
    y, ck = ssg.grouped_scan_fwd(*args, reverse=reverse)
    y_p, ck_p = ssg.grouped_scan_fwd_plain(*args, reverse=reverse)
    gy = randn(g, B, L, C)
    got = ssg.grouped_scan_bwd(*args, ck_p, gy, reverse=reverse)
    want = ssg.grouped_scan_bwd_plain(*args, ck_p, gy, reverse=reverse)
    torch.cuda.synchronize()
    assert rel_err(y, y_p) < 2e-5 and rel_err(ck, ck_p) < 2e-5
    for name, w in want.items():
        assert rel_err(got[name], w) < 2e-5, name


# ---------------------------------------------------------------------------
# kernels 15 and 16: the chunked SSD scan and its adjoint
# ---------------------------------------------------------------------------

def _ssd_case(g, dtype, b, k, L, R, P, N, optional=True):
    """Kernel-layout operands with a trained model's ranges: A in
    [-e^1.5, -1] per head, dt about softplus(-4 +- 1); D, bias and the
    initial state present or None."""
    h = k * R
    args = [randn(g, b, k, L, R, P, dtype=dtype), randn(g, b, k, L, R, dtype=dtype) - 4.0,
            -torch.exp(1.5 * torch.rand(h, generator=g)).cuda(),
            randn(g, b, k, L, N, dtype=dtype), randn(g, b, k, L, N, dtype=dtype)]
    if optional:
        return args + [randn(g, h, P), randn(g, h, scale=0.5), randn(g, b, h, N, P)]
    return args + [None, None, None]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,k,L,R,P,N,optional", [
    (2, 4, 3136, 6, 16, 64, True),      # vmamba_small_m2 stage 0: 49 whole chunks
    (2, 4, 784, 12, 16, 64, True),      # stage 1: the last chunk ragged
    (4, 4, 49, 48, 16, 64, True),       # stage 3: one ragged chunk, several heads per block
    (1, 2, 150, 3, 8, 16, False),       # narrow heads and state; no D, bias or initial state
])
def test_ssd_fwd_and_bwd(dev, dtype, b, k, L, R, P, N, optional):
    """Kernel 15 (with and without checkpoints) and kernel 16 against their
    plain twins on the same operands: y, the final state, the checkpoints,
    and every gradient from the plain checkpoints (float32 sums in other
    orders and atomics: 1e-4 of each output's largest magnitude; bfloat16
    y rounds: 2e-2)."""
    g = torch.Generator().manual_seed(18)
    args = _ssd_case(g, dtype, b, k, L, R, P, N, optional)
    before = (ssd_chunk.ssd_fwd.launches, ssd_chunk.ssd_bwd.launches)
    y, fin, states = ssd_chunk.ssd_fwd(*args, save_states=True)
    y_i, fin_i = ssd_chunk.ssd_fwd(*args)
    y_p, fin_p, states_p = ssd_chunk.ssd_fwd_plain(*args, save_states=True)
    torch.cuda.synchronize()
    assert y.dtype == dtype and states.shape == (b, k * R, -(-L // 64), N, P)
    for got, want in ((y, y_p), (y_i, y_p), (fin, fin_p), (fin_i, fin_p), (states, states_p)):
        assert rel_err(got, want) < TOL[dtype]
    dy, dfin = randn(g, b, k, L, R, P), (randn(g, b, k * R, N, P) if optional else None)
    got = ssd_chunk.ssd_bwd(*args[:7], states_p, dy, dfin)
    want = ssd_chunk.ssd_bwd_plain(*args[:7], states_p, dy, dfin)
    torch.cuda.synchronize()
    assert (ssd_chunk.ssd_fwd.launches, ssd_chunk.ssd_bwd.launches) == \
        (before[0] + 2, before[1] + 1)
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        assert rel_err(got[name], w) < TOL[dtype], name


SSD_PASS_CASES = [
    (2, 4, 3136, 6, 16, 64, True),      # vmamba_small_m2 stage 0: 49 whole chunks
    (4, 4, 49, 48, 16, 64, True),       # stage 3: one ragged chunk, several heads per block
    (1, 2, 150, 3, 8, 16, False),       # narrow heads and state; no D, bias or initial state
    (1, 2, 100, 2, 32, 40, True),       # the widest head, a d_state tile short of 64
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,k,L,R,P,N,optional", SSD_PASS_CASES)
def test_ssd_kernel_passes(dev, dtype, b, k, L, R, P, N, optional):
    """Each pass of kernels 15 and 16 against its plain twin on the same
    inputs: (a) the chunk states forward and adjoint with their decays,
    (b) the state pass in order and in reverse, (c) the chunk scan and the
    chunk gradients; one launch of each per call."""
    g = torch.Generator().manual_seed(23)
    x, dt, A, B, C, D, bias, init = _ssd_case(g, dtype, b, k, L, R, P, N, optional)
    dy, ds = randn(g, b, k, L, R, P), randn(g, b, k * R, -(-L // 64), N, P)
    before = {n: f.launches for n, f in ssd_chunk.PASSES.items()}
    for adjoint, src, mat in ((False, x, B), (True, dy, C)):
        got = ssd_chunk.ssd_chunk_states(src, dt, A, mat, bias, adjoint=adjoint)
        want = ssd_chunk.ssd_chunk_states_plain(src, dt, A, mat, bias, adjoint=adjoint)
        for gt, w in zip(got, want):
            assert rel_err(gt, w) < TOL[dtype]
        for reverse in (False, True):
            plain = ssd_chunk.ssd_state_pass_plain(want[0], want[1], init, reverse)
            got = ssd_chunk.ssd_state_pass(want[0].clone(), want[1], init, reverse)
            for gt, w in zip(got, plain):
                assert rel_err(gt, w) < 1e-5
    states = ssd_chunk.ssd_fwd_plain(x, dt, A, B, C, D, bias, init, save_states=True)[2]
    assert rel_err(ssd_chunk.ssd_chunk_scan(x, dt, A, B, C, D, bias, states),
                   ssd_chunk.ssd_chunk_scan_plain(x, dt, A, B, C, D, bias, states)) < TOL[dtype]
    got = ssd_chunk.ssd_chunk_grads(x, dt, A, B, C, D, bias, states, ds, dy)
    want = ssd_chunk.ssd_chunk_grads_plain(x, dt, A, B, C, D, bias, states, ds, dy)
    torch.cuda.synchronize()
    for name, w in want.items():
        assert rel_err(got[name], w) < TOL[dtype], name
    assert {n: f.launches - before[n] for n, f in ssd_chunk.PASSES.items()} == \
        {"states": 2, "state_pass": 4, "scan": 1, "grads": 1}


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_serial_kernels(dev, dtype):
    """The serial kernels that the chunk-parallel ones replaced (kept for
    timing) still agree with the plain twins."""
    g = torch.Generator().manual_seed(24)
    args = _ssd_case(g, dtype, 2, 4, 784, 12, 16, 64)
    want = ssd_chunk.ssd_fwd_plain(*args, save_states=True)
    for got, w in zip(ssd_chunk.ssd_fwd_serial(*args, save_states=True), want):
        assert rel_err(got, w) < TOL[dtype]
    dy, dfin = randn(g, 2, 4, 784, 12, 16), randn(g, 2, 48, 64, 16)
    got = ssd_chunk.ssd_bwd_serial(*args[:7], want[2], dy, dfin)
    for name, w in ssd_chunk.ssd_bwd_plain(*args[:7], want[2], dy, dfin).items():
        assert rel_err(got[name], w) < TOL[dtype], name


def test_ssd_autograd_card_matches_cpu(dev):
    """`ssd_chunk_scan_heads` under autograd (kernels 15 and 16), y and the
    final state and every gradient, card against the CPU plain twins,
    float32, two chunks, the last ragged."""
    g = torch.Generator().manual_seed(19)
    args = [a.cpu() for a in _ssd_case(g, torch.float32, 2, 2, 100, 3, 16, 64)]
    gy, gfin = torch.randn(2, 2, 100, 3, 16, generator=g), torch.randn(2, 6, 64, 16, generator=g)
    results = []
    for device in ("cpu", "cuda"):
        leaves = [a.detach().to(device).requires_grad_() for a in args]
        y, fin = ssd_chunk.ssd_chunk_scan_heads(*leaves)
        ((y * gy.to(device)).sum() + (fin * gfin.to(device)).sum()).backward()
        results.append([y.detach().cpu(), fin.detach().cpu()] + [a.grad.cpu() for a in leaves])
    for got, want in zip(results[1], results[0]):
        assert rel_err(got, want) < 1e-4


def test_tiny_m2_classifier_card_matches_cpu(dev):
    """A tiny m2 classifier (d_state 64, head width 16), float32: eval
    logits (kernel 15, one launch per block) and one training step's
    gradients (kernels 15 and 16), card against the CPU plain twins."""
    kw = dict(depths=(1, 1, 2, 1), dims=16, num_classes=10, drop_path_rate=0.0)
    model = vssm.vmamba_tiny_m2(device="cpu", seed=3, **kw)
    g = torch.Generator().manual_seed(20)
    x, label = torch.randn(2, 64, 64, 3, generator=g), torch.tensor([1, 7])
    results = []
    for device in ("cpu", "cuda"):
        model.to(device).eval().zero_grad()
        before = (ssd_chunk.ssd_fwd.launches, ssd_chunk.ssd_bwd.launches)
        with torch.no_grad():
            logits = model(x.to(device)).cpu()
        model.train()
        torch.nn.functional.cross_entropy(model(x.to(device)), label.to(device)).backward()
        counts = (ssd_chunk.ssd_fwd.launches - before[0], ssd_chunk.ssd_bwd.launches - before[1])
        results.append([logits] + [p.grad.cpu().clone() for p in model.parameters()])
    assert counts == (10, 5)
    for got, want in zip(results[1], results[0]):
        assert rel_err(got, want) < 1e-4


# ---------------------------------------------------------------------------
# kernels 8, 9 and 10: the two-level scans, the v1 block and the fused
# cross2d core; the SSD kernels past their limits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kinds,N,R,H,W", [
    (("row_f", "col_f", "row_r", "col_r"), 1, 3, 14, 14),  # the v1 block's scan
    (("row_f", "col_f", "row_r", "col_r"), 1, 3, 56, 40),  # several segments per chunk
    (("row_f",), 16, 0, 7, 7),                             # ShallowFuse form
    (("row_f", "col_f", "row_r", "col_r"), 16, 0, 5, 9),   # Cross_SS2Dv5 form
    (("row_f", "row_f", "row_r", "row_r"), 4, 0, 1, 6),    # bidi on a single row
])
def test_scan_two_level(dev, dtype, kinds, N, R, H, W):
    """The two-level scan against the serial plain scan: the products of a
    are reassociated, so float32 agrees to 1e-4 of the largest value."""
    g = torch.Generator().manual_seed(22)
    args = _scan_case(g, dtype, 3, H, W, 70, kinds, N, R)
    got = nk_scan_v1.scan_two_level_cuda(**args, round_rank=bool(R))
    want = nk_scan_v1.scan_two_level_plain(**args, round_rank=bool(R))
    assert rel_err(got, want) < 5 * TOL[torch.float32]


@pytest.mark.parametrize("dtype", DTYPES)
def test_nk_scan_v1(dev, dtype):
    """Kernel 9 at ShallowFuse's K=1 row_f and Cross_SS2Dv5's K=4 forms."""
    g = torch.Generator().manual_seed(23)
    H, W, D, N = 7, 7, 96, 16
    for B, kinds in ((1, ("row_f",)), (3, nk_scan.scan_mode_kinds("cross2d"))):
        K, L = len(kinds), H * W
        args = (randn(g, B, L, D, dtype=dtype), randn(g, B, L, K * D, dtype=dtype, scale=0.5),
                randn(g, B, L, K * N, dtype=dtype), randn(g, B, L, K * N, dtype=dtype),
                decay_rates(K, N, D).reshape(K * N, D), randn(g, K, D), randn(g, K, D, scale=0.5),
                H, W, kinds)
        before = nk_scan_v1.nk_scan_v1.launches
        got = nk_scan_v1.nk_scan_v1(*args)
        assert nk_scan_v1.nk_scan_v1.launches == before + 1 and got.dtype == dtype
        assert rel_err(got, nk_scan_v1.nk_scan_v1_plain(*args)) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,W,d", [(14, 14, 32), (7, 7, 64), (9, 5, 16)])
def test_vss_block_v1(dev, dtype, H, W, d):
    """Kernel 8, one block, against the sequence's plain version (2
    images)."""
    g = torch.Generator().manual_seed(24)
    block = VSSBlock(d, generator=g).eval().cuda()
    p = vss_block_v1.pack_vss_block_v1_params(block, dtype)
    x = randn(g, 2, H * W, d, dtype=dtype)
    before = vss_block_v1.vss_block_v1.launches
    got = vss_block_v1.vss_block_v1(x, p, H, W)
    assert vss_block_v1.vss_block_v1.launches == before + 1 and got.dtype == dtype
    assert rel_err(got, vss_block_v1.vss_block_v1_plain(x, p, H, W)) < TOL[dtype]


# kernel 8's stage maps (H, d): XFMamba-S's and XFMamba-B's stages 2 and 3
V1_MAPS = [(14, 384), (7, 768), (14, 512), (7, 1024)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("H,d", V1_MAPS)
def test_vss_block_v1_at_the_stage_maps(dev, dtype, n, H, d):
    """The cooperative kernel against its plain twin at the stage-2/3 maps
    of both models, 2 and 4 images (5e-2 in bfloat16 as chip_smoke.py
    holds it: rounding flips chain through ten phases; 1e-4 in
    float32)."""
    g = torch.Generator().manual_seed(40 + H + n)
    block = VSSBlock(d, generator=g).eval().cuda()
    p = vss_block_v1.pack_vss_block_v1_params(block, dtype)
    x = randn(g, n, H * H, d, dtype=dtype)
    with torch.no_grad():
        got = vss_block_v1.vss_block_v1(x, p, H, H)
        want = vss_block_v1.vss_block_v1_phases_plain(x, p, H, H)
    assert rel_err(got, want) < (1e-4 if dtype == torch.float32 else 5e-2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_vss_block_v1_rows_short_of_the_grid(dev, dtype):
    """A 3 x 5 map of one image: 15 rows, so most of the grid's blocks have
    no item in any phase (and the 64-row tiles are mostly past the edge)."""
    g = torch.Generator().manual_seed(41)
    block = VSSBlock(32, generator=g).eval().cuda()
    p = vss_block_v1.pack_vss_block_v1_params(block, dtype)
    x = randn(g, 1, 15, 32, dtype=dtype)
    with torch.no_grad():
        got = vss_block_v1.vss_block_v1(x, p, 3, 5)
        want = vss_block_v1.vss_block_v1_phases_plain(x, p, 3, 5)
    assert rel_err(got, want) < TOL[dtype]


def test_vss_block_v1_is_one_device_launch(dev):
    """One call of kernel 8 launches one kernel on the card (the workspace
    is kept across calls of one shape), and its phase clock covers the
    ten phases."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator().manual_seed(42)
    block = VSSBlock(384, generator=g).eval().cuda()
    p = vss_block_v1.pack_vss_block_v1_params(block, torch.bfloat16)
    x = randn(g, 2, 196, 384, dtype=torch.bfloat16)
    with torch.no_grad():
        vss_block_v1.vss_block_v1(x, p, 14, 14)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            vss_block_v1.vss_block_v1(x, p, 14, 14)
            torch.cuda.synchronize()
        phases = vss_block_v1.phase_ns(x, p, 14, 14)
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "vss_block_v1_kernel" in kernels[0], kernels
    assert list(phases) == list(vss_block_v1.PHASES) and all(v > 0 for v in phases.values())


@pytest.mark.parametrize("dtype", DTYPES)
def test_vss_block_v1_sequence(dev, dtype):
    """The earlier design, the launch sequence, against its plain version."""
    g = torch.Generator().manual_seed(43)
    block = VSSBlock(64, generator=g).eval().cuda()
    p = vss_block_v1.pack_vss_block_v1_params(block, dtype)
    x = randn(g, 2, 49, 64, dtype=dtype)
    with torch.no_grad():
        got = vss_block_v1.vss_block_v1_sequence(x, p, 7, 7)
    assert rel_err(got, vss_block_v1.vss_block_v1_plain(x, p, 7, 7)) < TOL[dtype]


def _cross_case(g, dtype, B, H, W, D, N):
    return (randn(g, B, H, W, D, dtype=dtype), randn(g, B, H, W, 4, D, dtype=dtype) - 4.0,
            randn(g, B, H, W, 4, N, dtype=dtype), randn(g, B, H, W, 4, N, dtype=dtype),
            -torch.exp(1.5 * torch.rand(4, D, N, generator=g)).cuda(), randn(g, 4, D),
            randn(g, 4, D, scale=0.5))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,W,D,N", [(2, 56, 56, 32, 1), (2, 14, 14, 64, 1),
                                       (3, 7, 9, 48, 16), (1, 5, 3, 40, 4)])
def test_fused_cross_scan(dev, dtype, B, H, W, D, N):
    """Kernel 10's first design (the two-level scan of
    ``csrc/scan_two_level.cu`` and its merge) against the plain twin
    (float32 merge of the directions, each rounded to the input dtype for
    N = 1)."""
    g = torch.Generator().manual_seed(25)
    args = _cross_case(g, dtype, B, H, W, D, N)
    got = fused_cross_scan._fused_cross_scan_first(*args)
    assert got.dtype == torch.float32
    assert rel_err(got, fused_cross_scan.fused_cross_scan_plain(*args)) < TOL[dtype]


# kernel 9's geometries of phase 3c: (images, kinds, D) at 7 x 7, N 16
WHOLE_MAP_K9 = [(1, 1, 1536), (3, 4, 1536), (1, 1, 2048), (3, 4, 2048), (12, 1, 1536),
                (36, 4, 1536)]


def _k9_args(g, dtype, n, K, D, H=7, W=7, N=16):
    L = H * W
    kinds = ("row_f",) if K == 1 else nk_scan.scan_mode_kinds("cross2d")
    return (randn(g, n, L, D, dtype=dtype), randn(g, n, L, K * D, dtype=dtype, scale=0.5),
            randn(g, n, L, K * N, dtype=dtype), randn(g, n, L, K * N, dtype=dtype),
            -torch.exp(1.5 * torch.rand(K * N, D, generator=g)).cuda(), randn(g, K, D),
            randn(g, K, D, scale=0.5) - 3.0, H, W, kinds)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,K,D", WHOLE_MAP_K9)
def test_whole_map_kernel9(dev, dtype, n, K, D):
    """Kernel 9 (``csrc/scan_whole_map.cu``) at phase 3c's geometries
    against its plain twin, one counted call, the same bits on two runs."""
    g = torch.Generator().manual_seed(27)
    args = _k9_args(g, dtype, n, K, D)
    before = nk_scan_v1.nk_scan_v1.launches
    got = nk_scan_v1.nk_scan_v1(*args)
    assert nk_scan_v1.nk_scan_v1.launches == before + 1 and got.dtype == dtype
    assert rel_err(got, nk_scan_v1.nk_scan_v1_plain(*args)) < TOL[dtype]
    assert torch.equal(got, nk_scan_v1.nk_scan_v1(*args))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,W,D,N", [(6, 7, 7, 1536, 1), (2, 7, 7, 1536, 16),
                                       (2, 56, 56, 192, 1), (2, 56, 56, 192, 16),
                                       (2, 28, 28, 384, 1), (1, 5, 3, 40, 4)])
def test_whole_map_kernel10(dev, dtype, B, H, W, D, N):
    """Kernel 10 (``csrc/scan_whole_map.cu``; the 28 x 28 and 56 x 56 maps
    take the chunked plan) against its plain twin, one counted call, float32
    out, the same bits on two runs."""
    g = torch.Generator().manual_seed(28)
    args = _cross_case(g, dtype, B, H, W, D, N)
    before = fused_cross_scan.fused_cross_scan.launches
    got = fused_cross_scan.fused_cross_scan(*args)
    assert fused_cross_scan.fused_cross_scan.launches == before + 1
    assert got.dtype == torch.float32
    assert rel_err(got, fused_cross_scan.fused_cross_scan_plain(*args)) < TOL[dtype]
    assert torch.equal(got, fused_cross_scan.fused_cross_scan(*args))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", [9, 10])
def test_whole_map_large_map_plan(dev, monkeypatch, dtype, kernel):
    """The chunked plan (3 chunks, slabs of 8), forced by a shared-memory
    budget below the whole plan's blocks, at kernel 9's Cross_SS2Dv5 map
    and kernel 10's N = 1 map: the whole plan's bits."""
    g = torch.Generator().manual_seed(29)
    if kernel == 9:
        fn, args, N = nk_scan_v1.nk_scan_v1, _k9_args(g, dtype, 3, 4, 96), 16
    else:
        fn, args, N = fused_cross_scan.fused_cross_scan, _cross_case(g, dtype, 2, 7, 7, 96, 1), 1
    whole = fn(*args)
    smem = build.library().xfm_whole_map_smem
    bf16 = int(dtype == torch.bfloat16)
    budget = smem(0, 4, 49, 20, N, 8, 49, bf16)
    assert all(smem(1, 4, 49, 49, N, s, 49, bf16) > budget for s in scan_whole_map.SLABS)
    scan_whole_map._plan.cache_clear()
    monkeypatch.setattr(scan_whole_map, "WHOLE_MAP_SMEM", budget)
    monkeypatch.setattr(scan_whole_map, "CHUNK_SLABS", (8,))
    monkeypatch.setattr(scan_whole_map, "CHUNK", 20)
    monkeypatch.setattr(scan_whole_map.scan_whole_map_cuda, "by_plan", {})
    try:
        assert torch.equal(fn(*args), whole)
    finally:
        scan_whole_map._plan.cache_clear()
    assert scan_whole_map.scan_whole_map_cuda.by_plan == {"chunked x3, slab 8": 1}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", [9, 10])
def test_whole_map_past_the_accumulator(dev, dtype, kernel):
    """Maps whose parts do not fit in shared memory at one channel (kernel
    9 at 112 x 112, K 4, N 16; kernel 10 at 128 x 128, N 1), which the
    earlier plan refused: the banded plan (two bands at one channel) against
    the plain twins, one counted call."""
    g = torch.Generator().manual_seed(30)
    if kernel == 9:
        H, args = 112, _k9_args(g, dtype, 1, 4, 64, H=112, W=112)
        fn, plain = nk_scan_v1.nk_scan_v1, nk_scan_v1.nk_scan_v1_plain
    else:
        H, args = 128, _cross_case(g, dtype, 1, 128, 128, 32, 1)
        fn, plain = fused_cross_scan.fused_cross_scan, fused_cross_scan.fused_cross_scan_plain
    scan_whole_map.scan_whole_map_cuda.by_plan.clear()
    got = fn(*args)
    torch.cuda.synchronize()
    assert rel_err(got, plain(*args)) < TOL[dtype]
    L = H * H
    assert scan_whole_map.scan_whole_map_cuda.by_plan == {
        f"chunked x{-(-L // scan_whole_map.CHUNK)}, slab 1, 2 bands": 1}


def test_core_dispatch_n1_card_matches_cpu(dev):
    """`core_dispatch` at d_state 1 (kernel 10 forward, the recompute
    through kernels 13/14 backward), output and every input gradient, card
    against the CPU plain twins; bidi at N = 1 does not take kernel 10."""
    g = torch.Generator().manual_seed(26)
    args = [a.cpu() for a in _cross_case(g, torch.float32, 2, 6, 5, 24, 1)]
    gy = torch.randn(2, 6, 5, 24, generator=g)
    results = []
    for device in ("cpu", "cuda"):
        leaves = [a.detach().to(device).requires_grad_() for a in args]
        before = fused_cross_scan.fused_cross_scan.launches
        y = core_dispatch(*leaves)
        y.backward(gy.to(device))
        results.append([y.detach().cpu()] + [a.grad.cpu() for a in leaves])
    assert fused_cross_scan.fused_cross_scan.launches == before + 1
    for got, want in zip(results[1], results[0]):
        assert rel_err(got, want) < 1e-4
    before = fused_cross_scan.fused_cross_scan.launches
    core_dispatch(*(a.cuda() for a in args), scan_mode="bidi")
    assert fused_cross_scan.fused_cross_scan.launches == before


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_past_the_kernel_limits(dev, dtype):
    """d_state 128 and head width 64, which the gate admits: the tiled
    route (2 x 2 launches of each kernel) against the untiled plain twins."""
    g = torch.Generator().manual_seed(27)
    args = _ssd_case(g, dtype, 2, 4, 200, 2, 64, 128)
    before = (ssd_chunk.ssd_fwd.launches, ssd_chunk.ssd_bwd.launches)
    y, fin, states = ssd_chunk.ssd_fwd_tiled(*args, save_states=True)
    want = ssd_chunk.ssd_fwd_plain(*args, save_states=True)
    for got, w in zip((y, fin, states), want):
        assert rel_err(got, w) < TOL[dtype]
    dy, dfin = randn(g, 2, 4, 200, 2, 64), randn(g, 2, 8, 128, 64)
    got = ssd_chunk.ssd_bwd_tiled(*args[:7], want[2], dy, dfin)
    torch.cuda.synchronize()
    assert (ssd_chunk.ssd_fwd.launches, ssd_chunk.ssd_bwd.launches) == \
        (before[0] + 4, before[1] + 4)
    for name, w in ssd_chunk.ssd_bwd_plain(*args[:7], want[2], dy, dfin).items():
        assert rel_err(got[name], w) < TOL[dtype], name


def test_v1_route_tiny_model_card_matches_cpu(dev):
    """A one-study bfloat16 forward of a small XFMamba (maps 28, 14, 7, 4)
    whose stages 1 and 2 take kernel 8, stages 0 and 3 kernel 1, and whose
    fusion scans take kernel 9, card against the CPU plain twins."""
    g = torch.Generator().manual_seed(28)
    model = TwoViewXFMamba(model_type="tiny", hidden_dim=128, d_state=4,
                           backbone_overrides=dict(depths=(2, 2, 2, 2), dims=16),
                           generator=g).eval()
    xa, xb = (torch.randn(1, 112, 112, 1, generator=g).bfloat16() for _ in range(2))
    with torch.no_grad():
        want = model(xa, xb)
        model.cuda()
        fns = (vss_stage.vss_stage, vss_block_v1.vss_block_v1, nk_scan_v1.nk_scan_v1)
        counts = [f.launches for f in fns]
        got = model(xa.cuda(), xb.cuda()).cpu()
    assert [f.launches - c for f, c in zip(fns, counts)] == [2, 4, 3]
    assert rel_err(got, want) < 5e-2


# ---------------------------------------------------------------------------
# kernels 17-21: the ablation kernels behind JAX's switches
# ---------------------------------------------------------------------------

def _nk_case(g, dtype, B, H, W, D, kinds, N):
    K, L = len(kinds), H * W
    return (randn(g, B, L, D, dtype=dtype), randn(g, B, L, K * D, dtype=dtype, scale=0.5),
            randn(g, B, L, K * N, dtype=dtype), randn(g, B, L, K * N, dtype=dtype),
            decay_rates(K, N, D).reshape(K * N, D), randn(g, K, D), randn(g, K, D, scale=0.5),
            H, W, kinds)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scan_mode", ["cross2d", "unidi", "bidi"])
@pytest.mark.parametrize("N", [4, 16])
def test_nk_scan_ablations(dev, dtype, scan_mode, N):
    """Kernels 17 (group 8) and 18 (groups 8 and 2) against their plain
    twins and their first designs (``nk_scan_v4_first`` /
    ``nk_scan_v3_first``) on 7 x 7 maps of 256 channels, 8 images (D not a
    multiple of any slab at 200), and on a 40 x 40 map of 64 channels, which
    takes the chunked plan; two runs give the same bits."""
    g = torch.Generator().manual_seed(40)
    kinds = nk_scan.scan_mode_kinds(scan_mode)
    plans = ablation_scan.ablation_scan_cuda.by_plan
    for H, D in ((7, 256), (7, 200), (40, 64)):
        args = _nk_case(g, dtype, 8, H, H, D, kinds, N)
        for fn, plain, first, group in (
                (nk_scan_v4.nk_scan_v4, nk_scan_v4.nk_scan_v4_plain, nk_scan_v4.nk_scan_v4_first, 8),
                (nk_scan_wide.nk_scan_v3, nk_scan_wide.nk_scan_v3_plain,
                 nk_scan_wide.nk_scan_v3_first, 8),
                (nk_scan_wide.nk_scan_v3, nk_scan_wide.nk_scan_v3_plain,
                 nk_scan_wide.nk_scan_v3_first, 2)):
            before = fn.launches
            plans.clear()
            got, again = fn(*args, group=group), fn(*args, group=group)
            torch.cuda.synchronize()
            assert fn.launches == before + 2 and got.dtype == dtype
            assert torch.equal(got, again), (fn.__name__, D)
            assert all(("chunked" in p) == (H > 7) for p in plans), plans
            assert rel_err(got, plain(*args)) < TOL[dtype], (fn.__name__, D, group)
            assert rel_err(got, first(*args)) < TOL[dtype], (fn.__name__, D, group)


@pytest.mark.parametrize("dtype", DTYPES)
def test_nk_scan_ablations_past_the_accumulator(dev, monkeypatch, dtype):
    """Kernels 17 and 18 where the chunked plan's float32 accumulator does
    not hold the map: a 256 x 256 cross2d map of 16 channels on 8 images
    (two bands at one channel, the plan the port picks) against kernel 2 on
    the same inputs; and a 40 x 40 map whose shared-memory budget is lowered
    to leave room for 500 positions (four bands at one channel), the bits
    of the plan that holds the map; two runs give the same bits."""
    g = torch.Generator().manual_seed(43)
    kinds = nk_scan.scan_mode_kinds("cross2d")
    plans = ablation_scan.ablation_scan_cuda.by_plan
    big = _nk_case(g, dtype, 8, 256, 256, 16, kinds, 16)
    small = _nk_case(g, dtype, 8, 40, 40, 64, kinds, 16)
    want = nk_scan.nk_scan(*big)
    for kernel, fn in (("v4", nk_scan_v4.nk_scan_v4), ("v3", nk_scan_wide.nk_scan_v3)):
        plans.clear()
        got, again = fn(*big, group=8), fn(*big, group=8)
        assert torch.equal(got, again)
        assert rel_err(got, want) < TOL[dtype], kernel
        assert plans == {f"{kernel} chunked x1024, slab 1, 2 bands": 2}
        held = fn(*small, group=8)
        code = ablation_scan.KERNELS.index(kernel)
        budget = build.library().xfm_nk_ablation_smem(
            code, 0, 4, 1600, ablation_scan.CHUNK, 16, 1, 500, int(dtype == torch.bfloat16))
        ablation_scan._plan.cache_clear()
        monkeypatch.setattr(ablation_scan, "ABLATION_SMEM", budget)
        try:
            plans.clear()
            assert torch.equal(fn(*small, group=8), held), kernel
            assert plans == {f"{kernel} chunked x25, slab 1, 4 bands": 1}
        finally:
            monkeypatch.undo()
            ablation_scan._plan.cache_clear()


def test_nk_scan_routes_to_the_ablations(dev, monkeypatch):
    """With FUSED_V4 on, `nk_scan` launches kernel 17 at group 8 and kernel
    2 at group 4 (kernel 17's gate); with FUSED_V3 on, kernel 18 where D is a
    multiple of 128, else kernel 2; both off, kernel 2."""
    g = torch.Generator().manual_seed(41)
    fns = (nk_scan.nk_scan, nk_scan_v4.nk_scan_v4, nk_scan_wide.nk_scan_v3)
    cases = [((True, False), 256, 8, [0, 1, 0]), ((True, False), 256, 4, [1, 0, 0]),
             ((False, True), 256, 8, [0, 0, 1]), ((False, True), 96, 8, [1, 0, 0]),
             ((False, False), 256, 8, [1, 0, 0])]
    for (v4, v3), D, group, want in cases:
        monkeypatch.setattr(nk_scan_v4, "FUSED_V4", v4)
        monkeypatch.setattr(nk_scan, "FUSED_V3", v3)
        args = _nk_case(g, torch.float32, 8, 7, 7, D, nk_scan.scan_mode_kinds("cross2d"), 16)
        before = [f.launches for f in fns]
        got = nk_scan.nk_scan(*args, group=group)
        assert [f.launches - b for f, b in zip(fns, before)] == want, (v4, v3, D, group)
        assert rel_err(got, nk_scan.nk_scan_plain(*args)) < TOL[torch.float32]
    with pytest.raises(ValueError):
        nk_scan_v4.nk_scan_v4(*args, group=4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C", [48, 96, 192, 768, 6143, 16384])
@pytest.mark.parametrize("act", [False, True])
def test_ln_act_kernels(dev, dtype, C, act):
    """Kernels 19 and 20 against their plain twins, and kernel 21 (dx,
    dscale, dbias) against its own, at a pixel count that fills no whole
    block of kernel 21 nor whole warps of kernel 20 (3 x 11 x 13 pixels);
    C 6143 and 16384 take the row path (kernel 21's tile, or a block's
    values, past the staged plan)."""
    g = torch.Generator().manual_seed(42)
    x = randn(g, 3, 11, 13, C, dtype=dtype, scale=2.0) + 0.5
    scale, bias = 1 + randn(g, C, scale=0.1), randn(g, C, scale=0.1)
    before = (pe_fused.ln_act_fused.launches, seg_ln.seg_ln_fwd.launches,
              seg_ln.seg_ln_bwd.launches)
    want = pe_fused.ln_act_fused_plain(x, scale, bias, act)
    for got in (pe_fused.ln_act_fused(x, scale, bias, act), seg_ln.seg_ln_fwd(x, scale, bias,
                                                                              act=act)):
        assert got.dtype == dtype and rel_err(got, want) < TOL[dtype]
    gy = randn(g, *x.shape, dtype=dtype)
    got = seg_ln.seg_ln_bwd(x, scale, bias, gy, act=act)
    torch.cuda.synchronize()
    assert (pe_fused.ln_act_fused.launches, seg_ln.seg_ln_fwd.launches,
            seg_ln.seg_ln_bwd.launches) == tuple(b + 1 for b in before)
    assert got[0].dtype == dtype
    for a, w in zip(got, seg_ln.seg_ln_bwd_plain(x, scale, bias, gy, act=act)):
        assert rel_err(a, w) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C", [48, 96, 192])
def test_ln_kernels_first_design_and_bits(dev, dtype, C):
    """The first design's kernels (``csrc/ln_act_v1.cu``, kept for the
    old-against-new timings) against the plain twins; the redesigned
    backward gives the same bits on two runs, and so does it with x and g
    one element past a 16-byte boundary (every tile staged element by
    element) against the aligned copies."""
    g = torch.Generator().manual_seed(44)
    x = randn(g, 3, 37, 41, C, dtype=dtype, scale=2.0) + 0.5
    scale, bias = 1 + randn(g, C, scale=0.1), randn(g, C, scale=0.1)
    gy = randn(g, *x.shape, dtype=dtype)
    want = pe_fused.ln_act_fused_plain(x, scale, bias, True)
    for got in (pe_fused.ln_act_fused_first(x, scale, bias, True),
                seg_ln.seg_ln_fwd_first(x, scale, bias, act=True)):
        assert rel_err(got, want) < TOL[dtype]
    for a, w in zip(seg_ln.seg_ln_bwd_first(x, scale, bias, gy, act=True),
                    seg_ln.seg_ln_bwd_plain(x, scale, bias, gy, act=True)):
        assert rel_err(a, w) < TOL[dtype]
    new = seg_ln.seg_ln_bwd(x, scale, bias, gy, act=True)
    for a, b in zip(new, seg_ln.seg_ln_bwd(x, scale, bias, gy, act=True)):
        assert torch.equal(a, b)
    store = torch.empty(2, x.numel() + 1, dtype=dtype, device=dev)
    xu, gu = (store[i, 1:].view(x.shape) for i in range(2))
    xu.copy_(x), gu.copy_(gy)
    assert xu.data_ptr() % 16 and gu.data_ptr() % 16
    assert torch.equal(seg_ln.seg_ln_fwd(xu, scale, bias, act=True),
                       seg_ln.seg_ln_fwd(x, scale, bias, act=True))
    for a, b in zip(seg_ln.seg_ln_bwd(xu, scale, bias, gu, act=True), new):
        assert torch.equal(a, b)


def test_seg_ln_act_autograd_card_matches_cpu(dev):
    """The differentiable op (kernels 20 and 21) on the card against the
    CPU plain twins, float32, at 9000 pixels of C 48 (a ragged last block):
    output and the gradients of x, scale and bias."""
    g = torch.Generator().manual_seed(43)
    x = torch.randn(9000, 48, generator=g)
    scale, bias = 1 + 0.1 * torch.randn(48, generator=g), 0.1 * torch.randn(48, generator=g)
    gy = torch.randn(9000, 48, generator=g)
    results = []
    for device in ("cpu", "cuda"):
        leaves = [t.to(device).detach().requires_grad_() for t in (x, scale, bias)]
        y = seg_ln.seg_ln_act(*leaves, 48, act=True)
        y.backward(gy.to(device))
        results.append([y.detach().cpu()] + [t.grad.cpu() for t in leaves])
    for got, want in zip(results[1], results[0]):
        assert rel_err(got, want) < 1e-4


# ---------------------------------------------------------------------------
# the bfloat16 block's tensor-core GEMM and chunked cross2d scans
# ---------------------------------------------------------------------------

def _tc(got_fn, want_fn, tol=TOL[torch.bfloat16]):
    """Run the tensor-core kernel (counting one launch) and its plain twin."""
    before = primitives.gemm_tc_cuda.launches
    got = got_fn()
    torch.cuda.synchronize()
    assert primitives.gemm_tc_cuda.launches == before + 1
    assert rel_err(got, want_fn()) < tol


@pytest.mark.parametrize("a_major", ["k", "mn"])
@pytest.mark.parametrize("b_major", ["k", "mn"])
@pytest.mark.parametrize("M,N,K", [(1003, 200, 96), (20011, 40, 72), (37, 6, 4100),
                                   (6, 200, 8200)])
def test_gemm_tc_layouts(dev, a_major, b_major, M, N, K):
    """Each layout pair, ragged tiles on every side, float32 and bfloat16
    outputs; without an epilogue a long K splits (and a short M swaps)."""
    g = torch.Generator().manual_seed(60)
    bf16 = torch.bfloat16

    def operand(rows, major):
        t = randn(g, rows, K, dtype=bf16) if major == "k" else randn(g, K, rows, dtype=bf16).t()
        assert primitives._major(t) == major
        return t

    a, b = operand(M, a_major), operand(N, b_major)
    for out_dtype in (torch.float32, bf16):
        _tc(lambda: primitives.gemm_tc_cuda(a, b, out_dtype=out_dtype),
            lambda: primitives.gemm_ab_plain(a, b, out_dtype=out_dtype))


@pytest.mark.parametrize("res_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_gemm_tc_epilogues(dev, res_dtype, out_dtype):
    """bias, GELU, the per-sample row scale and a residual of either dtype,
    in that order, into either output dtype, and a residual aliasing out."""
    g = torch.Generator().manual_seed(61)
    bf16 = torch.bfloat16
    M, N, K = 7 * 143, 384, 96
    a, w = randn(g, M, K, dtype=bf16), randn(g, N, K, dtype=bf16, scale=0.1)
    bias, res = randn(g, N), randn(g, M, N, dtype=res_dtype)
    scale = (torch.rand(7, generator=g) < 0.5).float().cuda() / 0.5
    for kw in (dict(bias=bias, gelu=True), dict(bias=bias, residual=res, scale=scale),
               dict(residual=res, scale=scale)):
        _tc(lambda: primitives.gemm_tc_cuda(a, w, out_dtype=out_dtype, **kw),
            lambda: primitives.gemm_ab_plain(a, w, out_dtype=out_dtype, **kw))
    du = randn(g, M, N)
    want = primitives.gemm_ab_plain(a, w, residual=du)
    primitives.gemm_tc_cuda(a, w, residual=du, out=du)
    assert rel_err(du, want) < TOL[bf16]


@pytest.mark.parametrize("R", [6, 12, 24, 8])
def test_gemm_tc_block_backward_products(dev, R):
    """The block backward's bfloat16 products as it takes them: the rank
    gradients into their float32 columns of dxdbl, dw_dt from the rank
    slices (12-byte offsets at R = 6: element-wise loads), the x_proj
    gradient from dxdbl^T, and du += dxdbl @ w_xp in place."""
    g = torch.Generator().manual_seed(62)
    bf16, f32 = torch.bfloat16, torch.float32
    M, di = 4 * 784 + 5, 16 * R
    xdbl = randn(g, M, 4 * R + 8, dtype=bf16)
    dz = randn(g, M, 4, di, dtype=bf16)
    w_dt = randn(g, 4, R, di, dtype=bf16, scale=0.3)
    dx = torch.zeros(M, 4 * R + 8, dtype=f32, device="cuda")
    for k in range(4):
        sl = slice(k * R, (k + 1) * R)
        _tc(lambda: primitives.gemm_ab_cuda(dz[:, k], w_dt[k], out=dx[:, sl]),
            lambda: primitives.gemm_ab_plain(dz[:, k], w_dt[k], out_dtype=f32))
        _tc(lambda: primitives.gemm_ab_cuda(xdbl[:, sl].t(), dz[:, k].t(), out_dtype=f32),
            lambda: primitives.gemm_ab_plain(xdbl[:, sl].t(), dz[:, k].t(), out_dtype=f32))
    d16, u = dx.to(bf16), randn(g, M, di, dtype=bf16)
    w_xp = randn(g, 4 * R + 8, di, dtype=bf16, scale=0.2)
    _tc(lambda: primitives.gemm_ab_cuda(d16.t(), u.t(), out_dtype=f32),
        lambda: primitives.gemm_ab_plain(d16.t(), u.t(), out_dtype=f32))
    du = randn(g, M, di)
    want = primitives.gemm_ab_plain(d16, w_xp.t(), residual=du)
    _tc(lambda: primitives.gemm_ab_cuda(d16, w_xp.t(), residual=du, out=du), lambda: want)


def _cross2d_case(g, dtype, n, H, d):
    """The block's scan operands at a stage map: D = 2d, R = ceil(d / 16),
    deltas about softplus(-4 +- 1), A in [-e^1.5, -1]."""
    D, R, L = 2 * d, -(-d // 16), H * H
    return (randn(g, n, L, D, dtype=dtype), randn(g, n, L, 4 * R + 8, dtype=dtype),
            -torch.exp(1.5 * torch.rand(4, 1, D, generator=g)).cuda(),
            randn(g, 4, D, scale=0.5) - 4.0, randn(g, D), randn(g, 4, R, D, scale=R ** -0.5),
            H, H)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,d", [(56, 96), (28, 192), (14, 384), (7, 768)])
def test_cross2d_scan_chunked(dev, dtype, H, d):
    """The stage's scan and adjoint against their plain twins (the same
    checkpoint chunks and merge) at the four XFMamba-S stage maps: y, the
    checkpoints, du, dw_dt, dA, dbias, dDsum and the projections' gradient
    (dB / dC columns within 1e-3; the rank columns, like dw_dt, products of
    dz that the twin rounds to bfloat16 where the kernel does, within 1e-2
    in bfloat16).  No GEMM is launched, and two runs give the same bits."""
    g = torch.Generator().manual_seed(63)
    args = _cross2d_case(g, dtype, 4, H, d)
    u, xdbl = args[0], args[1]
    R = args[5].shape[1]
    y, ck = cross2d_scan.cross2d_scan(*args, checkpoints=True)
    y_p, ck_p = cross2d_scan.cross2d_scan_plain(*args, checkpoints=True)
    assert rel_err(y, y_p) < 1e-4 and rel_err(ck, ck_p) < 1e-4
    gy = randn(g, *u.shape)
    dx, dx_p, dx_2 = (torch.zeros(u.shape[0] * u.shape[1], xdbl.shape[-1], device="cuda")
                      for _ in range(3))
    gemms = (primitives.gemm_simt_cuda.launches, primitives.gemm_tc_cuda.launches)
    got = cross2d_scan.cross2d_scan_bwd(*args, gy, ck_p, dx)
    again = cross2d_scan.cross2d_scan_bwd(*args, gy, ck_p, dx_2)
    assert (primitives.gemm_simt_cuda.launches, primitives.gemm_tc_cuda.launches) == gemms
    assert all(torch.equal(got[k], again[k]) for k in got) and torch.equal(dx, dx_2)
    want = cross2d_scan.cross2d_scan_bwd_plain(*args, gy, ck_p, dx_p)
    assert set(want) - set(got) == {"dz"}
    for name in got:
        tol = 1e-2 if name == "dw_dt" and dtype == torch.bfloat16 else 1e-4
        assert rel_err(got[name], want[name]) < tol, name
    assert rel_err(dx[:, 4 * R:], dx_p[:, 4 * R:]) < 1e-3
    assert rel_err(dx[:, :4 * R], dx_p[:, :4 * R]) < (1e-2 if dtype == torch.bfloat16 else 1e-4)


def test_bf16_block_routes(dev):
    """A bfloat16 block's forward and backward launch the tensor-core GEMM
    for every product and the chunked scans, and no SIMT GEMM or serial
    scan."""
    g = torch.Generator().manual_seed(64)
    p, x, m1 = _block_case(g, 32, torch.bfloat16)
    fns = (primitives.gemm_tc_cuda, primitives.gemm_simt_cuda, cross2d_scan.cross2d_scan,
           cross2d_scan.cross2d_scan_bwd, nk_scan.selective_scan_cuda,
           nk_scan.selective_scan_bwd_cuda)
    before = [f.launches for f in fns]
    with torch.no_grad():
        vss_block_train.vss_block_bwd(x, p, 8, 6, m1, randn(g, *x.shape))
    torch.cuda.synchronize()
    # the recompute's 3 GEMMs; out_proj 2, x_proj 2, in_proj 2 (the rank
    # gradients are the adjoint scan's own products)
    assert [f.launches - b for f, b in zip(fns, before)] == [9, 0, 1, 1, 0, 0]


# ---------------------------------------------------------------------------
# the device preprocessing kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage_name,staged,size", [("mura", 224, 224), ("mura", 288, 256),
                                                    ("chexpert", 37, 41), ("ddsm", 64, 48)])
def test_device_preprocess_matches_plain(dev, stage_name, staged, size):
    """``csrc/device_preprocess.cu`` against its plain version, train and
    eval transforms, bit for bit, one counted launch a call; an operand
    that requires a gradient is refused while autograd records."""
    stage = getattr(dp, f"{stage_name}_device_preprocess")((size, size), seed=1)
    g = torch.Generator().manual_seed(staged)
    u8 = torch.randint(0, 256, (6, staged, staged, 1), generator=g, dtype=torch.uint8)
    rows = stage.rows(stage.draw_params(6, g))
    norm = {} if stage.normalize_mean is None else {"mean": stage.normalize_mean,
                                                    "std": stage.normalize_std}
    before = op.device_preprocess.launches
    got = stage.train_batch(u8.to(dev), rows)
    want = op.device_preprocess_plain(u8, (size, size), rows, stage.crop_size,
                                      bool(stage.rotation), **norm)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(stage.eval_batch(u8.to(dev)).cpu(),
                       op.device_preprocess_plain(u8, (size, size), **norm))
    assert op.device_preprocess.launches == before + 2
    with pytest.raises(RuntimeError, match="no gradient"):
        stage.train_batch(u8.to(dev), rows.to(dev).requires_grad_())



# ---------------------------------------------------------------------------
# utils.profiling.trace and data parallelism on the card
# ---------------------------------------------------------------------------

def test_trace_keeps_a_kernels_device_events_after_others(dev, tmp_path):
    """``utils.profiling.trace`` of ten calls of the device preprocessing
    kernel after a float32 XFMamba-T train step, a profile of three more
    and, until the trace without its guard has lost one of its first events
    (the profiler drops the first device events of a session, about one
    more every 16 s of profiling on an H100 host) or 60 s have passed, more
    calls: every call's kernel is in ``trace``'s trace, with its device time
    in ``key_averages``."""
    import json
    import time
    from torch.profiler import ProfilerActivity, profile
    from xfmamba_tpu_torch.models.tops import two_view_xfmamba
    from xfmamba_tpu_torch.train import loop
    from xfmamba_tpu_torch.train.config import TrainConfig
    from xfmamba_tpu_torch.utils import profiling
    model = two_view_xfmamba("tiny", seed=0)
    step, _ = loop.make_train_step(model, loop.make_optimizer(TrainConfig(), model.parameters()),
                                   multilabel=False)
    g = torch.Generator().manual_seed(1)
    batch = {"image1": randn(g, 8, 224, 224, 1), "image2": randn(g, 8, 224, 224, 1),
             "label": torch.zeros(8, dtype=torch.long, device=dev)}
    step(batch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(3):
            step(batch)
        torch.cuda.synchronize()
    stage = dp.mura_device_preprocess((224, 224), seed=1)
    u8 = torch.randint(0, 256, (16, 224, 224, 1), generator=g, dtype=torch.uint8).to(dev)
    rows = stage.rows(stage.draw_params(16, g)).to(dev)

    def traced(edge):
        with profiling.trace(str(tmp_path), edge=edge) as prof:
            for _ in range(10):
                stage.train_batch(u8, rows)
        events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
        return prof, [e for e in events if e.get("cat") == "kernel"
                      and "device_preprocess" in e.get("name", "")]

    end = time.time() + 60
    while time.time() < end and len(traced(0)[1]) == 10:
        step(batch)
        time.sleep(5)
    prof, kernels = traced(profiling.EDGE)
    assert len(kernels) == 10
    assert any("device_preprocess" in r.key and getattr(
        r, "device_time_total", getattr(r, "cuda_time_total", 0)) > 0
        for r in prof.key_averages())


def _gloo_rank_step(rank, world, port, out):
    """One rank of `test_two_gloo_ranks_on_the_card_match_one_rank`."""
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                         world_size=world, rank=rank)
    torch.save(_tiny_steps(rank, world), f"{out}/rank{rank}.pt")
    torch.distributed.destroy_process_group()


TINY_DP = dict(model_type="tiny", hidden_dim=128, d_state=4, drop_path_rate=0.0,
               backbone_overrides=dict(depths=(2, 2, 2, 2), dims=16, drop_path_rate=0.3))


def _tiny_steps(rank=0, world=0):
    """Two float32 train steps of a small XFMamba (dims 16, drop path 0.3)
    at 64 x 64 on the card, global batch 8, on this rank's rows of a mesh of
    ``world`` ranks (alone for 0): each step's loss and logits, the final
    weights."""
    from xfmamba_tpu_torch.parallel import mesh as pmesh
    from xfmamba_tpu_torch.train import loop
    from xfmamba_tpu_torch.train.config import TrainConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = TwoViewXFMamba(**TINY_DP, generator=torch.Generator().manual_seed(0),
                           dropout_generator=torch.Generator().manual_seed(1)).cuda()
    step, _ = loop.make_train_step(model, loop.make_optimizer(TrainConfig(lr=1e-3),
                                                              model.parameters()), False)
    mesh = pmesh.make_mesh(device="cuda") if world else None
    if mesh is not None:
        step = pmesh.make_parallel_train_step(step, mesh)
    g = torch.Generator().manual_seed(2)
    outs = []
    for _ in range(2):
        batch = {"image1": torch.randn(8, 64, 64, 1, generator=g),
                 "image2": torch.randn(8, 64, 64, 1, generator=g),
                 "label": torch.arange(8) % 2}
        batch = pmesh.shard_batch(batch, mesh) if mesh else {k: v.cuda() for k, v in
                                                             batch.items()}
        out = step(batch)
        outs.append((float(out["loss"]), out["logits"].cpu()))
    return {"outs": outs, "state": {k: v.cpu() for k, v in model.state_dict().items()}}


def test_two_gloo_ranks_on_the_card_match_one_rank(dev, tmp_path):
    """Two gloo ranks sharing the card (`parallel.mesh`, kernels 11 and 12,
    global BatchNorm, drop path drawn for the global batch), two steps,
    against one rank on the global batches: losses and logits within 1e-4
    (batches of 4 against 8), the ranks' weights bit for bit equal, and
    within 4 * lr of one rank's (a near-zero Adam input can flip), 1e-6 in
    the mean."""
    from xfmamba_tpu_torch.parallel.distributed import free_port
    one = _tiny_steps()
    torch.multiprocessing.spawn(_gloo_rank_step, args=(2, free_port(), str(tmp_path)), nprocs=2)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    for s, (loss, logits) in enumerate(one["outs"]):
        for r in ranks:
            assert abs(r["outs"][s][0] - loss) <= 1e-4 * max(1.0, abs(loss))
        got = torch.cat([r["outs"][s][1] for r in ranks])
        assert float((got - logits).abs().max()) <= 1e-4 * float(logits.abs().max())
    for k, want in one["state"].items():
        assert torch.equal(ranks[0]["state"][k], ranks[1]["state"][k]), k
        diff = (ranks[0]["state"][k].double() - want.double()).abs()
        assert float(diff.max()) <= 4e-3 and float(diff.mean()) <= 1e-6, k

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

from xfmamba_tpu_torch.models import vssm
from xfmamba_tpu_torch.models.tops import TwoViewXFMamba
from xfmamba_tpu_torch.models.vssm import VSSBlock
from xfmamba_tpu_torch.ops import (
    nk_scan, nk_scan_adjoint, primitives, selective_scan_grouped, ss2d_core_n1, ssd_chunk,
    vss_block_train, vss_stage, vss_stage_train)
from xfmamba_tpu_torch.ops.vss_block import pack_vss_block_params, pack_vss_block_train_params

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
               nk_scan.nk_scan_x)
        counts = [f.launches for f in fns]
        got = model(xa.cuda(), xb.cuda()).cpu()
    after = [f.launches for f in fns]
    want_counts = [8, 0, 2, 1] if route == "block" else [0, 4, 2, 1]
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
    y, every checkpoint, and every gradient (float32 atomics reorder the
    dB, dC and whole-grid sums: 1e-4 of each output's largest magnitude in
    float32, 2e-2 in bfloat16, where the recompute rounds as the forward)."""
    g = torch.Generator().manual_seed(14)
    x, (xdbl, w_dt, A, Ds, bias) = _n1_case(g, dtype, B, H, W, D, R)
    before = (ss2d_core_n1.ss2d_core_n1_fwd.launches, ss2d_core_n1.ss2d_core_n1_bwd.launches)
    y, ck = ss2d_core_n1.ss2d_core_n1_fwd(x, xdbl, w_dt, A, Ds, bias, chunk)
    y_p, ck_p = ss2d_core_n1.ss2d_core_n1_fwd_plain(x, xdbl, w_dt, A, Ds, bias, chunk)
    torch.cuda.synchronize()
    assert rel_err(y, y_p) < TOL[dtype] and rel_err(ck, ck_p) < TOL[dtype]
    gy = randn(g, B, H, W, D)
    got = ss2d_core_n1.ss2d_core_n1_bwd(x, xdbl, w_dt, A, Ds, bias, ck_p, gy, chunk)
    want = ss2d_core_n1.ss2d_core_n1_bwd_plain(x, xdbl, w_dt, A, Ds, bias, ck_p, gy, chunk)
    torch.cuda.synchronize()
    assert (ss2d_core_n1.ss2d_core_n1_fwd.launches,
            ss2d_core_n1.ss2d_core_n1_bwd.launches) == (before[0] + 1, before[1] + 1)
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        assert rel_err(got[name], w) < TOL[dtype], name


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
    """Kernels 13 and 14 against their plain twins on the same operands: y,
    the checkpoints, and every gradient from the plain checkpoints (the
    atomics of dB, dC, dA, dD and dbias reorder float32 sums: 1e-4 of each
    output's largest magnitude in float32, 2e-2 in bfloat16)."""
    g = torch.Generator().manual_seed(16)
    args = _grouped_case(g, dtype, B, L, K, C, N)
    ssg = selective_scan_grouped
    before = (ssg.grouped_scan_fwd.launches, ssg.grouped_scan_bwd.launches)
    y, ck = ssg.grouped_scan_fwd(*args, reverse=reverse)
    y_p, ck_p = ssg.grouped_scan_fwd_plain(*args, reverse=reverse)
    torch.cuda.synchronize()
    assert rel_err(y, y_p) < TOL[dtype] and rel_err(ck, ck_p) < TOL[dtype]
    gy = randn(g, B, L, K * C)
    got = ssg.grouped_scan_bwd(*args, ck_p, gy, reverse=reverse)
    want = ssg.grouped_scan_bwd_plain(*args, ck_p, gy, reverse=reverse)
    torch.cuda.synchronize()
    assert (ssg.grouped_scan_fwd.launches, ssg.grouped_scan_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        assert rel_err(got[name], w) < TOL[dtype], name


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

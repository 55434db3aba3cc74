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

from xfmamba_tpu_torch.models.tops import TwoViewXFMamba
from xfmamba_tpu_torch.models.vssm import VSSBlock
from xfmamba_tpu_torch.ops import nk_scan, primitives, vss_stage
from xfmamba_tpu_torch.ops.vss_block import pack_vss_block_params

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


def test_tiny_model_card_matches_cpu(dev):
    g = torch.Generator().manual_seed(6)
    model = TwoViewXFMamba(model_type="tiny", hidden_dim=128, d_state=4,
                           backbone_overrides=dict(depths=(2, 2, 2, 2), dims=16),
                           generator=g).eval()
    xa, xb = torch.randn(2, 32, 32, 1, generator=g), torch.randn(2, 32, 32, 1, generator=g)
    with torch.no_grad():
        want = model(xa, xb)
        model.cuda()
        counts = [f.launches for f in (vss_stage.vss_stage, nk_scan.nk_scan, nk_scan.nk_scan_x)]
        got = model(xa.cuda(), xb.cuda()).cpu()
    after = [f.launches for f in (vss_stage.vss_stage, nk_scan.nk_scan, nk_scan.nk_scan_x)]
    assert [b - a for a, b in zip(counts, after)] == [4, 2, 1]
    assert rel_err(got, want) < 1e-3

"""XFMamba cross-view fusion (port of ``xfmamba_tpu/models/fusion.py``):
`swapping_scan`, ShallowFuse_SS2Dv4 and its block, Cross_SS2Dv5, the fusion
block and the CSSF layer.  Channels-last throughout.

The projections, depthwise convs, norms and the SE gate run in PyTorch, as
the JAX package leaves them to XLA.  The scans go through the port's
kernels, routed as the JAX accelerator path routes them in the cross2d
mode every model here uses (`models.ss2d.core_dispatch` says where the
other modes differ):

- ShallowFuse in eval mode through `nk_scan_train` (kernel 2; one K=1
  row_f call per swap group); in training mode the same calls (kernel 7
  backward) where the routing rule of ``ops/nk_scan_adjoint.py`` gives
  them a group, else one `selective_scan_auto` call over both groups
  (kernels 13 and 14, K=2).
- Cross_SS2Dv5 in eval mode through `nk_scan_x` (rank form, LayerNorm
  epilogue); in training mode the deltas are projected in torch and the
  scan goes through `models.ss2d.core_dispatch` (kernels 2/7 as one K=4
  cross2d call, or kernels 13/14 as four per-direction calls), then the
  torch out-norm.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from xfmamba_tpu_torch.models.layers import (
    BatchNorm, Conv2dSame, Dense, DropPath, LayerNorm)
from xfmamba_tpu_torch.models.ss2d import (
    ScanParams, _project_kdirs, core_dispatch, dt_rank_of)
from xfmamba_tpu_torch.ops.nk_scan import nk_scan_x, scan_mode_kinds
from xfmamba_tpu_torch.ops.nk_scan_adjoint import nk_scan_train, nk_train_supported
from xfmamba_tpu_torch.ops.selective_scan_grouped import selective_scan_auto


def _swap(x, x2):
    even = torch.arange(x.shape[-1], device=x.device) % 2 == 0
    return torch.where(even, x2, x), torch.where(even, x, x2)


class _SwappingScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, x2):
        return _swap(x, x2)

    @staticmethod
    def backward(ctx, g1, g2):
        return g1, g2


def swapping_scan(x, x2):
    """Exchange the even-indexed channels of the two views
    (``fusion_vmamba.py:189-214``): the first output takes x2's even
    channels, the second x's.  Its backward is the reference's
    *straight-through* one (``:216-221``, ``xfmamba_tpu/models/fusion.py:
    31-62``): the gradients pass through un-swapped, not the true adjoint."""
    return _SwappingScan.apply(x, x2)


class ShallowFuseSS2Dv4(ScanParams):
    """Shallow two-view fusion (``fusion_vmamba.py:693-876``): shared
    in_proj, depthwise conv and SiLU; even channels swapped between the
    views; one forward flat scan per swapped stream; shared out-norm; each
    stream gated by the squeeze-excitation of the *other* view's pre-conv
    projection; shared out_proj."""

    def __init__(self, d_model: int, d_state: int = 4, ssm_ratio: float = 2.0,
                 dt_rank="auto", conv_bias: bool = True, generator=None):
        super().__init__()
        d_inner = int(ssm_ratio * d_model)
        self.d_inner = d_inner
        self.R = dt_rank_of(d_model, dt_rank)
        self.N = d_state
        self.in_proj = Dense(d_model, d_inner, bias=False, init="trunc_normal",
                             generator=generator)
        self.conv2d = Conv2dSame(d_inner, d_inner, 3, padding=1, groups=d_inner,
                                 bias=conv_bias, generator=generator)
        self.init_scan_params(2, d_inner, self.R, d_state, generator)
        self.out_norm = LayerNorm(d_inner)
        self.fc1 = nn.Sequential(
            Dense(d_inner, d_inner // 16, bias=False, generator=generator),
            nn.SiLU(),
            Dense(d_inner // 16, d_inner, bias=False, generator=generator),
            nn.Sigmoid())
        self.out_proj = Dense(d_inner, d_model, bias=False, init="trunc_normal",
                              generator=generator)

    def forward(self, x, x2):
        B, H, W, _ = x.shape
        L, di, R, N = H * W, self.d_inner, self.R, self.N
        p_cat = self.in_proj(torch.cat([x, x2], 0))
        x_p, x2_p = p_cat.chunk(2, 0)
        x_c, x2_c = F.silu(self.conv2d(p_cat)).chunk(2, 0)
        sx, sx2 = swapping_scan(x_c, x2_c)
        xs = torch.stack([sx.reshape(B, L, di), sx2.reshape(B, L, di)], 2)
        x_dbl = torch.einsum("blkd,kcd->blkc", xs, self.x_proj_weight.to(xs.dtype))
        dts, Bs, Cs = torch.split(x_dbl, [R, N, N], -1)
        dts = torch.einsum("blkr,kdr->blkd", dts, self.dt_projs_weight.to(xs.dtype))
        A, Dmat, bias = self.scan_operands(di)
        if self.training and nk_train_supported(B, L, W, di, 1, N, "unidi") is None:
            ys = selective_scan_auto(xs.reshape(B, L, 2 * di), dts.reshape(B, L, 2 * di),
                                     A.reshape(2 * di, N), Bs, Cs, Dmat.reshape(-1),
                                     bias.reshape(-1)).view(B, L, 2, di).unbind(2)
        else:
            ys = [nk_scan_train(xs[:, :, k].contiguous(), dts[:, :, k].contiguous(),
                                Bs[:, :, k].contiguous(), Cs[:, :, k].contiguous(),
                                A[k].t().contiguous(), Dmat[k:k + 1], bias[k:k + 1],
                                H, W, ("row_f",))
                  for k in range(2)]
        y1 = self.out_norm(ys[0].reshape(B, H, W, di).to(x.dtype))
        y2 = self.out_norm(ys[1].reshape(B, H, W, di).to(x.dtype))
        y1 = y1 * self.fc1(x2_p.mean((1, 2)))[:, None, None]
        y2 = y2 * self.fc1(x_p.mean((1, 2)))[:, None, None]
        return self.out_proj(y1), self.out_proj(y2)


class ShallowFusionBlock(nn.Module):
    """Shared BatchNorm (called once per view, so in training it updates
    its running statistics twice, as the flax module does),
    ShallowFuse_SS2Dv4, per-view residual with one drop-path mask shared by
    both views (``fusion_vmamba.py:879-920``)."""

    def __init__(self, hidden_dim: int, drop_path: float = 0.0, d_state: int = 4,
                 dt_rank="auto", ssm_ratio: float = 2.0, generator=None,
                 dropout_generator=None):
        super().__init__()
        self.norm = BatchNorm(hidden_dim, eps=1e-5)
        self.shallowfuseSS2D = ShallowFuseSS2Dv4(hidden_dim, d_state, ssm_ratio,
                                                 dt_rank, generator=generator)
        self.drop_path = DropPath(drop_path, dropout_generator)

    def forward(self, x1, x2):
        y1, y2 = self.drop_path(*self.shallowfuseSS2D(self.norm(x1), self.norm(x2)))
        return x1 + y1, x2 + y2


class CrossSS2Dv5(ScanParams):
    """Deep cross-view fusion (``fusion_vmamba.py:360-610``).  The streams
    [fused = (x + x2) / 2, x, x2] share in_proj_sec, the depthwise conv and
    the scan parameters; every stream scans with the fused stream's C; each
    stream's output is LayerNorm'd, the three are summed and gated by
    z = SiLU(in_proj_sec(fused)), then out_proj."""

    def __init__(self, d_model: int, d_state: int = 16, ssm_ratio: float = 2.0,
                 dt_rank="auto", conv_bias: bool = True,
                 scan_mode: str = "cross2d", generator=None):
        super().__init__()
        d_inner = int(ssm_ratio * d_model)
        self.d_inner = d_inner
        self.R = dt_rank_of(d_model, dt_rank)
        self.N = d_state
        self.scan_mode = scan_mode
        self.kinds = scan_mode_kinds(scan_mode, 4)
        self.in_proj_sec = Dense(d_model, d_inner, bias=False, init="trunc_normal",
                                 generator=generator)
        self.conv2d = Conv2dSame(d_inner, d_inner, 3, padding=1, groups=d_inner,
                                 bias=conv_bias, generator=generator)
        self.init_scan_params(4, d_inner, self.R, d_state, generator)
        self.out_norm = LayerNorm(d_inner)
        self.out_proj = Dense(d_inner, d_model, bias=False, init="trunc_normal",
                              generator=generator)

    def forward(self, x, x2):
        Bv, H, W, _ = x.shape
        L, di, R, N, K = H * W, self.d_inner, self.R, self.N, 4
        xp_cat = self.in_proj_sec(torch.cat([(x + x2) / 2, x, x2], 0))
        z = F.silu(xp_cat[:Bv])
        xcat = F.silu(self.conv2d(xp_cat))                     # (3B, H, W, di)
        Bc = xcat.shape[0]
        A, Dmat, bias = self.scan_operands(di)
        if self.training:
            dts, Bs, Cs = _project_kdirs(xcat, self.x_proj_weight, self.dt_projs_weight, R, N)
            y3 = core_dispatch(xcat, dts, Bs, Cs[:Bv].repeat(3, 1, 1, 1, 1), A, Dmat, bias,
                               self.scan_mode)
            y3 = self.out_norm(y3.to(x.dtype))
        else:
            x_dbl = torch.einsum("bhwd,kcd->bhwkc", xcat, self.x_proj_weight.to(xcat.dtype))
            ranks, Bs, Cs = torch.split(x_dbl, [R, N, N], -1)
            Cs = Cs[:Bv].repeat(3, 1, 1, 1, 1)
            y3 = nk_scan_x(
                xcat.reshape(Bc, L, di), ranks.reshape(Bc, L, K * R),
                Bs.reshape(Bc, L, K * N), Cs.reshape(Bc, L, K * N),
                self.dt_projs_weight.float().transpose(1, 2).reshape(K * R, di),
                A.transpose(1, 2).reshape(K * N, di), Dmat, bias,
                torch.stack([self.out_norm.weight, self.out_norm.bias]),
                H, W, self.kinds)
        y_fuse, y, y2 = y3.reshape(Bc, H, W, di).chunk(3, 0)
        return self.out_proj((y + y2 + y_fuse) * z)


class FusionBlock(nn.Module):
    """Shared pre-norm, Cross_SS2Dv5, residual x1 + x2 + y
    (``fusion_vmamba.py:613-643``)."""

    def __init__(self, hidden_dim: int, drop_path: float = 0.0, d_state: int = 16,
                 generator=None, dropout_generator=None):
        super().__init__()
        self.norm = LayerNorm(hidden_dim)
        self.self_attention = CrossSS2Dv5(hidden_dim, d_state, generator=generator)
        self.drop_path = DropPath(drop_path, dropout_generator)

    def forward(self, x1, x2):
        y = self.self_attention(self.norm(x1), self.norm(x2))
        return x1 + x2 + self.drop_path(y)


class CSSFVSSLayer(nn.Module):
    """Stack of FusionBlocks; the second view is held fixed
    (``fusion_vmamba.py:646-690``)."""

    def __init__(self, hidden_dim: int, depth: int = 1, drop_path=0.0,
                 d_state: int = 16, generator=None, dropout_generator=None):
        super().__init__()
        rates = drop_path if isinstance(drop_path, (list, tuple)) else [drop_path] * depth
        self.blocks = nn.ModuleList(
            FusionBlock(hidden_dim, float(rates[i]), d_state, generator, dropout_generator)
            for i in range(depth))

    def forward(self, x1, x2):
        for blk in self.blocks:
            x1 = blk(x1, x2)
        return x1

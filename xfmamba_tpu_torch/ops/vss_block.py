"""Operand packing and the plain VSSBlock of the backbone (port of
``xfmamba_tpu/ops/vss_block_pallas.py::pack_vss_block_params`` (:423) and
``vss_block_ref`` (:511)).

`vss_block_body` is one v05_noz VSSBlock (d_state 1, cross2d, SiLU, LN
out-norm, exact-GELU MLP) on x (B, L, d), written as the sequence of
kernels that ``ops/vss_stage.py`` launches on the card.  `vss_block_ref`
runs it with the plain versions of those kernels: activations are rounded
to x's dtype at each kernel's output and computed in float32 inside, so
the plain and the CUDA stage agree up to summation order.  In float32 it is
the JAX ``vss_block_ref`` (LayerNorm affine unfolded).
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace

import torch

from xfmamba_tpu_torch.ops.nk_scan import CROSS2D_KINDS, selective_scan_plain
from xfmamba_tpu_torch.ops.primitives import (
    dwconv3_silu_plain, gemm_plain, layer_norm_plain)


@dataclass(frozen=True)
class VSSBlockOperands:
    """Kernel operands of one VSSBlock.  Matmul weights are in nn.Linear
    layout (out, in) and the activation dtype; the rest is float32.
    ``w_xp`` rows are [rank_0 .. rank_3 | B0 C0 B1 C1 B2 C2 B3 C3]."""
    ln1_w: torch.Tensor
    ln1_b: torch.Tensor
    w_in: torch.Tensor       # (di, d)
    w_conv: torch.Tensor     # (9, di), tap (dy, dx) at dy * 3 + dx
    b_conv: torch.Tensor | None
    w_xp: torch.Tensor       # (4R + 8, di)
    w_dt: torch.Tensor       # (4, R, di)
    b_dt: torch.Tensor       # (4, di)
    A: torch.Tensor          # (4, 1, di) = -exp(A_logs)
    Dsum: torch.Tensor       # (di,) sum of Ds over the four directions
    lno_w: torch.Tensor
    lno_b: torch.Tensor
    w_out: torch.Tensor      # (d, di)
    ln2_w: torch.Tensor
    ln2_b: torch.Tensor
    w_fc1: torch.Tensor      # (hd, d)
    b_fc1: torch.Tensor
    w_fc2: torch.Tensor      # (d, hd)
    b_fc2: torch.Tensor

    @property
    def rank(self) -> int:
        return self.w_dt.shape[1]


@torch.no_grad()
def pack_vss_block_params(block, dtype) -> VSSBlockOperands:
    """Operands of a ``models.vssm.VSSBlock`` (forward_type v05_noz,
    d_state 1, with MLP) for activations of ``dtype``."""
    op = block.op
    xw = op.x_proj_weight.float()                          # (4, R + 2, di)
    K, _, di = xw.shape
    R = op.dt_projs_weight.shape[-1]
    if K != 4 or op.A_logs.shape[1] != 1 or block.mlp is None:
        raise ValueError("the VSS stage takes d_state-1 cross2d blocks with an MLP")

    def f32(t):
        return t.detach().float().contiguous()

    def mm(t):
        return t.detach().to(dtype).contiguous()

    return VSSBlockOperands(
        ln1_w=f32(block.norm.weight), ln1_b=f32(block.norm.bias),
        w_in=mm(op.in_proj.weight),
        w_conv=f32(op.conv2d.weight.reshape(di, 9).t()),
        b_conv=None if op.conv2d.bias is None else f32(op.conv2d.bias),
        w_xp=mm(torch.cat([xw[:, :R].reshape(4 * R, di),
                           xw[:, R:].reshape(8, di)])),
        w_dt=f32(op.dt_projs_weight.transpose(1, 2)),
        b_dt=f32(op.dt_projs_bias),
        A=f32(-torch.exp(op.A_logs.float()).reshape(4, 1, di)),
        Dsum=f32(op.Ds.float().reshape(4, di).sum(0)),
        lno_w=f32(op.out_norm.weight), lno_b=f32(op.out_norm.bias),
        w_out=mm(op.out_proj.weight),
        ln2_w=f32(block.norm2.weight), ln2_b=f32(block.norm2.bias),
        w_fc1=mm(block.mlp.fc1.weight), b_fc1=f32(block.mlp.fc1.bias),
        w_fc2=mm(block.mlp.fc2.weight), b_fc2=f32(block.mlp.fc2.bias))


def vss_block_body(x, p: VSSBlockOperands, H, W, ops):
    """One VSSBlock on x (B, L, d) with the kernel set ``ops`` (gemm,
    layer_norm, dwconv3_silu, selective_scan)."""
    B, L, d = x.shape
    di = p.w_in.shape[0]
    R = p.rank
    dtype = x.dtype
    rows = x.reshape(B * L, d)
    h1 = ops.layer_norm(rows, p.ln1_w, p.ln1_b, dtype)
    xin = ops.gemm(h1, p.w_in)
    u = ops.dwconv3_silu(xin.view(B, H, W, di), p.w_conv, p.b_conv)
    xdbl = ops.gemm(u.view(B * L, di), p.w_xp).view(B, L, 4 * R + 8)
    bc = xdbl[..., 4 * R:].unflatten(-1, (4, 2))
    y = ops.selective_scan(u.view(B, L, di), bc[..., 0:1], bc[..., 1:2], p.A,
                           p.b_dt, p.Dsum, CROSS2D_KINDS, H, W,
                           ranks=xdbl[..., :4 * R].unflatten(-1, (4, R)),
                           w_dt=p.w_dt, out_dtype=torch.float32)
    yn = ops.layer_norm(y.view(B * L, di), p.lno_w, p.lno_b, dtype)
    x1 = ops.gemm(yn, p.w_out, residual=rows)
    h2 = ops.layer_norm(x1, p.ln2_w, p.ln2_b, dtype)
    f1 = ops.gemm(h2, p.w_fc1, bias=p.b_fc1, gelu=True)
    return ops.gemm(f1, p.w_fc2, bias=p.b_fc2, residual=x1).view(B, L, d)


PLAIN_OPS = SimpleNamespace(gemm=gemm_plain, layer_norm=layer_norm_plain,
                            dwconv3_silu=dwconv3_silu_plain,
                            selective_scan=selective_scan_plain)


def vss_block_ref(x, p: VSSBlockOperands, H, W):
    """Plain VSSBlock on x (B, L, d); returns x's dtype."""
    return vss_block_body(x, p, H, W, PLAIN_OPS)

"""Operand packing and the plain VSSBlock of the backbone (port of
``xfmamba_tpu/ops/vss_block_pallas.py::pack_vss_block_params`` (:423) and
``vss_block_ref`` (:511)).

`vss_block_body` is one v05_noz VSSBlock (d_state 1, cross2d, SiLU, LN
out-norm, exact-GELU MLP) on x (B, L, d), written as the sequence of
kernels that ``ops/vss_stage.py`` launches on the card; its two halves
(`ss2d_half`, `mlp_half`) take the per-sample drop-path scales of training
as the GEMM epilogue's row scale, and `ss2d_half_fwd` keeps the
intermediates (and, for the backward, the scan's chunk checkpoints) that
the block backward (``ops/vss_block_train.py``) recomputes.  The kernel
set ``ops`` names each piece: ``gemm`` / ``gemm_ab``, ``layer_norm``,
``dwconv3_silu``, ``cross2d_scan`` (``ops/cross2d_scan.py``) and their
backwards.  `vss_block_ref` runs it with the plain versions of those
kernels (`PLAIN_OPS`): activations are rounded to x's dtype at each
kernel's output and computed in float32 inside, so the plain and the CUDA
stage agree up to summation order.  In float32 it is the JAX
``vss_block_ref`` (LayerNorm affine unfolded).
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from types import SimpleNamespace

import torch

from xfmamba_tpu_torch.ops.cross2d_scan import cross2d_scan_bwd_plain, cross2d_scan_plain
from xfmamba_tpu_torch.ops.primitives import (
    dwconv3_silu_bwd_plain, dwconv3_silu_plain, gemm_ab_plain, gemm_plain,
    layer_norm_bwd_plain, layer_norm_plain)


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
    # the MLP half (None where only the SS2D half is given)
    ln2_w: torch.Tensor | None = None
    ln2_b: torch.Tensor | None = None
    w_fc1: torch.Tensor | None = None     # (hd, d)
    b_fc1: torch.Tensor | None = None
    w_fc2: torch.Tensor | None = None     # (d, hd)
    b_fc2: torch.Tensor | None = None

    @property
    def rank(self) -> int:
        return self.w_dt.shape[1]

    def tensors(self) -> list:
        """The operands in field order (None for absent ones)."""
        return [getattr(self, f.name) for f in fields(self)]


# fields of the SS2D half, the operands of kernels 4 and 6
SS2D_FIELDS = ("ln1_w", "ln1_b", "w_in", "w_conv", "b_conv", "w_xp", "w_dt", "b_dt",
               "A", "Dsum", "lno_w", "lno_b", "w_out")
MLP_FIELDS = ("ln2_w", "ln2_b", "w_fc1", "b_fc1", "w_fc2", "b_fc2")


def _pack(block, dtype, detach) -> VSSBlockOperands:
    op = block.op
    xw = op.x_proj_weight.float()                          # (4, R + 2, di)
    K, _, di = xw.shape
    R = op.dt_projs_weight.shape[-1]
    if K != 4 or op.A_logs.shape[1] != 1:
        raise ValueError("the VSS stage takes d_state-1 cross2d blocks")

    def f32(t):
        return (t.detach() if detach else t).float().contiguous()

    def mm(t):
        return (t.detach() if detach else t).to(dtype).contiguous()

    return VSSBlockOperands(
        ln1_w=f32(block.norm.weight), ln1_b=f32(block.norm.bias),
        w_in=mm(op.in_proj.weight),
        w_conv=f32(op.conv2d.weight.reshape(di, 9).t()),
        b_conv=None if op.conv2d.bias is None else f32(op.conv2d.bias),
        w_xp=mm(torch.cat([xw[:, :R].reshape(4 * R, di), xw[:, R:].reshape(8, di)])),
        w_dt=f32(op.dt_projs_weight.transpose(1, 2)),
        b_dt=f32(op.dt_projs_bias),
        A=f32(-torch.exp(op.A_logs.float()).reshape(4, 1, di)),
        Dsum=f32(op.Ds.float().reshape(4, di).sum(0)),
        lno_w=f32(op.out_norm.weight), lno_b=f32(op.out_norm.bias),
        w_out=mm(op.out_proj.weight),
        **({} if block.mlp is None else dict(
            ln2_w=f32(block.norm2.weight), ln2_b=f32(block.norm2.bias),
            w_fc1=mm(block.mlp.fc1.weight), b_fc1=f32(block.mlp.fc1.bias),
            w_fc2=mm(block.mlp.fc2.weight), b_fc2=f32(block.mlp.fc2.bias))))


@torch.no_grad()
def pack_vss_block_params(block, dtype) -> VSSBlockOperands:
    """Operands of a ``models.vssm.VSSBlock`` (forward_type v05_noz,
    d_state 1) for activations of ``dtype``, off the autograd graph
    (inference); the MLP fields are None where the block has no MLP half
    (``mlp_ratio`` 0)."""
    return _pack(block, dtype, detach=True)


def pack_vss_block_train_params(block, dtype) -> VSSBlockOperands:
    """The same operands on the autograd graph: A = -exp(A_logs), the sum of
    Ds, the transposes and the casts are differentiable, so the kernels'
    gradients with respect to the operands chain back to the block's
    float32 parameters (as ``vss_block_v2_adjoint.py:474-477`` relies on
    for the JAX training op)."""
    return _pack(block, dtype, detach=False)


def ss2d_half_fwd(x, p: VSSBlockOperands, H, W, ops, m1=None, checkpoints=False):
    """The SS2D half of a block, x + m1 * out_proj(LN(scan(...))), on x
    (B, L, d), keeping every intermediate the backward recomputes (with
    ``checkpoints``, the scan's chunk checkpoints ``ck`` too).  m1 (B,)
    float32 is the per-sample drop-path scale of the branch (None: 1)."""
    B, L, d = x.shape
    di = p.w_in.shape[0]
    R = p.rank
    dtype = x.dtype
    rows = x.reshape(B * L, d)
    h1 = ops.layer_norm(rows, p.ln1_w, p.ln1_b, dtype)
    xin = ops.gemm(h1, p.w_in)
    u = ops.dwconv3_silu(xin.view(B, H, W, di), p.w_conv, p.b_conv)
    xdbl = ops.gemm(u.view(B * L, di), p.w_xp).view(B, L, 4 * R + 8)
    y, ck = ops.cross2d_scan(u.view(B, L, di), xdbl, p.A, p.b_dt, p.Dsum, p.w_dt, H, W,
                             checkpoints)
    yn = ops.layer_norm(y.view(B * L, di), p.lno_w, p.lno_b, dtype)
    x1 = ops.gemm(yn, p.w_out, residual=rows, scale=m1)
    return SimpleNamespace(rows=rows, h1=h1, xin=xin, u=u, xdbl=xdbl, ck=ck, y=y, yn=yn, x1=x1)


def ss2d_half(x, p: VSSBlockOperands, H, W, ops, m1=None):
    B, L, d = x.shape
    return ss2d_half_fwd(x, p, H, W, ops, m1).x1.view(B, L, d)


def mlp_half(x1, p: VSSBlockOperands, ops, m2=None):
    """x1 + m2 * fc2(GELU(fc1(LN(x1)))) on x1 (B, L, d)."""
    B, L, d = x1.shape
    rows = x1.reshape(B * L, d)
    h2 = ops.layer_norm(rows, p.ln2_w, p.ln2_b, x1.dtype)
    f1 = ops.gemm(h2, p.w_fc1, bias=p.b_fc1, gelu=True)
    return ops.gemm(f1, p.w_fc2, bias=p.b_fc2, residual=rows, scale=m2).view(B, L, d)


def vss_block_body(x, p: VSSBlockOperands, H, W, ops, m1=None, m2=None):
    """One VSSBlock on x (B, L, d) with the kernel set ``ops`` (gemm,
    layer_norm, dwconv3_silu, selective_scan) and optional drop-path
    scales m1, m2 (B,) at the two residual adds; a block without its MLP
    half ends after out_proj + residual."""
    x1 = ss2d_half(x, p, H, W, ops, m1)
    return x1 if p.w_fc1 is None else mlp_half(x1, p, ops, m2)


# the plain twin of every kernel a block's forward and backward launch;
# `ops.vss_stage.CUDA_OPS` holds the kernels
PLAIN_OPS = SimpleNamespace(
    gemm=gemm_plain, gemm_ab=gemm_ab_plain, layer_norm=layer_norm_plain,
    layer_norm_bwd=layer_norm_bwd_plain, dwconv3_silu=dwconv3_silu_plain,
    dwconv3_silu_bwd=dwconv3_silu_bwd_plain, cross2d_scan=cross2d_scan_plain,
    cross2d_scan_bwd=cross2d_scan_bwd_plain)


def vss_block_ref(x, p: VSSBlockOperands, H, W, m1=None, m2=None):
    """Plain VSSBlock on x (B, L, d); returns x's dtype."""
    return vss_block_body(x, p, H, W, PLAIN_OPS, m1, m2)

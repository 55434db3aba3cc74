"""Kernels 4 and 6: the training forward and the backward of a VSSBlock's
SS2D half on the card.

- Kernel 4, `vss_block_train`: replaces ``xfmamba_tpu/ops/
  vss_block_pallas_v2.py::_vss_block_kernel_v2`` (:412) in its masked
  training form (``fuse_mlp`` off): x + m1 * out_proj(outnorm(scan(...)))
  with the per-sample drop-path scale m1 in the out_proj GEMM's epilogue.
- Kernel 6, `vss_block_bwd`: replaces ``xfmamba_tpu/ops/
  vss_block_v2_adjoint.py::_vss_block_bwd_kernel`` (:128), the SS2D half's
  backward.  The TPU computes it in one Pallas call with everything in
  VMEM; here the host launches a sequence of hand-written kernels
  (`vss_block_bwd_body`): the forward recompute (LN, GEMMs, conv + SiLU,
  scan, out-norm), the out_proj gradient GEMMs, the out-norm LayerNorm
  backward, the adjoint scan (the tile-parallel kernels of
  ``csrc/ss2d_core_n1.cu``, ``ops/cross2d_scan.py``, which also take the
  rank and w_dt gradients on the tensor cores), the x_proj gradient GEMMs,
  the conv + SiLU backward, the in_proj gradient GEMMs and the LN1
  backward with the residual gradient added.  Weight gradients are GEMMs that reduce over all
  B * L rows, split along that axis and summed with atomics.  In bfloat16
  every GEMM runs on the tensor-core kernel (``csrc/gemm_tc.cu``; see
  ``primitives.gemm_plan``).
- `VSSBlockTrain`: the autograd op, kernel 4 forward and kernel 6
  backward.  It saves x, the mask and the (small) operands, and recomputes
  every activation in the backward, as the JAX custom VJP
  ``vss_block_train_v2`` does.

As in JAX, the adjoint runs in float32 and rounds to the activation dtype
only at GEMM inputs; the plain versions (`vss_block_bwd_plain`) run the
same sequence with the plain twin of every kernel, so they round at the
same points.  Each wrapper takes its plain version for CPU tensors; on CUDA
tensors it launches the kernels, adds one to its ``launches`` count, or
raises.
"""

from __future__ import annotations

import torch

from xfmamba_tpu_torch.ops.primitives import on_cpu
from xfmamba_tpu_torch.ops.vss_block import (
    PLAIN_OPS, SS2D_FIELDS, VSSBlockOperands, ss2d_half, ss2d_half_fwd)
from xfmamba_tpu_torch.ops.vss_stage import CUDA_OPS


def _check(x, p, H, W):
    if x.dim() != 3 or x.shape[1] != H * W or not x.is_contiguous():
        raise ValueError(f"x: expected a contiguous (B, {H * W}, d) map, got {tuple(x.shape)}")
    if p.w_in.dtype != x.dtype:
        raise TypeError("block operands were packed for another dtype")


# ---------------------------------------------------------------------------
# kernel 4: the masked SS2D half forward
# ---------------------------------------------------------------------------

def vss_block_train_plain(x, p: VSSBlockOperands, H, W, m1=None):
    return ss2d_half(x, p, H, W, PLAIN_OPS, m1)


def vss_block_train(x, p: VSSBlockOperands, H, W, m1=None):
    """x + m1 * SS2D(LN(x)) on x (B, H * W, d); m1 (B,) float32 or None."""
    if on_cpu(x, p.w_in, m1):
        return vss_block_train_plain(x, p, H, W, m1)
    _check(x, p, H, W)
    out = ss2d_half(x, p, H, W, CUDA_OPS, m1)
    vss_block_train.launches += 1  # counted once launched
    return out


vss_block_train.launches = 0


# ---------------------------------------------------------------------------
# kernel 6: the SS2D half backward
# ---------------------------------------------------------------------------

@torch.no_grad()
def vss_block_bwd_body(x, p: VSSBlockOperands, H, W, m1, g, ops):
    """Backward of x1 = x + m1 * SS2D(LN(x)) given g = dL/dx1 (B, L, d).
    Returns (dx float32 (B, L, d), {field: gradient} for `SS2D_FIELDS`)."""
    B, L, d = x.shape
    M = B * L
    di = p.w_in.shape[0]
    R = p.rank
    dtype = x.dtype
    f32 = torch.float32
    f = ss2d_half_fwd(x, p, H, W, ops, m1, checkpoints=True)    # forward recompute
    g = g.reshape(M, d).float()
    dout = g if m1 is None else g * m1.float().repeat_interleave(L)[:, None]
    dout = dout.to(dtype)
    grads = dict(w_out=ops.gemm_ab(dout.t(), f.yn.t(), out_dtype=f32))
    dyn = ops.gemm_ab(dout, p.w_out.t(), out_dtype=f32)
    dy, grads["lno_w"], grads["lno_b"] = ops.layer_norm_bwd(dyn, f.y.view(M, di), p.lno_w)
    # adjoint scan with the rank products; the rank, B and C gradients land
    # in their columns of dxdbl
    dxdbl = torch.zeros(M, 4 * R + 8, dtype=f32, device=x.device)
    s = ops.cross2d_scan_bwd(f.u.view(B, L, di), f.xdbl, p.A, p.b_dt, p.Dsum, p.w_dt, H, W,
                             dy.view(B, L, di), f.ck, dxdbl)
    grads.update(A=s["dA"], Dsum=s["dDsum"], b_dt=s["dbias"], w_dt=s["dw_dt"])
    dxdbl = dxdbl.to(dtype)
    u = f.u.view(M, di)
    grads["w_xp"] = ops.gemm_ab(dxdbl.t(), u.t(), out_dtype=f32)
    du = s["du"].view(M, di)
    du = ops.gemm_ab(dxdbl, p.w_xp.t(), residual=du, out=du)
    dxin, grads["w_conv"], grads["b_conv"] = ops.dwconv3_silu_bwd(
        du.view(B, H, W, di), f.xin.view(B, H, W, di), p.w_conv, p.b_conv)
    dxin = dxin.view(M, di).to(dtype)
    grads["w_in"] = ops.gemm_ab(dxin.t(), f.h1.t(), out_dtype=f32)
    dh1 = ops.gemm_ab(dxin, p.w_in.t(), out_dtype=f32)
    dx, grads["ln1_w"], grads["ln1_b"] = ops.layer_norm_bwd(dh1, f.rows, p.ln1_w, dres=g)
    return dx.view(B, L, d), grads


def vss_block_bwd_plain(x, p: VSSBlockOperands, H, W, m1, g):
    return vss_block_bwd_body(x, p, H, W, m1, g, PLAIN_OPS)


def vss_block_bwd(x, p: VSSBlockOperands, H, W, m1, g):
    """Kernel 6: see `vss_block_bwd_body`."""
    if on_cpu(x, p.w_in, m1, g):
        return vss_block_bwd_plain(x, p, H, W, m1, g)
    _check(x, p, H, W)
    grads = vss_block_bwd_body(x, p, H, W, m1, g.contiguous(), CUDA_OPS)
    vss_block_bwd.launches += 1  # counted once launched
    return grads


vss_block_bwd.launches = 0


class VSSBlockTrain(torch.autograd.Function):
    """The SS2D half of a VSSBlock in training: kernel 4 forward, kernel 6
    backward.  ``operands`` are the `SS2D_FIELDS` of the training packing
    (``b_conv`` may be None); their gradients chain back through it."""

    @staticmethod
    def forward(ctx, x, m1, H, W, *operands):
        p = VSSBlockOperands(**dict(zip(SS2D_FIELDS, operands)))
        ctx.geometry = (H, W)
        ctx.save_for_backward(x, m1, *operands)
        return vss_block_train(x, p, H, W, m1)

    @staticmethod
    def backward(ctx, g):
        x, m1, *operands = ctx.saved_tensors
        p = VSSBlockOperands(**dict(zip(SS2D_FIELDS, operands)))
        dx, grads = vss_block_bwd(x, p, *ctx.geometry, m1, g)
        dops = [None if t is None else grads[name].to(t.dtype).reshape(t.shape)
                for name, t in zip(SS2D_FIELDS, operands)]
        return (dx.to(x.dtype), None, None, None, *dops)


def vss_block_train_op(x, p: VSSBlockOperands, H, W, m1=None):
    """Autograd entry of `VSSBlockTrain` on x (B, H * W, d)."""
    return VSSBlockTrain.apply(x, m1, H, W, *(getattr(p, n) for n in SS2D_FIELDS))

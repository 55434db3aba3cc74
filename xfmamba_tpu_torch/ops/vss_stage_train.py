"""Kernel 5: the training step of a whole backbone stage.

Replaces ``xfmamba_tpu/ops/vss_block_pallas_v2.py::
_vss_stage_train_kernel_v2`` (:658; host ``_vss_stage_train_call`` :695,
custom VJP ``xfmamba_tpu/ops/vss_stage_train.py::vss_stage_train``).

Forward (`vss_stage_train_forward`): every block of the stage with its MLP
and the per-block drop-path scales m1 (SS2D branch) and m2 (MLP branch) in
the GEMM epilogues, keeping each block's input x_j and its post-SS2D
mid-point mid_j for the backward.  As in kernel 1, the host launches each
block's hand-written kernels in turn (``ops/vss_block.py``); the TPU's
one-call stage with the activation in VMEM has no counterpart yet.

Backward (`VSSStageTrain`): the blocks in reverse; for each, the MLP half's
gradient by torch autograd of `mlp_half` from mid_j (the JAX package runs
that half in XLA, outside any kernel), then kernel 6
(``ops/vss_block_train.py::vss_block_bwd``) for the SS2D half.

`vss_stage_train_forward` takes its plain version for CPU tensors; on CUDA
tensors it launches the kernels, adds one to ``launches`` per stage, or
raises.
"""

from __future__ import annotations

from dataclasses import fields

import torch

from xfmamba_tpu_torch.ops.primitives import on_cpu
from xfmamba_tpu_torch.ops.vss_block import (
    MLP_FIELDS, PLAIN_OPS, SS2D_FIELDS, VSSBlockOperands, mlp_half, ss2d_half)
from xfmamba_tpu_torch.ops.vss_block_train import _check, vss_block_bwd
from xfmamba_tpu_torch.ops.vss_stage import CUDA_OPS

N_FIELDS = len(SS2D_FIELDS) + len(MLP_FIELDS)


def _stage_forward(x, blocks, H, W, m1, m2, ops):
    xs, mids = [], []
    for j, p in enumerate(blocks):
        xs.append(x)
        x = ss2d_half(x, p, H, W, ops, m1[j])
        mids.append(x)
        x = mlp_half(x, p, ops, m2[j])
    return x, torch.stack(xs), torch.stack(mids)


def vss_stage_train_forward_plain(x, blocks, H, W, m1, m2):
    return _stage_forward(x, blocks, H, W, m1, m2, PLAIN_OPS)


def vss_stage_train_forward(x, blocks, H, W, m1, m2):
    """All blocks (``VSSBlockOperands``) of a stage on x (B, H * W, d) with
    drop-path scales m1, m2 (depth, B) float32.  Returns (y, xs, mids):
    y (B, L, d), the block inputs and the mid-points (depth, B, L, d)."""
    if on_cpu(x, m1, m2, *(p.w_in for p in blocks)):
        return vss_stage_train_forward_plain(x, blocks, H, W, m1, m2)
    for p in blocks:
        _check(x, p, H, W)
    out = _stage_forward(x, blocks, H, W, m1, m2, CUDA_OPS)
    vss_stage_train_forward.launches += 1  # counted once launched
    return out


vss_stage_train_forward.launches = 0


def _mlp_half_grads(mid, p, m2, g):
    """Gradients of `mlp_half` (plain torch, as the JAX package leaves this
    half to XLA) at mid given g: (dmid, {field: gradient})."""
    with torch.enable_grad():
        leaves = {n: getattr(p, n).detach().requires_grad_() for n in MLP_FIELDS}
        mid = mid.detach().requires_grad_()
        q = VSSBlockOperands(*(None,) * len(SS2D_FIELDS), **leaves)
        out = mlp_half(mid, q, PLAIN_OPS, m2)
        grads = torch.autograd.grad(out, [mid, *leaves.values()], g)
    return grads[0], dict(zip(MLP_FIELDS, grads[1:]))


def stage_train_backward(g, xs, mids, blocks, H, W, m1, m2, block_bwd=vss_block_bwd):
    """The stage's backward given g = dL/dy: per block in reverse, the MLP
    half's autograd gradient from mid_j, then ``block_bwd`` (kernel 6, or
    its plain version) for the SS2D half.  Returns (dx in xs's dtype, one
    {field: gradient} dict per block)."""
    gcur = g.to(xs.dtype)
    grads = [None] * len(blocks)
    for j in reversed(range(len(blocks))):
        gmid, grads[j] = _mlp_half_grads(mids[j], blocks[j], m2[j], gcur)
        dx, ss2d = block_bwd(xs[j], blocks[j], H, W, m1[j], gmid)
        grads[j].update(ss2d)
        gcur = dx.to(xs.dtype)
    return gcur, grads


class VSSStageTrain(torch.autograd.Function):
    """A stage in training: kernel 5 forward, `stage_train_backward`
    backward.  ``operands`` are the `VSSBlockOperands.tensors()` of every
    block, concatenated."""

    @staticmethod
    def forward(ctx, x, m1, m2, H, W, *operands):
        blocks = _blocks(operands)
        y, xs, mids = vss_stage_train_forward(x, blocks, H, W, m1, m2)
        ctx.geometry = (H, W)
        ctx.save_for_backward(m1, m2, xs, mids, *operands)
        return y

    @staticmethod
    def backward(ctx, g):
        m1, m2, xs, mids, *operands = ctx.saved_tensors
        blocks = _blocks(operands)
        dx, grads = stage_train_backward(g, xs, mids, blocks, *ctx.geometry, m1, m2)
        dops = [None if t is None else gj[f.name].to(t.dtype).reshape(t.shape)
                for p, gj in zip(blocks, grads) for f, t in zip(fields(p), p.tensors())]
        return (dx.to(g.dtype), None, None, None, None, *dops)


def _blocks(operands):
    return [VSSBlockOperands(*operands[i:i + N_FIELDS])
            for i in range(0, len(operands), N_FIELDS)]


def vss_stage_train(x, blocks, H, W, m1, m2):
    """Autograd entry of `VSSStageTrain`: x (B, H * W, d), blocks a list of
    training-packed ``VSSBlockOperands``, m1/m2 (depth, B) float32."""
    flat = [t for p in blocks for t in p.tensors()]
    return VSSStageTrain.apply(x, m1, m2, H, W, *flat)

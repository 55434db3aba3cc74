"""Kernel 1: a whole backbone stage of v05_noz VSSBlocks on the card.

Replaces ``xfmamba_tpu/ops/vss_block_pallas_v2.py::_vss_stage_kernel_v2``
(:542; host ``vss_stage_fused_v2`` :753), which runs every block of a stage
in one Pallas call with the activation held in VMEM.  Here the host loops
over the stage's blocks and launches, per block, the hand-written kernels
of ``csrc/vss_stage.cu`` (LayerNorm, tiled GEMMs with bias / GELU /
residual epilogues, depthwise conv + SiLU) and the rank-form cross2d scan
of ``csrc/nk_scan.cu``; the activation goes through device memory between
them.  What bounds each kernel on the H100 is noted in its source; keeping
a block's activations on chip (the TPU design) is later work.

`vss_stage` takes `vss_stage_plain` only for CPU tensors; on CUDA tensors it
launches the kernels, adds one to ``vss_stage.launches`` per stage, or
raises.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from xfmamba_tpu_torch.ops.nk_scan import selective_scan_bwd_cuda, selective_scan_cuda
from xfmamba_tpu_torch.ops.primitives import (
    dwconv3_silu_bwd_cuda, dwconv3_silu_cuda, gemm_ab_cuda, gemm_cuda,
    layer_norm_bwd_cuda, layer_norm_cuda, on_cpu)
from xfmamba_tpu_torch.ops.vss_block import vss_block_body, vss_block_ref

# the kernels a block's forward and backward launch (twins in
# `ops.vss_block.PLAIN_OPS`)
CUDA_OPS = SimpleNamespace(
    gemm=gemm_cuda, gemm_ab=gemm_ab_cuda, layer_norm=layer_norm_cuda,
    layer_norm_bwd=layer_norm_bwd_cuda, dwconv3_silu=dwconv3_silu_cuda,
    dwconv3_silu_bwd=dwconv3_silu_bwd_cuda, selective_scan=selective_scan_cuda,
    selective_scan_bwd=selective_scan_bwd_cuda)


def vss_stage_plain(x, blocks, H, W):
    """The blocks of a stage, plain: x (B, L, d) -> (B, L, d)."""
    for p in blocks:
        x = vss_block_ref(x, p, H, W)
    return x


def vss_stage(x, blocks, H, W):
    """Run a stage (a list of ``VSSBlockOperands``) on x (B, H * W, d)."""
    if on_cpu(x, *(p.w_in for p in blocks)):
        return vss_stage_plain(x, blocks, H, W)
    if x.dim() != 3 or x.shape[1] != H * W or not x.is_contiguous():
        raise ValueError(f"x: expected a contiguous (B, {H * W}, d) map, got "
                         f"{tuple(x.shape)}")
    if any(p.w_in.dtype != x.dtype for p in blocks):
        raise TypeError("stage operands were packed for another dtype")
    vss_stage.launches += 1
    for p in blocks:
        x = vss_block_body(x, p, H, W, CUDA_OPS)
    return x


vss_stage.launches = 0

"""Kernel 8: one whole v05_noz VSSBlock for inference, v1 (port of
``xfmamba_tpu/ops/vss_block_pallas.py::vss_block_fused`` (:609), TPU kernel
``_vss_block_kernel`` (:295, ``pallas_call`` :405)).

JAX runs it, in bfloat16 inference, for a backbone stage whose v2 kernels
find no image group aligned to 8 sublanes (``models/vssm.py:142-180``): at
one or two studies per batch, stages 2 and 3 of XFMamba-S.  Here the host
launches, per block, the hand-written kernels of ``csrc/vss_stage.cu``
(LayerNorm, the tiled GEMM with its epilogues, depthwise conv + SiLU) and
the rank-form two-level scan of ``csrc/scan_two_level.cu``, parallel along
L, with the rank->D projection inside the scan kernel as the TPU kernel
does it on the MXU inside its body.  The sequence rounds where the TPU
kernel rounds: ``xin``, ``u``, B, C, y and the residual stream stay float32
(``:306-381``); LayerNorm outputs, the rank values, ``u`` for x_proj and
the GELU output are rounded to the activation dtype for their products;
the block's output once, at the end.  GELU is exact (erf), as kernel 1's.
Its JAX backward is a pure-jnp remat that the training route never
reaches, so there is no backward kernel.

Also here, copied as they are: the v1 routing helpers ``_VMEM_BUDGET``,
``_vmem_estimate``, ``fused_vss_block_supported`` and ``pick_group``
(``:633-683``), whose TPU VMEM arithmetic decides where JAX runs this kernel
(``models/vssm.py`` uses them through `ops.vss_stage.stage_route`).

`vss_block_v1` takes `vss_block_v1_plain` only for CPU tensors; on CUDA
tensors it launches the kernels, adds one to ``vss_block_v1.launches`` per
block, or raises.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import torch

from xfmamba_tpu_torch.ops.nk_scan import CROSS2D_KINDS
from xfmamba_tpu_torch.ops.nk_scan_v1 import scan_two_level_cuda, scan_two_level_plain
from xfmamba_tpu_torch.ops.primitives import (
    dwconv3_silu_cuda, dwconv3_silu_plain, gemm_ab_cuda, gemm_ab_plain, layer_norm_cuda,
    layer_norm_plain, on_cpu)
from xfmamba_tpu_torch.ops.vss_block import VSSBlockOperands, pack_vss_block_params

# ---------------------------------------------------------------------------
# the v1 routing helpers (``vss_block_pallas.py:633-683``)
# ---------------------------------------------------------------------------

_VMEM_BUDGET = 44 * 1024 * 1024


def _vmem_estimate(H, W, d, di, hd, G, fuse_mlp):
    """The TPU kernel's VMEM working set in bytes for G images."""
    L = H * W

    def pad128(n):
        return ((n + 127) // 128) * 128

    R = -(-d // 16)
    Lg = G * L
    acts = 6 * Lg * pad128(di) * 4 + 3 * Lg * pad128(d) * 4 \
        + 2 * Lg * pad128(4 * R + 8) * 4 \
        + 3 * Lg * pad128(G * max(H, W)) * 4
    weights = 2 * (d * di * 2) + di * 4
    if fuse_mlp:
        weights += 2 * (d * hd * 2)
        acts += Lg * pad128(hd) * 2
    return acts + weights


def fused_vss_block_supported(H, W, d, di, hd, fuse_mlp=True, budget_bytes=_VMEM_BUDGET):
    """Whether JAX runs a block of this geometry through a whole-block
    kernel at all (else the composable blocks)."""
    if H * W < 8 or H < 2 or W < 2:
        return False
    return _vmem_estimate(H, W, d, di, hd, 1, fuse_mlp) < budget_bytes


def pick_group(B, H, W, d, di, hd, fuse_mlp=True, budget_bytes=_VMEM_BUDGET):
    """The TPU kernel's images per grid step."""
    L = H * W
    if L <= 64:
        prefs = (4, 2, 1)
    elif L <= 256:
        prefs = (2, 1)
    else:
        prefs = (1,)
    for G in prefs:
        if B % G:
            continue
        if _vmem_estimate(H, W, d, di, hd, G, fuse_mlp) < budget_bytes:
            return G
    return 1


# ---------------------------------------------------------------------------
# kernel 8
# ---------------------------------------------------------------------------

@torch.no_grad()
def pack_vss_block_v1_params(block, dtype) -> VSSBlockOperands:
    """`pack_vss_block_params` with w_dt rounded to ``dtype`` (the TPU
    packing casts it to the matmul dtype; kept float32 for the scan)."""
    p = pack_vss_block_params(block, dtype)
    return dataclasses.replace(p, w_dt=p.w_dt.to(dtype).float().contiguous())


def vss_block_v1_body(x, p: VSSBlockOperands, H, W, ops):
    """One block on x (B, L, d) with the kernel set ``ops`` (layer_norm,
    gemm_ab, dwconv3_silu, scan): see the module docstring."""
    B, L, d = x.shape
    di = p.w_in.shape[0]
    R = p.rank
    dtype = x.dtype
    f32 = torch.float32
    low = dtype != f32
    rows = x.reshape(B * L, d)
    h1 = ops.layer_norm(rows, p.ln1_w, p.ln1_b, dtype)
    xin = ops.gemm_ab(h1, p.w_in, out_dtype=f32)
    u = ops.dwconv3_silu(xin.view(B, H, W, di), p.w_conv, p.b_conv, copy_bf16=low)
    u, u_mm = u if low else (u, u)
    xdbl = ops.gemm_ab(u_mm.view(B * L, di), p.w_xp, out_dtype=f32).view(B, L, 4 * R + 8)
    bc = xdbl[..., 4 * R:].unflatten(-1, (4, 2))
    y = ops.scan(u.view(B, L, di), bc[..., 0:1], bc[..., 1:2], p.A, p.b_dt, p.Dsum,
                 CROSS2D_KINDS, H, W, ranks=xdbl[..., :4 * R].unflatten(-1, (4, R)),
                 w_dt=p.w_dt, out_dtype=f32, round_rank=low)
    yn = ops.layer_norm(y.view(B * L, di), p.lno_w, p.lno_b, dtype)
    res = ops.gemm_ab(yn, p.w_out, residual=rows, out_dtype=f32)
    h2 = ops.layer_norm(res, p.ln2_w, p.ln2_b, dtype)
    f1 = ops.gemm_ab(h2, p.w_fc1, bias=p.b_fc1, gelu=True)
    return ops.gemm_ab(f1, p.w_fc2, bias=p.b_fc2, residual=res, out_dtype=dtype).view(B, L, d)


V1_PLAIN_OPS = SimpleNamespace(layer_norm=layer_norm_plain, gemm_ab=gemm_ab_plain,
                               dwconv3_silu=dwconv3_silu_plain, scan=scan_two_level_plain)
V1_CUDA_OPS = SimpleNamespace(layer_norm=layer_norm_cuda, gemm_ab=gemm_ab_cuda,
                              dwconv3_silu=dwconv3_silu_cuda, scan=scan_two_level_cuda)


def vss_block_v1_plain(x, p: VSSBlockOperands, H, W):
    """The plain twin: the same sequence with the kernels' plain versions
    (the scan serial)."""
    return vss_block_v1_body(x, p, H, W, V1_PLAIN_OPS)


def vss_block_v1(x, p: VSSBlockOperands, H, W):
    """Kernel 8 on x (B, H * W, d) with the operands of
    `pack_vss_block_v1_params`; returns x's dtype."""
    if on_cpu(x, p.w_in):
        return vss_block_v1_plain(x, p, H, W)
    if x.dim() != 3 or x.shape[1] != H * W or not x.is_contiguous():
        raise ValueError(f"x: expected a contiguous (B, {H * W}, d) map, got {tuple(x.shape)}")
    if p.w_in.dtype != x.dtype:
        raise TypeError("block operands were packed for another dtype")
    vss_block_v1.launches += 1
    return vss_block_v1_body(x, p, H, W, V1_CUDA_OPS)


vss_block_v1.launches = 0

"""Kernel 1: a whole backbone stage of v05_noz VSSBlocks on the card.

Replaces ``xfmamba_tpu/ops/vss_block_pallas_v2.py::_vss_stage_kernel_v2``
(:542; host ``vss_stage_fused_v2`` :753), which runs every block of a stage
in one Pallas call with the activation held in VMEM.  Here the host loops
over the stage's blocks and launches, per block, the hand-written kernels
of `CUDA_OPS`: the LayerNorm and depthwise conv + SiLU of
``csrc/vss_stage.cu``, the GEMMs with bias / GELU / residual epilogues
(``primitives.gemm_ab_cuda``: the tensor-core kernel of
``csrc/gemm_tc.cu`` for bfloat16, the SIMT kernel for float32) and the
chunked rank-form cross2d scan (``ops/cross2d_scan.py``,
``csrc/ss2d_core_n1.cu``); the activation goes through device memory
between them.  A block without its MLP half (``mlp_ratio`` 0) ends after
out_proj + residual, as the JAX kernel does with ``fuse_mlp`` off.  What
bounds each kernel on the H100 is noted in its source; keeping a block's
activations on chip (the TPU design) is later work.  `SERIAL_OPS` keeps the
serial sequence (every GEMM on the SIMT kernel, the serial scans of
``csrc/nk_scan.cu`` and ``csrc/nk_scan_bwd.cu``), which ``chip_smoke.py``
times beside this one.

`vss_stage` takes `vss_stage_plain` only for CPU tensors; on CUDA tensors it
launches the kernels, adds one to ``vss_stage.launches`` per stage, or
raises.

`stage_route` is the JAX accelerator path's choice for a bfloat16
inference stage, from the v2 helpers copied here as they are
(``_VMEM_BUDGET_V2``, ``_vmem_estimate_v2``, ``pick_group_v2``,
``vss_block_pallas_v2.py:760-806``, with the stage path's weight-window
budget of ``models/vssm.py:336-341``) and the v1 ones of
``ops/vss_block_v1.py``.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from xfmamba_tpu_torch.ops.cost import reports_cost, vss_block_flops
from xfmamba_tpu_torch.ops.cross2d_scan import (
    cross2d_scan, cross2d_scan_bwd, serial_scan, serial_scan_bwd)
from xfmamba_tpu_torch.ops.primitives import (
    dwconv3_silu_bwd_cuda, dwconv3_silu_cuda, forward_only, gemm_ab_cuda, gemm_cuda, gemm_simt,
    gemm_simt_cuda, layer_norm_bwd_cuda, layer_norm_cuda, on_cpu)
from xfmamba_tpu_torch.ops.vss_block import vss_block_body, vss_block_ref
from xfmamba_tpu_torch.ops.vss_block_v1 import fused_vss_block_supported

# the kernels a block's forward and backward launch (twins in
# `ops.vss_block.PLAIN_OPS`)
CUDA_OPS = SimpleNamespace(
    gemm=gemm_cuda, gemm_ab=gemm_ab_cuda, layer_norm=layer_norm_cuda,
    layer_norm_bwd=layer_norm_bwd_cuda, dwconv3_silu=dwconv3_silu_cuda,
    dwconv3_silu_bwd=dwconv3_silu_bwd_cuda, cross2d_scan=cross2d_scan,
    cross2d_scan_bwd=cross2d_scan_bwd)
# the same sequence on the earlier pieces: SIMT GEMMs, the serial scans
SERIAL_OPS = SimpleNamespace(
    gemm=gemm_simt, gemm_ab=gemm_simt_cuda, layer_norm=layer_norm_cuda,
    layer_norm_bwd=layer_norm_bwd_cuda, dwconv3_silu=dwconv3_silu_cuda,
    dwconv3_silu_bwd=dwconv3_silu_bwd_cuda, cross2d_scan=serial_scan,
    cross2d_scan_bwd=serial_scan_bwd)


def vss_stage_plain(x, blocks, H, W):
    """The blocks of a stage, plain: x (B, L, d) -> (B, L, d)."""
    for p in blocks:
        x = vss_block_ref(x, p, H, W)
    return x


@reports_cost(lambda x, blocks, H, W: sum(vss_block_flops(x.shape[0], H * W, p)
                                          for p in blocks))
def vss_stage(x, blocks, H, W):
    """Run a stage (a list of ``VSSBlockOperands``) on x (B, H * W, d)."""
    if on_cpu(x, *(p.w_in for p in blocks)):
        return vss_stage_plain(x, blocks, H, W)
    if torch.is_grad_enabled():
        forward_only("vss_stage", x, *(t for p in blocks for t in vars(p).values()))
    if x.dim() != 3 or x.shape[1] != H * W or not x.is_contiguous():
        raise ValueError(f"x: expected a contiguous (B, {H * W}, d) map, got "
                         f"{tuple(x.shape)}")
    if any(p.w_in.dtype != x.dtype for p in blocks):
        raise TypeError("stage operands were packed for another dtype")
    for p in blocks:
        x = vss_block_body(x, p, H, W, CUDA_OPS)
    vss_stage.launches += 1  # counted once launched
    return x


vss_stage.launches = 0


# ---------------------------------------------------------------------------
# the route of a bfloat16 inference stage (JAX ``VSSM._fused_stage_path``,
# ``VSSBlock._fused_path``)
# ---------------------------------------------------------------------------

_VMEM_BUDGET_V2 = 80 * 1024 * 1024


def _vmem_estimate_v2(L, d, di, hd, G, fuse_mlp):
    """The v2 kernels' VMEM working set in bytes for G images."""

    def pad128(n):
        return ((n + 127) // 128) * 128

    Lg = L * G
    acts = 10 * Lg * pad128(di) * 4 + 3 * Lg * pad128(d) * 4
    weights = 2 * (d * di * 2) + di * 4
    if fuse_mlp:
        weights += 2 * (d * hd * 2)
        acts += Lg * pad128(hd) * 2
    return acts + weights


def pick_group_v2(B, H, W, d, di, hd, fuse_mlp=True, budget_bytes=_VMEM_BUDGET_V2):
    """The v2 kernels' image group, or None where no group of 1, 2, 4 or 8
    images keeps L * G and W * G multiples of 8 within the budget."""
    L = H * W
    if L >= 2048:
        prefs = (1, 2)
    elif L >= 512:
        prefs = (4, 2, 1)
    elif L >= 128:
        prefs = (4, 8, 2)
    else:
        prefs = (8, 4, 2)
    for G in prefs:
        if B % G:
            continue
        if (L * G) % 8 or (W * G) % 8:
            continue
        if _vmem_estimate_v2(L, d, di, hd, G, fuse_mlp) < budget_bytes:
            return G
    return None


def stage_weight_bytes(d, di, hd, fuse_mlp=True):
    """The stage kernel's headroom for its double-buffered per-block weight
    windows (``models/vssm.py:336-338``)."""
    return 2 * (2 * d * di + (2 * d * hd if fuse_mlp else 0) + 3 * di * di // 4) * 2


def stage_route(B, H, W, d, di, hd, depth) -> str:
    """Which kernels run a bfloat16 inference stage of ``depth`` blocks on
    B images of H x W x d, as the JAX accelerator path decides it:

    - "stage": kernel 1.  JAX's stage kernel, where the v2 group rule with
      the stage budget finds a group.  Also where JAX runs the per-block v2
      kernel (the group rule with the full budget, XFMamba-B's stage 3 at
      four or more images per view): kernel 1 computes the same function.
      A depth-1 stage, which JAX never gives the stage kernel, keeps this
      route too.
    - "v1": kernel 8, block by block, where no v2 group exists and
      ``fused_vss_block_supported`` holds.
    - "composable": the composable blocks (kernel 11), where JAX runs no
      whole-block kernel.

    ``hd`` 0 is a block without its MLP half (JAX's ``fuse_mlp`` off,
    ``mlp_ratio`` 0), whose working sets the rules then count without it."""
    if depth < 2:
        return "stage"
    mlp = hd > 0
    budget = _VMEM_BUDGET_V2 - stage_weight_bytes(d, di, hd, mlp)
    if pick_group_v2(B, H, W, d, di, hd, mlp, budget_bytes=budget) is not None:
        return "stage"
    if not fused_vss_block_supported(H, W, d, di, hd, mlp):
        return "composable"
    if pick_group_v2(B, H, W, d, di, hd, mlp) is not None:
        return "stage"
    return "v1"

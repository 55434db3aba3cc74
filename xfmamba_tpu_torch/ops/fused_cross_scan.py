"""Kernel 10: the cross2d SS2D core from precomputed deltas, B and C (port
of ``xfmamba_tpu/ops/selective_scan_pallas.py::fused_cross_scan`` (:214),
TPU kernels ``_scan_kernel`` (:73, any N) and ``_scan_kernel_n1`` (:161),
``pallas_call`` :277, with the merge of ``_core_pallas_fwd_impl``
(:1230-1265) and the custom VJP ``ss2d_core_pallas`` (:1268-1290)).

- `fused_cross_scan`: the kernel, one launch of the whole-map scan
  (``csrc/scan_whole_map.cu``, `fused_cross_scan_cuda`) over the four
  cross2d directions (row_f, col_f, row_r, col_r; the column ones walk
  t = w * H + h, so no transposed copy of x exists).  Each direction's
  y_k = C h + D_k u is kept apart in shared memory, rounded to the input
  dtype for N = 1 as the Pallas kernel writes it, and merged in float32 as
  (y_0 + y_2) + (y_1 + y_3).  Any N up to 16.  `_fused_cross_scan_first`
  is its first design (``csrc/scan_two_level.cu``), for old-against-new
  timings.
- `SS2DCoreFused` / `ss2d_core_fused`: the autograd op.  Its backward
  recomputes through the port's ``models.ss2d.ss2d_core_from_projs`` under
  autograd (kernels 13 and 14 on the card), as JAX's remats through its
  XLA form.

Layouts as ``ss2d_core_from_projs``: x (B, H, W, D); dts (B, H, W, 4, D);
Bs/Cs (B, H, W, 4, N); A (4, D, N); Dmat/bias (4, D); returns (B, H, W, D)
float32.

`fused_cross_scan` takes `fused_cross_scan_plain` only for CPU tensors; on
CUDA tensors it launches the kernel, adds one to
``fused_cross_scan.launches``, or raises.
"""

from __future__ import annotations

import torch

from xfmamba_tpu_torch.kernels import build
from xfmamba_tpu_torch.ops.cost import reports_cost, scan_flops
from xfmamba_tpu_torch.ops.nk_scan import CROSS2D_KINDS, traversal_order
from xfmamba_tpu_torch.ops.nk_scan_v1 import segments_per_chunk
from xfmamba_tpu_torch.ops.primitives import (
    dtype_code, forward_only, on_cpu, ptr, require, require_cuda, stream)
from xfmamba_tpu_torch.ops.scan_whole_map import scan_whole_map_cuda
from xfmamba_tpu_torch.ops.selective_scan import selective_scan_seq

MAX_STATE = 16


def fused_cross_scan_plain(x, dts, Bs, Cs, A, Dmat, bias):
    """Each direction's scan along its traversal (`selective_scan_seq`),
    rounded to x's dtype for N = 1, merged in float32."""
    B, H, W, D = x.shape
    N = A.shape[-1]
    L = H * W
    u = x.reshape(B, L, D)
    parts = []
    for k, kind in enumerate(CROSS2D_KINDS):
        order = traversal_order(kind, H, W, x.device)
        yk = selective_scan_seq(u[:, order], dts.reshape(B, L, 4, D)[:, order, k], A[k],
                                Bs.reshape(B, L, 4, N)[:, order, k:k + 1],
                                Cs.reshape(B, L, 4, N)[:, order, k:k + 1], D=Dmat[k],
                                delta_bias=bias[k])
        if N == 1:
            yk = yk.to(x.dtype).float()
        y = torch.empty(B, L, D, dtype=torch.float32, device=x.device)
        y[:, order] = yk
        parts.append(y)
    return ((parts[0] + parts[2]) + (parts[1] + parts[3])).view(B, H, W, D)


def fused_cross_scan(x, dts, Bs, Cs, A, Dmat, bias):
    """Kernel 10; see the module docstring."""
    if on_cpu(x, dts, Bs, Cs, A, Dmat, bias):
        return fused_cross_scan_plain(x, dts, Bs, Cs, A, Dmat, bias)
    forward_only("fused_cross_scan", x, dts, Bs, Cs, A, Dmat, bias)
    require_cuda(x, dts, Bs, Cs, A, Dmat, bias)
    B, H, W, D = x.shape
    N = A.shape[-1]
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"d_state {N}: kernel 10 takes 1..{MAX_STATE}")
    require(x, (B, H, W, D), name="x")
    for name, t, width in (("dts", dts, D), ("Bs", Bs, N), ("Cs", Cs, N)):
        require(t, (B, H, W, 4, width), x.dtype, name=name)
    require(A, (4, D, N), torch.float32, name="A")
    for name, t in (("Dmat", Dmat), ("bias", bias)):
        require(t, (4, D), torch.float32, name=name)
    out = fused_cross_scan_cuda(x, dts, Bs, Cs, A, Dmat, bias)
    fused_cross_scan.launches += 1  # counted once launched
    return out


fused_cross_scan.launches = 0


def fused_cross_scan_cuda(x, dts, Bs, Cs, A, Dmat, bias, phase_ns=False):
    """Kernel 10 on the card: one launch of ``csrc/scan_whole_map.cu``, A
    read in its (4, D, N) layout; ``phase_ns`` as `scan_whole_map_cuda`."""
    B, H, W, D = x.shape
    N, L = A.shape[-1], H * W
    y = scan_whole_map_cuda(
        x.view(B, L, D), dts.view(B, L, 4, D), Bs.view(B, L, 4, N), Cs.view(B, L, 4, N), A,
        bias, Dmat, CROSS2D_KINDS, H, W, cross=True, out_dtype=torch.float32,
        round_part=N == 1 and x.dtype == torch.bfloat16, phase_ns=phase_ns)
    return y if phase_ns else y.view(B, H, W, D)


def _fused_cross_scan_first(x, dts, Bs, Cs, A, Dmat, bias):
    """Kernel 10's first design (``csrc/scan_two_level.cu``: the scan, each
    direction's part in a float32 scratch, a merge launch), uncounted, for
    old-against-new timings."""
    B, H, W, D = x.shape
    N = A.shape[-1]
    f32 = dict(dtype=torch.float32, device=x.device)
    A_nd = A.transpose(1, 2).contiguous()                 # (4, N, D)
    part = torch.empty(4, B, H * W, D, **f32)
    out = torch.empty(B, H, W, D, **f32)
    build.check(build.library().xfm_fused_cross_scan(
        ptr(x), ptr(dts), ptr(Bs), ptr(Cs), ptr(A_nd), ptr(bias),
        ptr(Dmat), ptr(part), ptr(out), B, H, W, D, N, segments_per_chunk(H, W),
        dtype_code(x), stream(x)), "fused_cross_scan")
    return out


class SS2DCoreFused(torch.autograd.Function):
    """Kernel 10 forward; the backward recomputes ``ss2d_core_from_projs``
    under autograd and differentiates it (JAX ``_pallas_bwd``)."""

    @staticmethod
    def forward(ctx, x, dts, Bs, Cs, A, Dmat, bias):
        ctx.save_for_backward(x, dts, Bs, Cs, A, Dmat, bias)
        return fused_cross_scan(x, dts, Bs, Cs, A, Dmat, bias)

    @staticmethod
    def backward(ctx, g):
        from xfmamba_tpu_torch.models.ss2d import ss2d_core_from_projs
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(saved, ctx.needs_input_grad)]
            y = ss2d_core_from_projs(*leaves, scan_mode="cross2d")
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, g.float()))
        return tuple(next(grads) if t.requires_grad else None for t in leaves)


@reports_cost(lambda x, dts, Bs, Cs, A, Dmat, bias: scan_flops(
    x.shape[0], x.shape[1] * x.shape[2], A.shape[0] * A.shape[1], A.shape[2]))
def ss2d_core_fused(x, dts, Bs, Cs, A, Dmat, bias):
    """The cross2d core from projections through kernel 10, differentiable
    in all seven arguments; operands made contiguous (B and C are views of
    one projection)."""
    def c(t):
        return t.contiguous()

    return SS2DCoreFused.apply(c(x), c(dts), c(Bs), c(Cs), A.float().contiguous(),
                               Dmat.float().contiguous(), bias.float().contiguous())

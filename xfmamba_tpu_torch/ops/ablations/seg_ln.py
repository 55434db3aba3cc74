"""Kernels 20 and 21: the segment-packed LayerNorm (+ exact GELU) and its
backward (port of ``xfmamba_tpu/ops/ablations/seg_ln.py``, TPU kernels
``_seg_ln_fwd_kernel`` :101 and ``_seg_ln_bwd_kernel`` :110, the custom VJP
``seg_ln_act`` :206).

The TPU kernel packs P = lcm(C, 128) / C pixels into one row of full lanes
(`seg_pack`).  On the card (``csrc/ln_act.cu``) kernels 19 and 20 are one
function: tiles of contiguous pixels staged in shared memory by the bulk
copy engine, three in flight a block, a group of threads a pixel (about
three 16-byte pieces a thread); a pixel past 6,144 channels takes a block
of its own, read from device memory.  The backward stages x and g together,
recomputes the statistics, takes the derivative of the forward's own GELU
once an element and writes dscale and dbias as column sums in a fixed order
(a partial row a block, then a second launch), without float atomics.

- `SEG_LN`, `seg_pack` and `seg_ln_supported`: JAX's switch (on: it only
  gates the op, which no model calls) and gate, copied (:56, :64-71,
  :247-259).  The caller checks the gate, as in JAX.
- `seg_ln_act(x, scale, bias, C, eps, act)`: the differentiable op
  (`SegLNAct`: kernel 20 forward, kernel 21 backward).
- `seg_ln_fwd_plain` / `seg_ln_bwd_plain`: the plain twins, the backward
  written as the kernel computes it (recomputed statistics, GELU
  derivative, m1 / m2, the row sums), not by autograd.

The GELU is the erf form in both directions.  The JAX backward takes the
erf derivative even when its forward runs the tanh form under
``GELU_TANH`` (``seg_ln.py:127-132``); the port does not copy that:
forward and backward use the same GELU, as
``tests/test_torch_ablations.py`` pins.

`seg_ln_fwd` and `seg_ln_bwd` take the plain twins only for CPU tensors; on
CUDA tensors they launch the kernel and then add one to their ``launches``
count, or raise.  `seg_ln_fwd_first` and `seg_ln_bwd_first` run the first design (a
segment of `seg_lanes` lanes a pixel, ``csrc/ln_act_v1.cu``), CUDA tensors
only, for old-against-new timings.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from xfmamba_tpu_torch.kernels import build
from xfmamba_tpu_torch.ops.primitives import dtype_code, forward_only, on_cpu, ptr, require, stream

# the op's switch, on as in JAX
SEG_LN = True
# rows per block of the first design's backward (one float32 partial row each)
BWD_ROWS = 128
# the fields of the card's plan (`ln_plan`)
PLAN_FIELDS = ("tiles", "tile", "stages", "stage_bytes", "tpp", "vec", "rowwise", "smem",
               "blocks")
# a block's threads (kLnThreads): the backward's partial rows are sized at
# the most such blocks the card holds at once
LN_THREADS = 256
H100_SMS, SM_THREADS = 132, 2048  # the bound off the card (the emulated library)


def seg_pack(C: int):
    """The TPU's (P, width) lane packing for C channels, or None where the
    width lcm(C, 128) exceeds 1024 (:64-71)."""
    width = (C * 128) // math.gcd(C, 128)
    if width > 1024:
        return None
    return width // C, width


def seg_ln_supported(x_shape, C: int) -> bool:
    """JAX's gate (:247-259): the switch on, C tiling the lanes, the pixel
    count a multiple of P with at least 8 packed rows."""
    if not SEG_LN:
        return False
    pack = seg_pack(C)
    if pack is None:
        return False
    P, _ = pack
    n = math.prod(x_shape[:-1])
    return x_shape[-1] == C and n % P == 0 and n // P >= 8


def seg_lanes(C: int) -> int:
    """Lanes per pixel of the first design: gcd(C, 32) below C = 128 (32 /
    that many pixels per warp, every lane busy), else one pixel per warp."""
    return 32 if C >= 128 else math.gcd(C, 32)


def _stats(xf, eps):
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    return xc * rstd, rstd


def _gelu_grad(z):
    """d/dz of the erf GELU: Phi(z) + z phi(z)."""
    return 0.5 * (1.0 + torch.erf(z * 2.0 ** -0.5)) + z * torch.exp(-0.5 * z * z) / math.sqrt(
        2.0 * math.pi)


def seg_ln_fwd_plain(x, scale, bias, eps=1e-5, act=False):
    """LayerNorm over the last axis in float32 (+ erf GELU); x's dtype."""
    xhat, _ = _stats(x.float(), eps)
    y = xhat * scale.float() + bias.float()
    return (F.gelu(y) if act else y).to(x.dtype)


@torch.no_grad()
def seg_ln_bwd_plain(x, scale, bias, g, eps=1e-5, act=False):
    """Gradients of `seg_ln_fwd_plain` given g (x's shape): dx in x's dtype,
    dscale and dbias float32 (C,), as kernel 21 computes them."""
    C = x.shape[-1]
    xhat, rstd = _stats(x.float().reshape(-1, C), eps)
    s, b = scale.float(), bias.float()
    gf = g.float().reshape(-1, C)
    if act:
        gf = gf * _gelu_grad(xhat * s + b)
    gg = gf * s
    m1 = gg.mean(-1, keepdim=True)
    m2 = (gg * xhat).mean(-1, keepdim=True)
    dx = (gg - m1 - xhat * m2) * rstd
    return dx.to(x.dtype).reshape(x.shape), (gf * xhat).sum(0), gf.sum(0)


def _params(scale, bias, C):
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    require(scale, (C,), name="scale")
    require(bias, (C,), name="bias")
    return scale, bias


def seg_ln_fwd(x, scale, bias, eps=1e-5, act=False):
    """Kernel 20: x (..., C) float32 or bfloat16, scale and bias (C,).
    Returns x's shape and dtype."""
    if on_cpu(x, scale, bias):
        return seg_ln_fwd_plain(x, scale, bias, eps, act)
    forward_only("seg_ln_fwd", x, scale, bias)
    return _fwd(seg_ln_fwd, "xfm_seg_ln_fwd", (), x, scale, bias, eps, act)


def seg_ln_fwd_first(x, scale, bias, eps=1e-5, act=False):
    """`seg_ln_fwd` on the first design's kernel (CUDA tensors only)."""
    return _fwd(seg_ln_fwd_first, "xfm_seg_ln_fwd_first", (seg_lanes(x.shape[-1]),), x, scale,
                bias, eps, act)


def _fwd(counted, entry, plan, x, scale, bias, eps, act):
    """A forward of C entry ``entry`` (the first design's with its lanes a
    pixel, ``plan``), counted on ``counted`` once launched."""
    C = x.shape[-1]
    require(x, tuple(x.shape), name="x")
    scale, bias = _params(scale, bias, C)
    y = torch.empty_like(x)
    build.check(getattr(build.library(), entry)(
        ptr(x), ptr(scale), ptr(bias), ptr(y), x.numel() // C, C, *plan, int(act), eps,
        dtype_code(x), stream(x)), entry)
    counted.launches += 1
    return y


seg_ln_fwd.launches = 0
seg_ln_fwd_first.launches = 0


def ln_plan(x, backward=False) -> dict:
    """The card's plan of kernels 19/20 (or 21 with ``backward``) for x
    (..., C): {field: value} of `PLAN_FIELDS`; "blocks" is the grid (the
    card's resident blocks, at most one a tile; the backward's partial
    rows)."""
    C = x.shape[-1]
    out = (ctypes.c_longlong * len(PLAN_FIELDS))()
    build.check(build.library().xfm_ln_plan(x.numel() // C, C, dtype_code(x), int(backward),
                                            out), "ln_plan")
    return dict(zip(PLAN_FIELDS, out))


@functools.lru_cache(maxsize=None)
def _resident_blocks(device) -> int:
    """The most blocks of `LN_THREADS` the device holds at once: its SMs
    times the blocks an SM's threads allow."""
    if device.type != "cuda":
        return H100_SMS * SM_THREADS // LN_THREADS
    p = torch.cuda.get_device_properties(device)
    return p.multi_processor_count * p.max_threads_per_multi_processor // LN_THREADS


def seg_ln_bwd(x, scale, bias, g, eps=1e-5, act=False):
    """Kernel 21: given g (x's shape and dtype), (dx in x's dtype, dscale,
    dbias float32 (C,))."""
    if on_cpu(x, scale, bias, g):
        return seg_ln_bwd_plain(x, scale, bias, g, eps, act)
    C, rows = x.shape[-1], x.numel() // x.shape[-1]
    # room for any grid: 2 C column sums a block, then C of the row path's
    # scratch a block
    capacity = max(1, min(rows, _resident_blocks(x.device)))
    return _bwd(seg_ln_bwd, "xfm_seg_ln_bwd", (3 * capacity * C,), (capacity,), x, scale, bias,
                g, eps, act)


def seg_ln_bwd_first(x, scale, bias, g, eps=1e-5, act=False):
    """`seg_ln_bwd` on the first design's kernel (CUDA tensors only)."""
    C, rows = x.shape[-1], x.numel() // x.shape[-1]
    return _bwd(seg_ln_bwd_first, "xfm_seg_ln_bwd_first", (2 * C, -(-rows // BWD_ROWS)),
                (seg_lanes(C), BWD_ROWS), x, scale, bias, g, eps, act)


def _bwd(counted, entry, partial_shape, plan, x, scale, bias, g, eps, act):
    """A backward of C entry ``entry``: its float32 partial sums of
    ``partial_shape``, its ``plan`` (the capacity of the partial sums'
    rows, or the first design's lanes a pixel and rows a block); counted
    on ``counted`` once launched."""
    C, rows = x.shape[-1], x.numel() // x.shape[-1]
    require(x, tuple(x.shape), name="x")
    require(g, tuple(x.shape), x.dtype, name="g")
    scale, bias = _params(scale, bias, C)
    f32 = dict(dtype=torch.float32, device=x.device)
    partial = torch.empty(partial_shape, **f32)
    dsb = torch.empty(2, C, **f32)
    dx = torch.empty_like(x)
    build.check(getattr(build.library(), entry)(
        ptr(x), ptr(g), ptr(scale), ptr(bias), ptr(dx), ptr(partial), ptr(dsb), rows, C, *plan,
        int(act), eps, dtype_code(x), stream(x)), entry)
    counted.launches += 1
    return dx, dsb[0], dsb[1]


seg_ln_bwd.launches = 0
seg_ln_bwd_first.launches = 0


class SegLNAct(torch.autograd.Function):
    """Kernel 20 forward, kernel 21 backward (the custom VJP of JAX's
    ``seg_ln_act``); saves the inputs, the backward recomputes."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, act):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps, ctx.act = eps, act
        return seg_ln_fwd(x, scale, bias, eps, act)

    @staticmethod
    def backward(ctx, gy):
        x, scale, bias = ctx.saved_tensors
        dx, dscale, dbias = seg_ln_bwd(x, scale, bias, gy.to(x.dtype).contiguous(), ctx.eps,
                                       ctx.act)
        return dx, dscale.to(scale.dtype), dbias.to(bias.dtype), None, None


def seg_ln_act(x, scale, bias, C: int, eps: float = 1e-5, act: bool = False):
    """LayerNorm over the trailing C channels of NHWC x (+ the erf GELU),
    differentiable.  The caller checks `seg_ln_supported`, as in JAX."""
    if x.shape[-1] != C:
        raise ValueError(f"x has {x.shape[-1]} channels, expected {C}")
    return SegLNAct.apply(x, scale, bias, eps, act)

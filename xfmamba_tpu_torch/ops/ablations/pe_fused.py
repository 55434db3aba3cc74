"""Kernel 19: per-pixel LayerNorm with an optional GELU (port of
``xfmamba_tpu/ops/ablations/pe_fused.py``, TPU kernel ``_ln_act_kernel`` :46,
host ``ln_act_fused`` :61).

The JAX package builds XFMamba-S's patch embed from it in an A/B script
(conv1 -> ``ln_act_fused`` with GELU -> conv2 -> ``ln_act_fused``); no model
calls it.  On the card it is the staged streaming forward of
``csrc/ln_act.cu`` (entry ``xfm_ln_act``, kernel 20's function): tiles of
contiguous pixels brought into shared memory by the bulk copy engine, a
group of threads a pixel.  The GELU is the erf form, the port's GELU
(``models/layers.py::gelu``).

- `PE_FUSED` and `ln_act_supported`: JAX's switch (off) and gate, with "the
  TPU backend" read as "a CUDA tensor".
- `ln_act_fused` takes float32 or bfloat16, as the JAX op does in interpret
  mode; its plain twin only for CPU tensors, else the kernel (counted in
  ``ln_act_fused.launches`` once launched) or an exception.
- `ln_act_fused_first`: the first design (a warp a pixel,
  ``csrc/ln_act_v1.cu``), CUDA tensors only, for old-against-new timings.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from xfmamba_tpu_torch.kernels import build
from xfmamba_tpu_torch.ops.primitives import (
    dtype_code, forward_only, layer_norm_plain, on_cpu, ptr, require, stream)

# off by default, as in JAX (measured slower than XLA's lowering on the TPU)
PE_FUSED = False


def ln_act_supported(x: torch.Tensor, dtype: torch.dtype) -> bool:
    """JAX's gate (:88-98): the switch on, bfloat16, a CUDA tensor, H * W
    and C multiples of 8."""
    if not PE_FUSED or dtype != torch.bfloat16 or x.dtype != torch.bfloat16:
        return False
    if not x.is_cuda:
        return False
    _, H, W, C = x.shape
    return (H * W) % 8 == 0 and C % 8 == 0


def ln_act_fused_plain(x, scale, bias, act_gelu=False, eps=1e-5):
    """LayerNorm over the last axis of x (B, H, W, C) in float32, then the
    erf GELU when ``act_gelu``; returns x's dtype."""
    y = layer_norm_plain(x, scale, bias, torch.float32, eps)
    return (F.gelu(y) if act_gelu else y).to(x.dtype)


def ln_act_fused(x, scale, bias, act_gelu=False, eps=1e-5):
    """x (B, H, W, C) float32 or bfloat16; scale, bias (C,).  Returns
    (B, H, W, C) in x's dtype."""
    if on_cpu(x, scale, bias):
        return ln_act_fused_plain(x, scale, bias, act_gelu, eps)
    forward_only("ln_act_fused", x, scale, bias)
    return _launch(ln_act_fused, "xfm_ln_act", x, scale, bias, act_gelu, eps)


def ln_act_fused_first(x, scale, bias, act_gelu=False, eps=1e-5):
    """`ln_act_fused` on the first design's kernel (CUDA tensors only)."""
    return _launch(ln_act_fused_first, "xfm_ln_act_first", x, scale, bias, act_gelu, eps)


def _launch(counted, entry, x, scale, bias, act_gelu, eps):
    """One launch of C entry ``entry``, counted on ``counted`` once launched."""
    B, H, W, C = x.shape
    require(x, (B, H, W, C), name="x")
    scale = scale.float().contiguous()
    bias = bias.float().contiguous()
    require(scale, (C,), name="scale")
    require(bias, (C,), name="bias")
    y = torch.empty_like(x)
    build.check(getattr(build.library(), entry)(
        ptr(x), ptr(scale), ptr(bias), ptr(y), B * H * W, C, int(act_gelu), eps,
        dtype_code(x), stream(x)), entry)
    counted.launches += 1
    return y


ln_act_fused.launches = 0
ln_act_fused_first.launches = 0

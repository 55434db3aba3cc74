"""Dropout + residual + LayerNorm / RMSNorm (+ linear), the op family of
the reference's Triton layer-norm package (port of
``xfmamba_tpu/ops/layer_norm.py``): `layer_norm_fn`, `rms_norm_fn` and
`layer_norm_linear_fn`, in plain torch, as the JAX package's are an XLA
lowering with no Pallas kernel.  No model calls them.

Dropout draws its masks from the ``torch.Generator`` the caller passes
(``dropout_generator``), never from the global generator: the main
branch's mask first, then the parallel branch's; ``return_dropout_mask``
returns them as JAX does (the masks' values differ from JAX's, whose
random numbers are its own).
"""

from __future__ import annotations

import torch


def _norm(x, weight, bias, eps, is_rms_norm):
    """Float32 LayerNorm / RMSNorm over the last axis; a None weight scales
    by one."""
    if is_rms_norm:
        xhat = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    else:
        xc = x - x.mean(-1, keepdim=True)
        xhat = xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    if weight is not None:
        xhat = xhat * weight.to(torch.float32)
    if bias is not None:
        xhat = xhat + bias.to(torch.float32)
    return xhat


def _dropout(x, p, generator):
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), device=x.device)), keep


def layer_norm_fn(x, weight, bias=None, residual=None, x1=None, weight1=None, bias1=None,
                  eps: float = 1e-6, dropout_p: float = 0.0, rowscale=None,
                  prenorm: bool = False, residual_in_fp32: bool = False,
                  is_rms_norm: bool = False, dropout_generator=None,
                  return_dropout_mask: bool = False):
    """``layer_norm_ref`` semantics: x scaled by ``rowscale`` (main branch
    only), dropout on x and x1 (independent masks), x + x1, + residual
    (float32), out = norm(x, weight, bias) and out1 = norm(x, weight1,
    bias1).  Returns out [, out1] [, the residual stream if ``prenorm``]
    [, the masks if ``return_dropout_mask``]; the residual stream is
    float32 with ``residual_in_fp32`` or a float32 residual, else x's
    dtype."""
    dtype = x.dtype
    res_dtype = torch.float32 if residual_in_fp32 else (
        residual.dtype if residual is not None else dtype)
    xf = x.to(torch.float32)
    x1f = None if x1 is None else x1.to(torch.float32)
    if rowscale is not None:
        if x1 is not None:
            raise ValueError("rowscale does not go with a parallel branch")
        xf = xf * rowscale.to(torch.float32)[..., None]
    mask = mask1 = None
    if dropout_p > 0.0:
        if dropout_generator is None:
            raise ValueError("dropout needs dropout_generator")
        xf, mask = _dropout(xf, dropout_p, dropout_generator)
        if x1f is not None:
            x1f, mask1 = _dropout(x1f, dropout_p, dropout_generator)
    if x1f is not None:
        xf = xf + x1f
    if residual is not None:
        xf = xf + residual.to(torch.float32)
    outs = (_norm(xf, weight, bias, eps, is_rms_norm).to(dtype),)
    if weight1 is not None:
        outs += (_norm(xf, weight1, bias1, eps, is_rms_norm).to(dtype),)
    if prenorm:
        outs += (xf.to(res_dtype),)
    if return_dropout_mask:
        outs += (mask,) if x1 is None else (mask, mask1)
    return outs[0] if len(outs) == 1 else outs


def rms_norm_fn(x, weight, bias=None, residual=None, x1=None, weight1=None, bias1=None,
                eps: float = 1e-6, dropout_p: float = 0.0, rowscale=None,
                prenorm: bool = False, residual_in_fp32: bool = False,
                dropout_generator=None, return_dropout_mask: bool = False):
    """`layer_norm_fn` as an RMSNorm."""
    return layer_norm_fn(x, weight, bias, residual, x1, weight1, bias1, eps, dropout_p,
                         rowscale, prenorm, residual_in_fp32, True, dropout_generator,
                         return_dropout_mask)


def layer_norm_linear_fn(x, norm_weight, norm_bias, linear_weight, linear_bias=None,
                         residual=None, eps: float = 1e-6, prenorm: bool = False,
                         residual_in_fp32: bool = False, is_rms_norm: bool = False):
    """out = norm(x [+ residual]) @ linear_weight [+ linear_bias], the
    product in x's dtype with float32 sums; ``linear_weight`` is
    (d_in, d_out) as in the JAX package.  With ``prenorm`` also the
    residual stream."""
    dtype = x.dtype
    res_dtype = torch.float32 if residual_in_fp32 else (
        residual.dtype if residual is not None else dtype)
    xf = x.to(torch.float32)
    if residual is not None:
        xf = xf + residual.to(torch.float32)
    y = _norm(xf, norm_weight, norm_bias, eps, is_rms_norm).to(dtype)
    out = torch.matmul(y, linear_weight.to(dtype)).to(torch.float32)
    if linear_bias is not None:
        out = out + linear_bias.to(torch.float32)
    out = out.to(dtype)
    return (out, xf.to(res_dtype)) if prenorm else out

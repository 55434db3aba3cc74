"""The device preprocessing kernel (``csrc/device_preprocess.cu``, entry
``xfm_device_preprocess``) and its plain version.

It replaces no ``pallas_call``: the JAX package writes the stage in jnp
(``xfmamba_tpu/data/device_pipeline.py``) and XLA fuses it into the jitted
steps.  One launch turns a batch of one view, staged as uint8 (B, Hs, Ws,
1), into float32 (B, h, w, 1): u8 / 255, the bilinear resize to the image
size as ``jax.image.resize(..., "bilinear", antialias=False)`` computes it,
then per sample a crop at (top, left), a horizontal flip and a nearest
rotation with zero fill, then ``(x - mean) / std`` where the stage
normalizes.

- `resize_weights` / `resize_taps`: JAX's weights of one axis (half-pixel
  centres, a triangle kernel, normalised by their sum, zero outside the
  input) in float32, and the two taps an output position takes.
- `param_rows`: a sample's (top, left, flip, cos, sin) in float32, cos and
  sin of the angle in radians taken once here, as the kernel reads them.
- `device_preprocess`: the kernel for CUDA tensors (counted in
  ``device_preprocess.launches`` once launched) or an exception; its plain
  version `device_preprocess_plain` for CPU tensors, each step on its own
  in torch (`rotation_source` the rotation's index map), every product and
  sum rounded once in the kernel's order, so that the two agree bit for
  bit.
- `resize_bilinear`: ``jax.image.resize(x, ..., "bilinear", antialias)`` on
  (B, H, W[, C]) float32 by the dense weight matrices (Grad-CAM's upsampling
  takes it with ``antialias=True``, as JAX's default).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from xfmamba_tpu_torch.kernels import build
from xfmamba_tpu_torch.ops.primitives import forward_only, on_cpu, ptr, require, stream

ROW = 5  # top, left, flip, cos, sin


def resize_weights(n_in: int, n_out: int, antialias: bool = False) -> torch.Tensor:
    """(n_in, n_out) float32: ``jax.image.resize``'s weights of one axis for
    the bilinear (triangle) kernel, as its ``compute_weight_mat`` computes
    them in float32."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / kernel_scale
    weights = torch.clamp(1 - x, min=0)
    total = weights.sum(0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


@functools.lru_cache(maxsize=None)
def _taps(n_in: int, n_out: int, device: torch.device):
    w = resize_weights(n_in, n_out)
    nonzero = w != 0
    if int(nonzero.sum(0).max()) > 2:
        raise ValueError(f"{n_in} -> {n_out}: more than two taps an output")
    first = torch.where(nonzero.any(0), nonzero.int().argmax(0), torch.zeros(n_out, dtype=torch.long))
    second = torch.clamp(first + 1, max=n_in - 1)
    cols = torch.arange(n_out)
    w0 = w[first, cols]
    w1 = torch.where(first + 1 < n_in, w[second, cols], torch.zeros_like(w0))
    return first.int().to(device), torch.stack([w0, w1], 1).to(device)


def resize_taps(n_in: int, n_out: int, device="cpu"):
    """(first tap (n_out,) int32, weights (n_out, 2) float32) of the resize
    of one axis from ``n_in`` to ``n_out``: output position o reads inputs
    first[o] and min(first[o] + 1, n_in - 1), the second with weight 0 where
    the first is the last input.  Cached per device."""
    return _taps(n_in, n_out, torch.device(device))


def param_rows(top, left, flip, angle) -> torch.Tensor:
    """(B, 5) float32 rows (top, left, flip, cos, sin) of per-sample crop
    offsets, flip flags and angles in degrees, on the CPU; the radians are
    ``angle * float32(pi / 180)`` and cos and sin are taken in float32."""
    angle = torch.as_tensor(angle, dtype=torch.float32)
    rad = angle * torch.tensor(np.float32(np.pi / 180))
    cols = [torch.as_tensor(v).to(torch.float32) for v in (top, left, flip)]
    return torch.stack(cols + [torch.cos(rad), torch.sin(rad)], 1).contiguous()


def rotation_source(h: int, w: int, cos: torch.Tensor, sin: torch.Tensor):
    """The nearest rotation's inverse map of (B,) cos / sin over an (h, w)
    window: (sy, sx) int64 (B, h, w), clipped into the window, and the mask
    of sources inside it, on cos's device.  ``round`` is half to even, as
    ``jnp.round``."""
    f32 = dict(dtype=torch.float32, device=cos.device)
    cy = torch.tensor(np.float32((h - 1) / 2.0), **f32)
    cx = torch.tensor(np.float32((w - 1) / 2.0), **f32)
    yy = (torch.arange(h, **f32) - cy)[None, :, None]
    xx = (torch.arange(w, **f32) - cx)[None, None, :]
    c, s = cos[:, None, None], sin[:, None, None]
    sx = torch.round((c * xx - s * yy) + cx).long()
    sy = torch.round((s * xx + c * yy) + cy).long()
    valid = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    return sy.clamp(0, h - 1), sx.clamp(0, w - 1), valid


def _resize_plain(x, out_hw):
    """The two-tap resize of (B, Hs, Ws) float32 to ``out_hw``, the row
    pair first, then the column, each product and sum rounded once."""
    B, Hs, Ws = x.shape
    ty, wy = resize_taps(Hs, out_hw[0], x.device)
    tx, wx = resize_taps(Ws, out_hw[1], x.device)
    y0, x0 = ty.long(), tx.long()
    y1, x1 = (y0 + 1).clamp(max=Hs - 1), (x0 + 1).clamp(max=Ws - 1)
    rows0, rows1 = x[:, y0], x[:, y1]                         # (B, Hr, Ws)
    r0 = wx[:, 0] * rows0[:, :, x0] + wx[:, 1] * rows0[:, :, x1]
    r1 = wx[:, 0] * rows1[:, :, x0] + wx[:, 1] * rows1[:, :, x1]
    return wy[None, :, 0, None] * r0 + wy[None, :, 1, None] * r1


def device_preprocess_plain(u8, out_hw, rows=None, crop=None, rotate=False, mean=None,
                            std=None):
    """The kernel's function on the CPU, step by step as the JAX stage runs
    it: u8 / 255, resize to ``out_hw``, then with ``rows`` (B, 5) the crop
    to ``crop`` x ``crop`` (the image size where None), the flip and, with
    ``rotate``, the rotation; then the normalize where ``mean`` is given.
    Returns (B, h, w, 1) float32 on u8's device."""
    x = _resize_plain(u8[..., 0].float() / 255, out_hw)
    if rows is not None:
        B, dev = x.shape[0], x.device
        h, w = (crop, crop) if crop else out_hw
        top, left = rows[:, 0].long(), rows[:, 1].long()
        ys = top[:, None] + torch.arange(h, device=dev)[None]
        xs = left[:, None] + torch.arange(w, device=dev)[None]
        images = torch.arange(B, device=dev)[:, None, None]
        x = x[images, ys[:, :, None], xs[:, None, :]]
        x = torch.where(rows[:, 2, None, None] != 0, x.flip(2), x)
        if rotate:
            sy, sx, valid = rotation_source(h, w, rows[:, 3], rows[:, 4])
            x = torch.where(valid, x[images, sy, sx], torch.zeros((), device=dev))
    if mean is not None:
        x = (x - mean) / std
    return x[..., None].contiguous()


def device_preprocess(u8, out_hw, rows=None, crop=None, rotate=False, mean=None, std=None):
    """u8 (B, Hs, Ws, 1) uint8 staged views -> (B, h, w, 1) float32, where
    (h, w) is (crop, crop) with ``rows`` and a crop, else ``out_hw``.
    ``rows`` (B, 5) float32 as `param_rows` (None: the eval transform);
    ``rotate`` applies the rows' rotation; ``mean`` / ``std`` the normalize
    (None: none).  CPU tensors take the plain version; CUDA tensors one
    launch of the kernel, or an exception."""
    if on_cpu(u8, rows):
        return device_preprocess_plain(u8, out_hw, rows, crop, rotate, mean, std)
    forward_only("device_preprocess", u8, rows)
    B, Hs, Ws, _ = u8.shape
    require(u8, (B, Hs, Ws, 1), torch.uint8, name="u8")
    Hr, Wr = out_hw
    h, w = (crop, crop) if (rows is not None and crop) else (Hr, Wr)
    if h > Hr or w > Wr:
        raise ValueError(f"a {h}x{w} crop of a {Hr}x{Wr} image")
    if rows is not None:
        require(rows, (B, ROW), torch.float32, name="rows")
    ty, wy = resize_taps(Hs, Hr, u8.device)
    tx, wx = resize_taps(Ws, Wr, u8.device)
    out = torch.empty(B, h, w, 1, dtype=torch.float32, device=u8.device)
    normalize = mean is not None
    build.check(build.library().xfm_device_preprocess(
        ptr(u8), ptr(out), ptr(rows), ptr(ty), ptr(wy), ptr(tx), ptr(wx), B, Hs, Ws, h, w,
        int(bool(rotate)), int(normalize), float(mean) if normalize else 0.0,
        float(std) if normalize else 1.0, stream(u8)), "device_preprocess")
    device_preprocess.launches += 1
    return out


device_preprocess.launches = 0


def resize_bilinear(x: torch.Tensor, out_hw, antialias: bool = True) -> torch.Tensor:
    """``jax.image.resize(x, (B, h, w[, C]), "bilinear", antialias)`` of a
    float32 (B, H, W) or (B, H, W, C) tensor: each resized axis contracted
    with its `resize_weights` (an axis of equal size is left as it is, as
    in JAX)."""
    H, W = x.shape[1:3]
    h, w = out_hw
    if (H, W) != (h, w):
        if H != h:
            x = torch.einsum("bh...,hH->bH...", x, resize_weights(H, h, antialias).to(x))
        if W != w:
            x = torch.einsum("bHw...,wW->bHW...", x, resize_weights(W, w, antialias).to(x))
    return x


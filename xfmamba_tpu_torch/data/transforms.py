"""Host-side image transforms in numpy (port of
``xfmamba_tpu/data/transforms.py`` without cv2 or PIL).

The JAX package calls cv2; this module computes what those calls compute:
- `resize`: ``cv2.resize(INTER_LINEAR)`` on uint8 in cv2's fixed point
  (half-pixel centres, edges clamped, weights rounded to 1/2048, the
  vertical pass as cv2's vector loop rounds it), and on float32 as cv2's
  float path computes it (`_float_taps`; each pass ``a + (b - a) t`` with
  one rounding, as a fused multiply-add);
- `random_rotation`: ``cv2.warpAffine(INTER_NEAREST, borderValue=0)``
  about ``(w/2 - 0.5, h/2 - 0.5)``, the inverse map in float32 as cv2's
  warp computes it, with the angle drawn by the same ``rng`` call as JAX's.
Crop, flip and every draw take the same ``rng`` calls in the same order, so
one ``np.random.Generator`` gives both packages the same augmentation.

The MURA pipeline (``libs/dataset_mura_twoview.py:808-816``): Grayscale,
Resize(224²), RandomCrop(224), HFlip, RandomRotation(30, nearest),
ToTensor, Normalize([0.456], [0.224]); CheXpert's differs only in having no
Normalize (``dataset_chexpert_twoview.py:289-303``).  Outputs are
channels-last (H, W, 1) float32; the u8 normalisation runs in the native
library.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

COEF_BITS = 11           # cv2 INTER_RESIZE_COEF_BITS


def _linear_taps(src: int, dst: int, clamp_weights: bool):
    """cv2's source indices and fixed-point weight pair of each output
    position along one axis (``resize.cpp``, INTER_LINEAR).  Along x cv2
    moves a tap past an edge onto the edge with weight (1, 0); along y it
    keeps the weights and clamps only the row indices."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = f - i0.astype(np.float32)
    if clamp_weights:
        low = i0 < 0
        f[low], i0[low] = 0.0, 0
        high = i0 >= src - 1
        f[high], i0[high] = 0.0, src - 1
    one = np.float32(1 << COEF_BITS)
    w0 = np.rint((np.float32(1.0) - f) * one).astype(np.int64)
    w1 = np.rint(f * one).astype(np.int64)
    return np.clip(i0, 0, src - 1), np.clip(i0 + 1, 0, src - 1), w0, w1


def _float_taps(src: int, dst: int):
    """cv2's source index and weight of the second tap of each output
    position along one axis on its float path: the position
    ``(i + 0.5) src / dst - 0.5`` in float64, its floor, and the fraction
    cast to float32 (which may round to 1)."""
    pos = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    i0 = np.floor(pos).astype(np.int64)
    return i0, (pos - i0).astype(np.float32)


def _lerp(a: np.ndarray, b: np.ndarray, t: np.ndarray) -> np.ndarray:
    """``a + (b - a) t`` in float32 with the product and the sum rounded
    once (cv2's fused multiply-add), through float64."""
    return (a.astype(np.float64) + (b - a).astype(np.float64) * t).astype(np.float32)


def _resize_float(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)`` on (H, W)
    float32: the taps of `_float_taps`, the edges along x moved onto the
    edge with weight 0, the rows along y clamped with their weights kept,
    then `_lerp` along x and along y."""
    h, w = size
    H, W = img.shape
    x0, fx = _float_taps(W, w)
    edge = (x0 < 0) | (x0 >= W - 1)
    fx[edge] = 0
    x0 = np.clip(x0, 0, W - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    y0, fy = _float_taps(H, h)
    y1, y0 = np.clip(y0 + 1, 0, H - 1), np.clip(y0, 0, H - 1)
    rows = np.unique(np.concatenate([y0, y1]))
    src = img[rows]
    horiz = np.zeros((H, w), np.float32)
    horiz[rows] = _lerp(src[:, x0], src[:, x1], fx)
    return _lerp(horiz[y0], horiz[y1], fy[:, None])


def resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Resize (H, W) uint8 or float32 to exactly ``size`` = (h, w),
    bilinear, as ``cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)``
    computes it.  uint8: the horizontal pass in int32 (weights of 2048ths),
    the vertical pass as cv2's vector loop does it, ``((r0 >> 4) b0 >> 16)
    + ((r1 >> 4) b1 >> 16)`` rounded by ``(v + 2) >> 2``; float32:
    `_resize_float`."""
    h, w = size
    if img.shape[:2] == (h, w):
        return img
    if img.ndim != 2 or img.dtype not in (np.uint8, np.float32):
        raise ValueError(f"resize takes (H, W) uint8 or float32, got {img.dtype} {img.shape}")
    if img.dtype == np.float32:
        return _resize_float(img, size)
    H, W = img.shape
    x0, x1, a0, a1 = _linear_taps(W, w, clamp_weights=True)
    y0, y1, b0, b1 = _linear_taps(H, h, clamp_weights=False)
    rows = np.unique(np.concatenate([y0, y1]))
    src = img[rows].astype(np.int32)
    horiz = np.zeros((H, w), np.int32)
    horiz[rows] = (src[:, x0] * a0.astype(np.int32) + src[:, x1] * a1.astype(np.int32)) >> 4
    v = ((horiz[y0] * b0[:, None].astype(np.int32)) >> 16) + \
        ((horiz[y1] * b1[:, None].astype(np.int32)) >> 16)
    return np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)


def random_crop(img: np.ndarray, size: int, rng: np.random.Generator,
                pad_if_needed: bool = True) -> np.ndarray:
    h, w = img.shape[:2]
    if h < size or w < size:
        ph, pw = max(0, size - h), max(0, size - w)
        img = np.pad(img, ((0, ph), (0, pw)) + ((0, 0),) * (img.ndim - 2))
        h, w = img.shape[:2]
    top = int(rng.integers(0, h - size + 1))
    left = int(rng.integers(0, w - size + 1))
    return img[top:top + size, left:left + size]


def random_hflip(img: np.ndarray, rng: np.random.Generator, p: float = 0.5) -> np.ndarray:
    if rng.random() < p:
        return img[:, ::-1]
    return img


def rotation_matrix(center, angle: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, 1.0)``."""
    a = math.radians(angle)
    alpha, beta = math.cos(a), math.sin(a)
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def warp_nearest(img: np.ndarray, m: np.ndarray) -> np.ndarray:
    """``cv2.warpAffine(img, m, (w, h), flags=INTER_NEAREST, borderValue=0)``
    as cv2's float32 warp computes it: the inverse of ``m`` (in float64)
    cast to float32, each row's term ``a12 y + b1`` in float32, then a fused
    multiply-add with ``a11 x`` (emulated in float64), rounded half to even
    to the nearest source pixel; outside the image is 0."""
    h, w = img.shape[:2]
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = -m[0, 1] * d, -m[1, 0] * d
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    a11, a12, b1, a21, a22, b2 = (np.float32(v) for v in (a11, a12, b1, a21, a22, b2))
    xs, ys = np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32)

    def coord(ax, ay, b):
        row = (ay * ys + b).astype(np.float64)[:, None]
        fused = (np.float64(ax) * xs.astype(np.float64))[None, :] + row
        return np.rint(fused.astype(np.float32)).astype(np.int64)

    sx, sy = coord(a11, a12, b1), coord(a21, a22, b2)
    inside = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    out = np.zeros_like(img)
    out[inside] = img[sy[inside], sx[inside]]
    return out


def random_rotation(img: np.ndarray, degrees: float, rng: np.random.Generator) -> np.ndarray:
    """Uniform rotation in ±degrees about the centre, nearest, fill 0."""
    angle = float(rng.uniform(-degrees, degrees))
    h, w = img.shape[:2]
    return warp_nearest(img, rotation_matrix((w / 2 - 0.5, h / 2 - 0.5), angle))


def to_float(img: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] -> float32 [0, 1] with a trailing channel axis."""
    out = img.astype(np.float32) / 255.0
    if out.ndim == 2:
        out = out[:, :, None]
    return out


@dataclasses.dataclass
class TwoViewTransform:
    """Composed per-view transform; ``train=False`` applies resize only."""
    image_size: Tuple[int, int] = (224, 224)
    crop: Optional[int] = 224
    hflip: bool = True
    rotation: float = 30.0
    normalize_mean: Optional[float] = 0.456
    normalize_std: Optional[float] = 0.224
    train: bool = True

    def __call__(self, img: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        img = resize(img, self.image_size)
        if self.train:
            rng = rng or np.random.default_rng()
            if self.crop:
                img = random_crop(img, self.crop, rng)
            if self.hflip:
                img = random_hflip(img, rng)
            if self.rotation:
                img = random_rotation(img, self.rotation, rng)
        if img.dtype == np.uint8 and self.normalize_mean is not None and img.ndim == 2:
            from xfmamba_tpu_torch.native import normalize_u8
            return np.ascontiguousarray(
                normalize_u8(img, self.normalize_mean, self.normalize_std)[:, :, None])
        img = to_float(img)
        if self.normalize_mean is not None:
            img = (img - self.normalize_mean) / self.normalize_std
        return np.ascontiguousarray(img)


def mura_train_transform(image_size=(224, 224)):
    # the reference hardcodes RandomCrop(224) (`:811`), a no-op at the
    # default 224² resize; clamped to the configured size otherwise
    return TwoViewTransform(image_size=image_size, train=True, crop=min(224, *image_size))


def mura_eval_transform(image_size=(224, 224)):
    return TwoViewTransform(image_size=image_size, train=False)


def chexpert_train_transform(image_size=(224, 224)):
    # no Normalize (commented out in the reference, :295)
    return TwoViewTransform(image_size=image_size, train=True, crop=min(224, *image_size),
                            normalize_mean=None, normalize_std=None)


def chexpert_eval_transform(image_size=(224, 224)):
    return TwoViewTransform(image_size=image_size, train=False, normalize_mean=None,
                            normalize_std=None)

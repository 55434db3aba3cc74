"""The gray conversions the readers share: cv2's colour -> gray and PIL's
``convert("L")`` from each of its modes.

cv2 (``imgcodecs``' ``icvCvt_BGR2Gray`` family): ``(4899 R + 9617 G + 1868
B + 8192) >> 14`` on 8-bit samples.  PIL (``Convert.c``): ``L24``, ``(19595
R + 38470 G + 7471 B + 32768) >> 16``; ``1`` to 0 / 255; ``I;16`` and
``I`` clipped to 0-255; ``F`` clipped to 0-255 and truncated (NaN to 0);
``LA`` its L band; ``P`` and ``PA`` through the palette and ``L24``;
``CMYK`` through ``cmyk2rgb`` (``255 - k - MULDIV255(c, 255 - k)``) and
``L24``.
"""

from __future__ import annotations

import numpy as np


def cv2_gray(r, g, b) -> np.ndarray:
    """cv2's 8-bit colour -> gray."""
    r, g, b = (np.asarray(c, np.int64) for c in (r, g, b))
    return ((4899 * r + 9617 * g + 1868 * b + 8192) >> 14).astype(np.uint8)


def pil_l24(r, g, b) -> np.ndarray:
    """PIL's 8-bit RGB -> L."""
    r, g, b = (np.asarray(c, np.int64) for c in (r, g, b))
    return ((19595 * r + 38470 * g + 7471 * b + 32768) >> 16).astype(np.uint8)


def muldiv255(a, b) -> np.ndarray:
    t = np.asarray(a, np.int64) * np.asarray(b, np.int64) + 128
    return ((t >> 8) + t) >> 8


def pil_to_l(arr: np.ndarray, mode: str, palette=None) -> np.ndarray:
    """PIL's ``convert("L")`` of an image of ``mode`` held as its numpy
    array (``np.asarray`` of the image); ``palette`` (n, 3) uint8 for ``P``
    and ``PA``."""
    if mode == "1":
        return np.where(arr != 0, 255, 0).astype(np.uint8)
    if mode == "L":
        return np.ascontiguousarray(arr, dtype=np.uint8)
    if mode in ("I;16", "I;16B", "I;16L", "I"):
        return np.clip(arr.astype(np.int64), 0, 255).astype(np.uint8)
    if mode == "F":
        f = arr.astype(np.float32)
        out = np.zeros(f.shape, np.uint8)
        inside = (f > 0) & (f < 255)
        out[inside] = f[inside].astype(np.uint8)
        out[f >= 255] = 255
        return out
    if mode == "LA":
        return np.ascontiguousarray(arr[..., 0], dtype=np.uint8)
    if mode in ("P", "PA"):
        pal = np.zeros((256, 3), np.uint8)
        if palette is not None:
            pal[:len(palette)] = palette[:256]
        idx = arr[..., 0] if mode == "PA" else arr
        rgb = pal[idx]
        return pil_l24(rgb[..., 0], rgb[..., 1], rgb[..., 2])
    if mode == "CMYK":
        nk = 255 - arr[..., 3].astype(np.int64)
        rgb = [np.clip(nk - muldiv255(arr[..., i], nk), 0, 255) for i in range(3)]
        return pil_l24(*rgb)
    if mode in ("RGB", "RGBA", "RGBX"):
        return pil_l24(arr[..., 0], arr[..., 1], arr[..., 2])
    raise ValueError(f"no L conversion for PIL mode {mode}")

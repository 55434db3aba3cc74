"""Sun raster decoding to 8-bit grayscale without PIL or cv2 (the machine
with the card has neither).

`decode_gray` gives what the JAX package's ``load_grayscale`` gives:
``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``, and where cv2 refuses the file,
PIL's ``Image.open(path).convert("L")``.  Probed file by file against cv2
5.0 and PIL 12.1:

cv2 (``grfmt_sunras.cpp``) reads the old and standard types (0, 1) only, at
depths 1, 8, 24 and 32, without a colour map or with an RGB map (type 1)
of at most ``3 * 2^depth`` bytes on a depth of 8 or less; rows padded to 16
bits.  Gray at 1 and 8 bits comes from the map's entries, ``(4899 R + 9617
G + 1868 B + 8192) >> 14``, and without a map from an all-zero table: such
an image reads as black.  24-bit pixels are B, G, R; 32-bit ones X, B, G,
R.  Byte-encoded (type 2), RGB (type 3) and the other types make cv2 fail,
as do data cut short.

PIL (``SunImagePlugin.py``) reads depths 1 (0 white, 1 black), 4 (scaled by
17, or indices into the map), 8, 24 (B, G, R; R, G, B for type 3) and 32 (B, G, R, X; R, G, B, X
for type 3) for the types 0-5, with an RGB map of at most 1024 bytes (a
1-bit image with a map fails in ``convert``); the byte-encoded type through
its run-length decoder (``0x80 n v``: n + 1 copies of v, ``0x80 0``: one
0x80; rows unpadded, runs crossing rows; ``native/raster_decode.cc``); rows
cut short make it fail.  PIL's GIMP brush plugin claims a raster one pixel
wide whose length field is 1 or 4, and fails on it.
"""

from __future__ import annotations

import struct

import numpy as np

from xfmamba_tpu_torch import native
from xfmamba_tpu_torch.data import limits
from xfmamba_tpu_torch.data.gray import cv2_gray, pil_l24

SIGNATURE = b"\x59\xa6\x6a\x95"


class Refused(Exception):
    """One reader does not read the file (the reason)."""


def _fail(path, what):
    raise ValueError(f"{path}: {what}")


def _header(raw: bytes):
    if len(raw) < 32:
        raise Refused("cut header")
    return struct.unpack(">8I", raw[:32])


def _bits(rows: np.ndarray, width: int) -> np.ndarray:
    return np.unpackbits(rows, axis=1)[:, :width]


def cv2_read(raw: bytes) -> np.ndarray:
    """What cv2.imread(..., IMREAD_GRAYSCALE) gives, or `Refused`."""
    _, w, h, depth, _, typ, maptype, maplength = _header(raw)
    w, h = struct.unpack(">ii", raw[4:12])
    pal_size = (1 << depth) * 3 if 0 < depth <= 8 else 0
    if not (w > 0 and h > 0 and depth in (1, 8, 24, 32)):
        raise Refused(f"depth {depth} or size")
    if typ not in (0, 1) or not ((maptype == 0 and maplength == 0) or (
            maptype == 1 and 0 < maplength <= pal_size and depth <= 8)):
        raise Refused(f"type {typ} with colour map type {maptype}")
    if 32 + maplength > len(raw):
        raise Refused("cut colour map")
    limits.check_cv2(w, h)
    gray = np.zeros(256, np.uint8)
    if maptype == 1:
        n = maplength // 3
        cmap = np.frombuffer(raw, np.uint8, 3 * n, 32).reshape(3, n)
        pal = np.zeros((256, 3), np.int64)
        pal[:n] = cmap.T
        gray = cv2_gray(pal[:, 0], pal[:, 1], pal[:, 2])
    pitch = ((w * depth + 7) // 8 + 1) & -2
    off = 32 + maplength
    if off + pitch * h > len(raw):
        raise Refused("unexpected end of input stream")
    rows = np.frombuffer(raw, np.uint8, pitch * h, off).reshape(h, pitch)
    if depth == 1:
        return gray[_bits(rows, w)]
    if depth == 8:
        return gray[rows[:, :w]]
    k = depth // 8
    px = rows[:, :k * w].reshape(h, w, k)[..., k - 3:]
    return cv2_gray(px[..., 2], px[..., 1], px[..., 0])


def pil_read(raw: bytes) -> np.ndarray:
    """What PIL's ``Image.open(path).convert("L")`` gives, or `Refused`."""
    _, w, h, depth, length, typ, maptype, maplength = _header(raw)
    if (w == 1 or (w == 2 and typ == 0x47494D50)) and length in (1, 4):
        # PIL's GIMP brush plugin claims the file first and finds no data
        raise Refused("read as a GIMP brush")
    if depth not in (1, 4, 8, 24, 32):
        raise Refused("unsupported mode/bit depth")
    if w <= 0 or h <= 0:
        raise Refused("bad image size")
    if not limits.pil_ok(w, h):
        raise Refused("decompression bomb")
    palette = None
    off = 32
    if maplength:
        if maplength > 1024:
            raise Refused("unsupported colour palette length")
        if maptype != 1:
            raise Refused("unsupported palette type")
        if depth == 1:
            raise Refused("unrecognized image mode")           # convert("L") of "1" + palette
        data = raw[32:32 + maplength]
        n = len(data) // 3
        palette = np.frombuffer(data[:3 * n], np.uint8).reshape(3, n).T
        off += maplength
    if typ not in (0, 1, 2, 3, 4, 5):
        raise Refused("unsupported Sun raster file type")
    rowbytes = (w * depth + 7) // 8
    if typ == 2:
        flat = native.sunras_rle(raw[off:], rowbytes * h)
        if flat.size < rowbytes * h:
            raise Refused("image file is truncated")
        rows = flat.reshape(h, rowbytes)
    else:
        stride = ((w * depth + 15) // 16) * 2
        need = (h - 1) * stride + rowbytes
        if off + need > len(raw):
            raise Refused("image file is truncated")
        rows = np.lib.stride_tricks.as_strided(np.frombuffer(raw, np.uint8, need, off),
                                               (h, rowbytes), (stride, 1))
    if depth == 1:
        return np.where(_bits(rows, w) != 0, 0, 255).astype(np.uint8)
    if depth in (4, 8):
        if depth == 4:
            v = (_bits(rows, 4 * w).reshape(h, w, 4) * np.array([8, 4, 2, 1])).sum(axis=2)
            v = v.astype(np.uint8) * np.uint8(1 if palette is not None else 17)
        else:
            v = rows[:, :w]
        if palette is None:
            return np.ascontiguousarray(v)
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(palette)] = palette[:256]
        rgb = pal[v]
        return pil_l24(rgb[..., 0], rgb[..., 1], rgb[..., 2])
    k = depth // 8
    px = rows[:, :k * w].reshape(h, w, k)
    if typ == 3:
        r, g, b = px[..., 0], px[..., 1], px[..., 2]
    else:
        b, g, r = px[..., 0], px[..., 1], px[..., 2]
    return pil_l24(r, g, b)


def decode_gray(raw: bytes, path="<bytes>") -> np.ndarray:
    """Decode Sun raster bytes to (H, W) uint8 gray (see the module
    docstring)."""
    if raw[:4] != SIGNATURE:
        _fail(path, "not a Sun raster file")
    try:
        return cv2_read(raw)
    except limits.TooLarge as e:
        _fail(path, str(e))
    except Refused as e:
        why = str(e)
    try:
        return pil_read(raw)
    except Refused as e:
        _fail(path, f"unreadable Sun raster (as cv2 reads it: {why}; as PIL reads it: {e})")


def load_grayscale(path) -> np.ndarray:
    with open(path, "rb") as f:
        raw = f.read()
    return decode_gray(raw, str(path))

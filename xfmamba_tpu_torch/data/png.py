"""PNG decoding to 8-bit grayscale without PIL or cv2 (the machine with the
card has neither).

`load_grayscale` parses the chunks (every CRC checked), inflates the IDAT
stream with ``zlib``, undoes the row filters in one native call
(`native.png_unfilter`) and converts to gray by the rule that
``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` applies, which the JAX package's
``load_grayscale`` takes first: libpng's ``rgb_to_gray`` with cv2's
weights (0.299, 0.587), as integers ``(9797 R + 19234 G + 3737 B) >> 15``
without a rounding term, for RGB, RGBA and palette images; the gray channel
of gray + alpha; the high byte of 16-bit gray.  Alpha is dropped.

Supported: colour types 0, 2, 3, 4 and 6 at bit depth 8, and types 0 and 4
at bit depth 16, not interlaced.  `decode_native` reads a gray PNG at its
own depth (8 or 16 bits), for DDSM's pre-converted masks and images.  Anything else raises a ``ValueError``
naming the file and the format: 16-bit colour (libpng converts it to gray
at 16 bits and rounds), bit depths 1, 2 and 4, Adam7 interlacing, a bad
CRC, a truncated or malformed stream, or a file that is not a PNG.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from xfmamba_tpu_torch import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# libpng's rgb_to_gray coefficients for cv2's (0.299, 0.587): 32768 * w, truncated
RED, GREEN, BLUE = 9797, 19234, 3737
SUPPORTED = {(0, 8), (2, 8), (3, 8), (4, 8), (6, 8), (0, 16), (4, 16)}
COLOUR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray + alpha", 6: "RGBA"}


def _fail(path, what):
    raise ValueError(f"{path}: {what}")


def read_chunks(raw: bytes, path="<bytes>"):
    """(IHDR fields, PLTE bytes or None, the concatenated IDAT data)."""
    if raw[:8] != SIGNATURE:
        _fail(path, "not a PNG file (bad signature)")
    pos, ihdr, plte, idat = 8, None, None, []
    while True:
        if pos + 12 > len(raw):
            _fail(path, "truncated PNG stream (no IEND chunk)")
        length, kind = struct.unpack(">I4s", raw[pos:pos + 8])
        end = pos + 12 + length
        if end > len(raw):
            _fail(path, f"truncated PNG stream (chunk {kind!r} cut short)")
        body = raw[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", raw[pos + 8 + length:end])
        if zlib.crc32(kind + body) != crc:
            _fail(path, f"bad CRC in chunk {kind!r}")
        if kind == b"IHDR":
            if length != 13:
                _fail(path, "malformed IHDR chunk")
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos = end
    if ihdr is None:
        _fail(path, "no IHDR chunk")
    return ihdr, plte, b"".join(idat)


def _pixels(raw: bytes, path, unfilter):
    """(colour type, bit depth, PLTE, the unfiltered samples (H, W, bytes a
    pixel) uint8) of a PNG in one of the `SUPPORTED` formats."""
    (width, height, depth, colour, compression, filtering, interlace), plte, idat = \
        read_chunks(raw, path)
    fmt = f"colour type {colour} ({COLOUR_NAMES.get(colour, 'unknown')}) at bit depth {depth}"
    if colour not in CHANNELS:
        _fail(path, f"unsupported PNG format: {fmt}")
    if interlace:
        _fail(path, f"unsupported PNG format: Adam7-interlaced {fmt}")
    if (colour, depth) not in SUPPORTED:
        _fail(path, f"unsupported PNG format: {fmt}")
    if compression or filtering or width == 0 or height == 0:
        _fail(path, "malformed IHDR chunk")
    bpp = CHANNELS[colour] * depth // 8
    rowbytes = width * bpp
    try:
        data = zlib.decompress(idat)
    except zlib.error as e:
        _fail(path, f"truncated or corrupt PNG image data ({e})")
    if len(data) != height * (rowbytes + 1):
        _fail(path, f"truncated or corrupt PNG image data ({len(data)} bytes, expected "
                    f"{height * (rowbytes + 1)})")
    buf = np.frombuffer(data, np.uint8)
    try:
        px = (unfilter or native.png_unfilter)(buf, height, rowbytes, bpp)
    except ValueError as e:
        _fail(path, str(e))
    return colour, depth, plte, px.reshape(height, width, bpp)


def decode_gray(raw: bytes, path="<bytes>", unfilter=None) -> np.ndarray:
    """Decode PNG bytes to (H, W) uint8 gray (see the module docstring).
    ``unfilter`` defaults to the native `png_unfilter`; tests pass its
    numpy twin."""
    colour, depth, plte, px = _pixels(raw, path, unfilter)
    if depth == 16:
        # the high byte of the gray sample (libpng's strip_16)
        return np.ascontiguousarray(px[:, :, 0])
    if colour in (0, 4):
        return np.ascontiguousarray(px[:, :, 0])
    if colour == 3:
        if plte is None or len(plte) % 3:
            _fail(path, "palette image without a valid PLTE chunk")
        pal = np.frombuffer(plte, np.uint8).reshape(-1, 3)
        idx = px[:, :, 0]
        if int(idx.max()) >= len(pal):
            _fail(path, "palette index past the PLTE chunk")
        rgb = pal[idx]
    else:
        rgb = px[:, :, :3]
    rgb = rgb.astype(np.uint32)
    gray = (RED * rgb[:, :, 0] + GREEN * rgb[:, :, 1] + BLUE * rgb[:, :, 2]) >> 15
    return gray.astype(np.uint8)


def decode_native(raw: bytes, path="<bytes>") -> np.ndarray:
    """A gray PNG (colour type 0) at its own depth, as PIL's
    ``np.asarray(Image.open(path))`` gives it: (H, W) uint8 at bit depth 8,
    uint16 at 16.  Other formats raise a ``ValueError`` naming them."""
    colour, depth, _, px = _pixels(raw, path, None)
    if colour != 0:
        _fail(path, f"unsupported PNG format for native depth: colour type {colour} "
                    f"({COLOUR_NAMES[colour]}); only gray reads at its own depth")
    if depth == 8:
        return np.ascontiguousarray(px[:, :, 0])
    return px.view(">u2")[:, :, 0].astype(np.uint16)


def load_grayscale(path, unfilter=None) -> np.ndarray:
    """Decode the PNG file at ``path`` to (H, W) uint8 grayscale."""
    with open(path, "rb") as f:
        raw = f.read()
    return decode_gray(raw, str(path), unfilter)

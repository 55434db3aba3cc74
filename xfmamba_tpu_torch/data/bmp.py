"""BMP decoding to 8-bit grayscale without PIL or cv2 (the machine with the
card has neither).

`decode_gray` gives what the JAX package's ``load_grayscale`` gives:
``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``, and where cv2 refuses the file,
PIL's ``Image.open(path).convert("L")``.  Probed file by file against cv2
5.0 and PIL 12.1:

cv2 (``grfmt_bmp.cpp``) reads the OS/2 core header (12 bytes, 3-byte palette
entries) and any header of 36 bytes or more (40, 52, 56, 64, 108, 124), at
1, 4, 8, 24 and 32 bits uncompressed, 16 bits uncompressed (5-5-5) or with
the 5-5-5 / 5-6-5 bitfields, 32 bits with any bitfields (the gray ignores
the masks: bytes are B, G, R, A), RLE4 and RLE8; a negative height is top
down.  The 16-bit masks are read after the whole header, where only a
40-byte header keeps them, so a 16-bit bitfields file with a longer header
is refused unless the bytes there happen to be the masks.  A 32-bit
bitfields file with a header of 56 bytes or more is read through its masks
(each channel widened to 8 bits in float32, then a float32 gray
truncated) unless a colour mask is 0.  Gray is ``(1868
B + 9617 G + 4899 R + 8192) >> 14`` of each pixel or palette entry (5-bit
channels widened as ``v << 3``, 6-bit ``v << 2``).  The RLE loops
(``native/raster_decode.cc``) fill, not skip: end of line, delta and end of
bitmap write palette entry 0; a run or absolute run that passes the end of
a row, or data that ends before the last row, makes cv2 fail.  A file cut
inside the pixel rows fails too.

PIL (``BmpImagePlugin.py``) reads headers of 12, 40, 52, 56, 64, 108 and
124 bytes, the bitfields it lists (16-bit 5-5-5 and 5-6-5, 24-bit BGR,
32-bit BGRX / XBGR / BGXR / ABGR / RGBA / BGRA / BGAR, masks from the header
when it has them), RLE4 and RLE8 with its own decoder (rows padded with 0,
runs clipped at the row's end, a delta's bytes read twice, absolute runs
aligned to even file offsets; fewer pixels than the image fails).  A
palette that is exactly the gray ramp (or black and white) makes the image
``L`` (``1``), its indices taken as gray.  Then ``convert("L")``.

Both refuse a file without the ``BM`` signature, an unknown header size or
depth, and pixel rows cut short.
"""

from __future__ import annotations

import struct

import numpy as np

from xfmamba_tpu_torch import native
from xfmamba_tpu_torch.data import limits
from xfmamba_tpu_torch.data.gray import cv2_gray, pil_to_l

SIGNATURE = b"BM"
RGB, RLE8, RLE4, BITFIELDS = 0, 1, 2, 3


class Refused(Exception):
    """One reader does not read the file (the reason)."""


def _fail(path, what):
    raise ValueError(f"{path}: {what}")


def _u32(raw, pos):
    if pos + 4 > len(raw):
        raise Refused("unexpected end of the header")
    return struct.unpack("<I", raw[pos:pos + 4])[0]


def _i32(raw, pos):
    if pos + 4 > len(raw):
        raise Refused("unexpected end of the header")
    return struct.unpack("<i", raw[pos:pos + 4])[0]


def _u16(raw, pos):
    if pos + 2 > len(raw):
        raise Refused("unexpected end of the header")
    return struct.unpack("<H", raw[pos:pos + 2])[0]


# ---- cv2 -----------------------------------------------------------------------

def _cv2_header(raw: bytes):
    """cv2's BmpDecoder::readHeader: a dict of what readData needs."""
    offset = _i32(raw, 10)
    size = _i32(raw, 14)
    if size <= 0:
        raise Refused("header size")
    h = {"offset": offset, "masks": None}
    if size >= 36:
        width, height = _i32(raw, 18), _i32(raw, 22)
        bpp = _u32(raw, 26) >> 16
        rle = _i32(raw, 30)
        if not 0 <= rle <= BITFIELDS:
            raise Refused(f"compression {rle}")
        clrused = _i32(raw, 46)
        pos = 14 + size
        if bpp == 32 and rle == BITFIELDS and size >= 56:
            h["masks"] = [_u32(raw, 54 + 4 * k) for k in range(4)]
        ok = width > 0 and height != 0 and (
            (bpp in (1, 4, 8, 24, 32) and rle == RGB) or (bpp in (16, 32) and rle in (RGB, BITFIELDS))
            or (bpp == 4 and rle == RLE4) or (bpp == 8 and rle == RLE8))
        if not ok:
            raise Refused(f"{bpp} bits with compression {rle}")
        if bpp <= 8:
            if not 0 <= clrused <= 256:
                raise Refused("palette size")
            n = clrused or 1 << bpp
            if pos + 4 * n > len(raw):
                raise Refused("cut palette")
            pal = np.frombuffer(raw, np.uint8, 4 * n, pos).reshape(n, 4)[:, :3]
            h["palette"] = np.zeros((256, 3), np.uint8)
            h["palette"][:n] = pal
        elif bpp == 16 and rle == BITFIELDS:
            red, green, blue = _u32(raw, pos), _u32(raw, pos + 4), _u32(raw, pos + 8)
            if (blue, green, red) == (0x1F, 0x3E0, 0x7C00):
                bpp = 15
            elif (blue, green, red) != (0x1F, 0x7E0, 0xF800):
                raise Refused("16-bit bitfields other than 5-5-5 and 5-6-5")
        elif bpp == 16:
            bpp = 15
    elif size == 12:
        width, height = _u16(raw, 18), _u16(raw, 20)
        bpp = _u32(raw, 22) >> 16
        rle = RGB
        if not (width > 0 and height != 0 and bpp in (1, 4, 8, 24, 32)):
            raise Refused(f"{bpp} bits")
        if bpp <= 8:
            n = 1 << bpp
            if 26 + 3 * n > len(raw):
                raise Refused("cut palette")
            h["palette"] = np.zeros((256, 3), np.uint8)
            h["palette"][:n] = np.frombuffer(raw, np.uint8, 3 * n, 26).reshape(n, 3)
    else:
        raise Refused(f"header size {size}")
    h.update(width=width, height=abs(height), bottom_up=height > 0, bpp=bpp, rle=rle)
    return h


def _gray_palette(pal):
    """cv2's CvtPaletteToGray (palette entries are B, G, R)."""
    return cv2_gray(pal[:, 2], pal[:, 1], pal[:, 0])


def _masked_gray(words: np.ndarray, masks) -> np.ndarray:
    """cv2's 32-bit bitfields read with masks from a header of 56 bytes or
    more: each channel ``(word & mask) >> shift`` widened to 8 bits as
    ``int(v * float32(255 / max))``, then ``int(0.299 R + 0.587 G + 0.114
    B)`` in float32."""
    chans = []
    for mask in masks[:3]:
        shift = (mask & -mask).bit_length() - 1
        top = mask >> shift
        scale = np.float32(255.0) / np.float32(top)
        v = ((words.astype(np.int64) & mask) >> shift).astype(np.float32)
        chans.append((v * scale).astype(np.int64).astype(np.float32))
    r, g, b = chans
    f32 = np.float32
    return (r * f32(0.299) + g * f32(0.587) + b * f32(0.114)).astype(np.int64).astype(np.uint8)


def cv2_read(raw: bytes) -> np.ndarray:
    """What cv2.imread(..., IMREAD_GRAYSCALE) gives, or `Refused`."""
    h = _cv2_header(raw)
    w, ht, bpp, rle = h["width"], h["height"], h["bpp"], h["rle"]
    limits.check_cv2(w, ht)
    if h["offset"] < 0 or h["offset"] > len(raw):
        raise Refused("data offset")
    if rle in (RLE4, RLE8):
        status, rows = native.bmp_rle_cv2(raw, h["offset"], rle == RLE4,
                                          _gray_palette(h["palette"]), w, ht)
        if status:
            raise Refused("RLE data that passes a row's end" if status == 1 else
                          "RLE data cut short")
        return np.ascontiguousarray(rows[::-1] if h["bottom_up"] else rows)
    pitch = ((w * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & -4
    if h["offset"] + pitch * ht > len(raw):
        raise Refused("unexpected end of input stream")
    rows = np.frombuffer(raw, np.uint8, pitch * ht, h["offset"]).reshape(ht, pitch)
    if bpp <= 8:
        gp = _gray_palette(h["palette"])
        if bpp < 8:
            bits = np.unpackbits(rows, axis=1)[:, :w * bpp].reshape(ht, w, bpp)
            idx = (bits * (1 << np.arange(bpp - 1, -1, -1))).sum(axis=2)
        else:
            idx = rows[:, :w]
        gray = gp[idx]
    elif bpp in (15, 16):
        v = rows[:, :2 * w].copy().view("<u2").astype(np.int64)
        b = (v << 3) & 0xF8
        g = ((v >> 2) & 0xF8) if bpp == 15 else ((v >> 3) & 0xFC)
        r = ((v >> 7) & 0xF8) if bpp == 15 else ((v >> 8) & 0xF8)
        gray = cv2_gray(r, g, b)
    elif h["masks"] and all(h["masks"][:3]):
        gray = _masked_gray(rows[:, :4 * w].copy().view("<u4")[:, :w], h["masks"])
    else:
        k = bpp // 8
        px = rows[:, :k * w].reshape(ht, w, k)
        gray = cv2_gray(px[..., 2], px[..., 1], px[..., 0])
    return np.ascontiguousarray(gray[::-1] if h["bottom_up"] else gray)


# ---- PIL -----------------------------------------------------------------------

MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX", (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR", (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR", (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR", (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15"}
BIT2MODE = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"), 16: ("RGB", "BGR;15"),
            24: ("RGB", "BGR"), 32: ("RGB", "BGRX")}
RAW_BITS = {"P;1": 1, "1": 1, "P;4": 4, "P": 8, "L": 8, "BGR;15": 16, "BGR;16": 16, "BGR": 24}


def _pil_header(raw: bytes):
    """Pillow's BmpImageFile._bitmap."""
    offset = _u32(raw, 10)
    hsize = _u32(raw, 14)
    if hsize not in (12, 40, 52, 56, 64, 108, 124):
        raise Refused(f"unsupported BMP header type ({hsize})")
    data = raw[18:14 + hsize]
    if len(data) < hsize - 4:
        raise Refused("truncated header")
    pos = 14 + hsize
    info = {"direction": -1}
    if hsize == 12:
        width, height = _u16(data, 0), _u16(data, 2)
        bits = _u16(data, 6)
        compression = RGB
        padding = 3
        colors = 0
    else:
        flip = data[7] == 0xFF
        info["direction"] = 1 if flip else -1
        width = _u32(data, 0)
        height = 2 ** 32 - _u32(data, 4) if flip else _u32(data, 4)
        bits = _u16(data, 10)
        compression = _u32(data, 12)
        colors = _u32(data, 28)
        padding = 4
        if compression == BITFIELDS:
            if len(data) >= 48:
                masks = [_u32(data, 36 + 4 * k) for k in range(4 if len(data) >= 52 else 3)]
                if len(masks) == 3:
                    masks.append(0)
            else:
                masks = [_u32(raw, pos + 4 * k) for k in range(3)] + [0]
                pos += 12
            info["rgb_mask"], info["rgba_mask"] = tuple(masks[:3]), tuple(masks)
    colors = colors or 1 << bits
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits not in BIT2MODE:
        raise Refused(f"unsupported BMP pixel depth ({bits})")
    mode, rawmode = BIT2MODE[bits]
    decoder = "raw"
    if compression == BITFIELDS:
        key = (bits, info["rgba_mask"] if bits == 32 else info["rgb_mask"])
        if bits not in (16, 24, 32) or key not in MASK_MODES:
            raise Refused("unsupported BMP bitfields layout")
        rawmode = MASK_MODES[key]
        if "A" in rawmode:
            mode = "RGBA"
    elif compression in (RLE8, RLE4):
        decoder = "rle"
    elif compression != RGB:
        raise Refused(f"unsupported BMP compression ({compression})")
    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise Refused("palette size")
        pal = raw[pos:pos + padding * colors]
        indices = (0, 255) if colors == 2 else range(colors)
        if all(pal[k * padding:k * padding + 3] == bytes([v]) * 3 for k, v in enumerate(indices)):
            mode = rawmode = "1" if colors == 2 else "L"
        else:
            entries = np.frombuffer(pal[:len(pal) // padding * padding], np.uint8).reshape(
                -1, padding)[:, :3]
            palette = entries[:, ::-1]                       # B, G, R -> R, G, B
    info.update(width=width, height=height, bits=bits, mode=mode, rawmode=rawmode,
                decoder=decoder, rle4=compression == RLE4, offset=offset, palette=palette)
    return info


def _pil_rows(rows: np.ndarray, rawmode: str, width: int):
    """Pillow's unpacker for one of the BMP raw modes."""
    n = rows.shape[0]
    if rawmode in ("P;1", "1", "P;4"):
        b = 1 if rawmode != "P;4" else 4
        bits = np.unpackbits(rows, axis=1)[:, :width * b].reshape(n, width, b)
        return (bits * (1 << np.arange(b - 1, -1, -1))).sum(axis=2).astype(np.uint8)
    if rawmode in ("P", "L"):
        return rows[:, :width]
    if rawmode in ("BGR;15", "BGR;16"):
        v = rows[:, :2 * width].copy().view("<u2").astype(np.int64)
        b = (v & 31) * 255 // 31
        if rawmode == "BGR;15":
            g, r = ((v >> 5) & 31) * 255 // 31, ((v >> 10) & 31) * 255 // 31
        else:
            g, r = ((v >> 5) & 63) * 255 // 63, ((v >> 11) & 31) * 255 // 31
        return np.stack([r, g, b], axis=2).astype(np.uint8)
    k = len(rawmode)
    px = rows[:, :k * width].reshape(n, width, k)
    return np.stack([px[..., rawmode.index(c)] for c in "RGB"], axis=2)


def pil_read(raw: bytes) -> np.ndarray:
    """What PIL's ``Image.open(path).convert("L")`` gives, or `Refused`."""
    if raw[:2] != SIGNATURE:
        raise Refused("not a BMP file")
    info = _pil_header(raw)
    w, h, mode, rawmode = info["width"], info["height"], info["mode"], info["rawmode"]
    if w <= 0 or h <= 0 or w >= 1 << 31 or h >= 1 << 31:
        raise Refused("bad image size")
    if not limits.pil_ok(w, h):
        raise Refused("decompression bomb")
    if info["decoder"] == "rle":
        n, pixels = native.bmp_rle_pil(raw, info["offset"], info["rle4"], w, h)
        if n < w * h:
            raise Refused("not enough image data")
        img = pixels.reshape(h, w)
    else:
        bits = RAW_BITS.get(rawmode, 32)
        stride = ((w * info["bits"] + 31) >> 3) & ~3
        rowbytes = (w * bits + 7) // 8
        need = (h - 1) * stride + rowbytes
        if info["offset"] + need > len(raw):
            raise Refused("image file is truncated")
        rows = np.lib.stride_tricks.as_strided(
            np.frombuffer(raw, np.uint8, need, info["offset"]), (h, rowbytes), (stride, 1))
        img = _pil_rows(np.ascontiguousarray(rows), rawmode, w)
    if info["direction"] == -1:
        img = img[::-1]
    return pil_to_l(img, "RGB" if mode == "RGBA" else mode, info["palette"])


# ---- the reader -------------------------------------------------------------------

def decode_gray(raw: bytes, path="<bytes>") -> np.ndarray:
    """Decode BMP bytes to (H, W) uint8 gray (see the module docstring)."""
    if raw[:2] != SIGNATURE:
        _fail(path, "not a BMP file")
    try:
        return cv2_read(raw)
    except limits.TooLarge as e:
        _fail(path, str(e))
    except Refused as e:
        why = str(e)
    try:
        return pil_read(raw)
    except Refused as e:
        _fail(path, f"unreadable BMP (as cv2 reads it: {why}; as PIL reads it: {e})")


def load_grayscale(path) -> np.ndarray:
    with open(path, "rb") as f:
        raw = f.read()
    return decode_gray(raw, str(path))

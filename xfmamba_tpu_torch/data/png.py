"""PNG decoding without PIL or cv2 (the machine with the card has neither).

`decode_gray` gives what the JAX package's ``load_grayscale`` gives:
``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``, which is libpng with cv2's
transformations, and where libpng refuses the file, PIL's
``Image.open(path).convert("L")``.  `decode_native` gives PIL's
``np.asarray(Image.open(path))``, which the JAX package's DDSM reader takes
for a pre-converted PNG.

Both parse the chunks here, inflate the IDAT stream with ``zlib`` and undo
the row filters in native code (`native.png_unfilter`, or `native.png_adam7`
for Adam7-interlaced files; `native.png_unpack` for samples of 1, 2 or 4
bits).  Every colour type at every bit depth is read, interlaced or not.

cv2's gray (libpng): gray samples of 1, 2 or 4 bits scaled to 0-255
(``png_set_expand_gray_1_2_4_to_8``), 16-bit samples cut to their high byte
(``png_set_strip_16``), alpha dropped, palette images through their palette,
and colour through libpng's ``rgb_to_gray`` with cv2's weights (0.299,
0.587) as integers ``(9797 R + 19234 G + 3737 B) >> 15``; at 16 bits with
a rounding term before the cut.  Where the file's gamma (a ``gAMA`` chunk,
or ``sRGB``, which wins) is not 1, libpng converts colour to gray in linear
light through its gamma tables.  ``tRNS`` and ``cHRM`` change nothing.
cv2 refuses a file with a bad CRC in a critical chunk other than IEND, an
image stream that is short, malformed or fails its checksum, no IEND chunk,
or an unknown critical chunk.

PIL's modes: ``1`` (bool) for 1-bit gray, ``L`` (2- and 4-bit gray scaled to
0-255), ``I;16`` (uint16), ``P`` (the palette indices), ``LA``, ``RGB``,
``RGBA``; 16-bit colour to its high byte; 16-bit gray + alpha as ``RGBA``.
PIL does not check the CRCs of IDAT chunks and needs no IEND, only every
image row; its ``convert("L")`` is `gray.pil_l24`, ``(19595 R + 38470 G +
7471 B + 32768) >> 16``, 255 for a set ``1`` pixel and 16-bit values
clipped to 255.

Refused, with a ``ValueError`` naming the file and the fault, exactly what
both refuse: not a PNG (no signature), a bad IHDR chunk (its CRC, length or
a colour type and depth PNG does not define), a bad CRC in IHDR or PLTE,
image data that is cut short or corrupt (PIL needs every row), a filter
type past 4.  (A palette image without PLTE, which cv2 refuses, reads as
PIL reads it: the indices, black through the empty palette.)
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

from xfmamba_tpu_torch import native
from xfmamba_tpu_torch.data.gray import pil_l24

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# libpng's rgb_to_gray coefficients for cv2's (0.299, 0.587): 32768 * w, truncated
RED, GREEN, BLUE = 9797, 19234, 3737
COLOUR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray + alpha", 6: "RGBA"}
SRGB_GAMMA = 45455                       # libpng's gamma of an sRGB chunk (x 100000)


def _fail(path, what):
    raise ValueError(f"{path}: {what}")


def _u32(b: bytes, i: int = 0) -> int:
    return struct.unpack(">I", b[i:i + 4])[0]


def read_chunks(raw: bytes):
    """[(type, body, CRC good)] of the chunks after the signature, up to and
    with IEND; a chunk the data ends inside comes last, with what there is
    of its body and CRC None."""
    chunks, pos = [], 8
    while pos + 8 <= len(raw):
        length, kind = _u32(raw, pos), raw[pos + 4:pos + 8]
        end = pos + 12 + length
        body = raw[pos + 8:pos + 8 + length]
        if end > len(raw):
            chunks.append((kind, body, None))
            break
        chunks.append((kind, body, zlib.crc32(kind + body) == _u32(raw, end - 4)))
        if kind == b"IEND":
            break
        pos = end
    return chunks


class Image:
    """The header and image data of a PNG as one reader (libpng or PIL)
    takes them."""

    def __init__(self, ihdr):
        (self.width, self.height, self.depth, self.colour, compression, filtering,
         self.interlace) = struct.unpack(">IIBBBBB", ihdr)
        self.plte, self.idat, self.gamma = None, b"", None
        self.plain = False                   # the numpy twins instead of the native code
        self.channels = CHANNELS.get(self.colour, 0)
        self.fmt = (f"colour type {self.colour} ({COLOUR_NAMES.get(self.colour, 'unknown')}) at "
                    f"bit depth {self.depth}")
        self.valid = (self.colour in DEPTHS and self.depth in DEPTHS[self.colour]
                      and not compression and not filtering and self.interlace in (0, 1)
                      and 0 < self.width < 1 << 31 and 0 < self.height < 1 << 31)
        self.bits = self.channels * self.depth
        self.sig_bits = 0                    # an sBIT chunk's significant bits

    def stream_size(self) -> int:
        if self.interlace:
            return native.adam7_size(self.width, self.height, self.bits)
        return self.height * (-(-self.width * self.bits // 8) + 1)

    def rows(self, data: bytes) -> np.ndarray:
        """Unfiltered (and deinterlaced) rows, (H, row bytes) uint8."""
        buf = np.frombuffer(data, np.uint8)
        if self.interlace:
            adam7 = native.png_adam7_plain if self.plain else native.png_adam7
            return adam7(buf, self.width, self.height, self.bits)
        rowbytes = -(-self.width * self.bits // 8)
        unfilter = native.png_unfilter_plain if self.plain else native.png_unfilter
        return unfilter(buf, self.height, rowbytes, max(self.bits // 8, 1))

    def samples(self, rows: np.ndarray, scale_gray: bool) -> np.ndarray:
        """(H, W, channels) samples: uint8, or uint16 at depth 16; samples
        of 1, 2 or 4 bits one a byte, gray ones scaled to 0-255 when
        ``scale_gray``."""
        h, w = self.height, self.width
        if self.depth < 8:
            unpack = native.png_unpack_plain if self.plain else native.png_unpack
            px = unpack(rows, w, self.depth, scale_gray and self.colour == 0)
            return px[:, :, None]
        if self.depth == 16:
            return rows.view(">u2").astype(np.uint16).reshape(h, w, self.channels)
        return rows.reshape(h, w, self.channels)


def _inflate(data: bytes, size: int, finish: bool):
    """(the first ``size`` bytes of the zlib stream ``data``, or None when
    it is corrupt or short before them; with ``finish``, whether the rest
    of the stream ends within ``data``, its checksum good, as libpng needs)."""
    d = zlib.decompressobj()
    try:
        out = d.decompress(data, size)
    except zlib.error:
        return None, False
    if len(out) < size:
        return None, False
    if not finish:
        return out, True
    try:
        d.decompress(d.unconsumed_tail)
    except zlib.error:
        return out, False
    return out, d.eof


def _libpng(chunks):
    """The image libpng (as cv2 drives it) reads, or the reason it
    refuses."""
    if not chunks or chunks[0][0] != b"IHDR":
        return "no IHDR chunk first"
    kind, body, ok = chunks[0]
    if not ok or len(body) != 13:
        return "bad IHDR chunk"
    img = Image(body)
    if not img.valid:
        return f"bad IHDR chunk ({img.fmt})"
    plte = gamma = srgb = None
    idat, seen_idat, after_idat, end = [], False, False, False
    for kind, body, ok in chunks[1:]:
        if ok is None:
            return "truncated PNG stream (a chunk cut short)"
        critical = not kind[0] & 0x20
        if not all(65 <= c <= 90 or 97 <= c <= 122 for c in kind):
            return f"invalid chunk type {kind!r}"
        if kind == b"IDAT":
            if after_idat:
                continue                     # "Too many IDATs found": ignored
            if img.colour == 3 and plte is None:
                return "palette image without a PLTE chunk before its data"
            if not ok:
                return "bad CRC in an IDAT chunk"
            seen_idat = True
            idat.append(body)
            continue
        if seen_idat:
            after_idat = True
        if kind == b"IEND":
            if not seen_idat:
                return "IEND before the image data"
            end = True
            break
        if critical and not ok:
            return f"bad CRC in chunk {kind!r}"
        if kind == b"PLTE":
            if plte is not None or seen_idat:
                return "PLTE chunk out of place"
            if img.colour in (0, 4):
                continue
            if not body or len(body) % 3 or len(body) > 768:
                if img.colour == 3:
                    return "invalid PLTE chunk"
                continue
            plte = body
        elif kind == b"IHDR":
            return "a second IHDR chunk"
        elif critical:
            return f"unknown critical chunk {kind!r}"
        elif not ok or seen_idat or plte is not None:
            continue                         # bad CRC or out of place: ignored
        elif kind == b"gAMA" and len(body) == 4 and 16 <= _u32(body) <= 625000000:
            gamma = _u32(body)
        elif kind == b"sRGB" and len(body) == 1 and body[0] <= 3:
            srgb = SRGB_GAMMA
        elif kind == b"sBIT" and len(body) == {0: 1, 2: 3, 3: 3, 4: 2, 6: 4}[img.colour]:
            depth = 8 if img.colour == 3 else img.depth
            if all(0 < v <= depth for v in body):
                img.sig_bits = max(body[:1] if img.colour in (0, 4) else body[:3])
    if not end:
        return "truncated PNG stream (no IEND chunk)"
    img.plte, img.idat = plte, b"".join(idat)
    img.gamma = srgb or gamma
    return img


def _pil(chunks):
    """The image PIL reads, or the reason it refuses: the chunks before the
    image data CRC-checked, the IDAT chunks after them taken as they are."""
    if not chunks:
        return "no chunks"
    ihdr = plte = None
    for i, (kind, body, ok) in enumerate(chunks):
        if kind == b"IDAT":
            break
        if not ok:
            return f"bad CRC in chunk {kind!r}"
        if kind == b"IHDR":
            ihdr = body
        elif kind == b"PLTE":
            plte = body
        elif kind == b"IEND":
            return "no image data"
    else:
        return "no image data"
    if ihdr is None or len(ihdr) != 13:
        return "no IHDR chunk"
    img = Image(ihdr)
    img.plte = plte
    if not img.valid:
        return f"unsupported PNG format: {img.fmt}"
    idat = []
    for kind, body, _ in chunks[i:]:
        if kind != b"IDAT":
            break
        idat.append(body)
    img.idat = b"".join(idat)
    return img


def _decode(img, finish: bool):
    data, rest_ok = _inflate(img.idat, img.stream_size(), finish)
    if data is None:
        return None, "truncated or corrupt PNG image data"
    if not rest_ok:
        return None, "truncated PNG image data (the stream does not end)"
    try:
        return img.rows(data), None
    except ValueError as e:
        return None, str(e)


def _gamma_table(exponent: int) -> np.ndarray:
    """libpng's png_build_8bit_table: floor(255 (i / 255)^(g / 1e5) + .5)."""
    if abs(exponent - 100000) <= 5000:
        return np.arange(256, dtype=np.int64)
    return np.array([0] + [int(math.floor(255 * math.pow(i / 255.0, exponent * 0.00001) + 0.5))
                           for i in range(1, 255)] + [255], np.int64)


def _reciprocal(a: int) -> int:
    return int(math.floor(1e10 / a + 0.5))


def _gamma_table16(shift: int, exponent: int) -> np.ndarray:
    """libpng's png_build_16bit_table, indexed by a 16-bit value >> shift."""
    top = (1 << (16 - shift)) - 1
    ig = np.arange(top + 1, dtype=np.int64)
    if abs(exponent - 100000) <= 5000:
        return (ig * 65535 + (1 << (15 - shift))) // top if shift else ig
    return np.array([int(math.floor(65535 * math.pow(v / top, exponent * 0.00001) + 0.5))
                     for v in range(top + 1)], np.int64)


def _gamma_16to8(shift: int) -> np.ndarray:
    """libpng's png_build_16to8_table at a gamma of 1: the 8-bit output
    (times 257) for each 16-bit value >> shift."""
    top = (1 << (16 - shift)) - 1
    table = np.full(top + 1, 65535, np.int64)
    last = 0
    for i in range(255):
        bound = ((i * 257 + 128) * top + 32768) // 65535 + 1
        table[last:bound] = i * 257
        last = max(last, bound)
    return table


def _rgb_to_gray(rgb: np.ndarray, depth: int, gamma, sig_bits=0) -> np.ndarray:
    """libpng's png_do_rgb_to_gray with cv2's coefficients, then the 16-bit
    cut: (H, W) uint8."""
    r, g, b = (rgb[:, :, k].astype(np.int64) for k in range(3))
    linear = gamma is not None and abs(gamma - 100000) > 5000
    if depth == 16 and linear:
        # png_build_gamma_table at 16 bits: 11 significant bits kept
        shift = min(max(16 - sig_bits if 0 < sig_bits < 16 else 0, 5), 8)
        to_1 = _gamma_table16(shift, _reciprocal(gamma))
        from_1 = _gamma_table16(shift, _reciprocal(_reciprocal(gamma)))
        gray = (RED * to_1[r >> shift] + GREEN * to_1[g >> shift] + BLUE * to_1[b >> shift]
                + 16384) >> 15
        w = np.where((r == g) & (g == b), _gamma_16to8(shift)[r >> shift], from_1[gray >> shift])
        return (w >> 8).astype(np.uint8)
    if depth == 16:
        gray = (RED * r + GREEN * g + BLUE * b + 16384) >> 15
        return (np.where((r == g) & (g == b), r, gray) >> 8).astype(np.uint8)
    if not linear:
        return ((RED * r + GREEN * g + BLUE * b) >> 15).astype(np.uint8)
    to_1 = _gamma_table(_reciprocal(gamma))
    from_1 = _gamma_table(_reciprocal(_reciprocal(gamma)))
    lin = (RED * to_1[r] + GREEN * to_1[g] + BLUE * to_1[b] + 16384) >> 15
    return np.where((r == g) & (g == b), r, from_1[lin]).astype(np.uint8)


def _palette(img, idx: np.ndarray) -> np.ndarray:
    pal = np.zeros((256, 3), np.uint8)
    entries = np.frombuffer(img.plte or b"", np.uint8).reshape(-1, 3)
    pal[:len(entries)] = entries
    return pal[idx]


def _cv2_gray(img, rows) -> np.ndarray:
    px = img.samples(rows, scale_gray=True)
    if img.colour in (0, 4):
        g = px[:, :, 0]
        return (g >> 8).astype(np.uint8) if img.depth == 16 else np.ascontiguousarray(g)
    rgb = _palette(img, px[:, :, 0]) if img.colour == 3 else px[:, :, :3]
    return _rgb_to_gray(rgb, 8 if img.colour == 3 else img.depth, img.gamma, img.sig_bits)


def _pil_array(img, rows) -> np.ndarray:
    """``np.asarray(Image.open(path))`` of the decoded rows."""
    px = img.samples(rows, scale_gray=img.depth in (2, 4))
    if img.colour in (0, 3):
        g = px[:, :, 0]
        return g.astype(bool) if img.colour == 0 and img.depth == 1 else np.ascontiguousarray(g)
    if img.depth == 16:
        px = (px >> 8).astype(np.uint8)
        if img.colour == 4:                                   # PIL's "LA;16B" -> RGBA
            px = px[:, :, [0, 0, 0, 1]]
    return np.ascontiguousarray(px)


def _pil_l(img, arr: np.ndarray) -> np.ndarray:
    """PIL's ``convert("L")`` of a `_pil_array` result."""
    if arr.dtype == bool:
        return arr.astype(np.uint8) * np.uint8(255)
    if arr.dtype == np.uint16:
        return np.minimum(arr, 255).astype(np.uint8)
    if arr.ndim == 2 and img.colour != 3:
        return arr
    if arr.ndim == 3 and arr.shape[2] == 2:                  # LA
        return np.ascontiguousarray(arr[:, :, 0])
    rgb = _palette(img, arr) if arr.ndim == 2 else arr[:, :, :3]
    return pil_l24(rgb[:, :, 0], rgb[:, :, 1], rgb[:, :, 2])


def _read(raw: bytes, path):
    if raw[:8] != SIGNATURE:
        _fail(path, "not a PNG file (bad signature)")
    return read_chunks(raw)


def decode_gray(raw: bytes, path="<bytes>", unfilter=None) -> np.ndarray:
    """Decode PNG bytes to (H, W) uint8 gray (see the module docstring).
    Given ``unfilter`` (tests pass `native.png_unfilter_plain`), the native
    row code is replaced by its numpy twins throughout."""
    chunks = _read(raw, path)
    img = _libpng(chunks)
    why = img
    if not isinstance(img, str):
        img.plain = unfilter is not None
        rows, why = _decode(img, finish=True)
        if rows is not None:
            return _cv2_gray(img, rows)
    pil = _pil(chunks)
    if isinstance(pil, str):
        pil_why = pil
    else:
        pil.plain = unfilter is not None
        rows, pil_why = _decode(pil, finish=False)
        if rows is not None:
            return _pil_l(pil, _pil_array(pil, rows))
    _fail(path, f"unreadable PNG (as libpng reads it: {why}; as PIL reads it: {pil_why})")


def decode_native(raw: bytes, path="<bytes>") -> np.ndarray:
    """PIL's ``np.asarray(Image.open(path))`` of PNG bytes: bool for 1-bit
    gray, uint16 for 16-bit gray, else uint8, (H, W) or (H, W, channels)."""
    img = _pil(_read(raw, path))
    if isinstance(img, str):
        _fail(path, img)
    rows, why = _decode(img, finish=False)
    if rows is None:
        _fail(path, why)
    return _pil_array(img, rows)


def load_grayscale(path, unfilter=None) -> np.ndarray:
    """Decode the PNG file at ``path`` to (H, W) uint8 grayscale."""
    with open(path, "rb") as f:
        raw = f.read()
    return decode_gray(raw, str(path), unfilter)

"""TIFF decoding to 8-bit grayscale without PIL, cv2 or tifffile (the
machine with the card has none of them).

`decode_gray` gives what the JAX package's ``load_grayscale`` gives:
``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``, and where cv2 refuses the file,
PIL's ``Image.open(path).convert("L")``.  Both readers were probed file by
file against cv2 5.0 (libtiff 4.7.1) and PIL 12.1; what they do:

cv2 reads the first page through libtiff's RGBA interface (``TIFFReadRGBA
Strip`` / ``TIFFReadRGBATile``, one strip or tile a call) for every depth,
because the gray output is 8-bit, then ``(4899 R + 9617 G + 1868 B + 8192)
>> 14``.  It takes 1-bit gray and palette, 4-bit palette, and 8- and 16-bit
samples (unsigned or signed, read as unsigned), at most 4 a pixel, that
libtiff's RGBA code puts: gray (min-is-black or min-is-white, through
libtiff's ``Map``: 16-bit samples by their high byte, ``v >> 8``), palette
(a colour map with any entry of 256 or more cut to its high byte), RGB
(16-bit as ``(v + 128) // 257``; an unassociated alpha premultiplies, ``(v
a + 127) // 255``), CMYK at 8 bits (``r = (255 - k)(255 - c) // 255``),
YCbCr (libtiff's fixed-point conversion with ``ReferenceBlackWhite``; a
subsampled pixel takes its block's Cb and Cr; JPEG-compressed YCbCr as
libjpeg converts it to RGB), contiguous or planar
(planar gray and RGB go through the RGB routines: no ``Map``, so planar
min-is-white is not inverted, 16-bit as ``(v + 128) // 257``).  libtiff's
gray and 8-bit palette put routines step a clipped tile's rows wrongly
when a pixel has more than one byte (they skip ``tile width - columns``
bytes instead of as many pixels); the right-hand column of tiles reads as
they read it.  Orientations: libtiff mirrors what each RGBA call returns for
2, 3, 6 and 7 (the whole width of a strip, the columns of a tile), cv2
turns the rows over for 3, 4, 7 and 8 and transposes for 5-8, which only a
square image survives (a non-square one makes cv2 fail).  A strip or tile
that cannot be read (a byte count of 0 or one past the end of the file) as
the first read of its RGBA call makes cv2 fail; one that decodes wrongly
keeps what its codec decoded, zeros after it, and no predictor or byte
swap (``native/tiff_decode.cc``); an uncompressed tile with FillOrder 2
that is not a whole number of KiB cannot be read.  libtiff's repairs of the directory are
followed: missing or inconsistent ``StripByteCounts`` of uncompressed
images estimated from the image size, colour channels past the
photometric's counted as extra samples, a palette image without a colour
map read as gray, a tag of the wrong type skipped.  A directory of more
than 2^24 strips or tiles, or of more than 8 GiB of decoded samples, is
refused before anything is allocated.

cv2 refuses 2-bit samples, 4-bit gray, 12-, 24-, 32- and 64-bit samples,
floating-point samples, 5 or more samples a pixel, 16-bit palette and CMYK,
and what libtiff's RGBA code cannot put; PIL then reads what its
``OPEN_INFO`` table names (2- and 4-bit gray scaled by 85 and 17, 12-bit as
``I;16``, 32-bit integers as ``I``, 32-bit floats as ``F``, gray + alpha,
16-bit CMYK by its high byte, ...; PIL has no unpacker for the bit-reversed
2- and 4-bit palette modes): uncompressed data with its own raw decoder,
which reads each strip or tile from its offset whatever its byte count
says, compressed data through libtiff, where any strip or tile that fails
makes PIL fail (planar bands: the mode's, 8 bits or a 16-bit sample's high
byte); then ``convert("L")`` (`gray.pil_to_l`).  PIL applies the
orientation after loading, and for 5-8 swaps the image's size first: an
uncompressed image in one strip or tile whose raw mode is PIL's mode is
memory-mapped at the swapped size (its bytes read as W rows of H pixels)
and then transposed, which scrambles it; every other layout is decoded at
its own size and transposed properly.  PIL reads no big-endian BigTIFF
(it takes the header's third byte for the version).

Both refuse what neither reads: not a TIFF file, a directory that cannot
be read, no image width or length, no strip or tile offsets, and the
samples both refuse (64-bit floats, 16-bit palette, ...).  What the port
does not read yet raises, naming it: subsampled YCbCr with a predictor
(and YCbCr that only PIL reads), old-style JPEG (compression 6), JPEG at other than 8 bits, and codecs past the ones above (LZMA, ZSTD, WebP, JBIG, SGI log,
ThunderScan).  Damaged CCITT data: Group 4 and RLE strips decode as
libtiff decodes them; a cut or corrupt Group 3 strip, or the last strip of
a damaged multi-strip Group 4 image, may differ: libtiff 4.7 goes on
decoding rows past the end of such data in a way not modelled here.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from xfmamba_tpu_torch import native
from xfmamba_tpu_torch.data import limits
from xfmamba_tpu_torch.data.gray import cv2_gray, pil_to_l

SIGNATURES = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")
# PIL's PREFIXES also take these two (byte order and version swapped)
PIL_SIGNATURES = SIGNATURES + (b"MM*\x00", b"II\x00*")
SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 13: 4,
         16: 8, 17: 8, 18: 8}
FORMATS = {1: "B", 2: "B", 3: "H", 4: "I", 5: "I", 6: "b", 7: "B", 8: "h", 9: "i", 10: "i",
           11: "f", 12: "d", 13: "I", 16: "Q", 17: "q", 18: "Q"}
(WIDTH, LENGTH, BPS, COMPRESSION, PHOTOMETRIC, FILLORDER, STRIPOFFSETS, ORIENTATION, SPP,
 RPS, STRIPBYTECOUNTS, PLANAR, PREDICTOR, COLORMAP, TILEWIDTH, TILELENGTH, TILEOFFSETS,
 TILEBYTECOUNTS, EXTRASAMPLES, SAMPLEFORMAT, JPEGTABLES, YCBCRCOEFFICIENTS,
 YCBCRSUBSAMPLING, REFERENCEBLACKWHITE, T4OPTIONS, T6OPTIONS, INKSET) = (
    256, 257, 258, 259, 262, 266, 273, 274, 277, 278, 279, 284, 317, 320, 322, 323, 324, 325,
    338, 339, 347, 529, 530, 532, 292, 293, 332)
# codecs the port decodes (tiff_decode.cc: none, CCITT RLE / Group 3 / Group
# 4 / RLEW, LZW, Deflate, PackBits), and JPEG (7) through jpeg_decode.cc
CODECS = {1, 2, 3, 4, 5, 7, 8, 32771, 32773, 32946}
NOT_YET = {6: "old-style JPEG", 32809: "ThunderScan", 34676: "SGI LogL", 34677: "SGI LogLuv",
           34925: "LZMA", 50000: "ZSTD", 50001: "WebP", 34661: "JBIG"}
# PIL's COMPRESSION_INFO keys (anything else: PIL refuses)
PIL_CODECS = {1, 2, 3, 4, 5, 6, 7, 8, 32771, 32773, 32809, 32946, 34676, 34677, 34925, 50000,
              50001}
MISSING = object()
INT_TYPES = {1, 3, 4, 6, 8, 9, 13, 16, 17, 18}
INTEGER_TAGS = {WIDTH, LENGTH, BPS, COMPRESSION, PHOTOMETRIC, FILLORDER, STRIPOFFSETS, ORIENTATION,
                SPP, RPS, STRIPBYTECOUNTS, PLANAR, PREDICTOR, COLORMAP, TILEWIDTH, TILELENGTH,
                TILEOFFSETS, TILEBYTECOUNTS, EXTRASAMPLES, SAMPLEFORMAT, YCBCRSUBSAMPLING,
                T4OPTIONS, T6OPTIONS, INKSET}
# past these a directory is refused before anything is allocated: more than
# 2^24 strips or tiles, or more than 8 GiB of decoded samples
MAX_CHUNKS = 1 << 24
MAX_DECODED = 1 << 33


class Refused(Exception):
    """One reader does not read the file (the reason)."""


def _fail(path, what):
    raise ValueError(f"{path}: {what}")


# ---- the directory ----------------------------------------------------------

class Directory:
    """The first image file directory: each tag's (type, values)."""

    def __init__(self, raw: bytes, pil: bool = False):
        head = raw[:4]
        if head not in (PIL_SIGNATURES if pil else SIGNATURES):
            raise Refused("not a TIFF file")
        self.order = "<" if head[:2] == b"II" else ">"
        self.big = head in (b"II+\x00", b"MM\x00+")
        if self.big:
            if pil and self.order == ">":
                # PIL takes byte 2 of the header for the version: a
                # big-endian BigTIFF's is 0, so it reads an 8-byte header
                raise Refused("PIL reads no big-endian BigTIFF")
            if len(raw) < 16:
                raise Refused("cut BigTIFF header")
            bytesize, reserved, first = struct.unpack(self.order + "HHQ", raw[4:16])
            if bytesize != 8 or reserved != 0:
                raise Refused("bad BigTIFF header")
        else:
            if len(raw) < 8:
                raise Refused("cut TIFF header")
            (first,) = struct.unpack(self.order + "I", raw[4:8])
        self.raw = raw
        self.tags = self._read(first)

    def _read(self, off: int) -> dict:
        raw, o = self.raw, self.order
        count_size, entry, inline = (8, 20, 8) if self.big else (2, 12, 4)
        if off < 8 or off + count_size > len(raw):
            raise Refused("cannot read the directory")
        (n,) = struct.unpack(o + ("Q" if self.big else "H"), raw[off:off + count_size])
        if off + count_size + n * entry > len(raw):
            raise Refused("cannot read the directory (cut)")
        tags = {}
        for i in range(n):
            e = raw[off + count_size + i * entry: off + count_size + (i + 1) * entry]
            if self.big:
                tag, typ, count = struct.unpack(o + "HHQ", e[:12])
                value = e[12:]
            else:
                tag, typ, count = struct.unpack(o + "HHI", e[:8])
                value = e[8:]
            if typ not in SIZES or tag in tags or (tag in INTEGER_TAGS and typ not in INT_TYPES):
                continue                        # as libtiff skips a tag of the wrong type
            size = SIZES[typ] * count
            if size > inline:
                (where,) = struct.unpack(o + ("Q" if self.big else "I"), value)
                if where + size > len(raw):
                    continue                    # an entry whose data is out of the file
                data = raw[where:where + size]
            else:
                data = value[:size]
            if typ in (5, 10):
                v = struct.unpack(o + FORMATS[typ] * (2 * count), data)
                vals = tuple(v[2 * k] / v[2 * k + 1] if v[2 * k + 1] else math.nan
                             for k in range(count))
            elif typ == 2 or typ == 7:
                vals = data
            else:
                vals = struct.unpack(o + FORMATS[typ] * count, data)
            tags[tag] = (typ, vals)
        return tags

    def get(self, tag, default=MISSING):
        t = self.tags.get(tag)
        if t is None or (not isinstance(t[1], bytes) and len(t[1]) == 0):
            return default
        return t[1]

    def first(self, tag, default=MISSING):
        v = self.get(tag)
        return default if v is MISSING else v[0]


class Layout:
    """The image's geometry and sample layout, as libtiff sets it up."""

    def __init__(self, d: Directory):
        self.d = d
        self.width = d.first(WIDTH, None)
        self.height = d.first(LENGTH, None)
        if not self.width or not self.height:
            raise Refused("no image width or length")
        self.spp = d.first(SPP, 1)
        bps = d.get(BPS, (1,))
        self.bits = bps[0]
        if any(b != self.bits for b in bps[:self.spp]):
            raise Refused("different bits per sample per sample")
        sf = d.get(SAMPLEFORMAT, (1,))
        self.sample_format = sf[0]
        self.compression = d.first(COMPRESSION, 1)
        self.photometric = d.first(PHOTOMETRIC, None)
        self.fill_order = d.first(FILLORDER, 1)
        o = d.first(ORIENTATION, 1)
        self.orientation = o if 1 <= o <= 8 else 1
        self.planar = d.first(PLANAR, 1)
        self.separate = self.planar == 2 and self.spp > 1
        self.predictor = d.first(PREDICTOR, 1)
        self.extra = tuple(d.get(EXTRASAMPLES, ()))
        self.tiled = TILEWIDTH in d.tags
        if self.tiled:
            self.tile_w = d.first(TILEWIDTH, 0)
            self.tile_h = d.first(TILELENGTH, 0)
            if not self.tile_w or not self.tile_h:
                raise Refused("bad tile size")
            self.offsets = d.get(TILEOFFSETS, None)
            self.counts = d.get(TILEBYTECOUNTS, None)
        else:
            rps = d.first(RPS, 0xFFFFFFFF)
            self.rps = rps if 0 < rps < self.height else self.height
            self.offsets = d.get(STRIPOFFSETS, None)
            self.counts = d.get(STRIPBYTECOUNTS, None)
        if self.offsets is None:
            raise Refused("no strip or tile offsets")
        self.planes = self.spp if self.separate else 1
        self.bits_pixel = self.bits * (1 if self.separate else self.spp)
        if self.tiled:
            self.across = -(-self.width // self.tile_w)
            self.down = -(-self.height // self.tile_h)
            self.row_bytes = -(-self.tile_w * self.bits_pixel // 8)
            self.nchunks = self.across * self.down * self.planes
        else:
            self.row_bytes = -(-self.width * self.bits_pixel // 8)
            self.strips_per_plane = -(-self.height // self.rps)
            self.nchunks = self.strips_per_plane * self.planes
        chunk_rows = self.tile_h if self.tiled else self.rps
        if self.nchunks > MAX_CHUNKS or self.nchunks * chunk_rows * self.row_bytes > MAX_DECODED:
            # a directory no reader decodes (cv2's buffers fail to allocate)
            raise Refused("strips or tiles past what a reader allocates")
        offsets = [min(v, 1 << 62) for v in self.offsets[:self.nchunks]]
        self.offsets = offsets + [0] * (self.nchunks - len(offsets))

    def chunk_rows(self, i: int) -> int:
        if self.tiled:
            return self.tile_h
        s = i % self.strips_per_plane
        return min(self.rps, self.height - s * self.rps)


def _libtiff_layout(d: Directory) -> Layout:
    """The layout after libtiff's directory repairs (TIFFReadDirectory)."""
    lay = Layout(d)
    if lay.photometric is None:
        raise Refused("no photometric interpretation")
    if lay.photometric == 3 and COLORMAP not in d.tags:
        if lay.bits >= 8 and lay.spp == 3:
            lay.photometric = 2
        elif lay.bits >= 8:
            lay.photometric = 1
        else:
            raise Refused("palette image without a colour map")
    colours = {0: 1, 1: 1, 3: 1, 4: 1, 2: 3, 6: 3, 8: 3, 9: 3, 10: 3, 5: 4}.get(lay.photometric, 0)
    if colours and lay.spp - len(lay.extra) > colours:
        lay.extra = lay.extra + (0,) * (lay.spp - colours - len(lay.extra))
    counts = lay.counts
    n = lay.nchunks
    if counts is not None:
        counts = [min(v, 1 << 62) for v in counts[:n]]
    if counts is None:
        counts = _estimate_counts(lay, d)
    else:
        counts = list(counts[:n]) + [0] * (n - len(counts[:n]))
        if (not lay.tiled and n == 1 and _count_looks_bad(lay, counts[0])) or (
                not lay.tiled and not lay.separate and n > 2 and lay.compression == 1
                and counts[0] != counts[1] and counts[0] and counts[1]):
            counts = _estimate_counts(lay, d)
    lay.counts = counts
    return lay


def _scanline(lay: Layout) -> int:
    """libtiff's TIFFScanlineSize: for subsampled YCbCr a row of blocks
    over the vertical subsampling, rounded down."""
    blocks = _ycbcr_blocks(lay)
    return blocks[2] // blocks[1] if blocks else lay.row_bytes


def _count_looks_bad(lay: Layout, count: int) -> bool:
    """libtiff's ByteCountLooksBad for a one-strip image."""
    filesize = len(lay.d.raw)
    off = lay.offsets[0]
    if off == 0:
        return False
    return count == 0 or (lay.compression == 1 and (
        count > filesize - off or count < _scanline(lay) * lay.height))


def _estimate_counts(lay: Layout, d: Directory) -> list:
    """libtiff's EstimateStripByteCounts."""
    n = lay.nchunks
    if lay.compression != 1:
        raise Refused("compressed data without byte counts")     # not estimated by the port
    if lay.tiled:
        return [lay.row_bytes * lay.tile_h] * n
    rows = lay.height // (lay.strips_per_plane or 1)
    return [_scanline(lay) * rows] * n


# ---- decoding the chunks ----------------------------------------------------

def _sample_bytes(lay: Layout) -> int:
    return max(lay.bits // 8, 1)


def _jpeg_tables(d: Directory):
    t = d.get(JPEGTABLES, None)
    return bytes(t) if t is not None else None


def _ycbcr_blocks(lay: Layout):
    """(h, v, bytes of a row of blocks) of subsampled contiguous YCbCr
    (each block h x v lumas, then Cb and Cr), or None."""
    if lay.photometric != 6 or lay.separate or lay.compression == 7:
        return None
    hs, vs = _subsampling(lay)
    if (hs, vs) == (1, 1):
        return None
    width = lay.tile_w if lay.tiled else lay.width
    return hs, vs, -(-width // hs) * (hs * vs + 2) * lay.bits // 8


def decode_chunks(lay: Layout, raw: bytes):
    """(buffer, per-chunk offsets in it, status) of every strip or tile:
    chunk i holds ``chunk_rows(i)`` rows of ``row_bytes`` (subsampled YCbCr:
    its rows of blocks)."""
    n = lay.nchunks
    rows = np.array([lay.chunk_rows(i) for i in range(n)], np.int64)
    wants = slots = rows * lay.row_bytes
    blocks = _ycbcr_blocks(lay)
    if blocks:
        _, vs, row = blocks
        slots = -(-rows // vs) * row
        # an RGBA strip read asks for its rows rounded up to whole blocks
        # times TIFFScanlineSize, the row of blocks over vs rounded down
        wants = slots if lay.tiled else -(-rows // vs) * vs * (row // vs)
    out_offsets = np.concatenate([[0], np.cumsum(slots)[:-1]]).astype(np.int64)
    total = int(slots.sum())
    if lay.compression == 7:
        return _decode_jpeg_chunks(lay, raw, wants, out_offsets, total)
    if lay.compression not in CODECS:
        raise Refused(f"compression {lay.compression}")
    predictor = lay.predictor if lay.compression in (5, 8, 32946) else 1
    if predictor == 2 and lay.bits not in (8, 16, 32, 64):
        predictor = -1
    if predictor == 3 and (lay.sample_format != 3 or lay.bits not in (16, 24, 32, 64)):
        predictor = -1
    if predictor not in (1, 2, 3):
        # libtiff's predictor setup fails: no strip can be decoded
        status = np.full(n, 2, np.int8)
        return np.zeros(total, np.uint8), out_offsets, status
    swap = lay.d.order == ">" and lay.bits in (16, 32, 64)
    fax = 0
    if lay.compression == 3:
        fax = lay.d.first(T4OPTIONS, 0)
    elif lay.compression == 4:
        fax = lay.d.first(T6OPTIONS, 0)
    buf, status = native.tiff_decode_chunks(
        raw, lay.offsets, lay.counts, wants, out_offsets, total, codec=lay.compression,
        predictor=predictor, sample_bytes=_sample_bytes(lay),
        stride=1 if lay.separate else lay.spp, row_bytes=lay.row_bytes, swap=swap,
        reverse_bits=lay.fill_order == 2,
        width=lay.tile_w if lay.tiled else lay.width, fax_options=fax)
    return buf, out_offsets, status


def _jpeg_stream(tables, data: bytes) -> bytes:
    """A strip's abbreviated JPEG datastream with the JPEGTables segments
    in front (libjpeg keeps the tables it read first)."""
    if not tables or len(tables) < 4 or data[:2] != b"\xff\xd8":
        return data
    body = tables[2:-2] if tables[-2:] == b"\xff\xd9" else tables[2:]
    return data[:2] + body + data[2:]


def _decode_jpeg_chunks(lay, raw, wants, out_offsets, total):
    """libtiff's JPEG codec (tif_jpeg.c): each strip or tile a JPEG
    datastream, YCbCr converted to RGB where the photometric is YCbCr and
    the samples contiguous (JPEGCOLORMODE_RGB), else taken as they are.  A
    frame wider than the segment, or taller where it is not the image's
    last strip, fails; a shorter one leaves zeros."""
    if lay.bits != 8:
        raise NotYet(f"{lay.bits}-bit JPEG-compressed TIFF")
    rgb = lay.photometric == 6 and not lay.separate
    tables = _jpeg_tables(lay.d)
    buf = np.zeros(total, np.uint8)
    status = np.zeros(lay.nchunks, np.int8)
    for i in range(lay.nchunks):
        off, count = lay.offsets[i], lay.counts[i]
        if count == 0 or off + count > len(raw):
            status[i] = 2
            continue
        rows = lay.chunk_rows(i)
        seg_w = lay.tile_w if lay.tiled else lay.width
        last = not lay.tiled and (i + 1) % lay.strips_per_plane == 0
        try:
            px = native.jpeg_decode_samples(_jpeg_stream(tables, raw[off:off + count]), rgb)
        except ValueError:
            status[i] = 1
            continue
        h, w, nc = px.shape
        spp = 3 if rgb else (1 if lay.separate else lay.spp)
        if w > seg_w or (h > rows and not (last and w == seg_w)) or nc != spp:
            status[i] = 1
            continue
        part = np.zeros((rows, seg_w, spp), np.uint8)
        part[:min(h, rows), :w] = px[:rows]
        buf[out_offsets[i]:out_offsets[i] + wants[i]] = part.reshape(-1)[:wants[i]]
    return buf, out_offsets, status


def _unpack(buf: np.ndarray, rows: int, row_bytes: int, width: int, bits: int, spp: int):
    """(rows, width, spp) samples of packed rows: uint8 below 16 bits,
    host-order uint16 / uint32 / uint64 above."""
    data = buf[:rows * row_bytes].reshape(rows, row_bytes)
    if bits == 8:
        return data[:, :width * spp].reshape(rows, width, spp)
    if bits in (16, 32, 64):
        k = bits // 8
        return data[:, :width * spp * k].copy().view(f"<u{k}").reshape(rows, width, spp)
    bitsarr = np.unpackbits(data, axis=1)[:, :width * spp * bits].reshape(rows, width * spp, bits)
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint16)
    v = (bitsarr.astype(np.uint16) * weights).sum(axis=2).astype(np.uint16)
    return v.reshape(rows, width, spp)


def assemble(lay: Layout, buf, out_offsets, plane: int = 0):
    """The whole image's samples of one plane (separate) or all (contig):
    (height, width, samples)."""
    spp = 1 if lay.separate else lay.spp
    parts = []
    if lay.tiled:
        img = None
        per_plane = lay.across * lay.down
        for t in range(per_plane):
            i = plane * per_plane + t
            ty, tx = divmod(t, lay.across)
            y0, x0 = ty * lay.tile_h, tx * lay.tile_w
            rows = min(lay.tile_h, lay.height - y0)
            s = _unpack(buf[out_offsets[i]:], rows, lay.row_bytes, lay.tile_w, lay.bits, spp)
            if img is None:
                img = np.zeros((lay.height, lay.width, spp), s.dtype)
            img[y0:y0 + rows, x0:x0 + lay.tile_w] = s[:, :lay.width - x0]
        return img
    for s in range(lay.strips_per_plane):
        i = plane * lay.strips_per_plane + s
        parts.append(_unpack(buf[out_offsets[i]:], lay.chunk_rows(i), lay.row_bytes, lay.width,
                             lay.bits, spp))
    return np.concatenate(parts, axis=0)


# ---- cv2: libtiff's RGBA interface --------------------------------------------

def _cv2_header_ok(lay: Layout) -> bool:
    """Whether cv2's TiffDecoder::readHeader takes the depth (after it
    treats samples past 8 bits of a photometric past RGB, or of 2 or 5+
    samples, as 8 bits)."""
    b = lay.bits
    if b > 8 and (lay.photometric > 2 or lay.spp not in (1, 3, 4)):
        b = 8
    return b in (1, 8, 10, 12, 14, 16, 32, 64) or (b == 4 and lay.photometric == 3)


def _cv2_supported(lay: Layout):
    """The reason cv2 refuses the layout, or None."""
    b, p, spp = lay.bits, lay.photometric, lay.spp
    if lay.sample_format == 3:
        return "floating-point samples"
    if b not in (1, 4, 8, 16) or (b == 4 and p != 3):
        return f"{b}-bit samples"
    if lay.orientation >= 5 and lay.width != lay.height:
        # cv2 transposes into a new buffer, which imread refuses
        return f"orientation {lay.orientation} of a non-square image"
    if spp > 4:
        return f"{spp} samples per pixel"
    colours = spp - len(lay.extra)
    if p == 2 and colours < 3:
        return "RGB with fewer than 3 colour channels"
    if p == 5 and (lay.d.first(INKSET, 1) != 1 or spp < 4):
        return "separated image that is not CMYK"
    if lay.separate:                              # libtiff's PickSeparateCase
        if p in (0, 1, 2) and b in (8, 16):
            return None
        if p == 5 and b == 8 and spp == 4:
            return None
        if p == 6 and b == 8 and spp == 3 and _subsampling(lay) == (1, 1):
            return None
        return "planar layout"
    if p in (0, 1, 3):                            # PickContigCase
        if spp != 1 and b < 8:
            return "contiguous samples below 8 bits with more than one sample"
        return "palette layout" if p == 3 and b == 16 else None
    if p == 2:
        return None if b in (8, 16) else "RGB depth"
    if p == 5:
        return None if b == 8 else "CMYK depth"
    if p == 6:
        if lay.compression == 7:
            # libtiff takes JPEG-compressed YCbCr as RGB: three colour samples
            return None if colours >= 3 else "RGB with fewer than 3 colour channels"
        if b != 8 or spp != 3:
            return "YCbCr layout"
        sub = _subsampling(lay)
        if sub not in ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)):
            return "YCbCr subsampling"
        return "YCbCr subsampled with a predictor" if sub != (1, 1) and \
            lay.predictor != 1 and lay.compression in (5, 8, 32946) else None
    return f"photometric {p}"


def _subsampling(lay: Layout):
    return tuple(lay.d.get(YCBCRSUBSAMPLING, (2, 2))[:2])


def _alpha(lay: Layout) -> int:
    """libtiff's img->alpha: 1 associated, 2 unassociated, 0 none."""
    if not lay.extra:
        return 0
    e = lay.extra[0]
    if e == 0:
        return 1 if lay.spp > 3 else 0
    return e if e in (1, 2) else 0


def _map(lay: Layout) -> np.ndarray:
    """libtiff's setupMap for gray: Map[x] for x in 0..range."""
    rng = 255 if lay.bits == 16 else (1 << lay.bits) - 1
    x = np.arange(rng + 1, dtype=np.int64)
    m = (rng - x) * 255 // rng if lay.photometric == 0 else x * 255 // rng
    return m.astype(np.uint8)


def _to8(v):
    """libtiff's Bitdepth16To8: (v + 128) // 257."""
    return ((v.astype(np.int64) + 128) // 257).astype(np.int64)


def _premultiply(v, a):
    """libtiff's UaToAa: (v a + 127) // 255."""
    return (v.astype(np.int64) * a.astype(np.int64) + 127) // 255


def _colormap(lay: Layout):
    cmap = np.asarray(lay.d.get(COLORMAP, ()), np.int64)
    n = 1 << lay.bits
    if cmap.size < 3 * n:
        raise Refused("short colour map")
    r, g, b = cmap[:n], cmap[n:2 * n], cmap[2 * n:3 * n]
    if (r >= 256).any() or (g >= 256).any() or (b >= 256).any():
        r, g, b = r >> 8, g >> 8, b >> 8
    return np.stack([r & 255, g & 255, b & 255], axis=1)


def _ycbcr_tables(lay: Layout):
    """libtiff's TIFFYCbCrToRGBInit tables (float32 arithmetic)."""
    luma = lay.d.get(YCBCRCOEFFICIENTS, (0.299, 0.587, 0.114))
    rbw = lay.d.get(REFERENCEBLACKWHITE, (0.0, 255.0, 128.0, 255.0, 128.0, 255.0))
    f32 = np.float32
    lr, lg, lb = (f32(v) for v in luma[:3])
    rbw = [f32(v) for v in rbw[:6]]

    def fix(v):
        return int(math.floor(float(f32(v)) * 65536 + 0.5))

    def clamp(v, lo, hi):
        return min(max(v, lo), hi)
    f1 = f32(2) - f32(2) * lr
    d1 = fix(clamp(f1, 0.0, 2.0))
    f2 = lr * f1 / lg
    d2 = -fix(clamp(f2, 0.0, 2.0))
    f3 = f32(2) - f32(2) * lb
    d3 = fix(clamp(f3, 0.0, 2.0))
    f4 = lb * f3 / lg
    d4 = -fix(clamp(f4, 0.0, 2.0))

    def code2v(c, rb, rw, cr):
        den = rw - rb if rw - rb != 0 else f32(1)
        return f32(f32(f32(c) - rb) * f32(cr)) / f32(den)
    cr_r, cb_b, cr_g, cb_g, y_tab = [], [], [], [], []
    for i in range(256):
        x = i - 128
        cr = int(clamp(float(code2v(x, rbw[4] - f32(128), rbw[5] - f32(128), 127)),
                       -128.0 * 32, 128.0 * 32))
        cb = int(clamp(float(code2v(x, rbw[2] - f32(128), rbw[3] - f32(128), 127)),
                       -128.0 * 32, 128.0 * 32))
        cr_r.append((d1 * cr + 32768) >> 16)
        cb_b.append((d3 * cb + 32768) >> 16)
        cr_g.append(d2 * cr)
        cb_g.append(d4 * cb + 32768)
        y_tab.append(int(clamp(float(code2v(x + 128, rbw[0], rbw[1], 255)),
                               -128.0 * 32, 128.0 * 32)))
    return [np.asarray(t, np.int64) for t in (y_tab, cr_r, cb_b, cr_g, cb_g)]


def _ycbcr_to_rgb(lay, y, cb, cr):
    y_tab, cr_r, cb_b, cr_g, cb_g = _ycbcr_tables(lay)
    y, cb, cr = (np.asarray(v, np.int64) for v in (y, cb, cr))
    r = np.clip(y_tab[y] + cr_r[cr], 0, 255)
    g = np.clip(y_tab[y] + ((cb_g[cb] + cr_g[cr]) >> 16), 0, 255)
    b = np.clip(y_tab[y] + cb_b[cb], 0, 255)
    return r, g, b


def _rgba_gray_contig(lay: Layout, s: np.ndarray) -> np.ndarray:
    """cv2's gray of libtiff's contiguous put routines on samples s."""
    p = lay.photometric
    if p in (0, 1):
        v = s[..., 0]
        if lay.bits == 16:
            v = v >> 8
        return _map(lay)[v]
    if p == 3:
        rgb = _colormap(lay)[s[..., 0]]
        return cv2_gray(rgb[..., 0], rgb[..., 1], rgb[..., 2])
    if p == 2 or p == 6:
        if p == 6 and lay.compression != 7:
            return cv2_gray(*_ycbcr_to_rgb(lay, s[..., 0], s[..., 1], s[..., 2]))
        c = [s[..., k].astype(np.int64) for k in range(3)]
        alpha = _alpha(lay) if p == 2 else 0
        if lay.bits == 16:
            c = [_to8(v) for v in c]
        if alpha == 2:
            a = s[..., 3].astype(np.int64)
            a = _to8(a) if lay.bits == 16 else a
            c = [_premultiply(v, a) for v in c]
        return cv2_gray(*c)
    if p == 5:
        k = 255 - s[..., 3].astype(np.int64)
        c = [k * (255 - s[..., i].astype(np.int64)) // 255 for i in range(3)]
        return cv2_gray(*c)
    raise Refused(f"photometric {p}")


def _rgba_gray_separate(lay: Layout, planes) -> np.ndarray:
    """The same for planar data: planes[i] is (H, W) or None."""
    p = lay.photometric
    colours = 4 if p == 5 else (1 if p in (0, 1) else 3)
    h, w = lay.height, lay.width
    zero = np.zeros((h, w), np.int64)
    get = [zero if planes[i] is None else planes[i].astype(np.int64) for i in range(len(planes))]
    if p == 5:
        k = 255 - get[3]
        return cv2_gray(*(k * (255 - get[i]) // 255 for i in range(3)))
    if p == 6:
        return cv2_gray(*_ycbcr_to_rgb(lay, get[0], get[1], get[2]))
    c = [get[0]] * 3 if colours == 1 else get[:3]
    alpha = _alpha(lay)
    if lay.bits == 16:
        c = [_to8(v) for v in c]
    if alpha == 2:
        a = get[colours]
        a = _to8(a) if lay.bits == 16 else a
        c = [_premultiply(v, a) for v in c]
    return cv2_gray(*c)


def _skewed_right_tiles(lay: Layout, buf, offs, samples):
    """The right-hand column of clipped tiles as libtiff's putgreytile,
    put16bitbwtile and put8bitcmaptile read it: after each row of ``npix`` pixels they skip
    ``tile width - npix`` bytes where they should skip as many pixels, so
    row r starts at byte r (npix bytes-per-pixel + tile width - npix)."""
    k = lay.bits // 8
    bpp = lay.spp * k
    tx = lay.across - 1
    x0 = tx * lay.tile_w
    npix = lay.width - x0
    step = npix * bpp + (lay.tile_w - npix)
    out = samples.copy()
    for ty in range(lay.down):
        t = ty * lay.across + tx
        tile = buf[offs[t]:offs[t] + lay.tile_h * lay.row_bytes]
        rows = min(lay.tile_h, lay.height - ty * lay.tile_h)
        starts = np.arange(rows)[:, None] * step + np.arange(npix)[None, :] * bpp
        v = tile[starts].astype(np.uint16)
        if k == 2:
            v = v | (tile[starts + 1].astype(np.uint16) << 8)
        out[ty * lay.tile_h:ty * lay.tile_h + rows, x0:, 0] = v
    return out


def _ycbcr_subsampled(lay: Layout, buf, offs):
    """(Y, Cb, Cr) of each pixel of subsampled YCbCr as libtiff's
    putcontig8bitYCbCr*tile routines read the blocks: a pixel takes its
    own luma and its block's Cb and Cr."""
    hs, vs, row = _ycbcr_blocks(lay)
    unit = hs * vs + 2
    ch_w = lay.tile_w if lay.tiled else lay.width
    ch_h = lay.tile_h if lay.tiled else lay.rps
    yy, xx = np.mgrid[:ch_h, :ch_w]
    block = (yy // vs) * (row // unit) + xx // hs
    luma = block * unit + (yy % vs) * hs + xx % hs
    chroma = block * unit + hs * vs
    planes = np.zeros((3, lay.height, lay.width), np.int64)
    per_plane = lay.nchunks
    for i in range(per_plane):
        data = buf[offs[i]:offs[i] + -(-lay.chunk_rows(i) // vs) * row].astype(np.int64)
        data = np.concatenate([data, np.zeros(luma.max() + 2, np.int64)])
        if lay.tiled:
            ty, tx = divmod(i, lay.across)
            y0, x0 = ty * lay.tile_h, tx * lay.tile_w
        else:
            y0, x0 = i * lay.rps, 0
        hh = min(ch_h, lay.height - y0)
        ww = min(ch_w, lay.width - x0)
        for k, idx in enumerate((luma, chroma, chroma + 1)):
            planes[k, y0:y0 + hh, x0:x0 + ww] = data[idx[:hh, :ww]]
    return planes


def _first_reads(lay: Layout):
    """The chunk index of the first read of each RGBA call."""
    if lay.tiled:
        return range(lay.across * lay.down)
    return range(lay.strips_per_plane)


def cv2_read(raw: bytes) -> np.ndarray:
    """What cv2.imread(..., IMREAD_GRAYSCALE) gives, or `Refused`."""
    lay = _libtiff_layout(Directory(raw))
    if _cv2_header_ok(lay):
        limits.check_cv2(lay.width, lay.height)
    why = _cv2_supported(lay)
    if why == "YCbCr subsampled with a predictor":
        raise NotYet(why)
    if why:
        raise Refused(why)
    if lay.compression in NOT_YET:
        raise NotYet(NOT_YET[lay.compression])
    if lay.tiled and lay.compression == 1 and lay.fill_order == 2 and \
            (lay.row_bytes * lay.tile_h) % 1024:
        # the bit-reversed copy of a tile goes to a raw buffer of a whole
        # number of KiB, which libtiff then takes for the tile's byte count
        raise Refused("invalid tile byte count")
    buf, offs, status = decode_chunks(lay, raw)
    if any(status[i] == 2 for i in _first_reads(lay)):
        raise Refused("a strip or tile cannot be read")
    if lay.separate:
        p = lay.photometric
        need = {0: 1, 1: 1}.get(p, 4 if p == 5 else 3)
        if p in (0, 1, 2) and _alpha(lay):
            need += 1
        planes = [assemble(lay, buf, offs, k)[..., 0] if k < lay.spp else None
                  for k in range(need)]
        gray = _rgba_gray_separate(lay, planes)
    elif _ycbcr_blocks(lay):
        gray = cv2_gray(*_ycbcr_to_rgb(lay, *_ycbcr_subsampled(lay, buf, offs)))
    else:
        samples = assemble(lay, buf, offs)
        if lay.tiled and lay.width % lay.tile_w and (
                (lay.photometric in (0, 1) and (lay.bits == 16 or (lay.bits == 8 and lay.spp > 1)))
                or (lay.photometric == 3 and lay.bits == 8 and lay.spp > 1)):
            samples = _skewed_right_tiles(lay, buf, offs, samples)
        gray = _rgba_gray_contig(lay, samples)
    o = lay.orientation
    if o in (2, 3, 6, 7):
        # libtiff mirrors what each RGBA call returns: a strip is the whole
        # width, a tile only its own (clipped) columns
        if lay.tiled:
            gray = gray.copy()
            for x in range(0, lay.width, lay.tile_w):
                gray[:, x:x + lay.tile_w] = gray[:, x:x + lay.tile_w][:, ::-1]
        else:
            gray = gray[:, ::-1]
    # then the rows' order and, for 5-8 (square images only), a transpose
    gray = {3: lambda a: a[::-1], 4: lambda a: a[::-1], 5: lambda a: a.T,
            6: lambda a: a.T[::-1, ::-1], 7: lambda a: a.T[:, ::-1],
            8: lambda a: a.T[::-1]}.get(o, lambda a: a)(gray)
    return np.ascontiguousarray(gray, dtype=np.uint8)


class NotYet(Exception):
    """A TIFF variant the port does not read yet."""


# ---- PIL ----------------------------------------------------------------------

def _pil_modes():
    """PIL's OPEN_INFO: (photometric, sample format, fill order, bits,
    extra samples) -> (mode, raw mode), for either byte order (the 16-bit
    raw modes are given for little-endian files; `_pil_rawmode` fixes
    them for the other order)."""
    t = {}
    for fo, r in ((1, ""), (2, "R")):
        t[(0, (1,), fo, (1,), ())] = ("1", "1;I" + r)
        t[(1, (1,), fo, (1,), ())] = ("1", "1" + (";R" if r else ""))
        for b in (2, 4):
            t[(0, (1,), fo, (b,), ())] = ("L", f"L;{b}I{r}")
            t[(1, (1,), fo, (b,), ())] = ("L", f"L;{b}{r}")
        t[(0, (1,), fo, (8,), ())] = ("L", "L;I" + r)
        t[(1, (1,), fo, (8,), ())] = ("L", "L;R" if r else "L")
        t[(3, (1,), fo, (1,), ())] = ("P", "P;1" + r)
        t[(3, (1,), fo, (2,), ())] = ("P", "P;2" + r)
        t[(3, (1,), fo, (4,), ())] = ("P", "P;4" + r)
    t[(1, (2,), 1, (8,), ())] = ("L", "L")
    t[(1, (1,), 1, (12,), ())] = ("I;16", "I;12")
    t[(0, (1,), 1, (16,), ())] = ("I;16", "I;16")
    t[(1, (1,), 1, (16,), ())] = ("I;16", "I;16")
    t[(1, (1,), 2, (16,), ())] = ("I;16", "I;16R")
    t[(1, (2,), 1, (16,), ())] = ("I", "I;16S")
    t[(0, (3,), 1, (32,), ())] = ("F", "F;32F")
    t[(1, (1,), 1, (32,), ())] = ("I", "I;32N")
    t[(1, (2,), 1, (32,), ())] = ("I", "I;32S")
    t[(1, (3,), 1, (32,), ())] = ("F", "F;32F")
    t[(1, (1,), 1, (8, 8), (2,))] = ("LA", "LA")
    t[(2, (1,), 1, (8, 8, 8), ())] = ("RGB", "RGB")
    t[(2, (1,), 2, (8, 8, 8), ())] = ("RGB", "RGB;R")
    t[(2, (1,), 1, (8,) * 4, ())] = ("RGBA", "RGBA")
    for extra, mode, raw in (((0,), "RGB", "RGBX"), ((0, 0), "RGB", "RGBXX"),
                             ((0, 0, 0), "RGB", "RGBXXX"), ((1,), "RGBA", "RGBa"),
                             ((1, 0), "RGBA", "RGBaX"), ((1, 0, 0), "RGBA", "RGBaXX"),
                             ((2,), "RGBA", "RGBA"), ((2, 0), "RGBA", "RGBAX"),
                             ((2, 0, 0), "RGBA", "RGBAXX"), ((999,), "RGBA", "RGBA")):
        t[(2, (1,), 1, (8,) * (3 + len(extra)), extra)] = (mode, raw)
    t[(2, (1,), 1, (16,) * 3, ())] = ("RGB", "RGB;16L")
    t[(2, (1,), 1, (16,) * 4, ())] = ("RGBA", "RGBA;16L")
    t[(2, (1,), 1, (16,) * 4, (0,))] = ("RGB", "RGBX;16L")
    t[(2, (1,), 1, (16,) * 4, (1,))] = ("RGBA", "RGBa;16L")
    t[(2, (1,), 1, (16,) * 4, (2,))] = ("RGBA", "RGBA;16L")
    t[(3, (1,), 1, (8,), ())] = ("P", "P")
    t[(3, (1,), 1, (8, 8), (0,))] = ("P", "PX")
    t[(3, (1,), 1, (8, 8), (2,))] = ("PA", "PA")
    t[(3, (1,), 2, (8,), ())] = ("P", "P;R")
    t[(5, (1,), 1, (8,) * 4, ())] = ("CMYK", "CMYK")
    t[(5, (1,), 1, (8,) * 5, (0,))] = ("CMYK", "CMYKX")
    t[(5, (1,), 1, (8,) * 6, (0, 0))] = ("CMYK", "CMYKXX")
    t[(5, (1,), 1, (16,) * 4, ())] = ("CMYK", "CMYK;16L")
    t[(6, (1,), 1, (8,), ())] = ("L", "L")
    t[(6, (1,), 1, (8,) * 3, ())] = ("RGB", "RGBX")
    return t


PIL_MODES = _pil_modes()
# little-endian only in PIL's table
PIL_LITTLE_ONLY = {(1, (1,), 1, (12,), ()), (0, (1,), 1, (16,), ()), (1, (1,), 2, (16,), ()),
                   (1, (1,), 1, (32,), ())}
MAPMODES = ("L", "P", "RGBX", "RGBA", "CMYK", "I;16", "I;16L", "I;16B")


def _pil_key(d: Directory):
    """PIL's OPEN_INFO lookup: (mode, raw mode, compression, bits per
    sample) or Refused."""
    if d.first(WIDTH, None) is None or d.first(LENGTH, None) is None:
        raise Refused("missing dimensions")
    compression = d.first(COMPRESSION, 1)
    if compression not in PIL_CODECS:
        raise Refused(f"compression {compression}")
    photo = d.first(PHOTOMETRIC, 0)
    if compression == 6:
        photo = 6
    fill = d.first(FILLORDER, 1)
    sf = tuple(d.get(SAMPLEFORMAT, (1,)))
    if len(sf) > 1 and max(sf) == min(sf) == 1:
        sf = (1,)
    bps = tuple(d.get(BPS, (1,)))
    extra = tuple(d.get(EXTRASAMPLES, ()))
    spp = d.first(SPP, 3 if compression == 6 and photo in (2, 6) else 1)
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise Refused("unknown data organization")
    key = (photo, sf, fill, bps, extra)
    if key not in PIL_MODES or (d.order == ">" and key in PIL_LITTLE_ONLY):
        raise Refused("unknown pixel mode")
    mode, rawmode = PIL_MODES[key]
    if d.order == ">":
        rawmode = {"I;16": "I;16B", "I;16S": "I;16BS", "I;32S": "I;32BS", "F;32F": "F;32BF"}.get(
            rawmode, rawmode.replace(";16L", ";16B"))
        if key == (1, (1,), 1, (16,), ()):
            mode = "I;16B"
    if compression == 1 and rawmode in ("P;1R", "P;2R", "P;4R", "L;IR"):
        raise Refused("unknown raw mode for given image mode")      # PIL has no such unpacker
    if compression != 1:
        if fill == 2:
            mode, rawmode = PIL_MODES[(photo, sf, 1, bps, extra)]
            if d.order == ">" and rawmode.endswith(";16L"):
                rawmode = rawmode[:-1] + "B"
        if photo == 6 and compression == 7 and d.first(PLANAR, 1) == 1:
            rawmode = "RGB"
        elif rawmode in ("I;16", "I;16B"):
            rawmode = "I;16N"
        elif rawmode.endswith((";16B", ";16L")):
            rawmode = rawmode[:-1] + "N"
    return mode, rawmode, compression, bps


def _pil_unpack(data: np.ndarray, rawmode: str, width: int):
    """PIL's unpacker for one raw mode: rows (n, bytes) -> (n, width[,
    bands]) of the mode's values."""
    n = data.shape[0]
    base = rawmode
    if rawmode.endswith("R"):                  # fill order 2: each byte's bits reversed
        base = rawmode[:-1].rstrip(";")
        data = np.packbits(np.unpackbits(data, axis=1, bitorder="little"), axis=1)
    if base in ("1", "1;I"):
        v = np.unpackbits(data, axis=1)[:, :width].astype(bool)
        return ~v if base == "1;I" else v
    for b in (2, 4):
        if base in (f"L;{b}", f"L;{b}I", f"P;{b}"):
            bits = np.unpackbits(data, axis=1)[:, :width * b].reshape(n, width, b)
            v = (bits * (1 << np.arange(b - 1, -1, -1))).sum(axis=2).astype(np.uint8)
            if base.startswith("P"):
                return v
            if base.endswith("I"):
                v = ((1 << b) - 1) - v
            return (v * (255 // ((1 << b) - 1))).astype(np.uint8)
    if base == "P;1":
        return np.unpackbits(data, axis=1)[:, :width]
    if base in ("L", "P"):
        return data[:, :width]
    if base == "L;I":
        return 255 - data[:, :width]
    if base == "I;12":
        out = np.zeros((n, width), np.uint16)
        for y in range(n):
            r = data[y].astype(np.uint16)
            k = np.arange(width)
            a = r[(k // 2) * 3]
            b = r[(k // 2) * 3 + 1]
            c = r[np.minimum((k // 2) * 3 + 2, len(r) - 1)]
            out[y] = np.where(k % 2 == 0, (a << 4) + (b >> 4), ((b & 15) << 8) + c)
        return out
    typed = {"I;16": "<u2", "I;16B": ">u2", "I;16S": "<i2",
             "I;16BS": ">i2", "I;32N": "<u4", "I;32S": "<i4", "I;32BS": ">i4", "F;32F": "<f4",
             "F;32BF": ">f4"}
    if base in typed:
        k = int(typed[base][-1])
        v = data[:, :width * k].copy().view(typed[base]).reshape(n, width)
        if base == "I;32N":
            return v.astype(np.int64).astype(np.int32)
        return v
    bands = {"LA": ("L", 2), "RGB": ("RGB", 3), "RGBX": ("RGBX", 4), "RGBXX": ("RGBX", 5),
             "RGBXXX": ("RGBX", 6), "RGBA": ("RGBA", 4), "RGBAX": ("RGBA", 5),
             "RGBAXX": ("RGBA", 6), "RGBa": ("RGBa", 4), "RGBaX": ("RGBa", 5),
             "RGBaXX": ("RGBa", 6), "PX": ("P", 2), "PA": ("PA", 2), "CMYK": ("CMYK", 4),
             "CMYKX": ("CMYK", 5), "CMYKXX": ("CMYK", 6)}
    if base in bands:
        kind, k = bands[base]
        v = data[:, :width * k].reshape(n, width, k)
        if kind == "RGBa":
            a = v[..., 3].astype(np.int64)
            c = v[..., :3].astype(np.int64)
            safe = np.maximum(a, 1)[..., None]
            rgb = np.where(a[..., None] == 0, 0,
                           np.where(a[..., None] == 255, c, np.minimum(c * 255 // safe, 255)))
            return np.concatenate([rgb, a[..., None]], axis=2).astype(np.uint8)
        if kind == "P":
            return v[..., 0]
        if kind == "PA":
            return v[..., :2]
        if kind == "L":
            return v[..., :2]
        return v[..., :{"RGB": 3, "RGBX": 3, "RGBA": 4, "CMYK": 4}[kind]]
    wide = {"RGB;16L": 3, "RGB;16B": 3, "RGB;16N": 3, "RGBA;16L": 4, "RGBA;16B": 4,
            "RGBA;16N": 4, "RGBX;16L": 4, "RGBX;16B": 4, "RGBX;16N": 4, "RGBa;16L": 4,
            "RGBa;16B": 4, "RGBa;16N": 4, "CMYK;16L": 4, "CMYK;16B": 4, "CMYK;16N": 4}
    if base in wide:
        k = wide[base]
        hi = 0 if base.endswith("B") else 1
        v = data[:, :width * k * 2].reshape(n, width, k, 2)[..., hi]
        if base.startswith("RGBX"):
            return v[..., :3]
        if base.startswith("RGBa"):
            return _pil_unpack(v.reshape(n, width * 4), "RGBa", width)
        return v
    raise Refused(f"raw mode {rawmode}")


# the one-band unpackers PIL has for a mode's planar layers
PIL_BANDS = {"RGB": "RGB", "RGBA": "RGBA", "CMYK": "CMYK"}


def _transpose(a: np.ndarray, orientation: int) -> np.ndarray:
    if orientation == 2:
        return a[:, ::-1]
    if orientation == 3:
        return a[::-1, ::-1]
    if orientation == 4:
        return a[::-1]
    if orientation == 5:
        return np.swapaxes(a, 0, 1)
    if orientation == 6:
        return np.swapaxes(a, 0, 1)[:, ::-1]
    if orientation == 7:
        return np.swapaxes(a, 0, 1)[::-1, ::-1]
    if orientation == 8:
        return np.swapaxes(a, 0, 1)[::-1]
    return a


def pil_read(raw: bytes) -> np.ndarray:
    """What PIL's ``Image.open(path).convert("L")`` gives, or `Refused`."""
    d = Directory(raw, pil=True)
    mode, rawmode, compression, bps = _pil_key(d)
    if not limits.pil_ok(d.first(WIDTH), d.first(LENGTH)):
        raise Refused("decompression bomb")
    if compression != 1:
        if compression in NOT_YET:
            raise NotYet(NOT_YET[compression])
        img = _pil_libtiff(d, raw, mode, rawmode)
    else:
        img = _pil_raw(d, raw, mode, rawmode, bps)
    palette = None
    if mode in ("P", "PA"):
        cmap = np.asarray(d.get(COLORMAP, ()), np.int64)
        palette = (cmap // 256).astype(np.uint8)
        n = len(palette) // 3
        palette = np.stack([palette[:n], palette[n:2 * n], palette[2 * n:3 * n]], axis=1)
    gray = pil_to_l(img, mode.replace("I;16B", "I;16"), palette)
    return np.ascontiguousarray(gray)


def _pil_tiles(d: Directory, bps):
    """PIL's tile list for raw data: [(x0, y0, x1, y1, offset, stride, layer)]."""
    w_img, h_img = d.first(WIDTH), d.first(LENGTH)
    planar = d.first(PLANAR, 1)
    if STRIPOFFSETS in d.tags:
        offsets = list(d.get(STRIPOFFSETS))
        h = d.first(RPS, h_img)
        w = w_img
    elif TILEOFFSETS in d.tags:
        offsets = list(d.get(TILEOFFSETS))
        w, h = d.first(TILEWIDTH, None), d.first(TILELENGTH, None)
        if not w or not h:
            raise Refused("invalid tile dimensions")
    else:
        raise Refused("unknown data organization")
    if w == w_img and h == h_img and planar != 2:
        offsets = offsets[-1:]
    tiles, x, y, layer = [], 0, 0, 0
    bands = len(bps)
    for off in offsets:
        if x + w > w_img:
            stride = w * sum(bps) / 8
        else:
            stride = 0
        if planar == 2:
            stride /= bands
        tiles.append((x, y, min(x + w, w_img), min(y + h, h_img), off, int(stride), layer))
        x += w
        if x >= w_img:
            x, y = 0, y + h
            if y >= h_img:
                y = 0
                layer += 1
    return tiles


def _raw_bits(rawmode: str) -> int:
    """Bits a pixel of one of PIL's raw modes."""
    base = rawmode[:-1].rstrip(";") if rawmode.endswith("R") else rawmode
    if base.startswith("1"):
        return 1
    for b in (1, 2, 4):
        if base.startswith((f"L;{b}", f"P;{b}")):
            return b
    if base == "I;12":
        return 12
    if base.startswith("I;16"):
        return 16
    if base.startswith(("I;32", "F;32")):
        return 32
    if ";16" in base:
        return 16 * len(base.split(";")[0])
    if base in ("L", "L;I", "P"):
        return 8
    return 8 * len(base)


def _pil_raw(d: Directory, raw: bytes, mode: str, rawmode: str, bps):
    w_img, h_img = d.first(WIDTH), d.first(LENGTH)
    o = d.first(ORIENTATION, 1)
    planar = d.first(PLANAR, 1)
    tiles = _pil_tiles(d, bps)
    bits = _raw_bits(rawmode)
    if planar == 2:
        bands = PIL_BANDS.get(mode, "")
        layers = max(t[6] for t in tiles) + 1
        if any(k >= len(rawmode) or rawmode[k] not in bands for k in range(layers)):
            raise Refused("no unpacker for a planar band")
        bits = 8                                # each layer through an 8-bit band unpacker
    if len(tiles) == 1 and mode in MAPMODES and rawmode == mode:
        x0, y0, x1, y1, off, stride, _ = tiles[0]
        size_w, size_h = (h_img, w_img) if o in (5, 6, 7, 8) else (w_img, h_img)
        if off + size_h * stride <= len(raw):
            if stride <= 0:
                stride = size_w * (1 if mode in ("L", "P") else 2 if mode.startswith("I;16")
                                   else 4)
            if off + size_h * stride > len(raw):
                raise Refused("buffer is not large enough")
            rows = np.frombuffer(raw, np.uint8, size_h * stride, off).reshape(size_h, stride)
            img = _pil_unpack(rows, rawmode, size_w)
            return _transpose(img, o)
    img = None
    for x0, y0, x1, y1, off, stride, layer in sorted(tiles, key=lambda t: t[4]):
        tw, th = x1 - x0, y1 - y0
        if tw <= 0 or th <= 0 or x1 > w_img or y1 > h_img:
            raise Refused("tile cannot extend outside image")
        rowbytes = (bits * tw + 7) // 8
        step = stride if stride > 0 else rowbytes
        need = (th - 1) * step + rowbytes
        if off + need > len(raw):
            raise Refused("image file is truncated")
        rows = np.lib.stride_tricks.as_strided(
            np.frombuffer(raw, np.uint8, need, off), (th, rowbytes), (step, 1)).copy()
        if planar == 2:
            if img is None:
                img = np.zeros((h_img, w_img, 4), np.uint8)
            img[y0:y1, x0:x1, mode.index(rawmode[layer])] = rows[:, :tw]
            continue
        part = _pil_unpack(rows, rawmode, tw)
        if img is None:
            img = np.zeros((h_img, w_img) + part.shape[2:], part.dtype)
        img[y0:y1, x0:x1] = part
    if planar == 2:
        k = {"RGB": 3, "RGBA": 4, "CMYK": 4, "LA": 2, "PA": 2}.get(mode, 1)
        img = img[..., :k] if k > 1 else img[..., 0]
    return _transpose(img, o)


def _pil_libtiff(d: Directory, raw: bytes, mode: str, rawmode: str):
    """PIL's libtiff decoder: every strip or tile must decode."""
    lay = _libtiff_layout(Directory(raw))
    if lay.photometric == 6 and not (lay.compression == 7 and not lay.separate):
        # PIL reads these through libtiff's RGBA conversion
        raise NotYet("YCbCr TIFF that cv2 refuses")
    buf, offs, status = decode_chunks(lay, raw)
    if (status != 0).any():
        raise Refused("decoder error")
    bands = {"LA": 2, "PA": 2, "RGB": 3, "RGBA": 4, "CMYK": 4}.get(mode, 1)
    if lay.separate and bands > 1:
        if bands != lay.spp and not lay.tiled:
            raise Refused("planar strips whose samples are not the mode's bands")
        # each of the mode's bands from its plane: 8-bit samples, or the
        # high byte of 16-bit ones (TiffDecode.c's "R" / "R;16N" unpackers)
        if lay.bits not in (8, 16):
            raise Refused("planar samples of neither 8 nor 16 bits")
        k = bands
        img = np.zeros((lay.height, lay.width, 4), np.uint8)
        for band in range(k):
            plane = assemble(lay, buf, offs, band)[..., 0]
            img[..., band] = plane >> 8 if lay.bits == 16 else plane
        if rawmode.startswith("RGBa"):
            img = _pil_unpack(img.reshape(lay.height, -1), "RGBa", lay.width)
        return _transpose(img[..., :k], lay.orientation)
    if lay.separate:
        raise Refused("planar data of a one-band mode")
    # libtiff gives host-order (little-endian) samples: PIL's "N" raw modes
    native_modes = {"I;16N": "I;16", "RGB;16N": "RGB;16L", "RGBA;16N": "RGBA;16L",
                    "RGBX;16N": "RGBX;16L", "RGBa;16N": "RGBa;16L", "CMYK;16N": "CMYK;16L"}
    rawmode = native_modes.get(rawmode, rawmode)
    if lay.tiled:
        img = None
        for t in range(lay.across * lay.down):
            ty, tx = divmod(t, lay.across)
            rows = buf[offs[t]:offs[t] + lay.tile_h * lay.row_bytes].reshape(lay.tile_h,
                                                                          lay.row_bytes)
            part = _pil_unpack(rows, rawmode, lay.tile_w)
            if img is None:
                img = np.zeros((lay.down * lay.tile_h, lay.across * lay.tile_w) + part.shape[2:],
                               part.dtype)
            img[ty * lay.tile_h:(ty + 1) * lay.tile_h, tx * lay.tile_w:(tx + 1) * lay.tile_w] = part
        img = img[:lay.height, :lay.width]
    else:
        rows = buf[:lay.height * lay.row_bytes].reshape(lay.height, lay.row_bytes)
        img = _pil_unpack(rows, rawmode, lay.width)
    return _transpose(img, lay.orientation)


# ---- the reader -----------------------------------------------------------------

def decode_gray(raw: bytes, path="<bytes>") -> np.ndarray:
    """Decode TIFF bytes to (H, W) uint8 gray (see the module docstring)."""
    try:
        return cv2_read(raw)
    except NotYet as e:
        _fail(path, f"TIFF variant not yet read by the port: {e}")
    except limits.TooLarge as e:
        _fail(path, str(e))
    except Refused as e:
        why = str(e)
    try:
        return pil_read(raw)
    except NotYet as e:
        _fail(path, f"TIFF variant not yet read by the port: {e}")
    except Refused as e:
        _fail(path, f"unreadable TIFF (as cv2 reads it: {why}; as PIL reads it: {e})")


def load_grayscale(path) -> np.ndarray:
    with open(path, "rb") as f:
        raw = f.read()
    return decode_gray(raw, str(path))

"""A baseline JPEG encoder, a DICOM writer and synthetic CheXpert, hip X-ray
and CBIS-DDSM trees, numpy only, for the port's CPU tests and for
``chip_smoke.py`` (pytest does not collect this module).

`encode_jpeg` writes sequential Huffman JPEGs with the standard tables
(ITU T.81 Annex K) at an IJG quality: gray, or YCbCr at 4:4:4, 4:2:2 or
4:2:0, interleaved, with an optional restart interval.  It returns the
pixels that libjpeg's islow IDCT gives its luma coefficients
(`idct_islow`), which is what ``cv2.imread(..., IMREAD_GRAYSCALE)`` reads.
`encode_dicom` writes a DICOM file in implicit or explicit VR little
endian, with sequences of undefined and defined length (an icon image with
its own Rows, Columns and Pixel Data among them) before the pixels.

The trees follow the datasets' layouts: CheXpert-v1.0-small's
``train/patientNNNNN/studyK/viewJ_{frontal,lateral}.jpg`` and its CSV; the
hip X-ray folder of ``NNN AP.jpg`` / ``NNN Lateral.jpg`` and its table;
CBIS-DDSM's DICOM folders, ``metadata.csv`` and the mass and calcification
case CSVs.  Each carries the quirks its loader must keep (see each
writer).
"""

from __future__ import annotations

import os
import struct

import numpy as np

from torch_mura_tree import encode_png, xray_like

# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

ZIGZAG = np.array(
    [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27,
     20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58,
     59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# Annex K's tables (natural order), scaled by the IJG quality rule
LUMA_Q = np.array(
    [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69,
     56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104,
     113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_Q = np.full(64, 99)
CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = \
    [17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]
# Annex K's Huffman tables: 16 code counts, then the symbols
HUFFMAN = {
    "dc_luma": ("00010501010101010100000000000000", "000102030405060708090a0b"),
    "dc_chroma": ("00030101010101010101010000000000", "000102030405060708090a0b"),
    "ac_luma": (
        "0002010303020403050504040000017d",
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a16171819"
        "1a25262728292a3435363738393a434445464748494a535455565758595a636465666768696a7374757677"
        "78797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
        "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"),
    "ac_chroma": (
        "00020102040403040705040400010277",
        "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f1"
        "1718191a262728292a35363738393a434445464748494a535455565758595a636465666768696a73747576"
        "7778797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4"
        "c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")}
SAMPLING = {"444": (1, 1), "422": (2, 1), "420": (2, 2)}   # luma (h, v); chroma 1 x 1


def quant_table(quality: int, base: np.ndarray) -> np.ndarray:
    """IJG's ``jpeg_quality_scaling`` of an Annex K table, baseline-clamped
    to 1-255 (natural order)."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def _codes(name):
    """{symbol: (code, length)} of a canonical Huffman table."""
    counts, vals = (bytes.fromhex(h) for h in HUFFMAN[name])
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


def _lookup(name, size):
    table = _codes(name)
    code, length = np.zeros(size, np.int64), np.zeros(size, np.int64)
    for sym, (c, n) in table.items():
        code[sym], length[sym] = c, n
    return code, length


def _fdct_matrix():
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    c = np.cos((2 * x + 1) * u * np.pi / 16) / 2
    c[0] /= np.sqrt(2)
    return c


def idct_islow(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """libjpeg's ``jpeg_idct_islow`` (jidctint.c) of (N, 8, 8) quantised
    coefficients (natural order) with the table ``q`` (natural order):
    (N, 8, 8) uint8."""
    fix = dict(a=2446, b=3196, c=4433, d=6270, e=7373, f=9633, g=12299, h=15137, i=16069,
               j=16819, k=20995, l=25172)

    def one_pass(v, axis):
        i = [np.take(v, k, axis=axis) for k in range(8)]
        z1 = (i[2] + i[6]) * fix["c"]
        t2, t3 = z1 - i[6] * fix["h"], z1 + i[2] * fix["d"]
        t0, t1 = (i[0] + i[4]) * 8192, (i[0] - i[4]) * 8192
        e10, e13, e11, e12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
        o0, o1, o2, o3 = i[7], i[5], i[3], i[1]
        z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
        z5 = (z3 + z4) * fix["f"]
        o0, o1, o2, o3 = o0 * fix["a"], o1 * fix["j"], o2 * fix["l"], o3 * fix["g"]
        z1, z2 = z1 * -fix["e"], z2 * -fix["k"]
        z3, z4 = z3 * -fix["i"] + z5, z4 * -fix["b"] + z5
        o0, o1, o2, o3 = o0 + z1 + z3, o1 + z2 + z4, o2 + z2 + z3, o3 + z1 + z4
        return [e10 + o3, e11 + o2, e12 + o1, e13 + o0, e13 - o0, e12 - o1, e11 - o2, e10 - o3]

    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    deq = coef.astype(np.int64) * q.reshape(8, 8)
    ws = np.stack([descale(v, 11) for v in one_pass(deq, 1)], axis=1)      # columns
    out = np.stack([descale(v, 18) for v in one_pass(ws, 2)], axis=2)      # rows
    x = (out & 1023)
    x = np.where(x < 512, x, x - 1024) + 128
    return np.clip(x, 0, 255).astype(np.uint8)


def _blocks(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """(rows, cols, 8, 8) blocks of ``plane`` padded by edge replication."""
    h, w = plane.shape
    padded = np.pad(plane, ((0, rows * 8 - h), (0, cols * 8 - w)), mode="edge")
    return padded.reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3)


def _segment(bits: np.ndarray, lengths: np.ndarray) -> bytes:
    """The bit string of (value, length) pairs, padded with ones to a byte,
    with 0xFF bytes stuffed."""
    total = int(lengths.sum())
    pad = -total % 8
    values = np.append(bits, (1 << pad) - 1)
    lengths = np.append(lengths, pad)
    starts = np.cumsum(lengths) - lengths
    out = np.zeros(total + pad, np.uint8)
    for b in range(int(lengths.max(initial=0))):
        m = lengths > b
        out[starts[m] + b] = (values[m] >> (lengths[m] - 1 - b)) & 1
    return np.packbits(out).tobytes().replace(b"\xff", b"\xff\x00")


def _category(v):
    return np.where(v == 0, 0, np.floor(np.log2(np.maximum(np.abs(v), 1))).astype(np.int64) + 1)


def _marker(code: int, body: bytes) -> bytes:
    return bytes([0xFF, code]) + struct.pack(">H", len(body) + 2) + body


def encode_jpeg(y: np.ndarray, quality: int = 90, sampling=None, restart: int = 0,
                chroma_seed: int = 0):
    """(JPEG bytes, the gray image libjpeg decodes from them) of the (H, W)
    uint8 luma plane ``y``: gray with ``sampling`` None, else YCbCr at
    "444", "422" or "420" with chroma planes of a smooth pattern;
    ``restart`` MCUs a restart interval (0: none)."""
    y = np.asarray(y, np.uint8)
    h, w = y.shape
    hy, vy = SAMPLING[sampling] if sampling else (1, 1)
    mcus_x, mcus_y = -(-w // (8 * hy)), -(-h // (8 * vy))
    fdct = _fdct_matrix()
    planes = [(y, hy, vy, quant_table(quality, LUMA_Q), "luma")]
    if sampling:
        rng = np.random.default_rng(chroma_seed)
        ch, cw = -(-h // vy), -(-w // hy)
        yy, xx = np.mgrid[0:ch, 0:cw]
        for _ in range(2):
            a, b = rng.uniform(0.01, 0.1, 2)
            c = 128 + 40 * np.sin(a * yy) * np.cos(b * xx)
            planes.append((c.astype(np.uint8), 1, 1, quant_table(quality, CHROMA_Q), "chroma"))
    coefs = []
    for plane, ph, pv, q, _ in planes:
        blk = _blocks(plane.astype(np.float64) - 128, mcus_y * pv, mcus_x * ph)
        dct = fdct @ blk @ fdct.T
        coefs.append(np.clip(np.rint(dct / q.reshape(8, 8)), -1023, 1023).astype(np.int64))
    # blocks in scan order: per MCU, each component's v x h blocks in raster order
    order, comp_of = [], []
    for c, (_, ph, pv, _, _) in enumerate(planes):
        by = np.arange(mcus_y)[:, None, None, None] * pv + np.arange(pv)[None, None, :, None]
        bx = np.arange(mcus_x)[None, :, None, None] * ph + np.arange(ph)[None, None, None, :]
        by, bx = np.broadcast_arrays(by, bx)
        order.append((c, by.reshape(mcus_y * mcus_x, -1), bx.reshape(mcus_y * mcus_x, -1)))
    zz, comps = [], []
    for c, by, bx in order:
        zz.append(coefs[c][by, bx])                       # (MCUs, blocks, 8, 8)
        comps += [c] * by.shape[1]
    n_mcu = mcus_x * mcus_y
    zz = np.concatenate(zz, axis=1).reshape(-1, 64)[:, ZIGZAG]
    comps = np.tile(comps, n_mcu)
    mcu = np.repeat(np.arange(n_mcu), len(comps) // n_mcu)
    segment = mcu // restart if restart else np.zeros_like(mcu)
    # DC differences per component, reset at each restart
    dc = zz[:, 0]
    diff = np.empty_like(dc)
    for c in range(len(planes)):
        idx = np.flatnonzero(comps == c)
        prev = np.concatenate([[0], dc[idx][:-1]])
        first = np.concatenate([[True], segment[idx][1:] != segment[idx][:-1]])
        diff[idx] = dc[idx] - np.where(first, 0, prev)
    tables = [("dc_luma", "ac_luma"), ("dc_chroma", "ac_chroma")]
    dc_codes = [_lookup(t[0], 12) for t in tables]
    ac_codes = [_lookup(t[1], 256) for t in tables]
    is_chroma = (comps > 0).astype(int)
    # events: (block, slot, code value, length); DC at slot 0, the AC run at
    # 4 p + k (k < 3: ZRLs before position p), EOB at slot 300
    cat = _category(diff)
    extra = np.where(diff < 0, diff + (1 << cat) - 1, diff)
    ev_block = [np.arange(len(zz))]
    ev_slot = [np.zeros(len(zz), np.int64)]
    dcc = np.where(is_chroma, dc_codes[1][0][cat], dc_codes[0][0][cat])
    dcl = np.where(is_chroma, dc_codes[1][1][cat], dc_codes[0][1][cat])
    ev_val = [(dcc << cat) | extra]
    ev_len = [dcl + cat]
    blk, pos = np.nonzero(zz[:, 1:])
    pos = pos + 1
    prev = np.concatenate([[0], pos[:-1]])
    prev[np.concatenate([[True], blk[1:] != blk[:-1]])] = 0
    run = pos - prev - 1
    v = zz[blk, pos]
    cat = _category(v)
    extra = np.where(v < 0, v + (1 << cat) - 1, v)
    chroma = is_chroma[blk].astype(bool)
    sym = (run % 16) * 16 + cat
    acc = np.where(chroma, ac_codes[1][0][sym], ac_codes[0][0][sym])
    acl = np.where(chroma, ac_codes[1][1][sym], ac_codes[0][1][sym])
    ev_block.append(blk)
    ev_slot.append(4 * pos + 3)
    ev_val.append((acc << cat) | extra)
    ev_len.append(acl + cat)
    for k in range(3):                                       # ZRL (0xF0) before long runs
        z = run // 16 > k
        zc = np.where(chroma[z], ac_codes[1][0][0xF0], ac_codes[0][0][0xF0])
        zl = np.where(chroma[z], ac_codes[1][1][0xF0], ac_codes[0][1][0xF0])
        ev_block.append(blk[z])
        ev_slot.append(4 * pos[z] + k)
        ev_val.append(zc)
        ev_len.append(zl)
    last = np.zeros(len(zz), np.int64)
    np.maximum.at(last, blk, pos)
    eob = np.flatnonzero(last < 63)
    ev_block.append(eob)
    ev_slot.append(np.full(len(eob), 300))
    ev_val.append(np.where(is_chroma[eob], ac_codes[1][0][0], ac_codes[0][0][0]))
    ev_len.append(np.where(is_chroma[eob], ac_codes[1][1][0], ac_codes[0][1][0]))
    eb, es, evv, evl = (np.concatenate(a) for a in (ev_block, ev_slot, ev_val, ev_len))
    order_ = np.lexsort((es, eb))
    eb, evv, evl = eb[order_], evv[order_], evl[order_]
    seg_of = segment[eb]
    bounds = np.flatnonzero(np.diff(seg_of)) + 1
    scan = b""
    for i, (a, b) in enumerate(zip(np.r_[0, bounds], np.r_[bounds, len(eb)])):
        if i:
            scan += bytes([0xFF, 0xD0 + (i - 1) % 8])
        scan += _segment(evv[a:b], evl[a:b])
    # headers
    out = b"\xff\xd8" + _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    qts = [planes[0][3]] + ([planes[1][3]] if sampling else [])
    for t, q in enumerate(qts):
        out += _marker(0xDB, bytes([t]) + bytes(q[ZIGZAG].astype(np.uint8)))
    sof = struct.pack(">BHHB", 8, h, w, len(planes))
    for c, (_, ph, pv, _, _) in enumerate(planes):
        sof += bytes([c + 1, ph * 16 + pv, min(c, 1)])
    out += _marker(0xC0, sof)
    for t, (dcn, acn) in enumerate(tables[:1 + bool(sampling)]):
        for kind, name in ((0, dcn), (1, acn)):
            counts, vals = (bytes.fromhex(x) for x in HUFFMAN[name])
            out += _marker(0xC4, bytes([kind * 16 + t]) + counts + vals)
    if restart:
        out += _marker(0xDD, struct.pack(">H", restart))
    sos = bytes([len(planes)]) + b"".join(bytes([c + 1, min(c, 1) * 17])
                                          for c in range(len(planes))) + b"\x00\x3f\x00"
    out += _marker(0xDA, sos) + scan + b"\xff\xd9"
    # what libjpeg reconstructs of the luma component
    yq = coefs[0].reshape(-1, 64)
    pix = idct_islow(yq.reshape(-1, 8, 8), planes[0][3]).reshape(mcus_y * vy, mcus_x * hy, 8, 8)
    gray = pix.transpose(0, 2, 1, 3).reshape(mcus_y * vy * 8, mcus_x * hy * 8)[:h, :w]
    return out, np.ascontiguousarray(gray)


def exif_app1(orientation: int, big_endian: bool = False) -> bytes:
    """An APP1 ``Exif`` segment whose IFD0 holds only ``Orientation``."""
    o = ">" if big_endian else "<"
    tiff = (b"MM" if big_endian else b"II") + struct.pack(o + "HI", 42, 8)
    tiff += struct.pack(o + "H", 1) + struct.pack(o + "HHIHH", 0x0112, 3, 1, orientation, 0)
    tiff += struct.pack(o + "I", 0)
    return _marker(0xE1, b"Exif\x00\x00" + tiff)


def with_segment(raw: bytes, segment: bytes) -> bytes:
    """JPEG bytes with ``segment`` spliced in right after SOI."""
    return raw[:2] + segment + raw[2:]


# ---------------------------------------------------------------------------
# DICOM
# ---------------------------------------------------------------------------

IMPLICIT_LE, EXPLICIT_LE = "1.2.840.10008.1.2", "1.2.840.10008.1.2.1"
LONG_VRS = {"OB", "OD", "OF", "OL", "OV", "OW", "SQ", "SV", "UC", "UN", "UR", "UT", "UV"}


def _element(group, elem, vr, value: bytes, explicit: bool, undefined: bool = False) -> bytes:
    if len(value) % 2:
        value += b"\x00" if vr in ("UI", "OB", "UN") else b" "
    length = 0xFFFFFFFF if undefined else len(value)
    head = struct.pack("<HH", group, elem)
    if not explicit or group == 0xFFFE:
        return head + struct.pack("<I", length) + value
    if vr in LONG_VRS:
        return head + vr.encode() + b"\x00\x00" + struct.pack("<I", length) + value
    return head + vr.encode() + struct.pack("<H", length) + value


def _us(group, elem, v, explicit):
    return _element(group, elem, "US", struct.pack("<H", v), explicit)


def encode_dicom(pixels: np.ndarray, explicit: bool = True, bits_stored=None, signed=None,
                 syntax=None, sequences: bool = True, encapsulated: bool = False,
                 samples: int = 1, frames=None) -> bytes:
    """A single-frame MONOCHROME2 DICOM of ``pixels`` ((H, W) uint8, int8,
    uint16 or int16; stored as given, so signed values past ``bits_stored``
    keep their high bits).  ``sequences``: before the pixels, a sequence of
    undefined length holding an item of undefined length (with a nested
    sequence) and one of defined length, then an icon image sequence whose
    item has its own Rows, Columns and Pixel Data.  ``signed`` overrides
    Pixel Representation (default: the dtype's), ``samples`` Samples per
    Pixel, ``frames`` adds Number of Frames; ``syntax`` overrides the
    transfer syntax UID in the meta; ``encapsulated`` writes the pixel data
    with undefined length as compressed data is."""
    px = np.ascontiguousarray(pixels)
    bits = px.dtype.itemsize * 8
    signed = px.dtype.kind == "i" if signed is None else signed
    syntax = syntax or (EXPLICIT_LE if explicit else IMPLICIT_LE)
    meta = b"".join([
        _element(0x0002, 0x0001, "OB", b"\x00\x01", True),
        _element(0x0002, 0x0002, "UI", b"1.2.840.10008.5.1.4.1.1.1.2", True),
        _element(0x0002, 0x0003, "UI", b"1.2.3.4.5.6.7", True),
        _element(0x0002, 0x0010, "UI", syntax.encode(), True),
        _element(0x0002, 0x0012, "UI", b"1.2.3.4", True)])
    meta = _element(0x0002, 0x0000, "UL", struct.pack("<I", len(meta)), True) + meta
    e = explicit
    ds = _element(0x0008, 0x0016, "UI", b"1.2.840.10008.5.1.4.1.1.1.2", e)
    ds += _element(0x0008, 0x0060, "CS", b"MG", e)
    if sequences:
        inner = _element(0x0008, 0x1150, "UI", b"1.2.3", e)
        nested = (_element(0x0040, 0xA730, "SQ", b"", e, undefined=True)
                  + _element(0xFFFE, 0xE000, None, b"", e, undefined=True)
                  + _element(0x0040, 0xA160, "UT", b"0028,0010 7FE0,0010", e)
                  + _element(0xFFFE, 0xE00D, None, b"", e)
                  + _element(0xFFFE, 0xE0DD, None, b"", e))
        ds += _element(0x0008, 0x1115, "SQ", b"", e, undefined=True)
        ds += _element(0xFFFE, 0xE000, None, b"", e, undefined=True) + inner + nested
        ds += _element(0xFFFE, 0xE00D, None, b"", e)
        ds += _element(0xFFFE, 0xE000, None, inner, e)
        ds += _element(0xFFFE, 0xE0DD, None, b"", e)
    ds += _element(0x0010, 0x0020, "LO", b"P_00001", e)
    ds += _us(0x0028, 0x0002, samples, e)
    ds += _element(0x0028, 0x0004, "CS", b"MONOCHROME2", e)
    if frames is not None:
        ds += _element(0x0028, 0x0008, "IS", str(frames).encode(), e)
    ds += _us(0x0028, 0x0010, px.shape[0], e) + _us(0x0028, 0x0011, px.shape[1], e)
    ds += _us(0x0028, 0x0100, bits, e) + _us(0x0028, 0x0101, bits_stored or bits, e)
    ds += _us(0x0028, 0x0102, (bits_stored or bits) - 1, e) + _us(0x0028, 0x0103, int(signed), e)
    if sequences:
        icon = (_us(0x0028, 0x0010, 2, e) + _us(0x0028, 0x0011, 3, e)
                + _us(0x0028, 0x0100, 8, e) + _element(0x7FE0, 0x0010, "OB", bytes(6), e))
        ds += _element(0x0088, 0x0200, "SQ", b"", e, undefined=True)
        ds += _element(0xFFFE, 0xE000, None, icon, e) + _element(0xFFFE, 0xE0DD, None, b"", e)
    data = px.astype(px.dtype.newbyteorder("<")).tobytes()
    if encapsulated:
        ds += _element(0x7FE0, 0x0010, "OB", b"", e, undefined=True)
        ds += _element(0xFFFE, 0xE000, None, b"", e) + _element(0xFFFE, 0xE000, None, data, e)
        ds += _element(0xFFFE, 0xE0DD, None, b"", e)
    else:
        ds += _element(0x7FE0, 0x0010, "OW" if bits == 16 else "OB", data, e)
    return b"\x00" * 128 + b"DICM" + meta + ds


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

CHEXPERT_CSV_LABELS = (
    "No Finding", "Enlarged Cardiomediastinum", "Cardiomegaly", "Lung Opacity", "Lung Lesion",
    "Edema", "Consolidation", "Pneumonia", "Atelectasis", "Pneumothorax", "Pleural Effusion",
    "Pleural Other", "Fracture", "Support Devices")


def _write(path: str, raw: bytes) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(raw)


def _csv(path: str, header, rows) -> None:
    with open(path, "w") as f:
        f.write(",".join(header) + "\n")
        for r in rows:
            f.write(",".join(str(v) for v in r) + "\n")


def _pooled(pool: dict, key, make):
    """``make()``, or with a ``key`` (not None) the result first made under
    it: a tree of ``distinct`` images written many times over costs the
    encoding of ``distinct``."""
    if key is None:
        return make()
    if key not in pool:
        pool[key] = make()
    return pool[key]


def write_chexpert_tree(root: str, n_patients: int = 24, size=(390, 320), quality: int = 90,
                        sampling=None, restart: int = 0, quirks: bool = True,
                        drop_columns=(), view_column: bool = True, distinct: int = 0,
                        seed: int = 0):
    """CheXpert-v1.0-small under ``root``: ``n_patients`` patients of one or
    two studies, each a frontal and a lateral JPEG of about ``size`` (H, W)
    (heights and widths drawn within 15 % of it), and ``train.csv`` with the
    dataset's columns (``Path``, ``Sex``, ``Age``, ``Frontal/Lateral``,
    ``AP/PA``, the 14 labels).  Labels are 1, 0, -1 or empty.  With
    ``quirks``: a study with a frontal view only, a second frontal before
    the lateral in another, a study's rows listed out of order, one path
    written with backslashes, one row whose path has no study part, and one
    image as PNG bytes under its ``.jpg`` name.  ``drop_columns`` leaves
    those columns out; ``view_column=False`` leaves out ``Frontal/Lateral``
    (the loader derives it from the file name).  With ``distinct`` above 0
    only that many JPEGs are made, and the k-th image repeats the (k mod
    ``distinct``)-th.  Returns (the CSV path, the image paths written)."""
    rng = np.random.default_rng(seed)
    pool = {}
    header = ["Path", "Sex", "Age"] + (["Frontal/Lateral"] if view_column else []) + \
        ["AP/PA"] + [c for c in CHEXPERT_CSV_LABELS if c not in drop_columns]
    rows, images = [], []
    k = 0
    for p in range(n_patients):
        for s in range(1 + (p % 3 == 0)):
            study = f"CheXpert-v1.0-small/train/patient{p + 1:05d}/study{s + 1}"
            views = ["frontal", "lateral"]
            if quirks and p == 1:
                views = ["frontal"]
            if quirks and p == 2:
                views = ["frontal", "frontal", "lateral"]
            labels = rng.choice(["1.0", "0.0", "-1.0", ""], size=len(CHEXPERT_CSV_LABELS),
                                p=[0.3, 0.3, 0.15, 0.25])
            study_rows = []
            for j, view in enumerate(views):
                rel = f"{study}/view{j + 1}_{view}.jpg"
                h = int(size[0] * rng.uniform(0.85, 1.15))
                w = int(size[1] * rng.uniform(0.85, 1.15))
                k += 1
                if quirks and k == 5:
                    raw = encode_png(xray_like(rng, h, w), 0, 8)
                else:
                    raw = _pooled(pool, k % distinct if distinct else None,
                                  lambda: encode_jpeg(xray_like(rng, h, w), quality, sampling,
                                                      restart)[0])
                _write(os.path.join(root, rel), raw)
                images.append(os.path.join(root, rel))
                path = rel.replace("/", "\\") if quirks and k == 7 else rel
                row = [path, "Female" if p % 2 else "Male", 40 + p]
                if view_column:
                    row.append(view.capitalize())
                row.append("AP" if view == "frontal" else "")
                row += [lab for c, lab in zip(CHEXPERT_CSV_LABELS, labels)
                        if c not in drop_columns]
                study_rows.append(row)
            if quirks and p == 4:
                study_rows = study_rows[::-1]
            rows += study_rows
    if quirks:
        rows.append(["lonely.jpg", "Male", 50] + (["Frontal"] if view_column else []) +
                    ["AP"] + ["1.0"] * (len(CHEXPERT_CSV_LABELS) - len(drop_columns)))
    csv_path = os.path.join(root, "train.csv")
    _csv(csv_path, header, rows)
    return csv_path, images


def write_hip_tree(root: str, n: int = 24, size=(512, 400), quality: int = 90, sampling=None,
                   quirks: bool = True, distinct: int = 0, seed: int = 0):
    """A hip X-ray folder under ``root``: ``images/NNN AP.jpg`` and
    ``images/NNN Lateral.jpg`` for image numbers 1..n, and ``hip.csv`` with
    ``Image_no`` (integers, zero-padded to 3 digits in the file names),
    ``Admission_Date``, ``Fracture_Classification`` and
    ``Final_Classification`` (three classes).  With ``quirks``: rows marked
    "Exclude" (in two spellings), an empty ``Final_Classification``, an
    empty ``Fracture_Classification`` (kept), and a row whose images are
    missing.  With ``distinct`` above 0 only that many JPEGs are made for
    each view, which the image numbers repeat in turn.  Returns (the images
    folder, the CSV path)."""
    rng = np.random.default_rng(seed)
    pool = {}
    images = os.path.join(root, "images")
    classes = ["Intertrochanteric", "Neck of femur", "Normal"]
    rows = []
    for i in range(1, n + 1):
        frac = ["A1", "B2", "C3"][i % 3]
        final = classes[i % 3]
        if quirks and i == 3:
            frac = "Exclude"
        if quirks and i == 5:
            frac = "EXCLUDE"
        if quirks and i == 7:
            final = ""
        if quirks and i == 8:
            frac = ""
        if not (quirks and i == 9):
            for view in ("AP", "Lateral"):
                h = int(size[0] * rng.uniform(0.85, 1.15))
                w = int(size[1] * rng.uniform(0.85, 1.15))
                _write(os.path.join(images, f"{i:03d} {view}.jpg"),
                       _pooled(pool, (i % distinct, view) if distinct else None,
                               lambda: encode_jpeg(xray_like(rng, h, w), quality, sampling)[0]))
        rows.append([i, f"2019-0{1 + i % 9}-1{i % 10}", frac, final])
    csv_path = os.path.join(root, "hip.csv")
    _csv(csv_path, ["Image_no", "Admission_Date", "Fracture_Classification",
                    "Final_Classification"], rows)
    return images, csv_path


def mammogram(rng, h: int, w: int, side: str):
    """A synthetic 16-bit mammogram: a bright half-ellipse against the
    ``side`` edge on a dark background with noise, and an ROI mask (uint8
    0/255) of one lesion inside it."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    x0 = 0 if side == "LEFT" else w - 1
    r = ((xx - x0) / (0.6 * w)) ** 2 + ((yy - h / 2) / (0.45 * h)) ** 2
    breast = r < 1
    img = np.where(breast, 20000 + 20000 * (1 - r), 0) + rng.normal(0, 300, (h, w))
    img[~breast] = 0
    cy = int(h * rng.uniform(0.35, 0.65))
    cx = int(w * (0.2 if side == "LEFT" else 0.8))
    rad = max(2, int(min(h, w) * 0.05))
    mask = ((yy - cy) ** 2 + (xx - cx) ** 2 < rad ** 2).astype(np.uint8) * 255
    img[mask > 0] += 8000
    return np.clip(img, 0, 65535).astype(np.uint16), mask


def write_ddsm_tree(root: str, n_patients: int = 10, size=(640, 400), npy: bool = False,
                    implicit_every: int = 3, mask_size_every: int = 4, distinct: int = 0,
                    seed: int = 0):
    """CBIS-DDSM under ``root``: for each patient one breast (sides in turn)
    with a CC and an MLO view, a mammogram and an ROI mask each, as DICOM
    files ``CBIS-DDSM/<series folder>/1-1.dcm`` (16-bit images, 8-bit
    masks; every ``implicit_every``-th in implicit VR; every
    ``mask_size_every``-th mask at another size, which the loader resizes),
    ``metadata.csv`` (Series UID, File Location, Number of Images) and the
    mass and calcification case CSVs (abnormality types and the three
    pathologies in turn).  ``npy`` also writes each file's pixels as
    ``1-1.npy`` beside it (what the JAX package reads without pydicom).
    With ``distinct`` above 0 only that many mammograms are made for each
    side, which the patients' views repeat in turn.  Returns (the base
    folder, the metadata CSV, [the case CSVs])."""
    rng = np.random.default_rng(seed)
    pool = {}
    base = os.path.join(root, "CBIS-DDSM")
    meta = [("Series UID", "File Location", "Number of Images")]
    cases = {"mass": [], "calcification": []}
    pathologies = ("BENIGN", "MALIGNANT", "BENIGN_WITHOUT_CALLBACK")
    k = 0
    for p in range(n_patients):
        pid = f"P_{p + 1:05d}"
        side = ("LEFT", "RIGHT")[p % 2]
        abn = ("mass", "calcification")[(p // 2) % 2]
        kind = "Mass" if abn == "mass" else "Calc"
        for j, view in enumerate(("CC", "MLO")):
            h = int(size[0] * rng.uniform(0.9, 1.1))
            w = int(size[1] * rng.uniform(0.9, 1.1))
            img, mask = _pooled(pool, ((2 * (p // 2) + j) % distinct, side) if distinct else None,
                                lambda: mammogram(rng, h, w, side))
            if mask_size_every and k % mask_size_every == mask_size_every - 1:
                mask = np.ascontiguousarray(mask[::2, ::2])
            folder = f"{kind}-Training_{pid}_{side}_{view}"
            uids = []
            for part, px in (("full", img), ("roi", mask)):
                uid = f"1.3.6.1.4.1.9590.100.1.2.{p + 1}{k}{len(part)}"
                loc = f"./CBIS-DDSM/{folder}{'_1' if part == 'roi' else ''}/{uid}"
                k += 1
                path = os.path.join(root, loc, "1-1.dcm")
                _write(path, encode_dicom(px, explicit=k % implicit_every != 0))
                if npy:
                    np.save(os.path.join(root, loc, "1-1.npy"), px)
                meta.append((uid, loc, 1))
                uids.append(uid)
            cases[abn].append((pid, 3, side, view, 1, abn, pathologies[p % 3],
                               f"{folder}/1.3.6.1.4.1.9590/{uids[0]}/000000.dcm",
                               f"{folder}_1/1.3.6.1.4.1.9590/{uids[1]}/000001.dcm"))
    meta_csv = os.path.join(root, "metadata.csv")
    _csv(meta_csv, meta[0], meta[1:])
    header = ("patient_id", "breast_density", "left or right breast", "image view",
              "abnormality id", "abnormality type", "pathology", "image file path",
              "ROI mask file path")
    case_csvs = []
    for abn, rows in cases.items():
        path = os.path.join(root, f"{abn}_case_description_train_set.csv")
        _csv(path, header, rows)
        case_csvs.append(path)
    return root, meta_csv, case_csvs

"""JPEG decoding to 8-bit grayscale without PIL or cv2 (the machine with the
card has neither).

`decode_gray` gives what ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` gives,
which the JAX package's ``load_grayscale`` takes first: libjpeg's decode to
a gray output, which reconstructs the luma (first) component alone with
the "islow" integer IDCT and drops the chroma, then cv2's EXIF
``Orientation`` (APP1) applied to the result.  The markers are parsed here;
each scan's entropy decode, dequantisation and IDCT run in one native call
(`native.jpeg_scan`, C++ without the GIL).

Supported: sequential Huffman JPEGs (SOF0 baseline and SOF1 extended) at 8
bits, one component (gray) or three (YCbCr at any sampling, 4:4:4, 4:2:2,
4:2:0, ...) in interleaved or separate scans, restart intervals, any
Huffman tables, any width and height.  Anything else raises a
``ValueError`` naming the file and the format: progressive, lossless,
hierarchical or arithmetic-coded files, 12-bit samples, CMYK/YCCK (four
components), RGB (an Adobe marker with transform 0, or component ids
R, G, B), two components, luma sampled below a chroma component, a height
given by a DNL marker, and truncated or corrupt files (a file that ends
before its EOI marker counts as truncated).
"""

from __future__ import annotations

import struct

import numpy as np

from xfmamba_tpu_torch import native

SOI = b"\xff\xd8"
SEQUENTIAL = {0xC0: "baseline", 0xC1: "extended sequential"}
REFUSED_SOF = {
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical (differential sequential)",
    0xC6: "hierarchical (differential progressive)", 0xC7: "hierarchical (differential "
    "lossless)", 0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded hierarchical (differential "
    "sequential)", 0xCE: "arithmetic-coded hierarchical (differential progressive)",
    0xCF: "arithmetic-coded hierarchical (differential lossless)"}
DHT, DAC, DQT, DRI, SOS, EOI = 0xC4, 0xCC, 0xDB, 0xDD, 0xDA, 0xD9
APP0, APP1, APP14 = 0xE0, 0xE1, 0xEE
STANDALONE = set(range(0xD0, 0xD8)) | {0x01}      # RSTn and TEM carry no length
ORIENTATION_TAG = 0x0112

# zigzag index -> natural (row-major) index of an 8 x 8 block
ZIGZAG = np.array(
    [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27,
     20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58,
     59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


def _fail(path, what):
    raise ValueError(f"{path}: {what}")


def exif_orientation(body: bytes) -> int:
    """The ``Orientation`` tag (0x0112) of IFD0 in an APP1 ``Exif`` segment's
    body, or 1 where there is none or it is not 1-8."""
    if body[:6] != b"Exif\x00\x00" or len(body) < 14:
        return 1
    tiff = body[6:]
    order = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if order is None:
        return 1
    (ifd,) = struct.unpack(order + "I", tiff[4:8])
    if ifd + 2 > len(tiff):
        return 1
    (count,) = struct.unpack(order + "H", tiff[ifd:ifd + 2])
    for i in range(count):
        entry = tiff[ifd + 2 + 12 * i:ifd + 14 + 12 * i]
        if len(entry) < 12:
            break
        tag, kind, n = struct.unpack(order + "HHI", entry[:8])
        if tag == ORIENTATION_TAG and kind == 3 and n >= 1:
            (value,) = struct.unpack(order + "H", entry[8:10])
            return value if 1 <= value <= 8 else 1
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """cv2's ``ApplyExifOrientation``: 2 flips left-right, 3 rotates by
    180 degrees, 4 flips up-down, 5 transposes, 6-8 transpose then flip
    left-right, both ways, or up-down."""
    if orientation >= 5:
        img = img.T
    flip = {2: (slice(None), slice(None, None, -1)), 3: (slice(None, None, -1),) * 2,
            4: (slice(None, None, -1),), 6: (slice(None), slice(None, None, -1)),
            7: (slice(None, None, -1),) * 2, 8: (slice(None, None, -1),)}.get(orientation)
    return np.ascontiguousarray(img[flip] if flip else img)


def _next_marker(raw: bytes, pos: int):
    """(marker code, offset after it) of the first marker at or after
    ``pos``, skipping stray bytes, fill bytes and stuffed zeros as libjpeg
    does; (None, len) at the end of the data."""
    n = len(raw)
    while True:
        pos = raw.find(b"\xff", pos)
        if pos < 0:
            return None, n
        while pos + 1 < n and raw[pos + 1] == 0xFF:
            pos += 1
        if pos + 1 >= n:
            return None, n
        if raw[pos + 1] != 0:
            return raw[pos + 1], pos + 2
        pos += 2


def _colour_space(frame, jfif: bool, adobe):
    """The refusal for a frame that libjpeg would not read as gray or YCbCr
    (``jdapimin.c``'s rules), or None."""
    ids = [c[0] for c in frame["comps"]]
    if len(ids) == 1:
        return None
    if len(ids) == 4:
        return "CMYK/YCCK (four components)"
    if len(ids) != 3:
        return f"{len(ids)} components"
    if jfif:
        return None
    if adobe is not None:
        return "RGB (Adobe marker with transform 0)" if adobe == 0 else None
    if ids == [82, 71, 66]:
        return "RGB (component ids R, G, B)"
    return None


def decode_gray(raw: bytes, path="<bytes>") -> np.ndarray:
    """Decode JPEG bytes to (H, W) uint8 gray (see the module docstring)."""
    if raw[:2] != SOI:
        _fail(path, "not a JPEG file (no SOI marker)")
    data = np.frombuffer(raw, np.uint8)
    quant, tables = {}, np.zeros((8, 272), np.uint8)
    defined = np.zeros(8, bool)
    frame = plane = adobe = None
    jfif, restart, orientation, luma_done = False, 0, 1, False
    pos = 2
    while True:
        marker, pos = _next_marker(raw, pos)
        if marker is None:
            _fail(path, "truncated JPEG (the data ends before the EOI marker)")
        if marker == EOI:
            break
        if marker in STANDALONE:
            continue
        if pos + 2 > len(raw):
            _fail(path, "truncated JPEG (a marker segment is cut short)")
        (length,) = struct.unpack(">H", raw[pos:pos + 2])
        body = raw[pos + 2:pos + length]
        if length < 2 or len(body) != length - 2:
            _fail(path, f"truncated or corrupt JPEG (marker 0x{marker:02X} segment)")
        pos += length
        if marker in REFUSED_SOF:
            _fail(path, f"unsupported JPEG format: {REFUSED_SOF[marker]}")
        if marker == DAC:
            _fail(path, "unsupported JPEG format: arithmetic-coded (DAC marker)")
        if marker in SEQUENTIAL:
            if frame is not None:
                _fail(path, "corrupt JPEG (a second frame header)")
            frame = _frame(body, path, SEQUENTIAL[marker])
        elif marker == DHT:
            _huffman_tables(body, tables, defined, path)
        elif marker == DQT:
            _quant_tables(body, quant, path)
        elif marker == DRI:
            if len(body) < 2:
                _fail(path, "corrupt JPEG (DRI segment)")
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == APP0:
            jfif |= body[:5] == b"JFIF\x00"
        elif marker == APP1 and orientation == 1:
            orientation = exif_orientation(body)
        elif marker == APP14 and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif marker == SOS:
            if frame is None:
                _fail(path, "corrupt JPEG (a scan before the frame header)")
            if plane is None:
                refused = _colour_space(frame, jfif, adobe)
                if refused:
                    _fail(path, f"unsupported JPEG format: {refused}")
                plane = np.empty((frame["mcus_y"] * frame["vmax"] * 8,
                                  frame["mcus_x"] * frame["hmax"] * 8), np.uint8)
            pos, took_luma = _scan(body, data, pos, frame, tables, defined, quant, restart,
                                   plane, path)
            if took_luma and luma_done:
                _fail(path, "corrupt JPEG (two scans of the luma component)")
            luma_done |= took_luma
    if frame is None or not luma_done:
        _fail(path, "corrupt JPEG (no frame header or no scan of the luma component)")
    return apply_orientation(plane[:frame["height"], :frame["width"]], orientation)


def _frame(body, path, kind):
    if len(body) < 6:
        _fail(path, "corrupt JPEG (frame header)")
    precision, height, width, n = struct.unpack(">BHHB", body[:6])
    if precision != 8:
        _fail(path, f"unsupported JPEG format: {precision}-bit samples ({kind})")
    if height == 0:
        _fail(path, "unsupported JPEG format: height given by a DNL marker")
    if width == 0 or n == 0 or len(body) < 6 + 3 * n:
        _fail(path, "corrupt JPEG (frame header)")
    comps = [(body[6 + 3 * i], body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15, body[8 + 3 * i])
             for i in range(n)]
    if any(not (1 <= h <= 4 and 1 <= v <= 4) or t > 3 for _, h, v, t in comps):
        _fail(path, "corrupt JPEG (frame header sampling factors or table ids)")
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    if (comps[0][1], comps[0][2]) != (hmax, vmax):
        _fail(path, f"unsupported JPEG format: luma sampled {comps[0][1]}x{comps[0][2]} below "
                    f"the frame's {hmax}x{vmax}")
    return dict(height=height, width=width, comps=comps, hmax=hmax, vmax=vmax,
                mcus_x=-(-width // (8 * hmax)), mcus_y=-(-height // (8 * vmax)))


def _huffman_tables(body, tables, defined, path):
    i = 0
    while i < len(body):
        if i + 17 > len(body):
            _fail(path, "corrupt JPEG (DHT segment)")
        kind, slot = body[i] >> 4, body[i] & 15
        counts = body[i + 1:i + 17]
        n = sum(counts)
        if kind > 1 or slot > 3 or n > 256 or i + 17 + n > len(body):
            _fail(path, "corrupt JPEG (DHT segment)")
        t = 4 * kind + slot
        tables[t] = 0
        tables[t, :16] = np.frombuffer(counts, np.uint8)
        tables[t, 16:16 + n] = np.frombuffer(body[i + 17:i + 17 + n], np.uint8)
        defined[t] = True
        i += 17 + n


def _quant_tables(body, quant, path):
    i = 0
    while i < len(body):
        wide, slot = body[i] >> 4, body[i] & 15
        size = 128 if wide else 64
        if wide > 1 or slot > 3 or i + 1 + size > len(body):
            _fail(path, "corrupt JPEG (DQT segment)")
        values = np.frombuffer(body[i + 1:i + 1 + size], ">u2" if wide else np.uint8)
        table = np.empty(64, np.int32)
        table[ZIGZAG] = values
        quant[slot] = table
        i += 1 + size


def _scan(body, data, pos, frame, tables, defined, quant, restart, plane, path):
    """Decode the scan whose header is ``body`` and whose data starts at
    ``pos``; returns (offset of the next marker, whether it held the
    luma component)."""
    if not body or len(body) != 4 + 2 * body[0]:
        _fail(path, "corrupt JPEG (scan header)")
    n = body[0]
    ids = [c[0] for c in frame["comps"]]
    ss, se, approx = body[1 + 2 * n], body[2 + 2 * n], body[3 + 2 * n]
    if (ss, se, approx) != (0, 63, 0) or not 1 <= n <= 4:
        _fail(path, "corrupt JPEG (scan parameters of a sequential scan)")
    comps, target = [], -1
    for k in range(n):
        cid, sel = body[1 + 2 * k], body[2 + 2 * k]
        if cid not in ids:
            _fail(path, "corrupt JPEG (a scan of an undeclared component)")
        idx = ids.index(cid)
        dc, ac = sel >> 4, sel & 15
        if dc > 3 or ac > 3 or not (defined[dc] and defined[4 + ac]):
            _fail(path, "corrupt JPEG (a scan's Huffman table is not defined)")
        _, h, v, tq = frame["comps"][idx]
        comps.append((h, v, dc, ac))
        if idx == 0:
            target = k
            if tq not in quant:
                _fail(path, "corrupt JPEG (the luma quantisation table is not defined)")
    if n == 1:
        # a non-interleaved scan: the component's own blocks, MCU padding aside
        h, v = comps[0][:2]
        w = -(-frame["width"] * h // frame["hmax"])
        ht = -(-frame["height"] * v // frame["vmax"])
        mcus_x, mcus_y = -(-w // 8), -(-ht // 8)
    else:
        mcus_x, mcus_y = frame["mcus_x"], frame["mcus_y"]
    qt = quant[frame["comps"][0][3]] if target >= 0 else np.ones(64, np.int32)
    try:
        end = native.jpeg_scan(data, pos, np.array(comps, np.int32), tables, mcus_x, mcus_y,
                               restart, target, qt, plane)
    except ValueError as e:
        _fail(path, f"truncated or corrupt JPEG ({e})")
    return end, target >= 0


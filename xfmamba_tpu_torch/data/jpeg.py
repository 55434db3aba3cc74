"""JPEG decoding to 8-bit grayscale without PIL or cv2 (the machine with the
card has neither).

`decode_gray` gives what ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` gives,
which the JAX package's ``load_grayscale`` takes first: libjpeg-turbo's
decode to a gray output, then cv2's EXIF ``Orientation`` (APP1) applied to
the result.  The whole decode runs in one native call
(`native.jpeg_decode_gray`, ``native/jpeg_decode.cc``, C++ without the
GIL), which follows libjpeg-turbo module by module: sequential and
progressive, Huffman and arithmetic-coded files, lossless files (SOF3) at 2
to 8 bits, any Huffman tables (the standard ones where a file defines none),
DAC conditioning, restart intervals; gray, YCbCr (the luma, upsampled where
it is sampled below a chroma component), RGB (Adobe transform 0 or ids R, G,
B; libjpeg's RGB -> gray), CMYK and YCCK (four components; OpenCV's CMYK ->
gray) at any sampling libjpeg upsamples; block smoothing where a progressive
file leaves coefficients inexact; truncated and corrupt files read as libjpeg
reads them (the rest of a cut file from a fake EOI marker, zeros after a
marker inside a scan, a bad Huffman code as 0, lost restart markers
resynchronised).

Refused, with a ``ValueError`` naming the file and the format, exactly what
cv2 and PIL both refuse: 12-bit samples (baseline, extended sequential,
progressive or arithmetic-coded), lossless files at 9 to 16 bits,
arithmetic-coded lossless files (SOF11), hierarchical files (SOF5-7,
SOF13-15) and the JPG marker (SOF 0xC8), a height given by a DNL marker (a
frame height of 0), two or five and more components, a component the
output needs sampled at a fractional ratio of the frame's maximum, more than
ten blocks in an MCU, a file whose first three bytes are not SOI and a
marker, files cut or corrupt before their first scan (no frame header or no
scan, a bad table or segment length, an unknown marker), a progressive or
lossless scan whose Huffman table no segment defines, a multi-scan file
whose markers after a scan are corrupt, and a frame of more than 2^30
pixels (cv2 asserts there and PIL's bomb check refuses; the port refuses
before it allocates anything).
"""

from __future__ import annotations

import struct

import numpy as np

from xfmamba_tpu_torch import native
from xfmamba_tpu_torch.data import limits

SOI = b"\xff\xd8"
SIGNATURE = b"\xff\xd8\xff"          # what cv2 and PIL take for a JPEG file
SOS, EOI, APP1 = 0xDA, 0xD9, 0xE1
STANDALONE = set(range(0xD0, 0xD8)) | {0x01}      # RSTn and TEM carry no length
ORIENTATION_TAG = 0x0112


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


def orientation(raw: bytes) -> int:
    """The EXIF orientation that cv2 applies: the first APP1 ``Exif``
    segment before the first scan that gives one other than 1."""
    pos, value = 2, 1
    while value == 1:
        marker, pos = _next_marker(raw, pos)
        if marker is None or marker in (SOS, EOI):
            break
        if marker in STANDALONE:
            continue
        if pos + 2 > len(raw):
            break
        (length,) = struct.unpack(">H", raw[pos:pos + 2])
        if marker == APP1:
            value = exif_orientation(raw[pos + 2:pos + length])
        pos += length
    return value


def frame_size(raw: bytes):
    """(height, width) of the first frame header before the first scan, or
    None."""
    pos = 2
    while True:
        marker, pos = _next_marker(raw, pos)
        if marker is None or marker in (SOS, EOI):
            return None
        if marker in STANDALONE:
            continue
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if pos + 7 > len(raw):
                return None
            return struct.unpack(">HH", raw[pos + 3:pos + 7])
        if pos + 2 > len(raw):
            return None
        pos += struct.unpack(">H", raw[pos:pos + 2])[0]


def decode_gray(raw: bytes, path="<bytes>") -> np.ndarray:
    """Decode JPEG bytes to (H, W) uint8 gray (see the module docstring)."""
    if raw[:3] != SIGNATURE:
        _fail(path, "not a JPEG file (no SOI marker and marker after it)")
    size = frame_size(raw)
    if size and size[0] * size[1] > limits.CV2_MAX_PIXELS:
        # cv2 asserts (or refuses past 65,500 a side) and PIL's bomb check
        # refuses: the JAX reader raises; decoding would take gigabytes
        _fail(path, f"{size[1]} x {size[0]} pixels, past cv2's limit of 2^30")
    try:
        img = native.jpeg_decode_gray(raw)
    except ValueError as e:
        _fail(path, str(e))
    return apply_orientation(img, orientation(raw))

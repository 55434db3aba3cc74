"""DICOM pixel data without pydicom (the machine with the card has none), in
place of ``pydicom.dcmread(path).pixel_array`` for CBIS-DDSM's mammograms
and ROI masks.

`read_pixels` reads the 128-byte preamble and ``DICM``, the group-0002 file
meta in explicit VR little endian, then the data set in implicit VR little
endian (1.2.840.10008.1.2) or explicit VR little endian
(1.2.840.10008.1.2.1).  Sequences of defined or undefined length are
skipped whole, so the tags of nested items (an icon image's Rows or Pixel
Data) are never taken for the image's.  It returns the stored values
unchanged, (Rows, Columns) uint8 / int8 at Bits Allocated 8 and uint16 /
int16 at 16 by Pixel Representation: no rescale slope or intercept, no
MONOCHROME1 inversion, no masking of the unused high bits of unsigned
data; signed values are sign-extended from Bits Stored.

Anything else raises a ``ValueError`` naming the file and the format: a
file without ``DICM``, another transfer syntax (named by its UID: big
endian, deflated, and every compressed one), encapsulated pixel data,
Samples per Pixel other than 1, Bits Allocated other than 8 or 16, more
than one frame, no pixel data, and truncated or malformed files.
"""

from __future__ import annotations

import struct

import numpy as np

IMPLICIT_LE = "1.2.840.10008.1.2"
EXPLICIT_LE = "1.2.840.10008.1.2.1"
OTHER_SYNTAXES = {
    "1.2.840.10008.1.2.2": "explicit VR big endian",
    "1.2.840.10008.1.2.1.99": "deflated explicit VR little endian",
    "1.2.840.10008.1.2.5": "RLE lossless",
    "1.2.840.10008.1.2.4.50": "JPEG baseline", "1.2.840.10008.1.2.4.51": "JPEG extended",
    "1.2.840.10008.1.2.4.57": "JPEG lossless", "1.2.840.10008.1.2.4.70": "JPEG lossless SV1",
    "1.2.840.10008.1.2.4.80": "JPEG-LS lossless", "1.2.840.10008.1.2.4.81": "JPEG-LS near-lossless",
    "1.2.840.10008.1.2.4.90": "JPEG 2000 lossless", "1.2.840.10008.1.2.4.91": "JPEG 2000",
    "1.2.840.10008.1.2.4.201": "HTJ2K lossless", "1.2.840.10008.1.2.4.202": "HTJ2K lossless RPCL",
    "1.2.840.10008.1.2.4.203": "HTJ2K"}
# explicit VRs whose length is 4 bytes after 2 reserved ones (PS3.5 7.1.2)
LONG_VRS = {b"OB", b"OD", b"OF", b"OL", b"OV", b"OW", b"SQ", b"SV", b"UC", b"UN", b"UR", b"UT",
            b"UV"}
UNDEFINED = 0xFFFFFFFF
ITEM, ITEM_END, SEQUENCE_END = (0xFFFE, 0xE000), (0xFFFE, 0xE00D), (0xFFFE, 0xE0DD)
TRANSFER_SYNTAX = (0x0002, 0x0010)
PIXEL_DATA = (0x7FE0, 0x0010)
# the image pixel module's tags that the reader takes (all US but the frame count)
SAMPLES, ROWS, COLUMNS = (0x0028, 0x0002), (0x0028, 0x0010), (0x0028, 0x0011)
FRAMES = (0x0028, 0x0008)
BITS_ALLOCATED, BITS_STORED, REPRESENTATION = (0x0028, 0x0100), (0x0028, 0x0101), (0x0028, 0x0103)
WANTED = {SAMPLES, ROWS, COLUMNS, FRAMES, BITS_ALLOCATED, BITS_STORED, REPRESENTATION}


class _Reader:
    def __init__(self, raw: bytes, path):
        self.raw, self.path = raw, path

    def fail(self, what):
        raise ValueError(f"{self.path}: {what}")

    def element(self, pos: int, explicit: bool):
        """(tag, VR or None, value length, offset of the value) of the data
        element at ``pos``."""
        raw = self.raw
        if pos + 8 > len(raw):
            self.fail("truncated DICOM file (a data element header is cut short)")
        group, elem = struct.unpack_from("<HH", raw, pos)
        tag = (group, elem)
        if group == 0xFFFE:                   # items and delimiters: no VR
            return tag, None, struct.unpack_from("<I", raw, pos + 4)[0], pos + 8
        if not explicit:
            return tag, None, struct.unpack_from("<I", raw, pos + 4)[0], pos + 8
        vr = raw[pos + 4:pos + 6]
        if vr in LONG_VRS:
            if pos + 12 > len(raw):
                self.fail("truncated DICOM file (a data element header is cut short)")
            return tag, vr, struct.unpack_from("<I", raw, pos + 8)[0], pos + 12
        return tag, vr, struct.unpack_from("<H", raw, pos + 6)[0], pos + 8

    def skip_sequence(self, pos: int, explicit: bool) -> int:
        """The offset after a sequence of undefined length whose first item
        starts at ``pos``."""
        while True:
            tag, _, length, pos = self.element(pos, explicit)
            if tag == SEQUENCE_END:
                return pos
            if tag != ITEM:
                self.fail(f"malformed DICOM sequence (tag {tag[0]:04X},{tag[1]:04X} where an "
                          "item was expected)")
            pos = self.walk(pos, explicit, {}, ITEM_END) if length == UNDEFINED else pos + length

    def walk(self, pos: int, explicit: bool, found: dict, until=None) -> int:
        """Read the elements from ``pos`` until the tag ``until`` (an item's
        end) or, at the top level, the pixel data or the end of the file;
        ``found`` gets the values of `WANTED` and the pixel data's (offset,
        length).  Returns the offset after the last element read."""
        raw = self.raw
        while pos < len(raw):
            tag, vr, length, pos = self.element(pos, explicit)
            if tag == until:
                return pos
            if length == UNDEFINED:
                if tag == PIXEL_DATA:
                    found["encapsulated"] = True
                    return pos
                # a sequence (SQ, or UN whose content is implicit VR)
                pos = self.skip_sequence(pos, explicit and vr != b"UN")
                continue
            if pos + length > len(raw):
                if tag == PIXEL_DATA:
                    found[PIXEL_DATA] = (pos, len(raw) - pos)
                    return len(raw)
                self.fail(f"truncated DICOM file (element {tag[0]:04X},{tag[1]:04X})")
            if until is None:
                if tag == PIXEL_DATA:
                    found[PIXEL_DATA] = (pos, length)
                    return pos + length
                if tag in WANTED:
                    found[tag] = raw[pos:pos + length]
            pos += length
        if until is not None:
            self.fail("truncated DICOM file (an item of undefined length has no end)")
        return pos


def _uid(value: bytes) -> str:
    return value.rstrip(b"\x00 ").decode("ascii", "replace")


def _us(found: dict, tag, reader: _Reader, default=None) -> int:
    if tag not in found:
        if default is None:
            reader.fail(f"DICOM file without the element {tag[0]:04X},{tag[1]:04X}")
        return default
    if len(found[tag]) < 2:
        reader.fail(f"malformed DICOM element {tag[0]:04X},{tag[1]:04X}")
    return struct.unpack_from("<H", found[tag])[0]


def decode_pixels(raw: bytes, path="<bytes>") -> np.ndarray:
    """The stored pixel values of DICOM bytes (see the module docstring)."""
    r = _Reader(raw, path)
    if len(raw) < 132 or raw[128:132] != b"DICM":
        r.fail("not a DICOM file (no DICM prefix after the 128-byte preamble)")
    pos, syntax = 132, None
    while pos + 8 <= len(raw) and struct.unpack_from("<H", raw, pos)[0] == 0x0002:
        tag, _, length, pos = r.element(pos, True)
        if pos + length > len(raw):
            r.fail("truncated DICOM file (file meta information)")
        if tag == TRANSFER_SYNTAX:
            syntax = _uid(raw[pos:pos + length])
        pos += length
    if syntax is None:
        r.fail("DICOM file without a transfer syntax UID (0002,0010)")
    if syntax not in (IMPLICIT_LE, EXPLICIT_LE):
        r.fail(f"unsupported DICOM transfer syntax {syntax} "
               f"({OTHER_SYNTAXES.get(syntax, 'unknown')})")
    found = {}
    r.walk(pos, syntax == EXPLICIT_LE, found)
    if found.get("encapsulated"):
        r.fail(f"unsupported DICOM pixel data: encapsulated (compressed) under transfer syntax "
               f"{syntax}")
    if PIXEL_DATA not in found:
        r.fail("DICOM file without pixel data (7FE0,0010)")
    samples = _us(found, SAMPLES, r, 1)
    rows, cols = _us(found, ROWS, r), _us(found, COLUMNS, r)
    allocated = _us(found, BITS_ALLOCATED, r)
    stored = _us(found, BITS_STORED, r, allocated)
    signed = _us(found, REPRESENTATION, r, 0)
    frames = found.get(FRAMES, b"1").rstrip(b"\x00 ").strip() or b"1"
    if samples != 1:
        r.fail(f"unsupported DICOM pixel data: {samples} samples per pixel")
    if allocated not in (8, 16):
        r.fail(f"unsupported DICOM pixel data: {allocated} bits allocated")
    if not frames.isdigit() or int(frames) != 1:
        r.fail(f"unsupported DICOM pixel data: {frames.decode('ascii', 'replace')} frames")
    if not 1 <= stored <= allocated or signed not in (0, 1):
        r.fail(f"malformed DICOM pixel module (bits stored {stored}, pixel representation "
               f"{signed})")
    offset, length = found[PIXEL_DATA]
    count = rows * cols
    dtype = np.dtype(f"<{'i' if signed else 'u'}{allocated // 8}")
    if length < count * dtype.itemsize:
        r.fail(f"truncated DICOM pixel data ({length} bytes, expected "
               f"{count * dtype.itemsize})")
    px = np.frombuffer(raw, dtype, count, offset).reshape(rows, cols).astype(dtype.newbyteorder("="))
    if signed and stored < allocated:
        # move the sign bit of Bits Stored to the top, then shift back arithmetically
        shift = allocated - stored
        unsigned = px.view(f"u{allocated // 8}")
        px = (unsigned << np.uint8(shift)).view(px.dtype) >> shift
    return px


def read_pixels(path) -> np.ndarray:
    """The stored pixel values of the DICOM file at ``path``."""
    with open(path, "rb") as f:
        raw = f.read()
    return decode_pixels(raw, str(path))

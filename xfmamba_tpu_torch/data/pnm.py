"""Netpbm decoding to 8-bit grayscale without PIL or cv2 (the machine with
the card has neither): PBM, PGM and PPM (P1-P6, ASCII and raw), PAM (P7)
and PFM (``Pf`` / ``PF``).

`decode_gray` gives what the JAX package's ``load_grayscale`` gives:
``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``, and where cv2 refuses the file,
PIL's ``Image.open(path).convert("L")``.  Probed file by file against cv2
5.0 and PIL 12.1:

cv2 P1-P6 (``grfmt_pxm.cpp``): the magic must be followed by whitespace;
numbers are separated by whitespace and ``#`` comments (to the end of the
line); one byte after the last header number starts the data.  Raw samples
of 8 bits are taken as they are whatever the maxval (a PGM with maxval 50
keeps 0-50), ASCII ones are scaled, ``v * 255 // maxval`` (values past the
maxval clamped to it); samples past 255 (maxval 256-65535) are cut to their
high byte, ``v >> 8``, raw or ASCII; PBM is 0 -> 255, other values -> 0,
an ASCII PBM taking one digit a pixel (whitespace between them optional);
colour is ``(4899 R + 9617 G +
1868 B + 8192) >> 14``.  A maxval of 0 or past 65535, a number past
``INT_MAX``, any other byte where a number should be, or data cut short,
and cv2 fails.

cv2 P7 (``grfmt_pam.cpp``): ``WIDTH`` / ``HEIGHT`` / ``DEPTH`` / ``MAXVAL``
(``strtol``, so ``0x`` hex and leading-0 octal) and ``TUPLTYPE``, 1-4
channels; without a tuple type one channel (maxval 1: BLACKANDWHITE) or
three below 256 (RGB), else it fails.  Samples past 255 are cut to ``v >>
8``; RGB goes to gray as above; GRAYSCALE_ALPHA and RGB_ALPHA go through
cv2's ``basic_conversion``, which steps three output bytes a pixel through
only ``width / depth`` pixels of the row, so output pixel ``j`` is the
first channel of input pixel ``j // 3`` where it writes at all (the rest of
an RGB_ALPHA row, past ``3 ceil(width / 4)``, is left as the buffer held
it: those pixels are undefined in cv2 and 0 here; a GRAYSCALE_ALPHA row
writes ``3 ceil(width / 2)`` bytes, and the last row's spill past the
buffer corrupts cv2's heap: wide files crash the process that reads them);
a maxval of 1 reads a byte a sample and takes the row's first ``width /
8`` bytes as packed bits.

cv2 PFM (``grfmt_pfm.cpp``): ``Pf``, a newline, then width, height and
scale each ended by one whitespace byte; rows bottom to top, little-endian
for a negative scale; ``v * (1 / |scale|)`` rounded half to even, then
clamped to 0-255 (NaN, infinities and magnitudes past 2^31 to 0).  A
colour PFM (``PF``) makes cv2 fail.

PIL (``PpmImagePlugin.py``) reads P1-P6 and ``Pf``: tokens of at most 10
characters, maxval 1-65535; ASCII samples and raw samples with a maxval
other than 255 (or 65535 for gray) scaled as ``round(v / maxval * 255)``
(65535 for gray past 255, then ``convert("L")`` clips to 255); fewer
samples than the image fails.  PIL reads no PAM and no colour PFM.
"""

from __future__ import annotations

import math

import numpy as np

from xfmamba_tpu_torch.data import limits
from xfmamba_tpu_torch.data.gray import cv2_gray, pil_to_l

SPACE = b" \t\n\v\f\r"
INT_MAX = 2 ** 31 - 1


class Refused(Exception):
    """One reader does not read the file (the reason)."""


class EndOfStream(Refused):
    pass


def _fail(path, what):
    raise ValueError(f"{path}: {what}")


def is_pnm(raw: bytes) -> bool:
    """The signatures cv2's PxM / PAM / PFM decoders and PIL's PPM plugin
    take: ``P`` then 1-7, ``f`` or ``F``."""
    return len(raw) >= 2 and raw[:1] == b"P" and raw[1:2] in b"1234567fF"


class Stream:
    """cv2's RLByteStream over the file's bytes: reading past the end
    throws."""

    def __init__(self, raw: bytes, pos: int = 0):
        self.raw, self.pos = raw, pos

    def byte(self) -> int:
        if self.pos >= len(self.raw):
            raise EndOfStream("unexpected end of the stream")
        b = self.raw[self.pos]
        self.pos += 1
        return b

    def bytes(self, n: int) -> bytes:
        if self.pos + n > len(self.raw):
            raise EndOfStream("unexpected end of the stream")
        b = self.raw[self.pos:self.pos + n]
        self.pos += n
        return b


def _read_number(s: Stream, maxdigits: int = 0) -> int:
    """cv2's ReadNumber (grfmt_pxm.cpp)."""
    code = s.byte()
    while not 48 <= code <= 57:
        if code == 35:                                   # '#'
            while code not in (10, 13):
                code = s.byte()
            code = s.byte()
        elif code in SPACE:
            while code in SPACE:
                code = s.byte()
        else:
            raise Refused(f"unexpected byte {code:#x} where a number should be")
    val = digits = 0
    while 48 <= code <= 57:
        val = val * 10 + code - 48
        if val > INT_MAX:
            raise Refused("number too large")
        digits += 1
        if maxdigits and digits >= maxdigits:
            break                                   # the next byte stays unread
        code = s.byte()
    return val


# ---- cv2 P1-P6 ------------------------------------------------------------------

def _cv2_pxm(raw: bytes) -> np.ndarray:
    s = Stream(raw, 2)
    kind = raw[1] - 48
    bpp = {1: 1, 4: 1, 2: 8, 5: 8, 3: 24, 6: 24}[kind]
    binary = kind >= 4
    width, height = _read_number(s, INT_MAX), _read_number(s, INT_MAX)
    maxval = _read_number(s, INT_MAX) if bpp > 1 else 1
    if maxval > 65535:
        raise Refused("maxval past 65535")
    if not (width > 0 and height > 0 and 0 < maxval < 65536):
        raise Refused("bad header")
    limits.check_cv2(width, height)
    wide = maxval > 255
    ch = 3 if bpp == 24 else 1
    n = width * ch
    if bpp == 1:
        gray_palette = np.array([255, 0], np.uint8)
        if binary:
            pitch = (width + 7) // 8
            rows = np.frombuffer(s.bytes(pitch * height), np.uint8).reshape(height, pitch)
            return gray_palette[np.unpackbits(rows, axis=1)[:, :width]]
        vals = np.array([[_read_number(s, 1) != 0 for _ in range(width)] for _ in range(height)],
                        np.uint8).reshape(height, width)
        return gray_palette[vals]
    if binary:
        k = 2 if wide else 1
        data = np.frombuffer(s.bytes(n * k * height), np.uint8)
        v = (data.reshape(-1, 2).copy().view(">u2")[:, 0] >> 8).astype(np.uint8) if wide else data
    else:
        codes = np.array([min(_read_number(s), maxval) for _ in range(n * height)], np.int64)
        if wide:
            v = (codes >> 8).astype(np.uint8)
        else:
            v = (codes * 255 // maxval).astype(np.uint8)
    v = v.reshape(height, width, ch)
    return v[..., 0] if ch == 1 else cv2_gray(v[..., 0], v[..., 1], v[..., 2])


# ---- cv2 P7 ---------------------------------------------------------------------

PAM_FIELDS = ("WIDTH", "HEIGHT", "DEPTH", "MAXVAL", "TUPLTYPE", "ENDHDR")
PAM_FORMATS = ("BLACKANDWHITE", "GRAYSCALE", "GRAYSCALE_ALPHA", "RGB", "RGB_ALPHA")
PAM_DEPTHS = {"BLACKANDWHITE": 1, "GRAYSCALE": 1, "GRAYSCALE_ALPHA": 2, "RGB": 3, "RGB_ALPHA": 4}


def _pam_line(s: Stream):
    """cv2's ReadPAMHeaderLine: (field or None for a comment, value)."""
    code = s.byte()
    while code in SPACE:
        code = s.byte()
    if code == 35:
        while code not in (10, 13):
            code = s.byte()
        return None, None
    ident = bytearray()
    for _ in range(8):
        ident.append(code)
        code = s.byte()
        if code in SPACE:
            break
    else:
        raise Refused("bad PAM header")
    name = ident.decode("latin-1")
    if name not in PAM_FIELDS:
        raise Refused(f"unknown PAM header field {name!r}")
    if name == "ENDHDR":
        return name, None
    while code in SPACE:
        code = s.byte()
    value = bytearray()
    for _ in range(255):
        value.append(code)
        code = s.byte()
        if code in (10, 13):
            return name, value.decode("latin-1")
    raise Refused("PAM header value too long")


def _strtol(text: str) -> int:
    """C's strtol(text, &end, 0) where the rest must be whitespace."""
    t = text.lstrip(" \t\n\v\f\r")
    sign = -1 if t[:1] == "-" else 1
    if t[:1] in "+-":
        t = t[1:]
    if t[:2].lower() == "0x":
        base, t = 16, t[2:]
    elif t[:1] == "0":
        base = 8
    else:
        base = 10
    digits = "0123456789abcdef"[:base]
    k = 0
    while k < len(t) and t[k].lower() in digits:
        k += 1
    if k == 0 and base != 8:
        raise Refused("bad PAM number")
    if t[k:].strip(" \t\n\v\f\r"):
        raise Refused("bad PAM number")
    return sign * int(t[:k] or "0", base)


def _cv2_pam(raw: bytes) -> np.ndarray:
    if raw[2:3] not in (b"\n", b"\r"):
        raise Refused("bad PAM header")
    s = Stream(raw, 3)
    fields, fmt = {}, None
    while True:
        name, value = _pam_line(s)
        if name is None:
            continue
        if name == "ENDHDR":
            break
        if name == "TUPLTYPE":
            if value not in PAM_FORMATS:
                raise Refused(f"unknown tuple type {value!r}")
            fmt = value
            continue
        if name in fields:
            raise Refused(f"{name} given twice")
        fields[name] = _strtol(value)
        if name == "MAXVAL" and fields[name] > 65535:
            raise Refused("maxval past 65535")
    if set(fields) != {"WIDTH", "HEIGHT", "DEPTH", "MAXVAL"}:
        raise Refused("incomplete PAM header")
    w, h, ch, maxval = fields["WIDTH"], fields["HEIGHT"], fields["DEPTH"], fields["MAXVAL"]
    if fmt is None:
        if ch == 1 and maxval == 1:
            fmt = "BLACKANDWHITE"
        elif ch == 1 and maxval < 256:
            fmt = "GRAYSCALE"
        elif ch == 3 and maxval < 256:
            fmt = "RGB"
        else:
            raise Refused("cannot determine the PAM format")
    if not 1 <= ch <= 4 or w <= 0 or h <= 0:
        raise Refused("unsupported PAM layout")
    if ch != PAM_DEPTHS[fmt]:
        raise Refused(f"{fmt} with {ch} channels")
    limits.check_cv2(w, h)
    wide = maxval > 255
    k = 2 if wide else 1
    n = w * ch
    data = np.frombuffer(s.bytes(n * k * h), np.uint8).reshape(h, n * k)
    if maxval == 1:                             # bit mode: bytes read as packed bits
        bits = np.unpackbits(data[:, :(w + 7) // 8], axis=1)[:, :w]
        return np.where(bits != 0, 255, 0).astype(np.uint8)
    if wide:
        data = (data.copy().view(">u2") >> 8).astype(np.uint8)
    px = data.reshape(h, w, ch)
    if ch == 1:
        return np.ascontiguousarray(px[..., 0])
    if ch == 3 and fmt == "RGB":
        return cv2_gray(px[..., 0], px[..., 1], px[..., 2])
    # basic_conversion: three output bytes per input pixel, over width / ch pixels
    out = np.zeros((h, w), np.uint8)
    count = -(-w // ch)
    src = px.reshape(h, -1)[:, ::ch][:, :count]
    rep = np.repeat(src, 3, axis=1)[:, :w]
    out[:, :rep.shape[1]] = rep
    return out


# ---- cv2 PFM ----------------------------------------------------------------------

def _pfm_token(s: Stream) -> str:
    chars = bytearray()
    for _ in range(2048):
        c = s.byte()
        if c >= 128:
            raise Refused("bad PFM header")
        if c in SPACE:
            break
        chars.append(c)
    return chars.decode("ascii")


def _cv2_pfm(raw: bytes) -> np.ndarray:
    s = Stream(raw, 2)
    if s.byte() != 10:
        raise Refused("PFM header without a line break")
    try:
        w, h = int(_pfm_token(s)), int(_pfm_token(s))
        scale = float(_pfm_token(s))
    except ValueError:
        raise Refused("bad PFM header") from None
    if w < 0 or h < 0 or w >= 1 << 32 or h >= 1 << 32:
        raise Refused("bad PFM size")
    limits.check_cv2(w, h)
    if raw[1:2] == b"F":
        raise Refused("colour PFM read into one channel")
    data = np.frombuffer(s.bytes(4 * w * h), "<f4" if scale < 0 else ">f4").reshape(h, w)[::-1]
    if scale == 0:
        raise Refused("PFM scale 0")
    with np.errstate(over="ignore", invalid="ignore"):      # past float32: inf, then 0
        v = np.rint(data.astype(np.float32) * np.float32(1.0 / abs(scale)))
    out = np.zeros(v.shape, np.uint8)
    ok = np.isfinite(v) & (np.abs(v) < 2.0 ** 31)
    out[ok] = np.clip(v[ok], 0, 255).astype(np.uint8)
    return out


def cv2_read(raw: bytes) -> np.ndarray:
    """What cv2.imread(..., IMREAD_GRAYSCALE) gives, or `Refused`."""
    if len(raw) < 3 or raw[2] not in SPACE:
        raise Refused("no cv2 Netpbm signature")
    kind = raw[1:2]
    if kind in b"123456":
        return _cv2_pxm(raw)
    if kind == b"7":
        return _cv2_pam(raw)
    if kind in (b"f", b"F"):
        return _cv2_pfm(raw)
    raise Refused("not a Netpbm file")


# ---- PIL ------------------------------------------------------------------------------

PIL_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB",
             b"Pf": "F"}


class _PilStream:
    def __init__(self, raw):
        self.raw, self.pos = raw, 0

    def read(self, n=1) -> bytes:
        b = self.raw[self.pos:self.pos + n]
        self.pos += len(b)
        return b


def _pil_token(f: _PilStream) -> bytes:
    token = b""
    while len(token) <= 10:
        c = f.read(1)
        if not c:
            break
        if c in SPACE:
            if not token:
                continue
            break
        if c == b"#":
            while f.read(1) not in b"\r\n":
                pass
            continue
        token += c
    if not token:
        raise Refused("reached EOF while reading header")
    if len(token) > 10:
        raise Refused("token too long in file header")
    return token


def _pil_int(token: bytes) -> int:
    try:
        return int(token)
    except ValueError:
        raise Refused("bad number in the header") from None


def _strip_comments(data: bytes) -> bytes:
    """PpmPlainDecoder's comment removal: '#' to the next CR or LF."""
    out, pos = bytearray(), 0
    while True:
        k = data.find(b"#", pos)
        if k < 0:
            out += data[pos:]
            return bytes(out)
        out += data[pos:k]
        ends = [e for e in (data.find(b"\n", k), data.find(b"\r", k)) if e >= 0]
        if not ends:
            return bytes(out)
        pos = min(ends) + 1


def pil_read(raw: bytes) -> np.ndarray:
    """What PIL's ``Image.open(path).convert("L")`` gives, or `Refused`."""
    f = _PilStream(raw)
    magic = b""
    for _ in range(6):
        c = f.read(1)
        if not c or c in SPACE:
            break
        magic += c
    if magic not in PIL_MODES:
        raise Refused("not a PPM file")
    mode = PIL_MODES[magic]
    w, h = _pil_int(_pil_token(f)), _pil_int(_pil_token(f))
    if w <= 0 or h <= 0:
        raise Refused("bad image size")
    if not limits.pil_ok(w, h):
        raise Refused("decompression bomb")
    plain = magic in (b"P1", b"P2", b"P3")
    bands = 3 if mode == "RGB" else 1
    if mode == "F":
        try:
            scale = float(_pil_token(f))
        except ValueError:
            raise Refused("bad scale") from None
        if scale == 0.0 or not math.isfinite(scale):
            raise Refused("scale must be finite and non-zero")
        need = 4 * w * h
        if f.pos + need > len(raw):
            raise Refused("image file is truncated")
        data = np.frombuffer(raw, "<f4" if scale < 0 else ">f4", w * h, f.pos).reshape(h, w)
        return pil_to_l(data[::-1], "F")
    maxval = 1
    if mode != "1":
        maxval = _pil_int(_pil_token(f))
        if not 0 < maxval < 65536:
            raise Refused("maxval must be greater than 0 and less than 65536")
        if maxval > 255 and mode == "L":
            mode = "I"
    out_max = 65535 if mode == "I" else 255
    total = w * h * bands
    rest = raw[f.pos:]
    if plain and mode == "1":
        tokens = b"".join(_strip_comments(rest).split())
        if any(t not in b"01" for t in tokens[:total]) or (
                len(tokens) <= total and any(t not in b"01" for t in tokens)):
            raise Refused("invalid token for this mode")
        if len(tokens) < total:
            raise Refused("not enough image data")
        bits = np.frombuffer(tokens[:total], np.uint8).reshape(h, w)
        return np.where(bits == 48, 255, 0).astype(np.uint8)
    if plain:
        vals = []
        for token in _strip_comments(rest).split():
            if len(vals) == total:
                break
            if len(token) > 10:
                raise Refused("token too long found in data")
            v = _pil_int(token)
            if v < 0 or v > maxval:
                raise Refused("channel value out of range")
            vals.append(round(v / maxval * out_max))
        if len(vals) < total:
            raise Refused("not enough image data")
        v = np.array(vals, np.int64)
    elif mode == "1":
        pitch = (w + 7) // 8
        if len(rest) < pitch * h:
            raise Refused("image file is truncated")
        rows = np.frombuffer(rest, np.uint8, pitch * h).reshape(h, pitch)
        return np.where(np.unpackbits(rows, axis=1)[:, :w] != 0, 0, 255).astype(np.uint8)
    elif maxval == 255 or (maxval == 65535 and mode == "I"):
        k = 2 if mode == "I" else 1
        if len(rest) < total * k:
            raise Refused("image file is truncated")
        v = np.frombuffer(rest, ">u2" if k == 2 else np.uint8, total).astype(np.int64)
    else:
        k = 1 if maxval < 256 else 2
        n = min(len(rest) // (k * bands), w * h) * bands
        if n < total:
            raise Refused("not enough image data")
        raw_v = np.frombuffer(rest, np.uint8 if k == 1 else ">u2", n).astype(np.float64)
        v = np.minimum(out_max, np.array([round(x) for x in raw_v / maxval * out_max]))
    img = v.reshape(h, w, bands) if bands > 1 else v.reshape(h, w)
    return pil_to_l(img.astype(np.int64 if mode == "I" else np.uint8), mode)


# ---- the reader -------------------------------------------------------------------

def decode_gray(raw: bytes, path="<bytes>") -> np.ndarray:
    """Decode Netpbm bytes to (H, W) uint8 gray (see the module docstring)."""
    if not is_pnm(raw):
        _fail(path, "not a Netpbm file")
    try:
        return cv2_read(raw)
    except limits.TooLarge as e:
        _fail(path, str(e))
    except Refused as e:
        why = str(e)
    try:
        return pil_read(raw)
    except Refused as e:
        _fail(path, f"unreadable Netpbm file (as cv2 reads it: {why}; as PIL reads it: {e})")


def load_grayscale(path) -> np.ndarray:
    with open(path, "rb") as f:
        raw = f.read()
    return decode_gray(raw, str(path))

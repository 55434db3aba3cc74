"""ctypes bindings for the port's host-side data-path kernels
(``xfm_host.cc``, and ``jpeg_decode.cc`` for `data/jpeg.py`).

The sources are compiled with ``g++`` at the first call, not at import, into
``xfmamba_tpu_torch/_build/`` (git-ignored) under a name keyed on a hash of
the sources and the flags.  A failed build raises: there is no silent numpy
fallback.  `png_unfilter_plain`, `png_adam7_plain` and `png_unpack_plain`
are the numpy twins of the C++ PNG code, for tests.  The calls release the
GIL, so the loader's threads overlap them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCES = tuple(Path(__file__).resolve().parent / name
                for name in ("xfm_host.cc", "jpeg_decode.cc"))
BUILD_DIR = PACKAGE_DIR / "_build"
# no -march=native: a library built on one host may be loaded on another
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for source in SOURCES:
        h.update(source.read_bytes())
    return BUILD_DIR / f"libxfm_host_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources into one library unless it exists."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)
    return so


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.normalize_u8_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_float, ctypes.c_float]
    lib.normalize_u8_f32.restype = None
    lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_int]
    lib.png_unfilter.restype = ctypes.c_int64
    lib.png_adam7.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                              ctypes.c_int64, ctypes.c_int]
    lib.png_adam7.restype = ctypes.c_int64
    lib.png_unpack.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    lib.png_unpack.restype = None
    i64, pi64 = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
    lib.jpeg_decode_gray.argtypes = [ctypes.c_char_p, i64, pi64, pi64, ctypes.c_char_p, i64]
    lib.jpeg_decode_gray.restype = ctypes.c_void_p
    lib.xfm_free.argtypes = [ctypes.c_void_p]
    lib.xfm_free.restype = None
    return lib


def library() -> ctypes.CDLL:
    """The loaded host library (built at the first call)."""
    with _lock:
        return _library()


def normalize_u8(img_u8: np.ndarray, mean: float = 0.0, std: float = 1.0) -> np.ndarray:
    """uint8 -> float32 ``(x / 255 - mean) / std``, computed as
    ``x * (1 / (255 std)) - mean / std`` in float32 (the JAX package's
    native kernel), elementwise over any shape."""
    src = np.ascontiguousarray(img_u8, dtype=np.uint8)
    out = np.empty(src.shape, np.float32)
    library().normalize_u8_f32(src.ctypes.data, out.ctypes.data, src.size,
                               ctypes.c_float(mean), ctypes.c_float(std))
    return out


def _check_unfilter_args(data, height, rowbytes):
    data = np.ascontiguousarray(data, dtype=np.uint8)
    if data.size != height * (rowbytes + 1):
        raise ValueError(f"filtered data holds {data.size} bytes, expected "
                         f"{height} rows of 1 + {rowbytes}")
    return data


def png_unfilter(data: np.ndarray, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters of a whole (non-interlaced) image: ``data``
    is the inflated IDAT stream, ``height`` rows of a filter-type byte and
    ``rowbytes`` bytes; ``bpp`` the bytes per complete pixel (at least 1).
    Returns (height, rowbytes) uint8.  A filter type past 4 raises."""
    data = _check_unfilter_args(data, height, rowbytes)
    out = np.empty((height, rowbytes), np.uint8)
    bad = library().png_unfilter(data.ctypes.data, out.ctypes.data, height, rowbytes,
                                 max(int(bpp), 1))
    if bad:
        raise ValueError(f"PNG row {bad - 1} has filter type {data[(bad - 1) * (rowbytes + 1)]}")
    return out


def png_unfilter_plain(data: np.ndarray, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """numpy twin of `png_unfilter`: None, Sub and Up by whole rows, Average
    and Paeth a byte at a time."""
    data = _check_unfilter_args(data, height, rowbytes).reshape(height, rowbytes + 1)
    bpp = max(int(bpp), 1)
    out = np.zeros((height, rowbytes), np.uint8)
    prev = np.zeros(rowbytes, np.uint8)
    for y in range(height):
        kind, row = int(data[y, 0]), data[y, 1:]
        if kind == 0:
            cur = row.copy()
        elif kind == 1:
            # a running sum a pixel apart, modulo 256
            pad = -rowbytes % bpp
            cols = np.concatenate([row, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
            cur = np.cumsum(cols, axis=0, dtype=np.uint8).reshape(-1)[:rowbytes]
        elif kind == 2:
            cur = row + prev
        elif kind in (3, 4):
            r, b = row.tolist(), prev.tolist()
            c = [0] * rowbytes
            for i in range(rowbytes):
                left = c[i - bpp] if i >= bpp else 0
                if kind == 3:
                    c[i] = (r[i] + ((left + b[i]) >> 1)) & 255
                    continue
                upleft = b[i - bpp] if i >= bpp else 0
                p = left + b[i] - upleft
                pa, pb, pc = abs(p - left), abs(p - b[i]), abs(p - upleft)
                pred = left if pa <= pb and pa <= pc else (b[i] if pb <= pc else upleft)
                c[i] = (r[i] + pred) & 255
            cur = np.asarray(c, np.uint8)
        else:
            raise ValueError(f"PNG row {y} has filter type {kind}")
        out[y] = cur
        prev = cur
    return out


# Adam7's passes: (first row, first column, row step, column step)
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
         (1, 0, 2, 1))


def adam7_passes(width: int, height: int, bits: int):
    """[(pass, pass width, pass height, row bytes)] of the nonempty passes."""
    out = []
    for k, (y0, x0, dy, dx) in enumerate(ADAM7):
        pw = -(-(width - x0) // dx) if width > x0 else 0
        ph = -(-(height - y0) // dy) if height > y0 else 0
        if pw and ph:
            out.append((k, pw, ph, -(-pw * bits // 8)))
    return out


def adam7_size(width: int, height: int, bits: int) -> int:
    """Bytes of the inflated stream of an interlaced image."""
    return sum(ph * (rb + 1) for _, _, ph, rb in adam7_passes(width, height, bits))


def png_adam7(data: np.ndarray, width: int, height: int, bits: int) -> np.ndarray:
    """Undo the filters of an Adam7-interlaced image's inflated stream
    ``data`` and put each pass's pixels in place: (height, ceil(width *
    bits / 8)) uint8, packed as a plain image's rows.  ``bits`` is the bits
    per pixel.  A short stream or a filter type past 4 raises."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    out = np.empty((height, -(-width * bits // 8)), np.uint8)
    bad = library().png_adam7(data.ctypes.data, data.size, out.ctypes.data, width, height, bits)
    if bad < 0:
        raise ValueError(f"interlaced data holds {data.size} bytes, expected "
                         f"{adam7_size(width, height, bits)}")
    if bad:
        raise ValueError(f"PNG interlaced row {bad - 1} has a filter type past 4")
    return out


def png_adam7_plain(data: np.ndarray, width: int, height: int, bits: int) -> np.ndarray:
    """numpy twin of `png_adam7`: each pass through `png_unfilter_plain`,
    its samples unpacked to one a byte, placed, and the rows packed again."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    if data.size < adam7_size(width, height, bits):
        raise ValueError(f"interlaced data holds {data.size} bytes, expected "
                         f"{adam7_size(width, height, bits)}")
    unit = max(bits // 8, 1)
    full = np.zeros((height, width * unit), np.uint8)
    pos, row_index = 0, 0
    for k, pw, ph, rb in adam7_passes(width, height, bits):
        y0, x0, dy, dx = ADAM7[k]
        chunk = data[pos:pos + ph * (rb + 1)]
        try:
            rows = png_unfilter_plain(chunk, ph, rb, unit)
        except ValueError:
            bad = int(np.flatnonzero(chunk.reshape(ph, rb + 1)[:, 0] > 4)[0])
            raise ValueError(f"PNG interlaced row {row_index + bad} has a filter type past 4")
        if bits < 8:
            px = png_unpack_plain(rows, pw, bits, scale=False)
        else:
            px = rows.reshape(ph, pw * unit)
        full.reshape(height, width, unit)[y0::dy, x0::dx] = px.reshape(ph, pw, unit)
        pos += ph * (rb + 1)
        row_index += ph
    if bits >= 8:
        return full
    per = 8 // bits
    padded = np.zeros((height, -(-width // per) * per), np.uint8)
    padded[:, :width] = full
    shifts = (8 - bits * (np.arange(per) + 1)).astype(np.uint8)
    return np.bitwise_or.reduce(padded.reshape(height, -1, per) << shifts, axis=2).astype(np.uint8)


def png_unpack(rows: np.ndarray, width: int, depth: int, scale: bool) -> np.ndarray:
    """(H, rowbytes) packed ``depth``-bit samples (1, 2 or 4) -> (H, width)
    uint8, each scaled to 0-255 when ``scale`` (libpng's gray expansion)."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    out = np.empty((rows.shape[0], width), np.uint8)
    library().png_unpack(rows.ctypes.data, out.ctypes.data, rows.shape[0], width, rows.shape[1],
                         depth, int(scale))
    return out


def png_unpack_plain(rows: np.ndarray, width: int, depth: int, scale: bool) -> np.ndarray:
    """numpy twin of `png_unpack`."""
    bits = np.unpackbits(np.ascontiguousarray(rows, dtype=np.uint8), axis=1)
    bits = bits[:, :width * depth].reshape(rows.shape[0], width, depth)
    v = (bits * (1 << np.arange(depth - 1, -1, -1))).sum(axis=2).astype(np.uint8)
    return v * np.uint8(255 // ((1 << depth) - 1)) if scale else v


def jpeg_decode_gray(raw: bytes) -> np.ndarray:
    """Decode a whole JPEG file (bytes) to (H, W) uint8 gray as
    ``cv2.imread(path, IMREAD_GRAYSCALE)`` does, EXIF orientation aside (see
    ``jpeg_decode.cc``).  A file libjpeg or cv2 would not read raises
    ``ValueError`` naming the format or the fault."""
    lib = library()
    h, w = ctypes.c_int64(), ctypes.c_int64()
    err = ctypes.create_string_buffer(256)
    ptr = lib.jpeg_decode_gray(raw, len(raw), ctypes.byref(h), ctypes.byref(w), err, len(err))
    if not ptr:
        raise ValueError(err.value.decode(errors="replace"))
    try:
        out = np.empty((h.value, w.value), np.uint8)
        ctypes.memmove(out.ctypes.data, ptr, out.size)
    finally:
        lib.xfm_free(ptr)
    return out

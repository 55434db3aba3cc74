"""ctypes bindings for the port's host-side data-path kernels
(``xfm_host.cc``, ``jpeg_decode.cc`` for `data/jpeg.py`, ``tiff_decode.cc``
for `data/tiff.py` and ``raster_decode.cc`` for `data/bmp.py` and
`data/sunras.py`).

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
                for name in ("xfm_host.cc", "jpeg_decode.cc", "tiff_decode.cc",
                             "raster_decode.cc"))
BUILD_DIR = PACKAGE_DIR / "_build"
# no -march=native: a library built on one host may be loaded on another
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
LIBS = ("-ldl",)          # tiff_decode.cc loads the system zlib with dlopen
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
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
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES), *LIBS]
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
    lib.jpeg_decode_samples.argtypes = [ctypes.c_char_p, i64, ctypes.c_int, pi64, pi64,
                                        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, i64]
    lib.jpeg_decode_samples.restype = ctypes.c_void_p
    lib.xfm_free.argtypes = [ctypes.c_void_p]
    lib.xfm_free.restype = None
    p = ctypes.c_void_p
    lib.tiff_decode_chunks.argtypes = [p, i64, i64, p, p, p, p, p, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int, i64, ctypes.c_int, ctypes.c_int,
                                       i64, ctypes.c_int, p]
    lib.tiff_decode_chunks.restype = i64
    lib.bmp_rle_cv2.argtypes = [p, i64, i64, ctypes.c_int, p, i64, i64, p]
    lib.bmp_rle_cv2.restype = ctypes.c_int
    lib.bmp_rle_pil.argtypes = [p, i64, i64, ctypes.c_int, i64, i64, p, i64]
    lib.bmp_rle_pil.restype = i64
    lib.sunras_rle.argtypes = [p, i64, p, i64]
    lib.sunras_rle.restype = i64
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


def tiff_decode_chunks(raw: bytes, offsets, counts, wants, out_offsets, out_size: int, *,
                       codec: int, predictor: int = 1, sample_bytes: int = 1, stride: int = 1,
                       row_bytes: int = 0, swap: bool = False, reverse_bits: bool = False,
                       width: int = 0, fax_options: int = 0):
    """Decode TIFF strips or tiles as libtiff's TIFFReadEncodedStrip /
    TIFFReadEncodedTile leave them (``tiff_decode.cc``): chunk i is
    ``counts[i]`` raw bytes at ``offsets[i]`` of the file ``raw``,
    decoded to ``wants[i]`` bytes at ``out_offsets[i]`` of a zeroed
    ``out_size``-byte buffer.  Returns (buffer as uint8, status per chunk:
    0 decoded, 1 the codec failed, 2 the strip could not be read)."""
    lib = library()
    arrays = [np.ascontiguousarray(a, dtype=np.int64) for a in (offsets, counts, wants,
                                                                  out_offsets)]
    n = len(arrays[0])
    if any(len(a) != n for a in arrays) or (arrays[2] < 0).any() or (arrays[3] < 0).any() or \
            (n and (arrays[3] + arrays[2] > out_size).any()):
        raise ValueError("chunk outputs outside the buffer")
    out = np.zeros(out_size, np.uint8)
    status = np.zeros(n, np.int8)
    ret = lib.tiff_decode_chunks(raw, len(raw), n, *(a.ctypes.data for a in arrays[:3]),
                                 out.ctypes.data, arrays[3].ctypes.data, codec, predictor,
                                 sample_bytes, stride, row_bytes, int(swap), int(reverse_bits),
                                 width, fax_options, status.ctypes.data)
    if ret < 0:
        raise RuntimeError("Deflate-compressed TIFF data needs the system zlib (libz.so.1), "
                           "which could not be loaded")
    return out, status


def bmp_rle_cv2(raw: bytes, pos: int, rle4: bool, gray_palette: np.ndarray, width: int,
                height: int):
    """cv2's RLE8 / RLE4 decoding of a BMP from byte ``pos`` of ``raw``
    (``raster_decode.cc``): (status, (height, width) uint8 rows in decoding
    order).  Status 0: decoded; 1: a run passes a row's end; 2: the data
    ends first."""
    gray = np.zeros(256, np.uint8)
    gray[:len(gray_palette)] = gray_palette[:256]
    out = np.zeros((height, width), np.uint8)
    status = library().bmp_rle_cv2(raw, len(raw), pos, int(rle4), gray.ctypes.data, width,
                                   height, out.ctypes.data)
    return status, out


def bmp_rle_pil(raw: bytes, pos: int, rle4: bool, width: int, height: int):
    """Pillow's BmpRleDecoder from byte ``pos``: (pixels produced, -1 where
    it raises; the first width x height of them, uint8)."""
    out = np.zeros(width * height, np.uint8)
    n = library().bmp_rle_pil(raw, len(raw), pos, int(rle4), width, height, out.ctypes.data,
                              out.size)
    return n, out


def sunras_rle(data: bytes, capacity: int) -> np.ndarray:
    """Expand a byte-encoded Sun raster's data, at most ``capacity`` bytes."""
    out = np.zeros(capacity, np.uint8)
    n = library().sunras_rle(data, len(data), out.ctypes.data, capacity)
    return out[:n]


def jpeg_decode_samples(raw: bytes, rgb: bool) -> np.ndarray:
    """A JPEG datastream's samples as libtiff's JPEG codec gets them from
    libjpeg: (H, W, components) uint8, YCbCr converted to RGB when ``rgb``
    (JPEGCOLORMODE_RGB), else every component as it is.  A datastream
    libjpeg would not decode raises ``ValueError``."""
    lib = library()
    h, w, nc = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int()
    err = ctypes.create_string_buffer(256)
    ptr = lib.jpeg_decode_samples(raw, len(raw), 2 if rgb else 1, ctypes.byref(h),
                                  ctypes.byref(w), ctypes.byref(nc), err, len(err))
    if not ptr:
        raise ValueError(err.value.decode(errors="replace"))
    try:
        out = np.empty((h.value, w.value, nc.value), np.uint8)
        ctypes.memmove(out.ctypes.data, ptr, out.size)
    finally:
        lib.xfm_free(ptr)
    return out

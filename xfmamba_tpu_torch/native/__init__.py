"""ctypes bindings for the port's host-side data-path kernels
(``xfm_host.cc``, and ``jpeg_scan.cc`` for `data/jpeg.py`).

The sources are compiled with ``g++`` at the first call, not at import, into
``xfmamba_tpu_torch/_build/`` (git-ignored) under a name keyed on a hash of
the sources and the flags.  A failed build raises: there is no silent numpy
fallback.  `png_unfilter_plain` is the numpy twin of the C++ unfilter, for
tests.  The calls release the GIL, so the loader's threads overlap them.
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
                for name in ("xfm_host.cc", "jpeg_scan.cc"))
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
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.jpeg_scan.argtypes = [p, i64, i64, ctypes.c_int, p, p, i64, i64, i64, ctypes.c_int,
                              p, p, i64]
    lib.jpeg_scan.restype = i64
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


JPEG_STATUS = {-1: "a Huffman table that is not a prefix code",
               -2: "a bit pattern that starts no Huffman code",
               -3: "a scan that needs data past its end",
               -4: "a restart marker missing or out of order",
               -5: "no marker after a scan"}


def jpeg_scan(data: np.ndarray, pos: int, comps: np.ndarray, tables: np.ndarray, mcus_x: int,
              mcus_y: int, restart_interval: int, target: int, quant: np.ndarray,
              plane: np.ndarray) -> int:
    """Decode one sequential Huffman scan of a JPEG (``data`` the whole file
    as uint8, its entropy-coded data from ``pos``): ``comps`` (n, 4) int32
    of (h, v, DC table, AC table) per scan component, ``tables`` (8, 272)
    uint8 (DC 0-3 then AC 0-3: 16 code counts, 256 symbols), the scan's
    MCU grid, the restart interval (0: none), and the scan component
    ``target`` (-1: none) whose blocks are dequantised by ``quant`` (64
    int32, natural order), inverse transformed by libjpeg's islow IDCT and
    written into ``plane`` (uint8, C order, 8 x 8 blocks in MCU layout).
    Returns the offset of the marker after the scan; a corrupt or truncated
    scan raises ``ValueError``."""
    assert data.dtype == np.uint8 and data.flags.c_contiguous
    comps = np.ascontiguousarray(comps, dtype=np.int32)
    tables = np.ascontiguousarray(tables, dtype=np.uint8)
    quant = np.ascontiguousarray(quant, dtype=np.int32)
    assert plane.dtype == np.uint8 and plane.flags.c_contiguous and plane.ndim == 2
    end = library().jpeg_scan(data.ctypes.data, data.size, pos, len(comps), comps.ctypes.data,
                              tables.ctypes.data, mcus_x, mcus_y, restart_interval, target,
                              quant.ctypes.data, plane.ctypes.data, plane.shape[1])
    if end < 0:
        raise ValueError(JPEG_STATUS.get(end, f"status {end}"))
    return end

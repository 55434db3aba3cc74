"""A PNG encoder and a synthetic MURA tree, numpy and zlib only, for the
port's CPU tests and for ``chip_smoke.py`` (pytest does not collect this
module).

`encode_png` writes any of the formats that `data/png.py` reads or refuses
(colour types 0, 2, 3, 4, 6; bit depths 1-16; the interlace flag), with a
filter type chosen row by row.  `write_mura_tree` lays out MURA-v1.1's
structure: ``{split}/XR_{PART}/patientNNNNN/studyK_{positive|negative}/
imageJ.png`` and the four CSVs (image paths, then study labels, each with a
header row).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_row(kind: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """PNG filter ``kind`` (0-4) applied to one raw row (uint8)."""
    r = row.astype(np.int32)
    up = prev.astype(np.int32)
    left = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
    pred = {0: 0, 1: left, 2: up, 3: (left + up) >> 1, 4: _paeth(left, up, upleft)}[kind]
    return ((r - pred) & 255).astype(np.uint8)


def _chunk(kind: bytes, body: bytes, crc_ok: bool = True) -> bytes:
    crc = zlib.crc32(kind + body) ^ (0 if crc_ok else 1)
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def encode_png(pixels: np.ndarray, colour: int = 0, depth: int = 8, palette=None,
               filters=None, interlace: int = 0, bad_crc: bool = False,
               truncate: int = 0, level: int = 6) -> bytes:
    """PNG bytes of ``pixels`` ((H, W) or (H, W, channels); uint8, or uint16
    at depth 16; palette indices for colour 3 with ``palette`` (n, 3) uint8;
    for depths below 8 the samples, packed here).  ``filters``: one filter
    type a row (cycled); default 0-4 in turn.  ``interlace`` only sets the
    IHDR flag (the data stays sequential); ``bad_crc`` spoils the IDAT CRC;
    ``truncate`` drops that many bytes from the end."""
    px = np.asarray(pixels)
    if px.ndim == 2:
        px = px[:, :, None]
    h, w, ch = px.shape
    assert ch == CHANNELS[colour], (ch, colour)
    if depth == 16:
        rows = px.astype(">u2").reshape(h, w * ch).view(np.uint8).reshape(h, -1)
    elif depth == 8:
        rows = px.astype(np.uint8).reshape(h, w * ch)
    else:
        per = 8 // depth
        padded = np.zeros((h, -(-w // per) * per), np.uint8)
        padded[:, :w] = px[:, :, 0]
        shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
        rows = np.bitwise_or.reduce(
            padded.reshape(h, -1, per) << shifts, axis=2).astype(np.uint8)
    bpp = max(1, ch * depth // 8)
    filters = list(filters) if filters is not None else [0, 1, 2, 3, 4]
    out, prev = [], np.zeros(rows.shape[1], np.uint8)
    for y in range(h):
        kind = filters[y % len(filters)]
        out.append(bytes([kind]) + filter_row(kind, rows[y], prev, bpp).tobytes())
        prev = rows[y]
    ihdr = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace)
    body = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
    if colour == 3:
        body += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    body += _chunk(b"IDAT", zlib.compress(b"".join(out), level), crc_ok=not bad_crc)
    body += _chunk(b"IEND", b"")
    return body[:len(body) - truncate] if truncate else body


class ArrayPairs:
    """A picklable load function over in-memory images: a sample (i, j,
    label) gives (images[i], images[j], int32 label)."""

    def __init__(self, images):
        self.images = images

    def __call__(self, sample):
        i, j, label = sample
        return self.images[i], self.images[j], np.int32(label)


def xray_like(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A smooth gray image with some noise (compresses like a radiograph)."""
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
    r = np.hypot((yy - cy) / h, (xx - cx) / w)
    base = 200 * np.exp(-6 * r ** 2) + rng.normal(0, 6, (h, w))
    return np.clip(base, 0, 255).astype(np.uint8)


def image_file(rng, path: str, kind: str, h: int, w: int) -> None:
    """Write one image of ``kind``: gray8, rgb8, rgba8, palette8, graya8,
    gray16, graya16."""
    g = xray_like(rng, h, w)
    if kind == "gray8":
        raw = encode_png(g, 0, 8)
    elif kind in ("rgb8", "rgba8"):
        tint = rng.integers(0, 40, 3)
        px = np.clip(g[:, :, None].astype(int) + tint, 0, 255).astype(np.uint8)
        if kind == "rgba8":
            px = np.concatenate([px, rng.integers(0, 256, (h, w, 1), dtype=np.uint8)], 2)
        raw = encode_png(px, 2 if kind == "rgb8" else 6, 8)
    elif kind == "palette8":
        pal = rng.integers(0, 256, (256, 3), dtype=np.uint8)
        raw = encode_png(g, 3, 8, palette=pal)
    elif kind == "graya8":
        raw = encode_png(np.stack([g, rng.integers(0, 256, (h, w), dtype=np.uint8)], 2), 4, 8)
    elif kind == "gray16":
        raw = encode_png(g.astype(np.uint16) * 257 + rng.integers(0, 257, (h, w)), 0, 16)
    elif kind == "graya16":
        px = np.stack([g.astype(np.uint16) * 257, rng.integers(0, 65536, (h, w))], 2)
        raw = encode_png(px.astype(np.uint16), 4, 16)
    else:
        raise ValueError(kind)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(raw)


def write_mura_tree(root: str, n_studies: int = 64, parts=("ELBOW", "WRIST"),
                    sizes=((380, 512), (300, 512)), images_per_study=(1, 3),
                    n_valid: int = 16, kinds=("rgb8", "palette8", "gray16"),
                    seed: int = 0):
    """A synthetic MURA tree under ``root``: ``n_studies`` training and
    ``n_valid`` validation studies, one patient each (distinct
    ``patientNNNNN`` directories), body parts in turn, labels balanced,
    1-3 images a study at sizes drawn between ``sizes`` (min, max) per side;
    every 11th image is of one of ``kinds``, the rest 8-bit gray.  Returns
    the four CSV paths (train images, train labels, valid images, valid
    labels) and the list of image paths written."""
    rng = np.random.default_rng(seed)
    csvs, images, k = [], [], 0
    for split, n, first in (("train", n_studies, 0), ("valid", n_valid, n_studies)):
        img_rows, lbl_rows = [], []
        for s in range(n):
            part = parts[s % len(parts)]
            label = (s // len(parts)) % 2
            study = (f"MURA-v1.1/{split}/XR_{part}/patient{first + s:05d}/"
                     f"study1_{'positive' if label else 'negative'}/")
            for j in range(int(rng.integers(images_per_study[0], images_per_study[1] + 1))):
                h = int(rng.integers(sizes[0][0], sizes[0][1] + 1))
                w = int(rng.integers(sizes[1][0], sizes[1][1] + 1))
                rel = f"{study}image{j + 1}.png"
                k += 1
                kind = kinds[(k // 11) % len(kinds)] if kinds and k % 11 == 0 else "gray8"
                image_file(rng, os.path.join(root, rel), kind, h, w)
                img_rows.append(rel)
                images.append(os.path.join(root, rel))
            lbl_rows.append(f"{study},{label}")
        img_csv = os.path.join(root, f"{split}_image_paths.csv")
        lbl_csv = os.path.join(root, f"{split}_labeled_studies.csv")
        with open(img_csv, "w") as f:
            f.write("Path\n" + "\n".join(img_rows) + "\n")
        with open(lbl_csv, "w") as f:
            f.write("Study,Label\n" + "\n".join(lbl_rows) + "\n")
        csvs += [img_csv, lbl_csv]
    return csvs, images

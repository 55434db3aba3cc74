"""Image files to 8-bit grayscale by their content, as ``cv2.imread(path,
cv2.IMREAD_GRAYSCALE)`` reads them (and PIL's ``convert("L")`` where cv2
refuses), whatever the file's name (the JAX package's tests write PNG
bytes under ``.jpg`` names).  The leading bytes pick the reader:

- ``\\x89PNG`` -> `png`; ``FF D8 FF`` -> `jpeg`;
- ``II*\\0``, ``MM\\0*``, BigTIFF's ``II+\\0`` / ``MM\\0+`` (and the two
  swapped forms PIL takes) -> `tiff`;
- ``BM`` -> `bmp`;
- ``P1``-``P7``, ``Pf``, ``PF`` -> `pnm`;
- ``59 A6 6A 95`` -> `sunras`.

GIF, WebP (and other RIFF files), JPEG 2000, AVIF, HDR, TGA, PCX and ICO,
which cv2 or PIL read, raise a ``ValueError`` naming the format as not yet
read by the port; anything else raises as an unknown format.  The TIFF,
BMP, Netpbm and Sun raster readers keep the oracle's size limits
(`limits`).
"""

from __future__ import annotations

import numpy as np

from xfmamba_tpu_torch.data import bmp, jpeg, png, pnm, sunras, tiff

NOT_YET = "a format the port does not read yet"


def _reader(raw: bytes):
    if raw[:8] == png.SIGNATURE:
        return png.decode_gray
    if raw[:3] == jpeg.SIGNATURE:
        return jpeg.decode_gray
    if raw[:4] in tiff.PIL_SIGNATURES:
        return tiff.decode_gray
    if raw[:2] == bmp.SIGNATURE:
        return bmp.decode_gray
    if pnm.is_pnm(raw):
        return pnm.decode_gray
    if raw[:4] == sunras.SIGNATURE:
        return sunras.decode_gray
    return None


def other_format(raw: bytes):
    """The name of a format cv2 or PIL reads and the port does not yet,
    or None."""
    if raw[:6] in (b"GIF87a", b"GIF89a"):
        return "GIF"
    if raw[:4] == b"RIFF":
        return "WebP" if raw[8:12] == b"WEBP" else "RIFF"
    if raw[:4] == b"\xff\x4f\xff\x51" or raw[:12] == b"\x00\x00\x00\x0cjP  \r\n\x87\n":
        return "JPEG 2000"
    if raw[4:8] == b"ftyp" and raw[8:12] in (b"avif", b"avis"):
        return "AVIF"
    if raw[:10] in (b"#?RADIANCE", b"#?RGBE\n\n\n\n"[:10]) or raw[:6] == b"#?RGBE":
        return "HDR"
    if raw[:4] in (b"\x00\x00\x01\x00", b"\x00\x00\x02\x00"):
        return "ICO"
    if len(raw) >= 4 and raw[0] == 0x0A and raw[1] in (0, 2, 3, 4, 5) and raw[2] == 1:
        return "PCX"
    if raw[-18:] == b"TRUEVISION-XFILE.\x00" or (
            len(raw) >= 18 and raw[1] in (0, 1) and raw[2] in (1, 2, 3, 9, 10, 11)
            and raw[16] in (8, 15, 16, 24, 32)):
        return "TGA"
    return None


def decode_grayscale(raw: bytes, path="<bytes>") -> np.ndarray:
    """(H, W) uint8 gray of an image file's bytes; a ``ValueError`` for
    bytes no reader takes."""
    reader = _reader(raw)
    if reader is not None:
        return reader(raw, path)
    name = other_format(raw)
    if name is not None:
        raise ValueError(f"{path}: {name} image, {NOT_YET}")
    raise ValueError(f"{path}: not a PNG or JPEG file, nor a TIFF, BMP, Netpbm or Sun raster "
                     f"one")


def load_grayscale(path) -> np.ndarray:
    """Decode the image file at ``path`` to (H, W) uint8 grayscale."""
    with open(path, "rb") as f:
        raw = f.read()
    return decode_grayscale(raw, str(path))

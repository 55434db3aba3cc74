"""Image files to 8-bit grayscale by their content, as ``cv2.imread(path,
cv2.IMREAD_GRAYSCALE)`` reads them: the PNG signature goes to `png`, the
JPEG signature (SOI and the start of a marker) to `jpeg`, whatever the
file's name (the JAX package's tests write PNG bytes under ``.jpg``
names)."""

from __future__ import annotations

import numpy as np

from xfmamba_tpu_torch.data import jpeg, png


def decode_grayscale(raw: bytes, path="<bytes>") -> np.ndarray:
    """(H, W) uint8 gray of PNG or JPEG bytes; anything else raises a
    ``ValueError``."""
    if raw[:8] == png.SIGNATURE:
        return png.decode_gray(raw, path)
    if raw[:3] == jpeg.SIGNATURE:
        return jpeg.decode_gray(raw, path)
    raise ValueError(f"{path}: not a PNG or JPEG file")


def load_grayscale(path) -> np.ndarray:
    """Decode the PNG or JPEG file at ``path`` to (H, W) uint8 grayscale."""
    with open(path, "rb") as f:
        raw = f.read()
    return decode_grayscale(raw, str(path))

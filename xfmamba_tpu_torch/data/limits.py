"""The image-size limits of the two readers the port follows.

cv2's ``imread`` asserts sides of 1 to 2^20 pixels and at most 2^30
pixels in all (imgcodecs' ``validateInputImageSize``) once a decoder has
read the header, so the JAX package's ``load_grayscale`` raises there
instead of trying PIL.  PIL refuses an image of more than 2 x 89,478,485
pixels (``Image._decompression_bomb_check``).
"""

from __future__ import annotations

CV2_MAX_SIDE = 1 << 20
CV2_MAX_PIXELS = 1 << 30
PIL_MAX_PIXELS = 2 * 89478485


class TooLarge(ValueError):
    """A header past cv2's limits: the oracle raises, so the port does."""


def check_cv2(width: int, height: int) -> None:
    """Raise `TooLarge` where cv2's imread asserts after the header."""
    if not (0 < width <= CV2_MAX_SIDE and 0 < height <= CV2_MAX_SIDE) or \
            width * height > CV2_MAX_PIXELS:
        raise TooLarge(f"{width} x {height} pixels, past cv2's limits (2^20 a side, 2^30 "
                       f"pixels)")


def pil_ok(width: int, height: int) -> bool:
    return width * height <= PIL_MAX_PIXELS

"""NYU-style breast-region cropping (host-side numpy/scipy; a copy of
``xfmamba_tpu/data/nyu_cropping.py``).

Functional equivalent of the reference's ``libs/nyu_cropping.py`` (itself
from the NYU breast-cancer screening codebase): threshold > 0, binary
erosion (default 100 iterations) to kill thin background lines, largest
connected component, dilation to recover, buffered bounding box, and a
breast-side sanity distance.  Plus the integral-image optimal-window search
that ``libs/calc_optimal_centers.py`` provides (window center maximizing
mask mass).

Only the bounding box feeds the DDSM pipeline (`_crop2`,
``dataset_ddsmxray_twoview.py:337-341``); the rest is exposed for API
parity, and tests/test_torch_cropping.py holds all of it to the JAX
package's copy.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import scipy.ndimage as ndi


def largest_connected_component(mask: np.ndarray) -> np.ndarray:
    labeled, n = ndi.label(mask)
    if n == 0:
        return mask
    sizes = ndi.sum_labels(np.ones_like(labeled), labeled,
                           index=np.arange(1, n + 1))
    return labeled == (1 + int(np.argmax(sizes)))


def fast_binary_erosion(mask: np.ndarray, iterations: int) -> np.ndarray:
    """Exactly ``ndi.binary_erosion(mask, iterations=N)`` for the default
    cross-shaped structuring element, in ONE pass: a pixel survives N
    erosions iff its taxicab distance to the nearest background pixel
    exceeds N.  ~N× less work than scipy's iterated passes — the erosion
    dominates the DDSM NYU-crop host cost (100 iterations over multi-MP
    scans, `dataset_ddsmxray_twoview.py:327-341`'s `_crop2`)."""
    mask = np.asarray(mask, bool)
    if iterations <= 0:
        return mask.copy()
    # border_value=0 in scipy: treat outside-the-frame as background, so
    # pad with a zero ring before the distance transform
    padded = np.pad(mask, 1)
    dist = ndi.distance_transform_cdt(padded, metric="taxicab")
    return dist[1:-1, 1:-1] > iterations


def fast_binary_dilation(mask: np.ndarray, iterations: int) -> np.ndarray:
    """Exactly ``ndi.binary_dilation(mask, iterations=N)`` (cross-shaped
    element) via one taxicab distance transform of the complement."""
    mask = np.asarray(mask, bool)
    if iterations <= 0:
        return mask.copy()
    dist = ndi.distance_transform_cdt(~mask, metric="taxicab")
    return dist <= iterations


def crop_img_from_largest_connected(
        img: np.ndarray, mode: str, erode_dialate: bool = True,
        iterations: int = 100, buffer_size: int = 50,
        find_rightmost_from_ratio: float = 1 / 3):
    """Returns (window_location, rightmost_points, bottommost_points,
    distance_from_starting_side) — same contract as the reference
    (`nyu_cropping.py:141-217`)."""
    assert mode in ("left", "right")
    H, W = img.shape
    mask = img > 0
    if erode_dialate:
        mask = fast_binary_erosion(mask, iterations)
    largest = largest_connected_component(mask)
    if erode_dialate:
        largest = fast_binary_dilation(largest, iterations)

    rows = np.flatnonzero(largest.any(axis=1))
    cols = np.flatnonzero(largest.any(axis=0))
    if rows.size == 0 or cols.size == 0:
        return (0, H, 0, W), ((0, 0), 0), (0, (0, 0)), 0
    y_top, y_bottom = int(rows[0]), int(rows[-1]) + 1
    x_left, x_right = int(cols[0]), int(cols[-1]) + 1

    # breast must touch its anatomical side of the frame
    distance_from_starting_side = (x_left if mode == "left"
                                   else W - x_right)

    y_top = max(0, y_top - buffer_size)
    y_bottom = min(H, y_bottom + buffer_size)
    x_left = max(0, x_left - buffer_size)
    x_right = min(W, x_right + buffer_size)

    crop = largest[y_top:y_bottom, x_left:x_right]
    ch, cw = crop.shape
    # orient so the breast points left, as the reference's helpers do
    oriented = crop if mode == "left" else crop[:, ::-1]

    # bottommost nonzero pixels
    brows = np.flatnonzero(oriented.any(axis=1))
    if brows.size:
        by = int(brows[-1])
        bxs = np.flatnonzero(oriented[by])
        bottommost = (by, (int(bxs[0]), int(bxs[-1])))
    else:
        bottommost = (0, (0, 0))

    # rightmost nonzero pixels within the lower portion of the image
    start_y = int(ch * (1 - find_rightmost_from_ratio))
    sub = oriented[start_y:]
    bcols = np.flatnonzero(sub.any(axis=0))
    if bcols.size:
        rx = int(bcols[-1])
        rys = np.flatnonzero(sub[:, rx]) + start_y
        rightmost = ((int(rys[0]), int(rys[-1])), rx)
    else:
        rightmost = ((0, 0), 0)

    return ((y_top, y_bottom, x_left, x_right), rightmost, bottommost,
            int(distance_from_starting_side))


def optimal_window_center(mask: np.ndarray,
                          window: Sequence[int]) -> Tuple[int, int]:
    """Center of the window of given (h, w) maximizing mask coverage — the
    integral-image optimizer of ``calc_optimal_centers.py``
    (`get_images_optimal_window_info:34`)."""
    h, w = int(window[0]), int(window[1])
    H, W = mask.shape
    h, w = min(h, H), min(w, W)
    ii = np.pad(np.cumsum(np.cumsum(mask.astype(np.int64), 0), 1),
                ((1, 0), (1, 0)))
    sums = (ii[h:, w:] - ii[:-h, w:] - ii[h:, :-w] + ii[:-h, :-w])
    top, left = np.unravel_index(int(np.argmax(sums)), sums.shape)
    return int(top + h // 2), int(left + w // 2)


def find_crop_center(img: np.ndarray, crop_size=(1024, 1024),
                     side: str = "left", view: str = "cc",
                     threshold: float = -0.999, iterations: int = 100,
                     buffer_size: int = 50):
    """Pick a crop center over the breast mask — the reference's full
    recipe (`nyu_cropping.py:219-270`): orient the breast left, threshold,
    erode/label/dilate to the largest component, buffered bbox, then the
    COM-anchored optimal-window search with a view-dependent constraint
    (cc: right edge pinned; mlo: bottom-right pinned).

    Returns ``((center_y, center_x), bbox, wininfo)`` with center_x mapped
    back to the original (unflipped) frame for ``side='right'``."""
    from xfmamba_tpu_torch.data import optimal_centers as oc

    x = img[:, ::-1] if side == "right" else img
    mask = fast_binary_erosion(x > threshold, iterations)
    mask = largest_connected_component(mask)
    mask = fast_binary_dilation(mask, iterations)

    rows = np.flatnonzero(mask.any(axis=1))
    cols = np.flatnonzero(mask.any(axis=0))
    if rows.size == 0 or cols.size == 0:
        bbox = (0, 0, mask.shape[0], mask.shape[1])
    else:
        bbox = (int(rows[0]), int(cols[0]),
                int(rows[-1]) + 1, int(cols[-1]) + 1)
    ymax = max(0, min(bbox[2] + buffer_size, mask.shape[0]))
    xmax = max(0, min(bbox[3] + buffer_size, mask.shape[1]))

    if view == "cc":
        constraint = oc.get_rightmost_pixel_constraint(rightmost_x=xmax)
    else:
        assert view == "mlo"
        constraint = oc.get_bottomrightmost_pixel_constraint(
            rightmost_x=xmax, bottommost_y=ymax)

    wininfo = oc.get_image_optimal_window_info(
        image=mask, com=np.array(mask.shape) // 2,
        window_dim=np.array(crop_size), tl_br_constraint=constraint)
    cy, cx = int(wininfo["best_center_y"]), int(wininfo["best_center_x"])
    if side == "right":
        cx = x.shape[1] - cx
    return (cy, cx), bbox, wininfo

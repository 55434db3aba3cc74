"""Integral-image optimal-window search (a copy of
``xfmamba_tpu/data/optimal_centers.py`` without pandas) — the API of the
reference's NYU module (``libs/calc_optimal_centers.py``, itself from
nyukat/breast_cancer_classifier).

Given a binary-izable image, a center-of-mass anchor and candidate window
sizes, finds the window position that maximizes the number of nonzero
pixels, searching a step-grid of centers anchored at the COM and
tie-breaking toward the COM.  Exposes the same public surface:

- ``get_images_optimal_window_info(image, com, window_dim_ls, ...)`` ->
  one row per window size (`calc_optimal_centers.py:34`): a list of dicts
  here, the JAX package's pandas DataFrame's rows
- ``get_image_optimal_window_info(...)`` -> dict for one window size (`:53`)
- ``get_image_cumsum(image)`` (`:100`)
- ``get_rightmost_pixel_constraint`` / ``get_bottomrightmost_pixel_constraint``
  (`:187`, `:211`) — tl/br grid remappers used by `nyu_cropping`

Implementation is a fresh numpy formulation: one zero-padded 2-D integral
image, vectorized candidate evaluation (the reference builds four
selector-masked corner slices; the pad row/column makes those branches
unnecessary), same results.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np


def get_image_cumsum(image: np.ndarray) -> np.ndarray:
    """2-D inclusive prefix sum of ``image > 0`` (the reference's cumsum
    layout, no padding — kept for API compatibility)."""
    return np.cumsum(np.cumsum(image > 0, axis=0), axis=1)


def _padded_integral(cumsum: np.ndarray) -> np.ndarray:
    """Zero-pad the inclusive cumsum so window sums need no edge cases."""
    return np.pad(cumsum, ((1, 0), (1, 0)))


def _window_sums(pad_ii: np.ndarray, tl: np.ndarray,
                 br: np.ndarray) -> np.ndarray:
    """Nonzero-pixel count of [tl, br) windows, vectorized over rows of
    tl/br (the reference's ``v_get_topleft_bottomright_partialsum``)."""
    y0, x0 = tl[:, 0], tl[:, 1]
    y1, x1 = br[:, 0], br[:, 1]
    return (pad_ii[y1, x1] - pad_ii[y0, x1]
            - pad_ii[y1, x0] + pad_ii[y0, x0]).astype(np.float64)


def _candidate_center_bounds(com: np.ndarray, image_dim: np.ndarray,
                             window_dim: np.ndarray, step: int):
    """Inclusive-exclusive [tl, br) bounds of the COM-anchored candidate
    center grid; degenerate axes collapse to the COM
    (`calc_optimal_centers.py:111-131` semantics)."""
    half = window_dim // 2
    rem = window_dim - half
    lo = com - step * ((com - half) // step)
    hi = com + step * ((image_dim - rem - com) // step)
    for ax in range(2):
        if lo[ax] >= hi[ax]:
            lo[ax] = hi[ax] = com[ax]
    return lo, hi + 1


def _feasible_windows(centers: np.ndarray, image_dim: np.ndarray,
                      window_dim: np.ndarray):
    """Array-indexable [tl, br) of each candidate window: windows poking
    off the top/left shift inward by the overhang; the bottom/right edge
    clips (implicit zero padding) — reference `:134-148`."""
    half = window_dim // 2
    rem = window_dim - half
    tl = centers - half
    shift = np.clip(-tl, 0, None)
    tl = np.clip(tl, 0, None)
    br = np.minimum(centers + rem + shift, image_dim)
    return tl, br


def get_image_optimal_window_info(image: np.ndarray, com: np.ndarray,
                                  window_dim: np.ndarray, step: int = 1,
                                  tl_br_constraint: Optional[Callable] = None,
                                  cumsum: Optional[np.ndarray] = None):
    """Best window center (and covered fraction) for one window size."""
    image_dim = np.asarray(image.shape)
    com = np.asarray(com)
    window_dim = np.asarray(window_dim)
    if cumsum is None:
        cumsum = get_image_cumsum(image)
    pad_ii = _padded_integral(cumsum)

    lo, hi = _candidate_center_bounds(com, image_dim, window_dim, step)
    if tl_br_constraint:
        lo, hi = tl_br_constraint(tl=lo, br=hi, image=image,
                                  window_dim=window_dim)
    ys = np.arange(lo[0], hi[0], step)
    xs = np.arange(lo[1], hi[1], step)
    centers = np.stack(np.meshgrid(ys, xs, indexing="ij"),
                       -1).reshape(-1, 2)

    tl, br = _feasible_windows(centers, image_dim, window_dim)
    sums = _window_sums(pad_ii, tl, br)
    area = float(np.prod(window_dim))

    if len(sums) == 1:
        best_center = lo
        fraction = sums[0] / area
    else:
        best = sums.max()
        tied = centers[sums == best]
        if len(tied) == 1:
            best_center = tied[0]
        else:
            off = tied - com
            best_center = com + off[np.argmin((off ** 2).sum(1))]
        fraction = best / area
    return {
        "window_dim_y": window_dim[0],
        "window_dim_x": window_dim[1],
        "best_center_y": best_center[0],
        "best_center_x": best_center[1],
        "fraction": fraction,
    }


def get_images_optimal_window_info(image: np.ndarray, com: np.ndarray,
                                   window_dim_ls: Sequence, step: int = 1,
                                   tl_br_constraint: Optional[Callable]
                                   = None):
    """One row (a dict) per window size, sharing one integral image."""
    cumsum = get_image_cumsum(image)
    rows = [get_image_optimal_window_info(
        image, com, np.asarray(wd), step=step,
        tl_br_constraint=tl_br_constraint, cumsum=cumsum)
        for wd in window_dim_ls]
    return rows


def get_rightmost_pixel_constraint(rightmost_x: int) -> Callable:
    """Pin the window's right edge at ``rightmost_x`` (2-D search -> 1-D
    over y); reference `:187-208`, including its off-by-one center quirk."""

    def _f(tl, br, image, window_dim, rightmost_x_=rightmost_x):
        if tl[1] == br[1]:
            return tl, br
        tl, br = tl.copy(), br.copy()
        new_x = rightmost_x_ - window_dim[1] // 2
        tl[1] = new_x - 1
        br[1] = new_x
        return tl, br

    return _f


def get_bottomrightmost_pixel_constraint(rightmost_x: int,
                                         bottommost_y: int) -> Callable:
    """Pin the window's bottom-right at (bottommost_y, rightmost_x),
    tightening bottommost_y to the last nonzero row within the rightmost
    window_dim_x columns (reference `:211-236`) — a single-candidate
    grid."""

    def _f(tl, br, image, window_dim,
           by_=bottommost_y, rx_=rightmost_x):
        right_cols = image[:, -window_dim[1]:]
        nz_rows = np.flatnonzero((right_cols != 0).any(axis=1))
        if nz_rows.size:
            by_ = min(int(nz_rows[-1]), by_)
        br = np.array([by_, rx_]) - window_dim // 2
        return br - 1, br

    return _f

"""Cross-scan / cross-merge: the four 2-D traversal orders of VMamba's SS2D
(port of ``xfmamba_tpu/ops/cross_scan.py``, :37-69), on channels-last maps.

The four directions of ``scans=0`` ("cross2d") are

    k=0 : row-major (H then W)            k=1 : column-major (W then H)
    k=2 : row-major reversed              k=3 : column-major reversed

``scans=1`` ("unidi") repeats the row-major traversal four times;
``scans=2`` ("bidi") uses [row, row, row reversed, row reversed].  The
SSD path (``models/ss2d.py``, forward type ``m0``) and the xv family
materialise the four traversals with these; autograd gives their exact
adjoints (the backward of a scan is a merge and vice versa).  The
one-by-one forms (`cross_scan_1b1`, `cross_merge_1b1`, :72-104) traverse
each of four inputs in its own direction; `directional_scan_2d` (:107) runs
a callee per direction without materialising the flips and merges in
``cross_merge``'s order.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def _transpose_hw(x):
    return x.transpose(1, 2)


def cross_scan(x: torch.Tensor, scans: int = 0) -> torch.Tensor:
    """x (B, H, W, C) -> xs (B, 4, L, C), L = H * W."""
    B, H, W, C = x.shape
    L = H * W
    row = x.reshape(B, L, C)
    if scans == 0:
        col = x.transpose(1, 2).reshape(B, L, C)
        return torch.stack([row, col, row.flip(1), col.flip(1)], dim=1)
    if scans == 1:
        return row.unsqueeze(1).repeat(1, 4, 1, 1)
    if scans == 2:
        rev = row.flip(1)
        return torch.stack([row, row, rev, rev], dim=1)
    raise ValueError(f"unsupported scans={scans}")


def cross_merge(ys: torch.Tensor, H: int, W: int, scans: int = 0) -> torch.Tensor:
    """ys (B, 4, L, C) -> y (B, L, C): each direction back to row-major
    order, summed as the reference does, (y0 + y2) + T^-1(y1 + y3) for
    cross2d."""
    B, K, L, C = ys.shape
    if K != 4 or L != H * W:
        raise ValueError(f"ys {tuple(ys.shape)} is not four traversals of {H} x {W}")
    if scans == 0:
        y02 = ys[:, 0] + ys[:, 2].flip(1)
        y13 = ys[:, 1] + ys[:, 3].flip(1)
        y13 = y13.reshape(B, W, H, C).transpose(1, 2).reshape(B, L, C)
        return y02 + y13
    if scans == 1:
        return ys.sum(1)
    if scans == 2:
        return (ys[:, 0] + ys[:, 2].flip(1)) + (ys[:, 1] + ys[:, 3].flip(1))
    raise ValueError(f"unsupported scans={scans}")


def cross_scan_1b1(xs: torch.Tensor, scans: int = 0) -> torch.Tensor:
    """xs (B, 4, H, W, C) -> (B, 4, L, C): input k traversed in direction k."""
    B, K, H, W, C = xs.shape
    if K != 4:
        raise ValueError(f"xs has {K} inputs, expected 4")
    L = H * W

    def r(k):
        return xs[:, k].reshape(B, L, C)

    def t(k):
        return _transpose_hw(xs[:, k]).reshape(B, L, C)

    if scans == 0:
        return torch.stack([r(0), t(1), r(2).flip(1), t(3).flip(1)], dim=1)
    if scans == 1:
        return xs.reshape(B, K, L, C)
    if scans == 2:
        return torch.stack([r(0), r(1), r(2).flip(1), r(3).flip(1)], dim=1)
    raise ValueError(f"unsupported scans={scans}")


def cross_merge_1b1(ys: torch.Tensor, H: int, W: int, scans: int = 0) -> torch.Tensor:
    """The inverse of `cross_scan_1b1` without the sum: (B, 4, L, C), each
    direction back in row-major order."""
    B, K, L, C = ys.shape
    if K != 4 or L != H * W:
        raise ValueError(f"ys {tuple(ys.shape)} is not four traversals of {H} x {W}")

    def inv_t(y):
        return _transpose_hw(y.reshape(B, W, H, C)).reshape(B, L, C)

    if scans == 0:
        return torch.stack([ys[:, 0], inv_t(ys[:, 1]), ys[:, 2].flip(1),
                            inv_t(ys[:, 3].flip(1))], dim=1)
    if scans == 1:
        return ys
    if scans == 2:
        return torch.stack([ys[:, 0], ys[:, 1], ys[:, 2].flip(1), ys[:, 3].flip(1)], dim=1)
    raise ValueError(f"unsupported scans={scans}")


def directional_scan_2d(scan_fn: Callable, H: int, W: int, per_dir_inputs: Sequence,
                        scans: int = 0) -> torch.Tensor:
    """Cross-scan, scan and cross-merge without flips: ``scan_fn(k,
    inputs_k, transposed, reverse)`` returns y (B, L, C) in the order it was
    given (column-major directions get and return the W-major order, the
    reversed ones scan backwards in place).  Directions: k=0 row-major, k=1
    column-major, k=2 row-major reversed, k=3 column-major reversed for
    cross2d; the merge order is `cross_merge`'s, (y0 + y2) + T^-1(y1 + y3)."""
    if scans == 0:
        y0 = scan_fn(0, per_dir_inputs[0], False, False)
        y2 = scan_fn(2, per_dir_inputs[2], False, True)
        y1 = scan_fn(1, per_dir_inputs[1], True, False)
        y3 = scan_fn(3, per_dir_inputs[3], True, True)
        y13 = y1 + y3
        B, L, C = y13.shape
        return (y0 + y2) + _transpose_hw(y13.reshape(B, W, H, C)).reshape(B, L, C)
    if scans == 1:
        ys = [scan_fn(k, per_dir_inputs[k], False, False) for k in range(4)]
        return ((ys[0] + ys[1]) + ys[2]) + ys[3]
    if scans == 2:
        y0 = scan_fn(0, per_dir_inputs[0], False, False)
        y1 = scan_fn(1, per_dir_inputs[1], False, False)
        y2 = scan_fn(2, per_dir_inputs[2], False, True)
        y3 = scan_fn(3, per_dir_inputs[3], False, True)
        return (y0 + y2) + (y1 + y3)
    raise ValueError(f"unsupported scans={scans}")

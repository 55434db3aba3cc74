"""Cross-scan / cross-merge: the four 2-D traversal orders of VMamba's SS2D
(port of ``xfmamba_tpu/ops/cross_scan.py``, :37-69), on channels-last maps.

The four directions of ``scans=0`` ("cross2d") are

    k=0 : row-major (H then W)            k=1 : column-major (W then H)
    k=2 : row-major reversed              k=3 : column-major reversed

``scans=1`` ("unidi") repeats the row-major traversal four times;
``scans=2`` ("bidi") uses [row, row, row reversed, row reversed].  The
SSD path (``models/ss2d.py``, forward type ``m0``) materialises the four
traversals with these; autograd gives their exact adjoints (the backward of
a scan is a merge and vice versa).
"""

from __future__ import annotations

import torch


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

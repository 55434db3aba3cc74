"""Selective-scan (Mamba S6) recurrence, sequential form (port of
``xfmamba_tpu/ops/selective_scan.py::selective_scan_seq``).

    delta' = softplus(delta + delta_bias)
    h[t]   = exp(delta'[t] * A) * h[t-1] + delta'[t] * B[t] * u[t]
    y[t]   = <C[t], h[t]> + D * u[t]

Time-major, channel-last layout: u/delta (B, L, KC), A (KC, N), B/C
(B, L, K, N) shared by each group of KC // K channels.  Float32 state.  This
is the plain oracle that every scan kernel of the port is checked against.
"""

from __future__ import annotations

import torch

from xfmamba_tpu_torch.ops.fast_math import exp, softplus


def selective_scan_seq(u, delta, A, Bmat, Cmat, D=None, delta_bias=None,
                       delta_softplus=True, reverse=False):
    """Sequential scan; returns (B, L, KC) float32.  ``reverse`` scans from
    the last position to the first (flip, scan, flip)."""
    u = u.float()
    delta = delta.float()
    if delta_bias is not None:
        delta = delta + delta_bias.float()
    if delta_softplus:
        delta = softplus(delta)
    Bsz, L, KC = u.shape
    K = Bmat.shape[2]
    Bx = Bmat.float().repeat_interleave(KC // K, dim=2)      # (B, L, KC, N)
    Cx = Cmat.float().repeat_interleave(KC // K, dim=2)
    dA = exp(delta[..., None] * A.float())            # (B, L, KC, N)
    dBu = delta[..., None] * Bx * u[..., None]
    h = torch.zeros(Bsz, KC, A.shape[1], dtype=torch.float32, device=u.device)
    ys = torch.empty(Bsz, L, KC, dtype=torch.float32, device=u.device)
    steps = range(L - 1, -1, -1) if reverse else range(L)
    for t in steps:
        h = dA[:, t] * h + dBu[:, t]
        ys[:, t] = (h * Cx[:, t]).sum(-1)
    if D is not None:
        ys = ys + u * D.float()
    return ys

"""Selective-scan (Mamba S6) recurrence (port of
``xfmamba_tpu/ops/selective_scan.py``): the sequential form
`selective_scan_seq`, the log-step form `selective_scan` and the
reference-layout wrapper `selective_scan_torch_layout`.

    delta' = softplus(delta + delta_bias)
    h[t]   = exp(delta'[t] * A) * h[t-1] + delta'[t] * B[t] * u[t]
    y[t]   = <C[t], h[t]> + D * u[t]

Time-major, channel-last layout: u/delta (B, L, KC), A (KC, N), B/C
(B, L, K, N) shared by each group of KC // K channels.  Float32 state.
`selective_scan_seq` is the plain oracle that every scan kernel of the port
is checked against.  `selective_scan` computes the same function in
ceil(log2 L) steps over the pairs (a, b) of h[t] = a[t] h[t-1] + b[t], the
associative scan of the JAX package (``selective_scan``, :112), and is
differentiable by autograd.  No model calls it: the SS2D modes that JAX
runs through it (cascade2d, the xv family) scan with kernels 13/14
(``ops/selective_scan_grouped.py::selective_scan_auto``), whose plain
versions serve CPU tensors.
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


def _combine_log_step(a, b):
    """Inclusive scan of h[t] = a[t] h[t-1] + b[t] along axis 1 with h[-1]
    = 0: at step d every position t >= d folds in the pair d places
    earlier, (a, b)[t] <- (a[t] a[t-d], a[t] b[t-d] + b[t])."""
    L = a.shape[1]
    d = 1
    while d < L:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def selective_scan(u, delta, A, Bmat, Cmat, D=None, delta_bias=None,
                   delta_softplus=True, reverse=False):
    """The log-step scan (see the module docstring), shapes as
    `selective_scan_seq`; ``reverse`` scans from the last position to the
    first.  Returns (B, L, KC) float32."""
    u = u.float()
    delta = delta.float()
    if delta_bias is not None:
        delta = delta + delta_bias.float()
    if delta_softplus:
        delta = softplus(delta)
    KC = u.shape[2]
    K = Bmat.shape[2]
    Bx = Bmat.float().repeat_interleave(KC // K, dim=2)      # (B, L, KC, N)
    Cx = Cmat.float().repeat_interleave(KC // K, dim=2)
    a = exp(delta[..., None] * A.float())
    b = delta[..., None] * Bx * u[..., None]
    if reverse:
        h = _combine_log_step(a.flip(1), b.flip(1)).flip(1)
    else:
        h = _combine_log_step(a, b)
    y = (h * Cx).sum(-1)
    if D is not None:
        y = y + u * D.float()
    return y


def selective_scan_torch_layout(u, delta, A, Bmat, Cmat, D=None, delta_bias=None,
                                delta_softplus=True, impl=None):
    """The reference's layout: u / delta (B, KC, L), B / C (B, K, N, L);
    returns (B, KC, L) float32 from ``impl`` (default `selective_scan`)."""
    fn = impl or selective_scan
    y = fn(u.transpose(1, 2), delta.transpose(1, 2), A, Bmat.permute(0, 3, 1, 2),
           Cmat.permute(0, 3, 1, 2), D, delta_bias, delta_softplus)
    return y.transpose(1, 2)

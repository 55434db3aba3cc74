"""Mamba-2 / SSD (state-space duality) chunked scan, the einsum formulation
(port of ``xfmamba_tpu/ops/ssd.py``, :41-196).

`ssd_chunk_scan` computes ``h[t] = exp(dt A) h[t-1] + dt B[t] x[t]``,
``y[t] = C[t] . h[t] (+ D x[t])`` chunk by chunk: a quadratic form inside
each chunk, state passing between chunks.  It is the semantics oracle of
kernel 15 (``ops/ssd_chunk.py``) and the route that ``models/ss2d.py``
takes outside ``ssd_supported``, as the JAX package takes its XLA form
there.  Its calls are counted in ``ssd_chunk_scan.calls``.

The JAX package writes the intra-chunk term as one four-operand einsum.
Here each step is written out (C B^T, the decay mask, batched products), so
the memory it takes is known: the (b, h, n_chunks, l, l) mask and products
are the largest tensors, 0.6 GB each at 32 images of a 56 x 56 map with 24
heads.  All arithmetic is float32; y returns in x's dtype.

``selective_state_update``, the gated norms, ``swiglu``, ``causal_conv1d``
and ``mamba_split_conv1d_scan`` of the JAX module are not on the m0 path
and are not ported yet.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from xfmamba_tpu_torch.ops.cost import flops_ssd_chunk_scan, reports_cost


def segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T) with ``out[..., i, j] = sum_{j < r <= i} x[r]``
    for i >= j and -inf above the diagonal."""
    T = x.shape[-1]
    r = torch.arange(T, device=x.device)[:, None]
    c = torch.arange(T, device=x.device)[None, :]
    xx = x[..., :, None].expand(*x.shape, T)
    xx = torch.where(r > c, xx, torch.zeros((), dtype=x.dtype, device=x.device))
    s = torch.cumsum(xx, dim=-2)
    return torch.where(r >= c, s, torch.full((), -math.inf, dtype=x.dtype, device=x.device))


def _pick_chunk_size(seqlen: int, chunk_size: int) -> int:
    """Halve chunk_size until it divides seqlen."""
    while seqlen % chunk_size != 0:
        chunk_size >>= 1
        if chunk_size == 0:
            raise ValueError(f"no chunk size divides seqlen={seqlen}")
    return chunk_size


@reports_cost(lambda x, dt, A, B, C, chunk_size, *args, **kwargs: flops_ssd_chunk_scan(
    *x.shape[:3], x.shape[3], B.shape[-1], chunk_size))
def ssd_chunk_scan(x, dt, A, B, C, chunk_size, D=None, z=None, dt_bias=None,
                   initial_states=None, dt_softplus=False, dt_limit=(0.0, math.inf),
                   return_final_states=False):
    """Chunked SSD scan.  x (b, s, h, p); dt (b, s, h); A (h,), negative
    decay rates; B, C (b, s, g, n) with g dividing h; D (h,) or (h, p);
    z (b, s, h, p), a SiLU gate; dt_bias (h,); initial_states (b, h, p, n).
    The chunk is halved until it divides s.  Returns y (b, s, h, p) in x's
    dtype and, with ``return_final_states``, the final state (b, h, p, n)
    float32."""
    ssd_chunk_scan.calls += 1
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if h % g:
        raise ValueError(f"{h} heads do not split into {g} groups")
    chunk = _pick_chunk_size(s, chunk_size)
    nc = s // chunk
    f32 = torch.float32

    xf = x.to(f32)
    dtf = dt.to(f32)
    if dt_bias is not None:
        dtf = dtf + dt_bias.to(f32)
    if dt_softplus:
        dtf = torch.logaddexp(dtf, torch.zeros((), dtype=f32, device=dtf.device))
    lo, hi = dt_limit
    if lo > 0.0 or hi < math.inf:
        dtf = torch.clamp(dtf, min=lo, max=None if math.isinf(hi) else hi)
    if h != g:
        B = B.repeat_interleave(h // g, dim=2)
        C = C.repeat_interleave(h // g, dim=2)

    # (b, h, nc, l, .): heads ahead of chunks, so that every product is a
    # batched matmul over (b, h, nc)
    def heads_first(t):
        return t.reshape(b, nc, chunk, h, -1).permute(0, 3, 1, 2, 4)

    X = heads_first(xf * dtf[..., None])                     # dt x
    Bc, Cc = heads_first(B.to(f32)), heads_first(C.to(f32))
    w = (A.to(f32) * dtf).reshape(b, nc, chunk, h).permute(0, 3, 1, 2)   # (b, h, nc, l)
    w_cumsum = torch.cumsum(w, dim=-1)

    # 1. inside each chunk: (C B^T * exp(segsum)) @ X
    M = (Cc @ Bc.transpose(-1, -2)) * torch.exp(segsum(w))
    y_diag = M @ X                                           # (b, h, nc, l, p)
    del M

    # 2. the state each chunk adds: (X * decay)^T @ B
    decay_states = torch.exp(w_cumsum[..., -1:] - w_cumsum)
    states = (X * decay_states[..., None]).transpose(-1, -2) @ Bc    # (b, h, nc, p, n)

    # 3. passing between chunks: one product over chunk boundaries
    if initial_states is None:
        init = torch.zeros(b, h, 1, p, n, dtype=f32, device=x.device)
    else:
        init = initial_states.to(f32)[:, :, None]
    states = torch.cat([init, states], dim=2)                # (b, h, nc + 1, p, n)
    chunk_decay = F.pad(w_cumsum[..., -1], (1, 0))           # (b, h, nc + 1)
    decay_chunk = torch.exp(segsum(chunk_decay))             # (b, h, nc + 1, nc + 1)
    new_states = (decay_chunk @ states.reshape(b, h, nc + 1, p * n)).reshape(b, h, nc + 1, p, n)
    states, final_state = new_states[:, :, :-1], new_states[:, :, -1]

    # 4. each chunk's entering state read out by C
    y_off = (Cc @ states.transpose(-1, -2)) * torch.exp(w_cumsum)[..., None]

    y = (y_diag + y_off).permute(0, 2, 3, 1, 4).reshape(b, s, h, p)
    if D is not None:
        Df = D.to(f32)
        y = y + (Df[:, None] if Df.dim() == 1 else Df) * xf
    if z is not None:
        y = y * F.silu(z.to(f32))
    y = y.to(x.dtype)
    if return_final_states:
        return y, final_state
    return y


ssd_chunk_scan.calls = 0

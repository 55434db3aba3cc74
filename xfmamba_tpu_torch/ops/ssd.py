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

The rest of the JAX module (:199-384), in plain torch as JAX's are XLA:
``selective_state_update`` (one decode step, functional), the gated norms
``layernorm_gated`` / ``rmsnorm_gated``, ``swiglu``, ``causal_conv1d``, and
``mamba_split_conv1d_scan``, the fused split-conv1d entry, whose scan runs
on kernels 15/16 (``ops/ssd_chunk.py::ssd_chunk_scan_heads``) wherever
``ssd_supported`` holds, the SiLU gate applied to the kernels' y outside
them, and on `ssd_chunk_scan` elsewhere.  None of them is on a model's
path (the JAX package's models call none of them either).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from xfmamba_tpu_torch.ops import ssd_chunk
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


# the reference's public name (``ssd_minimal.py:144-146``)
selective_scan_chunk_fn = ssd_chunk_scan


def selective_state_update(state, x, dt, A, B, C, D=None, z=None, dt_bias=None,
                           dt_softplus=False):
    """One decode step, functional: state' = state exp(dt A) + dt B x,
    y = state' . C + D x (times silu(z)).  state (batch, ..., dim, n);
    x, dt (batch, ..., dim); A (..., dim, n) or (..., dim); B, C
    (batch, ..., n), shared over dim.  Returns (state' float32, y in x's
    dtype)."""
    f32 = torch.float32
    state, xf, dtf = state.to(f32), x.to(f32), dt.to(f32)
    if dt_bias is not None:
        dtf = dtf + dt_bias.to(f32)
    if dt_softplus:
        dtf = F.softplus(dtf)
    Af = A.to(f32)
    if Af.dim() == state.dim() - 2:
        Af = Af[..., None]
    new_state = state * torch.exp(dtf[..., None] * Af) + \
        dtf[..., None] * B.to(f32)[..., None, :] * xf[..., None]
    y = (new_state * C.to(f32)[..., None, :]).sum(-1)
    if D is not None:
        y = y + D.to(f32) * xf
    if z is not None:
        y = y * F.silu(z.to(f32))
    return new_state, y.to(x.dtype)


def layernorm_gated(x, weight, bias=None, z=None, eps: float = 1e-5, group_size=None,
                    norm_before_gate: bool = True, is_rms_norm: bool = False):
    """LayerNorm (or RMSNorm) over groups of ``group_size`` channels (all
    by default), gated by silu(z): norm(x) silu(z) with
    ``norm_before_gate``, else norm(x silu(z)).  Float32 inside, x's dtype
    out."""
    xf = x.to(torch.float32)
    if z is not None and not norm_before_gate:
        xf = xf * F.silu(z.to(torch.float32))
    d = xf.shape[-1]
    gs = group_size or d
    if d % gs:
        raise ValueError(f"group size {gs} does not divide {d} channels")
    xg = xf.reshape(*xf.shape[:-1], d // gs, gs)
    if is_rms_norm:
        xg = xg * torch.rsqrt((xg * xg).mean(-1, keepdim=True) + eps)
    else:
        mu = xg.mean(-1, keepdim=True)
        xg = (xg - mu) * torch.rsqrt(((xg - mu) ** 2).mean(-1, keepdim=True) + eps)
    out = xg.reshape(xf.shape) * weight.to(torch.float32)
    if bias is not None:
        out = out + bias.to(torch.float32)
    if z is not None and norm_before_gate:
        out = out * F.silu(z.to(torch.float32))
    return out.to(x.dtype)


def rmsnorm_gated(x, weight, z=None, eps: float = 1e-5, group_size=None,
                  norm_before_gate: bool = True):
    """`layernorm_gated` as an RMSNorm, no bias."""
    return layernorm_gated(x, weight, None, z, eps, group_size, norm_before_gate,
                           is_rms_norm=True)


def swiglu(e, g):
    """silu(e) g."""
    return F.silu(e) * g


def causal_conv1d(x, weight, bias=None, activation=None):
    """Depthwise causal 1-D conv: x (batch, seqlen, d), weight (d, width),
    bias (d,); left padding of width - 1, then SiLU for ``activation``
    "silu" / "swish".  Float32 inside, x's dtype out."""
    if activation not in (None, "silu", "swish"):
        raise ValueError(f"activation {activation!r}: None, 'silu' or 'swish'")
    d, width = weight.shape
    out = F.conv1d(F.pad(x.to(torch.float32).transpose(1, 2), (width - 1, 0)),
                   weight.to(torch.float32)[:, None], None if bias is None else
                   bias.to(torch.float32), groups=d).transpose(1, 2)
    if activation is not None:
        out = F.silu(out)
    return out.to(x.dtype)


def _scan_on_kernels(x, dt, A, B, C, chunk_size, D, z, dt_bias, initial_states):
    """`ssd_chunk_scan` with softplus, no dt limit, on kernels 15/16 (or
    their plain twins for CPU tensors): the public layout packed for
    `ssd_chunk.ssd_chunk_scan_heads`, z's SiLU gate on the kernels' y.
    Returns (y, final state (b, h, p, n))."""
    b, s, h, p = x.shape
    args = ssd_chunk.pack_args(x, dt, A, B, C, D, dt_bias, initial_states)
    y, fin = ssd_chunk.ssd_chunk_scan_heads(*args, chunk=chunk_size)
    y = y.transpose(1, 2).reshape(b, s, h, p)
    if z is not None:
        y = (y.float() * F.silu(z.float())).to(x.dtype)
    return y, fin.transpose(2, 3)


def mamba_split_conv1d_scan(zxbcdt, conv1d_weight, conv1d_bias, dt_bias, A, D, chunk_size,
                            initial_states=None, dt_limit=(0.0, math.inf),
                            return_final_states=False, activation="silu",
                            rmsnorm_weight=None, rmsnorm_eps=1e-6, outproj_weight=None,
                            outproj_bias=None, headdim=None, ngroups=1,
                            norm_before_gate=True):
    """The fused split-conv1d SSD entry (``ssd_combined.py:760-984``
    semantics): ``zxbcdt`` (batch, seqlen, 2 d_nonssm + 2 dim + 2 ngroups
    dstate + nheads) splits into the swiglu pair, the gate z, the conv
    input of x, B and C, and dt; a causal depthwise conv, the SSD scan
    (kernels 15/16 where ``ssd_supported`` holds and dt is not limited),
    the gated group RMSNorm when ``rmsnorm_weight`` is given (the scan is
    then ungated), the swiglu channels in front, and the out projection
    (torch's Linear layout).  D (nheads,) with ``headdim``, or
    (nheads, headdim).  Returns out and, with ``return_final_states``, the
    final state (batch, nheads, headdim, dstate) float32."""
    if D.dim() == 1:
        if headdim is None:
            raise ValueError("a D of one value a head needs headdim")
        nheads = D.shape[0]
    else:
        nheads, headdim = D.shape
    batch, seqlen, packed = zxbcdt.shape
    dim = nheads * headdim
    if nheads % ngroups:
        raise ValueError(f"{nheads} heads do not split into {ngroups} groups")
    dstate = (conv1d_weight.shape[0] - dim) // ngroups // 2
    d_nonssm = (packed - 2 * dim - 2 * ngroups * dstate - nheads) // 2
    if d_nonssm < 0:
        raise ValueError(f"zxbcdt's {packed} channels are too few")
    zx0, z, xBC, dt = torch.split(
        zxbcdt, [2 * d_nonssm, dim, dim + 2 * ngroups * dstate, nheads], dim=-1)
    xBC = causal_conv1d(xBC, conv1d_weight, conv1d_bias, activation=activation)
    x, B, C = torch.split(xBC, [dim, ngroups * dstate, ngroups * dstate], dim=-1)
    x = x.reshape(batch, seqlen, nheads, headdim)
    B = B.reshape(batch, seqlen, ngroups, dstate)
    C = C.reshape(batch, seqlen, ngroups, dstate)
    zh = z.reshape(batch, seqlen, nheads, headdim) if rmsnorm_weight is None else None
    unlimited = dt_limit[0] <= 0.0 and math.isinf(dt_limit[1])
    if unlimited and ssd_chunk.ssd_supported(seqlen, nheads, headdim, dstate, ngroups,
                                             chunk_size):
        out, final = _scan_on_kernels(x, dt, A, B, C, chunk_size, D, zh, dt_bias,
                                      initial_states)
    else:
        out, final = ssd_chunk_scan(x, dt, A, B, C, chunk_size, D=D, z=zh, dt_bias=dt_bias,
                                    initial_states=initial_states, dt_softplus=True,
                                    dt_limit=dt_limit, return_final_states=True)
    out = out.reshape(batch, seqlen, dim)
    if rmsnorm_weight is not None:
        out = rmsnorm_gated(out, rmsnorm_weight, z=z, eps=rmsnorm_eps,
                            group_size=dim // ngroups, norm_before_gate=norm_before_gate)
    if d_nonssm > 0:
        out = torch.cat([swiglu(zx0[..., :d_nonssm], zx0[..., d_nonssm:]).to(out.dtype), out],
                        dim=-1)
    if outproj_weight is not None:
        out = out @ outproj_weight.t().to(out.dtype)
        if outproj_bias is not None:
            out = out + outproj_bias.to(out.dtype)
    elif outproj_bias is not None:
        raise ValueError("an out-projection bias needs its weight")
    return (out, final) if return_final_states else out

"""Kernels 15 and 16: the chunked SSD (Mamba-2) scan and its reverse-chunk
adjoint (port of ``xfmamba_tpu/ops/ssd_pallas.py``).

- Kernel 15, `ssd_fwd`: replaces ``_ssd_kernel`` (:74), called by
  ``_ssd_call`` (``pallas_call`` :211) for inference and by
  ``_ssd_call_train`` (:337), which also returns each chunk's start state,
  for training (``save_states``).  Per head h of group k, chunk by chunk::

      dt   = softplus(dt_raw + bias_h) * [row < L]        (threshold 20)
      cum  = inclusive cumsum of A_h dt over the chunk,  w_tot = cum[-1]
      M    = (C_c B_c^T) * exp(cum_i - cum_j) * [i >= j]
      y    = M (dt x) + (C_c state) * exp(cum) + D_h x
      state <- exp(w_tot) state + B_c^T ((dt x) * exp(w_tot - cum))

  with the state (N, P) per head carried from chunk to chunk.
- Kernel 16, `ssd_bwd`: replaces ``_ssd_bwd_kernel`` (:356, ``pallas_call``
  :581): the chunks in reverse from the checkpoints, every intra-chunk
  quantity recomputed, the state adjoint carried back; it returns dx, the
  gradient of the raw dt (through the softplus), dB and dC per group, dA,
  dbias and dD summed over the batch, and the initial state's gradient.
- `SSDChunkScanTrain`: the autograd op (the custom VJP
  ``ssd_chunk_scan_pallas_train``, :629-695), which `ssd_chunk_scan_heads`
  takes where gradients are asked for; `pack_args` (``_pack_args``,
  :605-626) gives its arguments from the public layout of ``ops/ssd.py``.
- `ssd_supported`: the JAX package's geometry gate (:228-237).
- `ssd_fwd_tiled` / `ssd_bwd_tiled`: every geometry the gate admits on the
  kernels, which take d_state up to `MAX_STATE` and head width up to
  `MAX_HEADDIM`: the head width is cut into slices of at most 32 (the
  columns of x, y and the state are independent) and d_state into tiles of
  at most 64 (y is linear in the sum over n of the C B and C state terms,
  so it is the sum of the tiles' outputs, the D skip carried by the first
  tile alone).  Backward: dx, ddt, dA and dbias are sums over the calls,
  dB and dC per tile sums over the slices, dD comes from the tile that
  carried D.  Where d_state takes more than one tile the calls run in
  float32 (the kernels' own arithmetic, on the same values), so y is
  rounded once.  `SSDChunkScanTrain` and `ssd_chunk_scan_heads` run them.

The port's layout is group-major, as SS2D's cross-scan gives it, so no
operand is transposed on the way in or out: x (b, g, L, R, P), dt
(b, g, L, R), B and C (b, g, L, N) for g groups of R heads (head
h = k * R + r reads group k's B and C); A and bias (g * R,), D (g * R, P),
float32.  States are (N, P) per head: the initial and final states
(b, g * R, N, P) and the checkpoints (b, g * R, n_chunks, N, P), float32.
x, dt, B and C share one dtype, float32 or bfloat16; y comes back in it and
everything else in float32.  A sequence that the chunk does not divide is
zero-padded (dt 0 past L: decay 1, contribution 0), as the Pallas kernel
pads, where ``ops/ssd.py`` halves its chunk instead: the two agree to
rounding.

Each wrapper takes its plain twin (``*_plain``, the same chunk loop in
PyTorch, checkpoints included; the backward replays the Pallas adjoint step
by step, not autograd) only for CPU tensors; on CUDA tensors it launches
the kernel, adds one to its ``launches`` count, or raises.
"""

from __future__ import annotations

import math

import torch

from xfmamba_tpu_torch.kernels import build
from xfmamba_tpu_torch.ops.fast_math import SOFTPLUS_THRESHOLD, softplus
from xfmamba_tpu_torch.ops.primitives import (
    dtype_code, on_cpu, ptr, require, require_cuda, stream)

# positions per chunk: the m0 path's chunk_size, and the only one the
# kernels take (their tiling of the chunk x chunk products is fixed)
CHUNK = 64
# the kernels' limits: the backward's shared memory per block
# (csrc/ssd_chunk.cu) holds N = 64 and P = 32 at one head per block
MAX_STATE = 64
MAX_HEADDIM = 32


def _head_tile(R: int, P: int) -> int:
    """The Pallas kernel's heads per grid step (``_head_tile``, :64-71)."""
    for t in (8, 6, 4, 3, 2, 1):
        if R % t == 0 and t * P <= 512:
            return t
    return 1


def ssd_supported(L, h, p, n, g, chunk=CHUNK) -> bool:
    """The JAX package's gate for its SSD kernels: h heads in g groups, head
    width p, state n, and a working set that fits the TPU's VMEM."""
    if h % g or n % 8 or n > 512 or p % 8 or p > 128 or chunk % 8:
        return False
    R_t = _head_tile(h // g, p)
    Lp = -(-L // chunk) * chunk
    est = (2 * Lp * R_t * p + 2 * Lp * n + R_t * n * p) * 4
    return est < 60 * 1024 * 1024


def _geometry(x, Bm, chunk):
    """(b, g, L, R, P, N, n_chunks) of a call."""
    b, g, L, R, P = x.shape
    if chunk < 1:
        raise ValueError(f"chunk {chunk} must be positive")
    return b, g, L, R, P, Bm.shape[-1], -(-L // chunk)


def _check(x, dt, A, Bm, Cm, D, bias, chunk):
    b, g, L, R, P, N, nc = _geometry(x, Bm, chunk)
    if chunk != CHUNK:
        raise ValueError(f"the SSD kernels take chunk {CHUNK}, not {chunk}")
    if N > MAX_STATE or P > MAX_HEADDIM or N % 2 or P % 2:
        raise ValueError(f"d_state {N} / head width {P}: the kernels take even values up to "
                         f"{MAX_STATE} / {MAX_HEADDIM}")
    require(x, (b, g, L, R, P), name="x")
    require(dt, (b, g, L, R), x.dtype, name="dt")
    require(Bm, (b, g, L, N), x.dtype, name="B")
    require(Cm, (b, g, L, N), x.dtype, name="C")
    require(A, (g * R,), torch.float32, name="A")
    if bias is not None:
        require(bias, (g * R,), torch.float32, name="bias")
    if D is not None:
        require(D, (g * R, P), torch.float32, name="D")
    dtype_code(x)
    return b, g, L, R, P, N, nc


# ---------------------------------------------------------------------------
# the plain twins
# ---------------------------------------------------------------------------

def _rows(t, nc, chunk):
    """t (b, g, L, ...) as float32 (b, g, nc, chunk, ...), rows past L zero."""
    b, g, L = t.shape[:3]
    t = t.float()
    if nc * chunk != L:
        t = torch.cat([t, t.new_zeros(b, g, nc * chunk - L, *t.shape[3:])], dim=2)
    return t.reshape(b, g, nc, chunk, *t.shape[3:])


def _heads(t, nc, chunk):
    """x-shaped t (b, g, L, R, P) as float32 (b, g, R, nc, chunk, P)."""
    return _rows(t, nc, chunk).permute(0, 1, 4, 2, 3, 5)


class _Chunks:
    """A call's float32 operands cut into chunks, rows past L zero:
    x (b, g, R, nc, c, P); z = dt_raw + bias, dt, cum (b, g, R, nc, c);
    valid (nc, c); B, C, CB = C B^T (b, g, nc, c, .)."""

    def __init__(self, x, dt, A, Bm, Cm, bias, chunk):
        b, g, L, R, P, N, nc = _geometry(x, Bm, chunk)
        self.x = _heads(x, nc, chunk)
        z = _rows(dt, nc, chunk).permute(0, 1, 4, 2, 3)
        if bias is not None:
            z = z + bias.float().view(1, g, R, 1, 1)
        self.z = z
        self.valid = (torch.arange(nc * chunk, device=x.device) < L).float().view(nc, chunk)
        self.dt = softplus(z) * self.valid
        self.cum = torch.cumsum(self.dt * A.float().view(1, g, R, 1, 1), dim=-1)
        self.B, self.C = _rows(Bm, nc, chunk), _rows(Cm, nc, chunk)
        self.CB = self.C @ self.B.transpose(-1, -2)
        self.lower = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
        self.shape = (b, g, L, R, P, N, nc)

    def chunk(self, i):
        """Chunk i's per-head quantities: x, dt, cum (b, g, R, c[, P]), the
        decay E = exp(cum_i - cum_j) [i >= j] and M = CB * E
        (b, g, R, c, c)."""
        cum = self.cum[:, :, :, i]
        diff = cum[..., :, None] - cum[..., None, :]
        E = torch.exp(torch.where(self.lower, diff, torch.full_like(diff, -math.inf)))
        return self.x[:, :, :, i], self.dt[:, :, :, i], cum, E, self.CB[:, :, None, i] * E


def _state(t, b, g, R, N, P, device):
    if t is None:
        return torch.zeros(b, g, R, N, P, dtype=torch.float32, device=device)
    return t.float().reshape(b, g, R, N, P)


@torch.no_grad()
def ssd_fwd_plain(x, dt, A, Bm, Cm, D=None, bias=None, init=None, chunk=CHUNK,
                  save_states=False):
    """Returns y (b, g, L, R, P) in x's dtype and the final state
    (b, g * R, N, P) float32; with ``save_states`` also the state entering
    each chunk, (b, g * R, n_chunks, N, P)."""
    ch = _Chunks(x, dt, A, Bm, Cm, bias, chunk)
    b, g, L, R, P, N, nc = ch.shape
    Dm = None if D is None else D.float().view(1, g, R, 1, P)
    state = _state(init, b, g, R, N, P, x.device)
    states = (torch.empty(b, g, R, nc, N, P, dtype=torch.float32, device=x.device)
              if save_states else None)
    ys = []
    for i in range(nc):
        if save_states:
            states[:, :, :, i] = state
        xc, dtc, cum, _, M = ch.chunk(i)
        dtx = xc * dtc[..., None]
        y = M @ dtx + (ch.C[:, :, None, i] @ state) * torch.exp(cum)[..., None]
        wt = cum[..., -1:]
        state = state * torch.exp(wt)[..., None] + \
            ch.B[:, :, None, i].transpose(-1, -2) @ (dtx * torch.exp(wt - cum)[..., None])
        if Dm is not None:
            y = y + xc * Dm
        ys.append(y)
    y = torch.stack(ys, 3).permute(0, 1, 3, 4, 2, 5).reshape(b, g, nc * chunk, R, P)
    out = (y[:, :, :L].to(x.dtype).contiguous(), state.reshape(b, g * R, N, P))
    if save_states:
        out += (states.reshape(b, g * R, nc, N, P),)
    return out


@torch.no_grad()
def ssd_bwd_plain(x, dt, A, Bm, Cm, D, bias, states, dy, dfin=None, chunk=CHUNK):
    """The Pallas adjoint replayed chunk by chunk from the checkpoints
    ``states``; dy (b, g, L, R, P) and dfin (b, g * R, N, P) or None
    (zeros) are the gradients of y and the final state.  Returns a dict of
    float32 gradients: dx (b, g, L, R, P), ddt of the raw dt (b, g, L, R),
    dB and dC (b, g, L, N), dA, dbias (g * R,), dD (g * R, P) and dinit
    (b, g * R, N, P), whether or not D, bias and an initial state were
    given."""
    ch = _Chunks(x, dt, A, Bm, Cm, bias, chunk)
    b, g, L, R, P, N, nc = ch.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    Af = A.float().view(1, g, R, 1)
    Dm = torch.zeros(1, g, R, 1, P, **f32) if D is None else D.float().view(1, g, R, 1, P)
    st_all = states.float().view(b, g, R, nc, N, P)
    dyc = _heads(dy, nc, chunk)
    ds = _state(dfin, b, g, R, N, P, x.device)
    dx = torch.empty(b, g, R, nc, chunk, P, **f32)
    ddt = torch.empty(b, g, R, nc, chunk, **f32)
    dB = torch.empty(b, g, nc, chunk, N, **f32)
    dC = torch.empty_like(dB)
    dA, dbias, dD = torch.zeros(b, g, R, **f32), torch.zeros(b, g, R, **f32), \
        torch.zeros(b, g, R, P, **f32)
    for i in reversed(range(nc)):
        xc, dtc, cum, E, M = ch.chunk(i)
        Bc, Cc = ch.B[:, :, None, i], ch.C[:, :, None, i]
        dyi = dyc[:, :, :, i]
        st = st_all[:, :, :, i]
        wt = cum[..., -1:]
        e_ch, e_wc = torch.exp(cum)[..., None], torch.exp(wt - cum)[..., None]
        e_wt = torch.exp(wt)[..., None]
        dtx = xc * dtc[..., None]
        G = dtx * e_wc
        # read-out adjoints: y = M dtx + (C st) e_ch + D x
        dye = dyi * e_ch
        dM = dyi @ dtx.transpose(-1, -2)
        d_dtx = M.transpose(-1, -2) @ dyi
        dch = (dyi * (Cc @ st)).sum(-1) * e_ch[..., 0]
        dC_h = dye @ st.transpose(-1, -2)
        dst = Cc.transpose(-1, -2) @ dye + ds * e_wt
        # state-update adjoints: st' = st e^wt + B^T G
        dG = Bc @ ds
        d_dtx = d_dtx + dG * e_wc
        dB_h = G @ ds.transpose(-1, -2)
        t_r = (dG * G).sum(-1)
        dch = dch - t_r
        dwt = t_r.sum(-1, keepdim=True) + (ds * st * e_wt).sum((-2, -1))[..., None]
        # M = CB * E, E = exp(cum_i - cum_j)
        dCB = (dM * E).sum(2)
        dS = dM * M
        dch = dch + dS.sum(-1) - dS.sum(-2)
        # cum = inclusive cumsum of w: dw_j = sum_{i >= j} dch_i (+ dwt)
        dw = torch.flip(torch.cumsum(torch.flip(dch, [-1]), -1), [-1]) + dwt
        dD += (dyi * xc).sum(-2)
        dx[:, :, :, i] = d_dtx * dtc[..., None] + dyi * Dm
        ddt_raw = (d_dtx * xc).sum(-1) + dw * Af
        dA += (dw * dtc).sum(-1)
        z = ch.z[:, :, :, i]
        sig = torch.where(z > SOFTPLUS_THRESHOLD, torch.ones_like(z), torch.sigmoid(z))
        dsp = ddt_raw * ch.valid[i] * sig
        dbias += dsp.sum(-1)
        ddt[:, :, :, i] = dsp
        dB[:, :, i] = dB_h.sum(2) + dCB.transpose(-1, -2) @ ch.C[:, :, i]
        dC[:, :, i] = dC_h.sum(2) + dCB @ ch.B[:, :, i]
        ds = dst
    Lp = nc * chunk
    return dict(
        dx=dx.permute(0, 1, 3, 4, 2, 5).reshape(b, g, Lp, R, P)[:, :, :L].contiguous(),
        ddt=ddt.permute(0, 1, 3, 4, 2).reshape(b, g, Lp, R)[:, :, :L].contiguous(),
        dB=dB.reshape(b, g, Lp, N)[:, :, :L].contiguous(),
        dC=dC.reshape(b, g, Lp, N)[:, :, :L].contiguous(),
        dA=dA.sum(0).reshape(g * R), dbias=dbias.sum(0).reshape(g * R),
        dD=dD.sum(0).reshape(g * R, P), dinit=ds.reshape(b, g * R, N, P))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def ssd_fwd(x, dt, A, Bm, Cm, D=None, bias=None, init=None, chunk=CHUNK, save_states=False):
    """Kernel 15; see `ssd_fwd_plain`."""
    if on_cpu(x, dt, A, Bm, Cm, D, bias, init):
        return ssd_fwd_plain(x, dt, A, Bm, Cm, D, bias, init, chunk, save_states)
    require_cuda(x, dt, A, Bm, Cm, D, bias, init)
    b, g, L, R, P, N, nc = _check(x, dt, A, Bm, Cm, D, bias, chunk)
    if init is not None:
        require(init, (b, g * R, N, P), torch.float32, name="init")
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    fin = torch.empty(b, g * R, N, P, **f32)
    states = torch.empty(b, g * R, nc, N, P, **f32) if save_states else None
    lib = build.library()
    ssd_fwd.launches += 1
    build.check(lib.xfm_ssd_fwd(
        ptr(x), ptr(dt), ptr(Bm), ptr(Cm), ptr(A), ptr(bias), ptr(D), ptr(init), ptr(y),
        ptr(fin), ptr(states), b, L, g, R, P, N, dtype_code(x), stream(x)), "ssd_fwd")
    return (y, fin, states) if save_states else (y, fin)


ssd_fwd.launches = 0


def ssd_bwd(x, dt, A, Bm, Cm, D, bias, states, dy, dfin=None, chunk=CHUNK):
    """Kernel 16; see `ssd_bwd_plain` for what it returns."""
    if on_cpu(x, dt, A, Bm, Cm, D, bias, states, dy, dfin):
        return ssd_bwd_plain(x, dt, A, Bm, Cm, D, bias, states, dy, dfin, chunk)
    require_cuda(x, dt, A, Bm, Cm, D, bias, states, dy, dfin)
    b, g, L, R, P, N, nc = _check(x, dt, A, Bm, Cm, D, bias, chunk)
    require(states, (b, g * R, nc, N, P), torch.float32, name="states")
    require(dy, (b, g, L, R, P), torch.float32, name="dy")
    if dfin is not None:
        require(dfin, (b, g * R, N, P), torch.float32, name="dfin")
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty(b, g, L, R, P, **f32)
    ddt = torch.empty(b, g, L, R, **f32)
    dB, dC = torch.zeros(b, g, L, N, **f32), torch.zeros(b, g, L, N, **f32)
    dA, dbias = torch.zeros(g * R, **f32), torch.zeros(g * R, **f32)
    dD = torch.zeros(g * R, P, **f32)
    dinit = torch.empty(b, g * R, N, P, **f32)
    lib = build.library()
    ssd_bwd.launches += 1
    build.check(lib.xfm_ssd_bwd(
        ptr(x), ptr(dt), ptr(Bm), ptr(Cm), ptr(A), ptr(bias), ptr(D), ptr(states), ptr(dy),
        ptr(dfin), ptr(dx), ptr(ddt), ptr(dB), ptr(dC), ptr(dA), ptr(dbias), ptr(dD),
        ptr(dinit), b, L, g, R, P, N, dtype_code(x), stream(x)), "ssd_bwd")
    return dict(dx=dx, ddt=ddt, dB=dB, dC=dC, dA=dA, dbias=dbias, dD=dD, dinit=dinit)


ssd_bwd.launches = 0


# ---------------------------------------------------------------------------
# the gate's geometries on the kernels: head-width slices, d_state tiles
# ---------------------------------------------------------------------------

def _cuts(n: int, size: int) -> list[slice]:
    """[0, n) in consecutive slices of at most ``size``."""
    return [slice(i, min(i + size, n)) for i in range(0, n, size)]


def _part(t, *index):
    return None if t is None else t[index].contiguous()


def ssd_fwd_tiled(x, dt, A, Bm, Cm, D=None, bias=None, init=None, save_states=False):
    """`ssd_fwd` at any head width and d_state the gate admits; returns
    what `ssd_fwd` returns (see the module docstring for the split)."""
    b, g, L, R, P = x.shape
    N = Bm.shape[-1]
    ps, ns = _cuts(P, MAX_HEADDIM), _cuts(N, MAX_STATE)
    if len(ps) == 1 and len(ns) == 1:
        return ssd_fwd(x, dt, A, Bm, Cm, D, bias, init, save_states=save_states)
    f32 = dict(dtype=torch.float32, device=x.device)
    cast = (lambda t: t.float()) if len(ns) > 1 else (lambda t: t)
    xc, dtc, Bc, Cc = cast(x), cast(dt), cast(Bm), cast(Cm)
    nc = -(-L // CHUNK)
    fin = torch.empty(b, g * R, N, P, **f32)
    states = torch.empty(b, g * R, nc, N, P, **f32) if save_states else None
    ys = []
    for pc in ps:
        xp = xc[..., pc].contiguous()
        y = None
        for i, nt in enumerate(ns):
            out = ssd_fwd(xp, dtc, A, _part(Bc, Ellipsis, nt), _part(Cc, Ellipsis, nt),
                          _part(D, slice(None), pc) if i == 0 else None, bias,
                          _part(init, slice(None), slice(None), nt, pc), save_states=save_states)
            y = out[0] if y is None else y + out[0]
            fin[:, :, nt, pc] = out[1]
            if save_states:
                states[:, :, :, nt, pc] = out[2]
        ys.append(y)
    y = torch.cat(ys, -1).to(x.dtype)
    return (y, fin, states) if save_states else (y, fin)


def ssd_bwd_tiled(x, dt, A, Bm, Cm, D, bias, states, dy, dfin=None):
    """`ssd_bwd` at any head width and d_state the gate admits, from the
    checkpoints of `ssd_fwd_tiled`; returns what `ssd_bwd` returns."""
    b, g, L, R, P = x.shape
    N = Bm.shape[-1]
    ps, ns = _cuts(P, MAX_HEADDIM), _cuts(N, MAX_STATE)
    if len(ps) == 1 and len(ns) == 1:
        return ssd_bwd(x, dt, A, Bm, Cm, D, bias, states, dy, dfin)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty(b, g, L, R, P, **f32)
    dB, dC = torch.zeros(b, g, L, N, **f32), torch.zeros(b, g, L, N, **f32)
    dD = torch.zeros(g * R, P, **f32)
    dinit = torch.empty(b, g * R, N, P, **f32)
    ddt = dA = dbias = None
    for pc in ps:
        xp = x[..., pc].contiguous()
        dyp = dy[..., pc].contiguous()
        dxp = None
        for i, nt in enumerate(ns):
            r = ssd_bwd(xp, dt, A, _part(Bm, Ellipsis, nt), _part(Cm, Ellipsis, nt),
                        _part(D, slice(None), pc) if i == 0 else None, bias,
                        _part(states, Ellipsis, nt, pc), dyp,
                        _part(dfin, slice(None), slice(None), nt, pc))
            dxp = r["dx"] if dxp is None else dxp + r["dx"]
            ddt = r["ddt"] if ddt is None else ddt + r["ddt"]
            dA = r["dA"] if dA is None else dA + r["dA"]
            dbias = r["dbias"] if dbias is None else dbias + r["dbias"]
            dB[..., nt] += r["dB"]
            dC[..., nt] += r["dC"]
            if i == 0:
                dD[:, pc] = r["dD"]
            dinit[:, :, nt, pc] = r["dinit"]
        dx[..., pc] = dxp
    return dict(dx=dx, ddt=ddt, dB=dB, dC=dC, dA=dA, dbias=dbias, dD=dD, dinit=dinit)


# ---------------------------------------------------------------------------
# the autograd op and its entries
# ---------------------------------------------------------------------------

class SSDChunkScanTrain(torch.autograd.Function):
    """Kernel 15 with checkpoints forward, kernel 16 backward; returns
    (y, final state).  A gradient that autograd leaves undefined (the final
    state, unused) counts as zeros."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, bias, init):
        y, fin, states = ssd_fwd_tiled(x, dt, A, Bm, Cm, D, bias, init, save_states=True)
        ctx.save_for_backward(x, dt, A, Bm, Cm, D, bias, states)
        ctx.has_init = init is not None
        ctx.set_materialize_grads(False)
        return y, fin

    @staticmethod
    def backward(ctx, gy, gfin):
        x, dt, A, Bm, Cm, D, bias, states = ctx.saved_tensors
        gy = torch.zeros(x.shape, dtype=torch.float32, device=x.device) if gy is None \
            else gy.float().contiguous()
        gfin = None if gfin is None else gfin.float().contiguous()
        g = ssd_bwd_tiled(x, dt, A, Bm, Cm, D, bias, states, gy, gfin)
        return (g["dx"].to(x.dtype), g["ddt"].to(dt.dtype), g["dA"], g["dB"].to(Bm.dtype),
                g["dC"].to(Cm.dtype), None if D is None else g["dD"],
                None if bias is None else g["dbias"], g["dinit"] if ctx.has_init else None)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def ssd_chunk_scan_heads(x, dt, A, Bm, Cm, D=None, bias=None, init=None):
    """The SSD scan in the kernel layout (see the module docstring): kernel
    15 alone where no gradient is asked for (``_ssd_call``), else
    `SSDChunkScanTrain` (kernels 15 and 16), both tiled to the kernels'
    limits.  x, dt, B and C are taken in
    x's dtype, A, D, bias and init in float32 (casts that autograd runs
    back).  Returns (y in x's dtype, final state float32)."""
    def f32(t):
        return None if t is None else t.float().contiguous()

    args = (x.contiguous(), dt.to(x.dtype).contiguous(), f32(A), Bm.to(x.dtype).contiguous(),
            Cm.to(x.dtype).contiguous(), f32(D), f32(bias), f32(init))
    if _needs_grad(*args):
        return SSDChunkScanTrain.apply(*args)
    return ssd_fwd_tiled(*args)


def pack_args(x, dt, A, B, C, D=None, dt_bias=None, initial_states=None):
    """The public layout of ``ops/ssd.py`` -- x (b, s, h, p), dt (b, s, h),
    B/C (b, s, g, n), D (h,) or (h, p), initial_states (b, h, p, n) -- as
    the arguments of `ssd_chunk_scan_heads`: x (b, g, s, R, p),
    dt (b, g, s, R), A, B/C (b, g, s, n), D (h, p), bias, init
    (b, h, n, p)."""
    b, s, h, p = x.shape
    g = B.shape[2]
    if h % g:
        raise ValueError(f"{h} heads do not split into {g} groups")
    R = h // g
    if D is not None and D.dim() == 1:
        D = D[:, None].expand(h, p)
    init = None if initial_states is None else initial_states.transpose(2, 3)
    return (x.view(b, s, g, R, p).transpose(1, 2), dt.view(b, s, g, R).transpose(1, 2), A,
            B.transpose(1, 2), C.transpose(1, 2), D, dt_bias, init)

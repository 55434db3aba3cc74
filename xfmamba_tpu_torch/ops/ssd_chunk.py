"""Kernels 15 and 16: the chunked SSD (Mamba-2) scan and its adjoint
(port of ``xfmamba_tpu/ops/ssd_pallas.py``), chunk-parallel.

- Kernel 15, `ssd_fwd`: replaces ``_ssd_kernel`` (:74), called by
  ``_ssd_call`` (``pallas_call`` :211) for inference and by
  ``_ssd_call_train`` (:337), which also returns each chunk's start state,
  for training (``save_states``).  Per head h of group k and chunk j::

      dt   = softplus(dt_raw + bias_h) * [row < L]        (threshold 20)
      cum  = inclusive cumsum of A_h dt over the chunk,  w_j = cum[-1]
      M    = (C_j B_j^T) * exp(cum_i - cum_l) * [i >= l]
      y_j  = M (dt x) + (C_j s_j) * exp(cum) + D_h x
      s_{j+1} = exp(w_j) s_j + B_j^T ((dt x) * exp(w_j - cum))

  with s_0 the initial state and s_j (N, P) the state entering chunk j.
  It runs as three kernels, each with its own wrapper and count: (a)
  `ssd_chunk_states`, every chunk's local end state B_j^T ((dt x)
  exp(w_j - cum)) and exp(w_j), all chunks in parallel; (b)
  `ssd_state_pass`, s_{j+1} = exp(w_j) s_j + local_j, serial over chunks and
  elementwise over the states; (c) `ssd_chunk_scan`, y of every chunk from
  s_j, all chunks in parallel.
- Kernel 16, `ssd_bwd`: replaces ``_ssd_bwd_kernel`` (:356, ``pallas_call``
  :581), the same decomposition in reverse: (a) `ssd_chunk_states` with
  ``adjoint``, Q_j = C_j^T (exp(cum) dy); (b) `ssd_state_pass` in reverse,
  ds_out[j - 1] = exp(w_j) ds_out[j] + Q_j from ds_out[n - 1] = dfin (the
  adjoint entering chunk 0 is dinit); (c) `ssd_chunk_grads`, every chunk's
  gradients from its checkpoint s_j and ds_out[j].  It returns dx, the
  gradient of the raw dt (through the softplus), dB and dC per group, dA,
  dbias and dD summed over the batch, and the initial state's gradient.
- `SSDChunkScanTrain`: the autograd op (the custom VJP
  ``ssd_chunk_scan_pallas_train``, :629-695), which `ssd_chunk_scan_heads`
  takes where gradients are asked for; `pack_args` (``_pack_args``,
  :605-626) gives its arguments from the public layout of ``ops/ssd.py``.
- `ssd_supported`: the JAX package's geometry gate (:228-237).  The
  kernels take every geometry it admits, at any chunk: d_state up to
  `MAX_STATE` and head width up to `MAX_HEADDIM` in one call each.  A
  block holds a slab of the state, at most `SLAB_N` rows of N by `SLAB_P`
  columns of P (one head's float32 state at d_state 512 and head width 128
  is 256 KiB, past a block's shared memory), and the grid has a block per
  slab.  The columns of P are independent; y, and every gradient, is a sum
  over n (and the gradients over q) of products of one factor from each,
  so each slab gives its part: where more than one slab adds to an output,
  the parts go to float32 workspaces and `ssd_slab_sum` adds them in slab
  order (one launch per output, no atomics), the D terms in the first slab
  of N's; y is rounded to its dtype once.  The m2 classifiers' geometries
  (d_state 64, head width 16) are one slab: the same launches as before.
- A chunk of any length: the kernels' blocks take pieces of at most
  `PIECE` rows that never cross a chunk's end (`pieces`): a shorter chunk
  is padded inside the 64-row tile, a longer one is cut into pieces of 64
  rows and its remainder, each carrying its state to the next.  The states
  arrays hold the state entering each piece.
- `ssd_fwd_serial` / `ssd_bwd_serial`: the serial kernels that walk every
  chunk in one block (``csrc/ssd_serial.cu``; chunk 64, one slab), the
  design these kernels replaced.  No model path calls them; they are kept so that
  ``chip_smoke.py`` can time both designs in turns.

The port's layout is group-major, as SS2D's cross-scan gives it, so no
operand is transposed on the way in or out: x (b, g, L, R, P), dt
(b, g, L, R), B and C (b, g, L, N) for g groups of R heads (head
h = k * R + r reads group k's B and C); A and bias (g * R,), D (g * R, P),
float32.  States are (N, P) per head: the initial and final states
(b, g * R, N, P) and the checkpoints (b, g * R, `pieces`, N, P), float32.
x, dt, B and C share one dtype, float32 or bfloat16; y comes back in it and
everything else in float32.  A sequence that the chunk does not divide is
zero-padded (dt 0 past L: decay 1, contribution 0), as the Pallas kernel
pads, where ``ops/ssd.py`` halves its chunk instead: the two agree to
rounding.

Each wrapper takes its plain twin (``*_plain``, the same passes in
PyTorch, the chunks batched) only for CPU tensors; on CUDA tensors it
launches the kernel, adds one to its ``launches`` count, or raises.
`ssd_fwd` and `ssd_bwd` count their calls (three kernel launches each, and
one `ssd_slab_sum` launch per output that more than one slab adds to).
"""

from __future__ import annotations

import math

import torch

from xfmamba_tpu_torch.kernels import build
from xfmamba_tpu_torch.ops.cost import flops_ssd_chunk_scan, reports_cost
from xfmamba_tpu_torch.ops.fast_math import SOFTPLUS_THRESHOLD, softplus
from xfmamba_tpu_torch.ops.primitives import (
    dtype_code, forward_only, needs_grad, on_cpu, ptr, require, require_cuda, stream)

# positions per chunk: the default of the m0 path's chunk_size
CHUNK = 64
# the kernels' rows per block: a chunk of at most PIECE positions is one
# piece, padded inside the tile; a longer chunk is cut into pieces of
# PIECE positions and its remainder (`pieces`)
PIECE = 64
# the kernels' limits, the JAX gate's (csrc/ssd_chunk.cu), and the slab of
# the state a block holds: its shared memory takes N = 64 by P = 32
MAX_STATE = 512
MAX_HEADDIM = 128
SLAB_N = 64
SLAB_P = 32


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


def pieces(L: int, chunk: int) -> int:
    """The kernels' pieces of L positions in chunks of ``chunk``: per chunk
    ceil(chunk / PIECE), the last chunk's only as far as L reaches
    (``csrc/ssd_chunk.cu::pieces``).  The states arrays hold one state a
    piece: the state entering it."""
    if chunk < 1:
        raise ValueError(f"chunk {chunk} must be positive")
    ppc, full = -(-chunk // PIECE), (L - 1) // chunk
    return full * ppc + -(-(L - full * chunk) // PIECE)


class _Layout:
    """The pieces of L positions in chunks of ``chunk``: ``idx`` (n, w) the
    position of each piece's row (clamped), ``valid`` (n, w) the rows
    before the piece's end, w = min(chunk, PIECE)."""

    def __init__(self, L, chunk, device):
        self.L, self.n, self.w = L, pieces(L, chunk), min(chunk, PIECE)
        k = torch.arange(self.n, device=device)
        ppc = -(-chunk // PIECE)
        t0 = (k // ppc) * chunk + (k % ppc) * PIECE
        cnt = torch.minimum(torch.clamp(chunk - (k % ppc) * PIECE, max=PIECE), L - t0)
        r = torch.arange(self.w, device=device)
        self.valid = r[None] < cnt[:, None]
        self.idx = torch.clamp(t0[:, None] + r[None], max=L - 1)


def _geometry(x, Bm, chunk):
    """(b, g, L, R, P, N, n_pieces) of a call."""
    b, g, L, R, P = x.shape
    return b, g, L, R, P, Bm.shape[-1], pieces(L, chunk)


def _check(x, dt, A, Bm, Cm, D, bias, chunk):
    b, g, L, R, P, N, nc = _geometry(x, Bm, chunk)
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
# the plain twins: one function per kernel pass, all chunks at once
# ---------------------------------------------------------------------------

def _rows(t, lay):
    """t (b, g, L, ...) as float32 (b, g, n, w, ...) by pieces, rows past a
    piece's end zero."""
    t = t.float()[:, :, lay.idx]
    return torch.where(lay.valid.view(*lay.valid.shape, *([1] * (t.dim() - 4))), t,
                       torch.zeros((), device=t.device))


def _unrows(t, lay):
    """(b, g, n, w, ...) by pieces back to (b, g, L, ...)."""
    out = t.new_zeros(*t.shape[:2], lay.L, *t.shape[4:])
    out[:, :, lay.idx[lay.valid]] = t[:, :, lay.valid]
    return out


def _heads(t, lay):
    """x-shaped t (b, g, L, R, P) as float32 (b, g, R, n, w, P)."""
    return _rows(t, lay).permute(0, 1, 4, 2, 3, 5)


def _unheads(t, lay):
    """(b, g, R, n, w, P) back to (b, g, L, R, P)."""
    return _unrows(t.permute(0, 1, 3, 4, 2, 5), lay)


class _Cum:
    """A call's per-head piece scalars, float32 (b, g, R, n, w), rows past a
    piece's end zero: z = dt_raw + bias, dt = softplus(z), cum = the
    inclusive cumsum of A dt within each piece; valid (n, w); ``lay`` the
    pieces (`_Layout`)."""

    def __init__(self, dt, A, bias, chunk):
        b, g, L, R = dt.shape
        self.lay = lay = _Layout(L, chunk, dt.device)
        z = _rows(dt, lay).permute(0, 1, 4, 2, 3)
        if bias is not None:
            z = z + bias.float().view(1, g, R, 1, 1)
        self.z = z
        self.valid = lay.valid.float()
        self.dt = softplus(z) * self.valid
        self.cum = torch.cumsum(self.dt * A.float().view(1, g, R, 1, 1), dim=-1)
        self.wt = self.cum[..., -1:]
        self.nc = lay.n

    def decay(self):
        """exp(w) of each chunk, (b, g * R, nc)."""
        b, g, R, nc, _ = self.cum.shape
        return torch.exp(self.wt[..., 0]).reshape(b, g * R, nc)


class _Chunks(_Cum):
    """Besides `_Cum`: x (b, g, R, n, w, P), B and C (b, g, n, w, N),
    CB = C B^T, the decay E = exp(cum_i - cum_l) [i >= l] and M = CB * E
    (b, g, R, n, w, w)."""

    def __init__(self, x, dt, A, Bm, Cm, bias, chunk):
        super().__init__(dt, A, bias, chunk)
        b, g, L, R, P, N, nc = _geometry(x, Bm, chunk)
        lay = self.lay
        self.x = _heads(x, lay)
        self.B, self.C = _rows(Bm, lay), _rows(Cm, lay)
        self.CB = self.C @ self.B.transpose(-1, -2)
        lower = torch.ones(lay.w, lay.w, dtype=torch.bool, device=x.device).tril()
        diff = self.cum[..., :, None] - self.cum[..., None, :]
        self.E = torch.exp(torch.where(lower, diff, torch.full_like(diff, -math.inf)))
        self.M = self.CB[:, :, None] * self.E
        self.shape = (b, g, L, R, P, N, nc)


@torch.no_grad()
def ssd_chunk_states_plain(src, dt, A, mat, bias=None, chunk=CHUNK, adjoint=False):
    """Pass (a): every piece's local state and decay, (b, g * R, n, N, P)
    and (b, g * R, n), float32 (n = `pieces`).  Forward (src x, mat B):
    B_j^T ((dt x) exp(w_j - cum)); ``adjoint`` (src dy, mat C):
    C_j^T (exp(cum) dy)."""
    cs = _Cum(dt, A, bias, chunk)
    b, g, L, R, P = src.shape
    N = mat.shape[-1]
    weight = torch.exp(cs.cum) if adjoint else cs.dt * torch.exp(cs.wt - cs.cum)
    s = _heads(src, cs.lay) * weight[..., None]
    local = _rows(mat, cs.lay).transpose(-1, -2)[:, :, None] @ s
    return local.reshape(b, g * R, cs.nc, N, P), cs.decay()


@torch.no_grad()
def ssd_state_pass_plain(local, decay, start=None, reverse=False):
    """Pass (b): with the carry s from ``start`` (b, h, N, P), or zeros,
    over the chunks in order (or in reverse), out[:, :, j] = s, then
    s = decay[:, :, j] s + local[:, :, j].  Returns (out, the last s)."""
    out = torch.empty_like(local, dtype=torch.float32)
    s = torch.zeros_like(out[:, :, 0]) if start is None else start.float().clone()
    nc = local.shape[2]
    for j in (reversed(range(nc)) if reverse else range(nc)):
        out[:, :, j] = s
        s = decay[:, :, j, None, None] * s + local[:, :, j]
    return out, s


@torch.no_grad()
def ssd_chunk_scan_plain(x, dt, A, Bm, Cm, D, bias, states, chunk=CHUNK):
    """Pass (c): y (b, g, L, R, P) in x's dtype from the state entering
    each piece, ``states`` (b, g * R, n, N, P)."""
    ch = _Chunks(x, dt, A, Bm, Cm, bias, chunk)
    b, g, L, R, P, N, nc = ch.shape
    st = states.float().view(b, g, R, nc, N, P)
    y = ch.M @ (ch.x * ch.dt[..., None]) + \
        (ch.C[:, :, None] @ st) * torch.exp(ch.cum)[..., None]
    if D is not None:
        y = y + ch.x * D.float().view(1, g, R, 1, 1, P)
    return _unheads(y, ch.lay).to(x.dtype).contiguous()


@torch.no_grad()
def ssd_chunk_grads_plain(x, dt, A, Bm, Cm, D, bias, states, ds_out, dy, chunk=CHUNK):
    """Pass (c) of the adjoint: every piece's gradients from the state
    entering it (``states``) and the gradient of the state leaving it
    (``ds_out``), both (b, g * R, n, N, P), and dy (b, g, L, R, P).
    Returns float32 dx, ddt (of the raw dt), dB, dC (b, g, L, N), dA,
    dbias (g * R,) and dD (g * R, P)."""
    ch = _Chunks(x, dt, A, Bm, Cm, bias, chunk)
    b, g, L, R, P, N, nc = ch.shape
    st = states.float().view(b, g, R, nc, N, P)
    ds = ds_out.float().view(b, g, R, nc, N, P)
    dyc = _heads(dy, ch.lay)
    Bc, Cc = ch.B[:, :, None], ch.C[:, :, None]
    e_ch = torch.exp(ch.cum)[..., None]
    e_wc = torch.exp(ch.wt - ch.cum)[..., None]
    e_wt = torch.exp(ch.wt)[..., None]
    dtx = ch.x * ch.dt[..., None]
    G = dtx * e_wc
    # read-out adjoints: y = M dtx + (C st) e_ch + D x
    dM = dyc @ dtx.transpose(-1, -2)
    d_dtx = ch.M.transpose(-1, -2) @ dyc
    dch = (dyc * (Cc @ st)).sum(-1) * e_ch[..., 0]
    dC_h = (dyc * e_ch) @ st.transpose(-1, -2)
    # state-update adjoints: s' = s e^w + B^T G
    dG = Bc @ ds
    d_dtx = d_dtx + dG * e_wc
    dB_h = G @ ds.transpose(-1, -2)
    t_r = (dG * G).sum(-1)
    dch = dch - t_r
    dwt = t_r.sum(-1, keepdim=True) + (ds * st * e_wt).sum((-2, -1))[..., None]
    # M = CB * E, E = exp(cum_i - cum_l)
    dCB = (dM * ch.E).sum(2)
    dS = dM * ch.M
    dch = dch + dS.sum(-1) - dS.sum(-2)
    # cum = inclusive cumsum of A dt: dw_l = sum_{i >= l} dch_i (+ dw)
    dw = torch.flip(torch.cumsum(torch.flip(dch, [-1]), -1), [-1]) + dwt
    Af = A.float().view(1, g, R, 1, 1)
    Dm = torch.zeros(1, g, R, 1, 1, P, dtype=torch.float32, device=x.device) if D is None \
        else D.float().view(1, g, R, 1, 1, P)
    dx = d_dtx * ch.dt[..., None] + dyc * Dm
    ddt_raw = (d_dtx * ch.x).sum(-1) + dw * Af
    sig = torch.where(ch.z > SOFTPLUS_THRESHOLD, torch.ones_like(ch.z), torch.sigmoid(ch.z))
    dsp = ddt_raw * ch.valid * sig
    dB = dB_h.sum(2) + dCB.transpose(-1, -2) @ ch.C
    dC = dC_h.sum(2) + dCB @ ch.B
    return dict(
        dx=_unheads(dx, ch.lay).contiguous(),
        ddt=_unrows(dsp.permute(0, 1, 3, 4, 2), ch.lay).contiguous(),
        dB=_unrows(dB, ch.lay).contiguous(), dC=_unrows(dC, ch.lay).contiguous(),
        dA=(dw * ch.dt).sum((0, 3, 4)).reshape(g * R), dbias=dsp.sum((0, 3, 4)).reshape(g * R),
        dD=(dyc * ch.x).sum((0, 3, 4)).reshape(g * R, P))


@torch.no_grad()
def ssd_fwd_plain(x, dt, A, Bm, Cm, D=None, bias=None, init=None, chunk=CHUNK,
                  save_states=False):
    """Returns y (b, g, L, R, P) in x's dtype and the final state
    (b, g * R, N, P) float32; with ``save_states`` also the state entering
    each piece, (b, g * R, `pieces`, N, P).  Passes (a), (b) and (c)."""
    local, decay = ssd_chunk_states_plain(x, dt, A, Bm, bias, chunk)
    states, fin = ssd_state_pass_plain(local, decay, init)
    y = ssd_chunk_scan_plain(x, dt, A, Bm, Cm, D, bias, states, chunk)
    return (y, fin, states) if save_states else (y, fin)


@torch.no_grad()
def ssd_bwd_plain(x, dt, A, Bm, Cm, D, bias, states, dy, dfin=None, chunk=CHUNK):
    """The adjoint from the checkpoints ``states``; dy (b, g, L, R, P) and
    dfin (b, g * R, N, P) or None (zeros) are the gradients of y and the
    final state.  Returns a dict of float32 gradients: dx (b, g, L, R, P),
    ddt of the raw dt (b, g, L, R), dB and dC (b, g, L, N), dA, dbias
    (g * R,), dD (g * R, P) and dinit (b, g * R, N, P), whether or not D,
    bias and an initial state were given.  Passes (a), (b) in reverse and
    (c)."""
    q, decay = ssd_chunk_states_plain(dy, dt, A, Cm, bias, chunk, adjoint=True)
    ds_out, dinit = ssd_state_pass_plain(q, decay, dfin, reverse=True)
    grads = ssd_chunk_grads_plain(x, dt, A, Bm, Cm, D, bias, states, ds_out, dy, chunk)
    grads["dinit"] = dinit
    return grads


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _launch_states(src, dt, A, mat, bias, adjoint, chunk):
    b, g, L, R, P = src.shape
    N, nc = mat.shape[-1], pieces(L, chunk)
    f32 = dict(dtype=torch.float32, device=src.device)
    st = torch.empty(b, g * R, nc, N, P, **f32)
    decay = torch.empty(b, g * R, nc, **f32)
    build.check(build.library().xfm_ssd_chunk_state(
        ptr(src), ptr(dt), ptr(mat), ptr(A), ptr(bias), ptr(st), ptr(decay), b, L, g, R, P, N,
        chunk, dtype_code(dt), int(adjoint), stream(src)), "ssd_chunk_states")
    ssd_chunk_states.launches += 1
    return st, decay


def _launch_pass(local, decay, start, reverse):
    b, h, nc, N, P = local.shape
    if start is not None and start.data_ptr() % 16:  # the kernel moves 16-byte vectors
        start = start.clone()
    fin = torch.empty(b, h, N, P, dtype=torch.float32, device=local.device)
    build.check(build.library().xfm_ssd_state_pass(
        ptr(local), ptr(decay), ptr(start), ptr(fin), b * h, nc, N * P, int(reverse),
        stream(local)), "ssd_state_pass")
    ssd_state_pass.launches += 1
    return local, fin


def slabs(N: int, P: int) -> tuple[int, int]:
    """The slabs of a (N, P) state the kernels' blocks take: (of N, of P)."""
    return -(-N // SLAB_N), -(-P // SLAB_P)


def _parts(count, *shape, device, zero=False):
    """A float32 workspace of ``count`` slabs' parts, or None for one."""
    if count == 1:
        return None
    return (torch.zeros if zero else torch.empty)(count, *shape, dtype=torch.float32,
                                                  device=device)


def ssd_slab_sum(part, out):
    """out = the sum of ``part`` (slabs, *out.shape, float32) over its first
    axis, in slab order, in out's dtype (float32 or bfloat16)."""
    build.check(build.library().xfm_ssd_sum(ptr(part), out.numel(), part.shape[0], ptr(out),
                                            dtype_code(out), stream(out)), "ssd_slab_sum")
    ssd_slab_sum.launches += 1
    return out


ssd_slab_sum.launches = 0


def _launch_scan(x, dt, A, Bm, Cm, D, bias, states, chunk):
    b, g, L, R, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty_like(x)
    part = _parts(slabs(N, P)[0], *x.shape, device=x.device)
    build.check(build.library().xfm_ssd_chunk_scan(
        ptr(x), ptr(dt), ptr(Bm), ptr(Cm), ptr(A), ptr(bias), ptr(D), ptr(states), ptr(y),
        ptr(part), b, L, g, R, P, N, chunk, dtype_code(x), stream(x)), "ssd_chunk_scan")
    ssd_chunk_scan.launches += 1
    return y if part is None else ssd_slab_sum(part, y)


def _launch_grads(x, dt, A, Bm, Cm, D, bias, states, ds_out, dy, chunk):
    b, g, L, R, P = x.shape
    N = Bm.shape[-1]
    ns, ps = slabs(N, P)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty(b, g, L, R, P, **f32)
    ddt = torch.empty(b, g, L, R, **f32)
    dB, dC = torch.zeros(b, g, L, N, **f32), torch.zeros(b, g, L, N, **f32)
    dA, dbias = torch.zeros(g * R, **f32), torch.zeros(g * R, **f32)
    dD = torch.zeros(g * R, P, **f32)
    part = _parts(ns, *dx.shape, device=x.device)
    part_dt = _parts(ns * ps, *ddt.shape, device=x.device)
    part_B = _parts(ps, *dB.shape, device=x.device, zero=True)
    part_C = _parts(ps, *dC.shape, device=x.device, zero=True)
    build.check(build.library().xfm_ssd_chunk_grads(
        ptr(x), ptr(dt), ptr(Bm), ptr(Cm), ptr(A), ptr(bias), ptr(D), ptr(states), ptr(ds_out),
        ptr(dy), ptr(dx), ptr(ddt), ptr(dB), ptr(dC), ptr(dA), ptr(dbias), ptr(dD), ptr(part),
        ptr(part_dt), ptr(part_B), ptr(part_C), b, L, g, R, P, N, chunk, dtype_code(x),
        stream(x)), "ssd_chunk_grads")
    ssd_chunk_grads.launches += 1
    for t, parts in ((dx, part), (ddt, part_dt), (dB, part_B), (dC, part_C)):
        if parts is not None:
            ssd_slab_sum(parts, t)
    return dict(dx=dx, ddt=ddt, dB=dB, dC=dC, dA=dA, dbias=dbias, dD=dD)


def ssd_chunk_states(src, dt, A, mat, bias=None, adjoint=False, chunk=CHUNK):
    """Pass (a) of kernel 15 (or 16, ``adjoint``: src dy float32, mat C);
    see `ssd_chunk_states_plain`."""
    if on_cpu(src, dt, A, mat, bias):
        return ssd_chunk_states_plain(src, dt, A, mat, bias, chunk, adjoint=adjoint)
    require_cuda(src, dt, A, mat, bias)
    b, g, L, R, P = src.shape
    N = mat.shape[-1]
    if N > MAX_STATE or P > MAX_HEADDIM or N % 2 or P % 2:
        raise ValueError(f"d_state {N} / head width {P}: the kernels take even values up to "
                         f"{MAX_STATE} / {MAX_HEADDIM}")
    require(src, (b, g, L, R, P), torch.float32 if adjoint else dt.dtype, name="src")
    require(dt, (b, g, L, R), name="dt")
    require(mat, (b, g, L, N), dt.dtype, name="mat")
    require(A, (g * R,), torch.float32, name="A")
    if bias is not None:
        require(bias, (g * R,), torch.float32, name="bias")
    return _launch_states(src, dt, A, mat, bias, adjoint, chunk)


ssd_chunk_states.launches = 0


def ssd_state_pass(local, decay, start=None, reverse=False):
    """Pass (b) of kernels 15 and 16; see `ssd_state_pass_plain`.  On the
    card ``local`` is overwritten with the result, which is returned."""
    if on_cpu(local, decay, start):
        return ssd_state_pass_plain(local, decay, start, reverse)
    require_cuda(local, decay, start)
    b, h, nc, N, P = local.shape
    require(local, (b, h, nc, N, P), torch.float32, name="local")
    require(decay, (b, h, nc), torch.float32, name="decay")
    if start is not None:
        require(start, (b, h, N, P), torch.float32, name="start")
    if local.data_ptr() % 16 or (N * P) % 4:
        raise ValueError("local: the state pass needs a 16-byte aligned array of rows of 4k")
    return _launch_pass(local, decay, start, reverse)


ssd_state_pass.launches = 0


def ssd_chunk_scan(x, dt, A, Bm, Cm, D, bias, states, chunk=CHUNK):
    """Pass (c) of kernel 15; see `ssd_chunk_scan_plain`."""
    if on_cpu(x, dt, A, Bm, Cm, D, bias, states):
        return ssd_chunk_scan_plain(x, dt, A, Bm, Cm, D, bias, states, chunk)
    require_cuda(x, dt, A, Bm, Cm, D, bias, states)
    b, g, L, R, P, N, nc = _check(x, dt, A, Bm, Cm, D, bias, chunk)
    require(states, (b, g * R, nc, N, P), torch.float32, name="states")
    return _launch_scan(x, dt, A, Bm, Cm, D, bias, states, chunk)


ssd_chunk_scan.launches = 0


def ssd_chunk_grads(x, dt, A, Bm, Cm, D, bias, states, ds_out, dy, chunk=CHUNK):
    """Pass (c) of kernel 16; see `ssd_chunk_grads_plain`."""
    if on_cpu(x, dt, A, Bm, Cm, D, bias, states, ds_out, dy):
        return ssd_chunk_grads_plain(x, dt, A, Bm, Cm, D, bias, states, ds_out, dy, chunk)
    require_cuda(x, dt, A, Bm, Cm, D, bias, states, ds_out, dy)
    b, g, L, R, P, N, nc = _check(x, dt, A, Bm, Cm, D, bias, chunk)
    require(states, (b, g * R, nc, N, P), torch.float32, name="states")
    require(ds_out, (b, g * R, nc, N, P), torch.float32, name="ds_out")
    require(dy, (b, g, L, R, P), torch.float32, name="dy")
    return _launch_grads(x, dt, A, Bm, Cm, D, bias, states, ds_out, dy, chunk)


ssd_chunk_grads.launches = 0

# the kernels of each pass, by name: their launch counts
PASSES = {"states": ssd_chunk_states, "state_pass": ssd_state_pass, "scan": ssd_chunk_scan,
          "grads": ssd_chunk_grads}


def ssd_fwd(x, dt, A, Bm, Cm, D=None, bias=None, init=None, chunk=CHUNK, save_states=False):
    """Kernel 15 (passes a, b, c, checked once); see `ssd_fwd_plain`."""
    if on_cpu(x, dt, A, Bm, Cm, D, bias, init):
        return ssd_fwd_plain(x, dt, A, Bm, Cm, D, bias, init, chunk, save_states)
    forward_only("ssd_fwd", x, dt, A, Bm, Cm, D, bias, init)
    require_cuda(x, dt, A, Bm, Cm, D, bias, init)
    b, g, L, R, P, N, nc = _check(x, dt, A, Bm, Cm, D, bias, chunk)
    if init is not None:
        require(init, (b, g * R, N, P), torch.float32, name="init")
    local, decay = _launch_states(x, dt, A, Bm, bias, False, chunk)
    states, fin = _launch_pass(local, decay, init, False)
    y = _launch_scan(x, dt, A, Bm, Cm, D, bias, states, chunk)
    ssd_fwd.launches += 1  # counted once launched
    return (y, fin, states) if save_states else (y, fin)


ssd_fwd.launches = 0


def ssd_bwd(x, dt, A, Bm, Cm, D, bias, states, dy, dfin=None, chunk=CHUNK):
    """Kernel 16 (passes a, b in reverse, c, checked once); see
    `ssd_bwd_plain` for what it returns."""
    if on_cpu(x, dt, A, Bm, Cm, D, bias, states, dy, dfin):
        return ssd_bwd_plain(x, dt, A, Bm, Cm, D, bias, states, dy, dfin, chunk)
    require_cuda(x, dt, A, Bm, Cm, D, bias, states, dy, dfin)
    b, g, L, R, P, N, nc = _check(x, dt, A, Bm, Cm, D, bias, chunk)
    require(states, (b, g * R, nc, N, P), torch.float32, name="states")
    require(dy, (b, g, L, R, P), torch.float32, name="dy")
    if dfin is not None:
        require(dfin, (b, g * R, N, P), torch.float32, name="dfin")
    q, decay = _launch_states(dy, dt, A, Cm, bias, True, chunk)
    ds_out, dinit = _launch_pass(q, decay, dfin, True)
    grads = _launch_grads(x, dt, A, Bm, Cm, D, bias, states, ds_out, dy, chunk)
    ssd_bwd.launches += 1  # counted once launched
    grads["dinit"] = dinit
    return grads


ssd_bwd.launches = 0


def ssd_fwd_serial(x, dt, A, Bm, Cm, D=None, bias=None, init=None, save_states=False):
    """The serial form of kernel 15 (``csrc/ssd_serial.cu``), for timing
    against `ssd_fwd`; returns what `ssd_fwd` returns."""
    if on_cpu(x, dt, A, Bm, Cm, D, bias, init):
        return ssd_fwd_plain(x, dt, A, Bm, Cm, D, bias, init, CHUNK, save_states)
    require_cuda(x, dt, A, Bm, Cm, D, bias, init)
    b, g, L, R, P, N, nc = _check(x, dt, A, Bm, Cm, D, bias, CHUNK)
    if N > SLAB_N or P > SLAB_P:
        raise ValueError(f"the serial kernels take one slab: d_state {N} / head width {P}")
    if init is not None:
        require(init, (b, g * R, N, P), torch.float32, name="init")
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    fin = torch.empty(b, g * R, N, P, **f32)
    states = torch.empty(b, g * R, nc, N, P, **f32) if save_states else None
    lib = build.library()
    build.check(lib.xfm_ssd_fwd_serial(
        ptr(x), ptr(dt), ptr(Bm), ptr(Cm), ptr(A), ptr(bias), ptr(D), ptr(init), ptr(y),
        ptr(fin), ptr(states), b, L, g, R, P, N, dtype_code(x), stream(x)), "ssd_fwd_serial")
    ssd_fwd_serial.launches += 1
    return (y, fin, states) if save_states else (y, fin)


ssd_fwd_serial.launches = 0


def ssd_bwd_serial(x, dt, A, Bm, Cm, D, bias, states, dy, dfin=None):
    """The serial form of kernel 16 (``csrc/ssd_serial.cu``), for timing
    against `ssd_bwd`; returns what `ssd_bwd` returns."""
    if on_cpu(x, dt, A, Bm, Cm, D, bias, states, dy, dfin):
        return ssd_bwd_plain(x, dt, A, Bm, Cm, D, bias, states, dy, dfin)
    require_cuda(x, dt, A, Bm, Cm, D, bias, states, dy, dfin)
    b, g, L, R, P, N, nc = _check(x, dt, A, Bm, Cm, D, bias, CHUNK)
    if N > SLAB_N or P > SLAB_P:
        raise ValueError(f"the serial kernels take one slab: d_state {N} / head width {P}")
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
    build.check(lib.xfm_ssd_bwd_serial(
        ptr(x), ptr(dt), ptr(Bm), ptr(Cm), ptr(A), ptr(bias), ptr(D), ptr(states), ptr(dy),
        ptr(dfin), ptr(dx), ptr(ddt), ptr(dB), ptr(dC), ptr(dA), ptr(dbias), ptr(dD),
        ptr(dinit), b, L, g, R, P, N, dtype_code(x), stream(x)), "ssd_bwd_serial")
    ssd_bwd_serial.launches += 1
    return dict(dx=dx, ddt=ddt, dB=dB, dC=dC, dA=dA, dbias=dbias, dD=dD, dinit=dinit)


ssd_bwd_serial.launches = 0


# ---------------------------------------------------------------------------
# the autograd op and its entries
# ---------------------------------------------------------------------------

class SSDChunkScanTrain(torch.autograd.Function):
    """Kernel 15 with checkpoints forward, kernel 16 backward; returns
    (y, final state).  A gradient that autograd leaves undefined (the final
    state, unused) counts as zeros."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, bias, init, chunk):
        y, fin, states = ssd_fwd(x, dt, A, Bm, Cm, D, bias, init, chunk, save_states=True)
        ctx.save_for_backward(x, dt, A, Bm, Cm, D, bias, states)
        ctx.has_init, ctx.chunk = init is not None, chunk
        ctx.set_materialize_grads(False)
        return y, fin

    @staticmethod
    def backward(ctx, gy, gfin):
        x, dt, A, Bm, Cm, D, bias, states = ctx.saved_tensors
        gy = torch.zeros(x.shape, dtype=torch.float32, device=x.device) if gy is None \
            else gy.float().contiguous()
        gfin = None if gfin is None else gfin.float().contiguous()
        g = ssd_bwd(x, dt, A, Bm, Cm, D, bias, states, gy, gfin, ctx.chunk)
        return (g["dx"].to(x.dtype), g["ddt"].to(dt.dtype), g["dA"], g["dB"].to(Bm.dtype),
                g["dC"].to(Cm.dtype), None if D is None else g["dD"],
                None if bias is None else g["dbias"], g["dinit"] if ctx.has_init else None, None)


@reports_cost(lambda x, dt, A, Bm, *args, chunk=CHUNK, **kwargs: flops_ssd_chunk_scan(
    x.shape[0], x.shape[2], x.shape[1] * x.shape[3], x.shape[4], Bm.shape[-1], chunk))
def ssd_chunk_scan_heads(x, dt, A, Bm, Cm, D=None, bias=None, init=None, chunk=CHUNK):
    """The SSD scan in the kernel layout (see the module docstring): kernel
    15 alone where no gradient is asked for (``_ssd_call``), else
    `SSDChunkScanTrain` (kernels 15 and 16).  x, dt, B and C are taken in
    x's dtype, A, D, bias and init in float32 (casts that autograd runs
    back); ``chunk`` positions a chunk.  Returns (y in x's dtype, final
    state float32)."""
    def f32(t):
        return None if t is None else t.float().contiguous()

    args = (x.contiguous(), dt.to(x.dtype).contiguous(), f32(A), Bm.to(x.dtype).contiguous(),
            Cm.to(x.dtype).contiguous(), f32(D), f32(bias), f32(init))
    if needs_grad(*args):
        return SSDChunkScanTrain.apply(*args, chunk)
    return ssd_fwd(*args, chunk=chunk)


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

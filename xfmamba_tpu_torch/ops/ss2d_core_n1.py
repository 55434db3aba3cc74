"""Kernels 11 and 12: the d_state-1 cross2d SS2D core with the rank->D
delta projection inside the kernel, and its backward (port of the N=1
section of ``xfmamba_tpu/ops/selective_scan_pallas.py``, :298-831).

- Kernel 11, `ss2d_core_n1_fwd`: replaces ``_scan_kernel_n1p`` (:298,
  ``pallas_call`` :414).  For the four cross2d directions of N=1 chains
  (k = 0 row_f, 1 col_f, 2 row_r, 3 col_r)::

      delta = softplus(rank . w_dt[k] + bias[k])      (threshold 20)
      h     = exp(delta * A[k]) * h + delta * u * B
      y_k   = C * h + D[k] * u

  merged in float32 as ``(y_0 + y_2) + (y_1 + y_3)``, the order of
  ``_core_fused_proj_parts`` (:718-723).  It also writes the state entering
  each chunk of each chain (the checkpoints the backward of the JAX kernel
  starts from).
- Kernel 12, `ss2d_core_n1_bwd`: replaces ``_scan_kernel_n1p_bwd`` (:440,
  ``pallas_call`` :618): h recomputed, the adjoint lambda[t] = C dy[t] +
  a[t+1] lambda[t+1] (against each direction's own order), du merged over
  the directions, dB and dC per position, the pre-softplus delta gradient
  ``dpre`` taken straight into the rank and w_dt gradients (``d rank_k =
  dpre_k w_dt[k]^T``, ``dw_dt[k] = rank_k^T dpre_k``, on the tensor cores
  as the Pallas body takes them on the MXU; dpre never reaches device
  memory), and the whole-grid sums of dbias, dA and dD, all in a fixed
  order.
- `SS2DCoreN1` / `ss2d_core_n1`: the autograd op around both, the
  counterpart of ``ss2d_core_pallas_n1`` (:809-831), with the glue of
  ``_core_fused_proj_parts`` / ``_core_fused_proj_bwd_impl`` (:709-806).
  The x_proj products stay plain torch matmuls, as JAX leaves them to XLA.

The kernels (``csrc/ss2d_core_n1.cu``) are tile-parallel two-level scans:
the map is cut into tiles of at most 8 x 8 positions and D into slabs of
`SLAB` channels (`tile_plan`); a forward is three launches (segment pairs,
carries, apply) or, on maps of at most `FUSE_TILES` tiles (14 x 14, 7 x 7),
one launch of thread-block clusters, an image's tiles each, that keeps
delta, a and b in shared memory between its two walks; a backward is four
launches (pairs, carries, apply with the rank products, the fixed-order
sums of the partials).  Each wrapper counts its calls by plan in
``by_plan`` (`TilePlan.key`).

The kernels read no checkpoint: the backward recomputes every state in
its own pair and carry passes.  The forward still writes ``ck`` and the
autograd op saves it, because it is the contract of the JAX kernels'
residuals (``cf`` / ``cr``) that the tests hold against Pallas in
interpret mode, and the plain twins and the first design's backward start
from it.

The first design (one thread per chain and data chunk) stays as
`ss2d_core_n1_fwd_v1` / `ss2d_core_n1_bwd_v1` (``csrc/ss2d_core_n1_v1.cu``,
its rank gradients by `_rank_grads`), for timing beside the new one; no
main path calls it.

Layouts (the port's own, not the TPU's lane packing):
  x      (B, H, W, D) NHWC, float32 or bfloat16; the column directions walk
         t = w * H + h, so no transposed copy of x exists
  xdbl   (B, H, W, 4, R + 2) in x's dtype: [rank | B | C] of direction k,
         all directions' projections of each position in one row
  w_dt   (4, R, D) float32 (rounded to x's dtype first, as the TPU kernel
         casts it); A = -exp(A_logs), Ds, bias (4, D) float32
  ck     (B, 4, n_chunks, D) float32, by data chunk: chunk j covers the
         positions t of [j * chunk, (j + 1) * chunk) of the direction's
         flattening; a forward direction enters it with the state after
         t = j * chunk - 1, a reverse one with the state after
         t = (j + 1) * chunk (JAX ``cf`` / ``cr``, row 0)

The same CUDA kernels serve the bfloat16 backbone's cross2d scans
(``ops/cross2d_scan.py``), whose projection rows are laid out
``[rank_0 .. rank_3 | B0 C0 .. B3 C3]``: `N1Layout` says where each
direction's rank, B and C sit in a row, and the plain twins here take it
too.  The kernels compute z = rank . w_dt in 3xTF32 in both dtypes; in
bfloat16 the two gradient products take bfloat16 operands (dpre and w_dt
rounded), float32 sums.

Each wrapper takes its plain twin (`*_plain`, the same sequential walk of
each chunk, dpre through plain matmuls) only for CPU tensors; on CUDA
tensors it launches the kernels, adds one to its ``launches`` count, or
raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from xfmamba_tpu_torch.kernels import build
from xfmamba_tpu_torch.ops.fast_math import softplus
from xfmamba_tpu_torch.ops.nk_scan import CROSS2D_KINDS, traversal_order
from xfmamba_tpu_torch.ops.primitives import (
    dtype_code, gemm_ab_cuda, gemm_ab_plain, on_cpu, ptr, require, require_cuda, stream)

# checkpoint chunks per chain (the first design's threads along L,
# csrc/ss2d_core_n1_v1.cu)
MAX_CHUNKS = 16
MIN_CHUNK = 8
MAX_RANK = 64
# the order in which the directions are walked and merged
MERGE_ORDER = (0, 2, 1, 3)
# csrc/ss2d_core_n1_v1.cu: channels of a block, positions of a dB / dC
# reduction, and the shared memory a block may take with its cache
CHANNELS = 32
SEG = 8
SMEM_CACHE_BUDGET = 100 * 1024
# csrc/ss2d_core_n1.cu: the largest tile side, the channels of a slab, the
# blocks a launch aims for (two waves of three blocks on each of the H100's
# 132 SMs), and the most tiles of a map whose forward is one launch of
# thread-block clusters (the portable cluster size)
TILE = 8
SLAB = 32
TARGET_BLOCKS = 2 * 3 * 132
FUSE_TILES = 8


@dataclass(frozen=True)
class TilePlan:
    """The tiling of a (B, H, W, D) map: TH x TW tiles (the last ones
    ragged), nth x ntw of them, NS segment slots per chain, D in n_slabs
    slabs of `SLAB` channels, P blocks per slab; ``fused``: the forward is
    one launch of clusters of nth x ntw blocks (an image's tiles), else
    three launches (pairs, carries, apply)."""
    TH: int
    TW: int
    nth: int
    ntw: int
    NS: int
    n_slabs: int
    P: int
    fused: bool

    def key(self, backward: bool = False) -> str:
        """The plan as a route counter's key: "7x7 one launch" (a forward),
        "7x7 four launches" (a backward)."""
        launches = "four launches" if backward else "one launch" if self.fused else \
            "three launches"
        return f"{self.TH}x{self.TW} {launches}"


def tile_plan(B: int, H: int, W: int, D: int) -> TilePlan:
    """Tiles of at most `TILE` x `TILE` positions that split H and W as
    evenly as they can (56 -> 8, 28, 14 and 7 -> 7); each slab's blocks walk
    the B x nth x ntw (image, tile) items, enough blocks that the launch
    reaches `TARGET_BLOCKS`, never more than the items.  The forward of a
    map of at most `FUSE_TILES` tiles (14 x 14 and 7 x 7 of the models) is
    one launch, a block an item."""
    nth, ntw = -(-H // TILE), -(-W // TILE)
    TH, TW = -(-H // nth), -(-W // ntw)
    nth, ntw = -(-H // TH), -(-W // TW)
    n_slabs = -(-D // SLAB)
    P = max(1, min(B * nth * ntw, -(-TARGET_BLOCKS // n_slabs), 65535))
    fused = nth * ntw <= FUSE_TILES and B * nth * ntw <= 65535
    return TilePlan(TH, TW, nth, ntw, max(H * ntw, W * nth), n_slabs, P, fused)


def count_plan(counted, plan: TilePlan, backward: bool = False) -> None:
    """One more call of ``counted`` (a wrapper) under ``plan``: its
    ``by_plan`` route counter."""
    key = plan.key(backward)
    counted.by_plan[key] = counted.by_plan.get(key, 0) + 1


@dataclass(frozen=True)
class N1Layout:
    """Where direction k's operands sit in a projection row of ``row``
    values: its R ranks from ``k * rank_k``, B at ``bc_off + k * bc_k``, C
    right after B."""
    row: int
    rank_k: int
    bc_off: int
    bc_k: int

    def args(self):
        return (self.row, self.rank_k, self.bc_off, self.bc_k)

    def split(self, xd, k, R):
        """(ranks (..., R), B (..., 1), C (..., 1)) of direction k in rows xd."""
        r0, b = k * self.rank_k, self.bc_off + k * self.bc_k
        return xd[..., r0:r0 + R], xd[..., b:b + 1], xd[..., b + 1:b + 2]


def core_layout(R: int) -> N1Layout:
    """Kernels 11 / 12: (4, R + 2) per position, [rank | B | C] per direction."""
    return N1Layout(4 * (R + 2), R + 2, R, R + 2)


def use_cache(R: int, chunk: int, n_chunks: int, backward: bool) -> bool:
    """Whether the first design's kernel keeps a chunk's values (a and
    delta u B forward, h and a backward) in shared memory: the block's
    shared memory with them (the words of ``n1_smem_bytes`` in
    ``csrc/ss2d_core_n1_v1.cu``) within `SMEM_CACHE_BUDGET`."""
    nthr = n_chunks * CHANNELS
    words = R * CHANNELS + 3 * nthr + 2 * chunk * nthr
    if backward:
        words += n_chunks * (2 * SEG * (CHANNELS + 1) + SEG)
    return 4 * words <= SMEM_CACHE_BUDGET


def pick_chunk(L: int) -> int:
    """Chunk length: L split into at most `MAX_CHUNKS` chunks of at least
    `MIN_CHUNK` positions (the last one ragged)."""
    n = min(MAX_CHUNKS, -(-L // MIN_CHUNK))
    return -(-L // n)


def _n_chunks(L: int, chunk) -> tuple[int, int]:
    chunk = chunk or pick_chunk(L)
    n = -(-L // chunk)
    if chunk < 1 or n > MAX_CHUNKS:
        raise ValueError(f"chunk {chunk} gives {n} chunks of L={L}; at most {MAX_CHUNKS}")
    return chunk, n


def scan_operands(dtype, dt_projs_weight, dt_projs_bias, A_logs, Ds):
    """w_dt (4, R, D), rounded to the activation ``dtype``; A = -exp(A_logs),
    Ds and bias (4, D); all float32."""
    K, D, _ = dt_projs_weight.shape
    if K != 4 or A_logs.shape != (K * D, 1):
        raise ValueError("the N=1 core is cross2d with d_state 1")
    w_dt = dt_projs_weight.transpose(1, 2).to(dtype).float().contiguous()
    return (w_dt, -torch.exp(A_logs.float()).reshape(K, D), Ds.float().reshape(K, D),
            dt_projs_bias.float().reshape(K, D))


def pack_n1_inputs(x, x_proj_weight, dt_projs_weight, dt_projs_bias, A_logs, Ds):
    """Kernel operands from the SS2D parameters (``_pack_n1_inputs``,
    :668-706): xdbl = x @ x_proj^T in x's dtype, one torch matmul for the
    four directions, then `scan_operands`."""
    B, H, W, D = x.shape
    K, RC, _ = x_proj_weight.shape
    xdbl = x.reshape(-1, D) @ x_proj_weight.to(x.dtype).reshape(K * RC, D).t()
    return (xdbl.view(B, H, W, K, RC),
            *scan_operands(x.dtype, dt_projs_weight, dt_projs_bias, A_logs, Ds))


def _check(x, xdbl, w_dt, A, Ds, bias):
    B, H, W, D = x.shape
    R = w_dt.shape[1]
    if not 1 <= R <= MAX_RANK:
        raise ValueError(f"dt rank {R} outside 1..{MAX_RANK}")
    require(x, (B, H, W, D), name="x")
    require(xdbl, (B, H, W, 4, R + 2), x.dtype, name="xdbl")
    require(w_dt, (4, R, D), torch.float32, name="w_dt")
    for name, t in (("A", A), ("Ds", Ds), ("bias", bias)):
        require(t, (4, D), torch.float32, name=name)
    dtype_code(x)
    return B, H, W, D, R


# ---------------------------------------------------------------------------
# the per-direction quantities, as the kernels compute them
# ---------------------------------------------------------------------------

def _direction(x, xdbl, w_dt, A, bias, k, chunk, n, layout):
    """Direction k in chunk layout: every (B, n, chunk, D) float32 quantity
    of the recurrence, positions past L padded with a = 1 and b = 0.
    Returns (pos, valid, dict): pos[t] is the row-major position of data
    index t of the direction's flattening (rows, or columns t = w * H + h)."""
    B, H, W, D = x.shape
    L = H * W
    R = w_dt.shape[1]
    pos = traversal_order(CROSS2D_KINDS[k & 1], H, W, x.device)
    pad = n * chunk - L
    u = x.reshape(B, L, D).float()[:, pos]
    rank, Bv, Cv = layout.split(xdbl.reshape(B, L, layout.row).float()[:, pos], k, R)
    z = rank @ w_dt[k] + bias[k]
    delta = softplus(z)
    a = torch.exp(delta * A[k])
    b = delta * u * Bv

    def chunks(t, fill=0.0):
        t = torch.nn.functional.pad(t, (0, 0, 0, pad), value=fill) if pad else t
        return t.view(B, n, chunk, -1)

    valid = (torch.arange(n * chunk, device=x.device) < L).view(1, n, chunk, 1)
    q = dict(u=chunks(u), z=chunks(z), delta=chunks(delta), a=chunks(a, 1.0), b=chunks(b),
             B=chunks(Bv), C=chunks(Cv))
    return pos, valid, q


def _walk(a, b, h, reverse):
    """h_i = a_i h_{i-1} + b_i along the chunk axis (dim 2) from h, in
    the direction's order; returns every h_i (B, n, chunk, D)."""
    hs = torch.empty_like(b)
    steps = range(a.shape[2] - 1, -1, -1) if reverse else range(a.shape[2])
    for i in steps:
        h = a[:, :, i] * h + b[:, :, i]
        hs[:, :, i] = h
    return hs


def _carries(prod, loc, backward):
    """The value entering each chunk: carry = prod * carry + loc across the
    chunks (dim 1), from chunk 0 up or (``backward``) from the last down."""
    cin = torch.empty_like(loc)
    carry = torch.zeros_like(loc[:, 0])
    n = loc.shape[1]
    for j in (range(n - 1, -1, -1) if backward else range(n)):
        cin[:, j] = carry
        carry = prod[:, j] * carry + loc[:, j]
    return cin


def _chunk_pair(a, b, reverse):
    """(product of a, h from a zero state) over each chunk, walked in order."""
    prod = torch.ones_like(b[:, :, 0])
    h = torch.zeros_like(prod)
    for i in (range(a.shape[2] - 1, -1, -1) if reverse else range(a.shape[2])):
        h = a[:, :, i] * h + b[:, :, i]
        prod = prod * a[:, :, i]
    return prod, h


def _merge(parts, pos_of, shape):
    """(y_0 + y_2) + (y_1 + y_3) in row-major positions; parts[k] is
    (B, L, D) in direction k's flattening."""
    def rowmajor(k):
        out = torch.empty(shape, dtype=torch.float32, device=parts[k].device)
        out[:, pos_of[k]] = parts[k]
        return out
    return (rowmajor(0) + rowmajor(2)) + (rowmajor(1) + rowmajor(3))


# ---------------------------------------------------------------------------
# kernel 11: the forward
# ---------------------------------------------------------------------------

def ss2d_core_n1_fwd_plain(x, xdbl, w_dt, A, Ds, bias, chunk=None, layout=None):
    """Returns y (B, H, W, D) float32 and the checkpoints ck (B, 4, n, D).
    ``layout``: the projection rows' `N1Layout` (kernel 11's by default)."""
    B, H, W, D = x.shape
    L = H * W
    layout = layout or core_layout(w_dt.shape[1])
    chunk, n = _n_chunks(L, chunk)
    ck = torch.empty(B, 4, n, D, dtype=torch.float32, device=x.device)
    parts, pos_of = {}, {}
    for k in MERGE_ORDER:
        reverse = k >= 2
        pos, _, q = _direction(x, xdbl, w_dt, A, bias, k, chunk, n, layout)
        prod, loc = _chunk_pair(q["a"], q["b"], reverse)
        cin = _carries(prod, loc, backward=reverse)
        ck[:, k] = cin
        hs = _walk(q["a"], q["b"], cin, reverse)
        y = q["C"] * hs + q["u"] * Ds[k]
        parts[k], pos_of[k] = y.reshape(B, n * chunk, D)[:, :L], pos
    return _merge(parts, pos_of, (B, L, D)).view(B, H, W, D), ck


def ss2d_core_n1_fwd(x, xdbl, w_dt, A, Ds, bias, chunk=None):
    """Kernel 11 on x (B, H, W, D); see the module docstring."""
    if on_cpu(x, xdbl, w_dt, A, Ds, bias):
        return ss2d_core_n1_fwd_plain(x, xdbl, w_dt, A, Ds, bias, chunk)
    require_cuda(x, xdbl, w_dt, A, Ds, bias)
    B, H, W, D, R = _check(x, xdbl, w_dt, A, Ds, bias)
    chunk, n = _n_chunks(H * W, chunk)
    ss2d_core_n1_fwd.launches += 1
    count_plan(ss2d_core_n1_fwd, tile_plan(B, H, W, D))
    return n1_fwd_launch(x, xdbl, w_dt, A, Ds, bias, chunk, n, core_layout(R))


def n1_fwd_launch(x, xdbl, w_dt, A, Dk, bias, chunk, n, layout, checkpoints=True):
    """Launch the forward kernels on checked operands: x (B, H, W, D), xdbl
    (B, H, W, layout.row).  Returns (y float32 (B, H, W, D), ck or None)."""
    B, H, W, D = x.shape
    plan = tile_plan(B, H, W, D)
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty(B, H, W, D, **f32)
    ck = torch.empty(B, 4, n, D, **f32) if checkpoints else None
    pairs = None if plan.fused else torch.empty(B, 4, plan.NS, D, 2, **f32)
    lib = build.library()
    build.check(lib.xfm_ss2d_n1_fwd(
        ptr(x), ptr(xdbl), ptr(w_dt), ptr(A), ptr(Dk), ptr(bias), ptr(y), ptr(ck), ptr(pairs),
        B, H, W, D, w_dt.shape[1], chunk, *layout.args(), plan.TH, plan.TW, plan.P,
        int(plan.fused), dtype_code(x), stream(x)), "ss2d_n1_fwd")
    return y, ck


ss2d_core_n1_fwd.launches = 0
ss2d_core_n1_fwd.by_plan = {}


def ss2d_core_n1_fwd_v1(x, xdbl, w_dt, A, Ds, bias, chunk=None):
    """Kernel 11's first design (``csrc/ss2d_core_n1_v1.cu``) on CUDA
    tensors, for timing beside `ss2d_core_n1_fwd`; counted in its own
    ``launches``."""
    require_cuda(x, xdbl, w_dt, A, Ds, bias)
    B, H, W, D, R = _check(x, xdbl, w_dt, A, Ds, bias)
    chunk, n = _n_chunks(H * W, chunk)
    ss2d_core_n1_fwd_v1.launches += 1
    return n1_fwd_launch_v1(x, xdbl, w_dt, A, Ds, bias, chunk, n, core_layout(R))


def n1_fwd_launch_v1(x, xdbl, w_dt, A, Dk, bias, chunk, n, layout, checkpoints=True):
    """`n1_fwd_launch` on the first design's kernel."""
    B, H, W, D = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty(B, H, W, D, **f32)
    scratch = torch.empty(B, H, W, D, **f32)
    ck = torch.empty(B, 4, n, D, **f32) if checkpoints else None
    lib = build.library()
    build.check(lib.xfm_ss2d_n1_fwd_v1(
        ptr(x), ptr(xdbl), ptr(w_dt), ptr(A), ptr(Dk), ptr(bias), ptr(y), ptr(scratch),
        ptr(ck), B, H, W, D, w_dt.shape[1], chunk, *layout.args(),
        int(use_cache(w_dt.shape[1], chunk, n, False)), dtype_code(x), stream(x)),
        "ss2d_n1_fwd_v1")
    return y, ck


ss2d_core_n1_fwd_v1.launches = 0


# ---------------------------------------------------------------------------
# kernel 12: the backward
# ---------------------------------------------------------------------------

def _rank_grads(dpre, xdbl, w_dt, dxdbl, gemm_ab):
    """d(rank) = dpre_k @ w_dt[k]^T into dxdbl's rank columns and
    dw_dt[k] = rank_k^T @ dpre_k, for each direction, with ``gemm_ab``."""
    D = dpre.shape[-1]
    M = dpre.numel() // (4 * D)
    R = w_dt.shape[1]
    dp = dpre.view(M, 4, D)
    ranks = xdbl.reshape(M, 4, R + 2).float()
    dx = dxdbl.view(M, 4, R + 2)
    dw_dt = torch.empty(4, R, D, dtype=torch.float32, device=dpre.device)
    for k in range(4):
        gemm_ab(dp[:, k], w_dt[k], out=dx[:, k, :R])
        dw_dt[k] = gemm_ab(ranks[:, k, :R].t(), dp[:, k].t(), out_dtype=torch.float32)
    return dw_dt


@torch.no_grad()
def ss2d_core_n1_bwd_plain(x, xdbl, w_dt, A, Ds, bias, ck, g, chunk=None):
    """Given g = dL/dy (B, H, W, D) float32 and the forward's checkpoints,
    returns a dict of float32 gradients: du (B, H, W, D), merged over the
    directions; dxdbl (B, H, W, 4, R + 2), [d rank | dB | dC]; dw_dt
    (4, R, D); dbias, dA (of A = -exp(A_logs)), dD (4, D)."""
    B, H, W, D = x.shape
    R = w_dt.shape[1]
    dxdbl = torch.zeros(B, H, W, 4, R + 2, dtype=torch.float32, device=x.device)
    r = n1_adjoint_plain(x, xdbl, w_dt, A, Ds, bias, ck, g, chunk, core_layout(R), dxdbl)
    dpre = r.pop("dpre")
    r["dxdbl"] = dxdbl
    r["dw_dt"] = _rank_grads(dpre, xdbl, w_dt, dxdbl, gemm_ab_plain)
    return r


@torch.no_grad()
def n1_adjoint_plain(x, xdbl, w_dt, A, Ds, bias, ck, g, chunk, layout, dxdbl):
    """The adjoint walks of the backward kernel, plain: returns du (B, H, W,
    D) merged over the directions, dpre (B, H, W, 4, D), dbias, dA, dD (4,
    D), all float32, and adds dB and dC into their columns of dxdbl (B, H,
    W, layout.row) float32."""
    B, H, W, D = x.shape
    L = H * W
    R = w_dt.shape[1]
    chunk, n = _n_chunks(L, chunk)
    f32 = dict(dtype=torch.float32, device=x.device)
    dpre = torch.zeros(B, L, 4, D, **f32)
    dxd = dxdbl.view(B, L, layout.row)
    dbias, dA, dD = (torch.empty(4, D, **f32) for _ in range(3))
    parts, pos_of = {}, {}
    for k in MERGE_ORDER:
        reverse = k >= 2
        pos, valid, q = _direction(x, xdbl, w_dt, A, bias, k, chunk, n, layout)
        gk = g.reshape(B, L, D).float()[:, pos]
        dy = torch.nn.functional.pad(gk, (0, 0, 0, n * chunk - L)).view(B, n, chunk, D)
        hin = ck[:, k]
        hs = _walk(q["a"], q["b"], hin, reverse)
        # the state before each position in the direction's order
        if reverse:
            h_prev = torch.cat([hs[:, :, 1:], hin[:, :, None]], 2)
        else:
            h_prev = torch.cat([hin[:, :, None], hs[:, :, :-1]], 2)
        # adjoint against the order: lambda_t = C dy + g, then g = a_t lambda_t
        c = q["C"] * dy
        prod, gloc = _chunk_pair(q["a"], q["a"] * c, not reverse)
        lam = _adjoint(q["a"], c, _carries(prod, gloc, backward=not reverse), reverse)
        du = dy * Ds[k] + lam * q["delta"] * q["B"]
        dexp = torch.where(valid, lam * h_prev * q["a"], 0.0)
        ddelta = lam * q["u"] * q["B"] + dexp * A[k]
        dp = torch.where(valid, ddelta * torch.sigmoid(q["z"]), 0.0)
        flat = (lambda t: t.reshape(B, n * chunk, -1)[:, :L])
        dpre[:, pos, k] = flat(dp)
        col = layout.bc_off + k * layout.bc_k
        dxd[:, pos, col] += flat((lam * q["delta"] * q["u"]).sum(-1, keepdim=True))[..., 0]
        dxd[:, pos, col + 1] += flat((dy * hs).sum(-1, keepdim=True))[..., 0]
        dbias[k] = dp.sum((0, 1, 2))
        dA[k] = (dexp * q["delta"]).sum((0, 1, 2))
        dD[k] = (dy * q["u"]).sum((0, 1, 2))
        parts[k], pos_of[k] = flat(du), pos
    du = _merge(parts, pos_of, (B, L, D)).view(B, H, W, D)
    return dict(du=du, dpre=dpre.view(B, H, W, 4, D), dbias=dbias, dA=dA, dD=dD)


def _adjoint(a, c, gin, reverse):
    """lambda_t = c_t + a_next lambda_next against the direction's order,
    entering each chunk with gin (= a lambda of the neighbouring chunk)."""
    lam = torch.empty_like(c)
    g = gin
    for i in (range(c.shape[2]) if reverse else range(c.shape[2] - 1, -1, -1)):
        lam[:, :, i] = c[:, :, i] + g
        g = a[:, :, i] * lam[:, :, i]
    return lam


def ss2d_core_n1_bwd(x, xdbl, w_dt, A, Ds, bias, ck, g, chunk=None):
    """Kernel 12 (the rank and w_dt gradients inside it); see
    `ss2d_core_n1_bwd_plain` for what it returns.  ``ck`` is checked but
    not read: the kernel recomputes the states it needs."""
    if on_cpu(x, xdbl, w_dt, A, Ds, bias, ck, g):
        return ss2d_core_n1_bwd_plain(x, xdbl, w_dt, A, Ds, bias, ck, g, chunk)
    require_cuda(x, xdbl, w_dt, A, Ds, bias, ck, g)
    B, H, W, D, R = _check(x, xdbl, w_dt, A, Ds, bias)
    chunk, n = _n_chunks(H * W, chunk)
    require(ck, (B, 4, n, D), torch.float32, name="ck")
    require(g, (B, H, W, D), torch.float32, name="g")
    dxdbl = torch.zeros(B, H, W, 4, R + 2, dtype=torch.float32, device=x.device)
    ss2d_core_n1_bwd.launches += 1
    count_plan(ss2d_core_n1_bwd, tile_plan(B, H, W, D), backward=True)
    r = n1_bwd_launch(x, xdbl, w_dt, A, Ds, bias, g, chunk, core_layout(R), dxdbl)
    r["dxdbl"] = dxdbl
    return r


def n1_bwd_launch(x, xdbl, w_dt, A, Dk, bias, g, chunk, layout, dxdbl):
    """Launch the backward kernels on checked operands (x, g (B, H, W, D),
    xdbl and the float32 dxdbl (B, H, W, layout.row)).  Returns du float32
    (B, H, W, D), dw_dt (4, R, D), dbias, dA, dD (4, D); d rank, dB and dC
    are added into dxdbl's columns."""
    B, H, W, D = x.shape
    R = w_dt.shape[1]
    plan = tile_plan(B, H, W, D)
    f32 = dict(dtype=torch.float32, device=x.device)
    pairs = torch.empty(B, 4, plan.NS, D, 2, **f32)
    gpairs = torch.empty(B, 4, plan.NS, D, **f32)
    du = torch.empty(B, H, W, D, **f32)
    part_x = torch.empty(plan.n_slabs, B, H, W, 4, R + 2, **f32)
    part_w = torch.empty(plan.P, 4, R, D, **f32)
    part_s = torch.empty(plan.P, 3, 4, D, **f32)
    dw_dt = torch.empty(4, R, D, **f32)
    dbias, dA, dD = (torch.empty(4, D, **f32) for _ in range(3))
    lib = build.library()
    build.check(lib.xfm_ss2d_n1_bwd(
        ptr(x), ptr(xdbl), ptr(w_dt), ptr(A), ptr(Dk), ptr(bias), ptr(g), ptr(pairs),
        ptr(gpairs), ptr(du), ptr(part_x), ptr(part_w), ptr(part_s), ptr(dxdbl), ptr(dw_dt),
        ptr(dbias), ptr(dA), ptr(dD), B, H, W, D, R, chunk, *layout.args(), plan.TH, plan.TW,
        plan.P, dtype_code(x), stream(x)), "ss2d_n1_bwd")
    return dict(du=du, dw_dt=dw_dt, dbias=dbias, dA=dA, dD=dD)


ss2d_core_n1_bwd.launches = 0
ss2d_core_n1_bwd.by_plan = {}


def ss2d_core_n1_bwd_v1(x, xdbl, w_dt, A, Ds, bias, ck, g, chunk=None):
    """Kernel 12's first design on CUDA tensors (``csrc/ss2d_core_n1_v1.cu``
    from the checkpoints, dpre in device memory, then `_rank_grads` on
    ``primitives.gemm_ab_cuda``), for timing beside `ss2d_core_n1_bwd`;
    counted in its own ``launches``."""
    require_cuda(x, xdbl, w_dt, A, Ds, bias, ck, g)
    B, H, W, D, R = _check(x, xdbl, w_dt, A, Ds, bias)
    chunk, n = _n_chunks(H * W, chunk)
    require(ck, (B, 4, n, D), torch.float32, name="ck")
    require(g, (B, H, W, D), torch.float32, name="g")
    dxdbl = torch.zeros(B, H, W, 4, R + 2, dtype=torch.float32, device=x.device)
    ss2d_core_n1_bwd_v1.launches += 1
    r = n1_bwd_launch_v1(x, xdbl, w_dt, A, Ds, bias, ck, g, chunk, n, core_layout(R), dxdbl,
                         torch.float32)
    dpre = r.pop("dpre")
    r["dxdbl"] = dxdbl
    r["dw_dt"] = _rank_grads(dpre, xdbl, w_dt, dxdbl, gemm_ab_cuda)
    return r


def n1_bwd_launch_v1(x, xdbl, w_dt, A, Dk, bias, ck, g, chunk, n, layout, dxdbl, dpre_dtype):
    """The first design's adjoint kernel on checked operands (x, g (B, H,
    W, D), xdbl and the zeroed float32 dxdbl (B, H, W, layout.row)).
    Returns du float32, dpre (B, H, W, 4, D) in ``dpre_dtype``, dbias, dA,
    dD (4, D); dB and dC land in dxdbl."""
    B, H, W, D = x.shape
    R = w_dt.shape[1]
    cache = use_cache(R, chunk, n, True)
    f32 = dict(dtype=torch.float32, device=x.device)
    hs = None if cache else torch.empty(B, H, W, D, **f32)
    scratch = torch.empty(B, H, W, D, **f32)
    du = torch.empty(B, H, W, D, **f32)
    dpre = torch.empty(B, H, W, 4, D, dtype=dpre_dtype, device=x.device)
    dbias, dA, dD = (torch.zeros(4, D, **f32) for _ in range(3))
    lib = build.library()
    build.check(lib.xfm_ss2d_n1_bwd_v1(
        ptr(x), ptr(xdbl), ptr(w_dt), ptr(A), ptr(Dk), ptr(bias), ptr(ck), ptr(g), ptr(hs),
        ptr(scratch), ptr(du), ptr(dpre), ptr(dxdbl), ptr(dbias), ptr(dA), ptr(dD),
        B, H, W, D, R, chunk, *layout.args(), int(cache), dtype_code(dpre), dtype_code(x),
        stream(x)), "ss2d_n1_bwd_v1")
    return dict(du=du, dpre=dpre, dbias=dbias, dA=dA, dD=dD)


ss2d_core_n1_bwd_v1.launches = 0


# ---------------------------------------------------------------------------
# the autograd op and its glue
# ---------------------------------------------------------------------------

def core_n1_parts(x, x_proj_weight, dt_projs_weight, dt_projs_bias, A_logs, Ds, chunk=None):
    """y (B, H, W, D) float32 and the residuals (xdbl, ck) of the backward
    (``_core_fused_proj_parts``)."""
    x = x.contiguous()
    xdbl, w_dt, A, Dk, bias = pack_n1_inputs(x, x_proj_weight, dt_projs_weight,
                                             dt_projs_bias, A_logs, Ds)
    y, ck = ss2d_core_n1_fwd(x, xdbl, w_dt, A, Dk, bias, chunk)
    return y, (xdbl, ck)


@torch.no_grad()
def core_n1_bwd(x, x_proj_weight, dt_projs_weight, dt_projs_bias, A_logs, Ds, xdbl, ck, g,
                chunk=None):
    """Gradients of the six primal arguments given g = dL/dy
    (``_core_fused_proj_bwd_impl``): kernel 12, then the x_proj chain as
    torch matmuls, dt_projs_weight back to (4, D, R), dA_logs = dA * A."""
    x = x.contiguous()
    B, H, W, D = x.shape
    M = B * H * W
    w_dt, A, Dk, bias = scan_operands(x.dtype, dt_projs_weight, dt_projs_bias, A_logs, Ds)
    r = ss2d_core_n1_bwd(x, xdbl, w_dt, A, Dk, bias, ck, g.float().contiguous(), chunk)
    dxdbl = r["dxdbl"].view(M, -1)
    dx = r["du"].view(M, D) + dxdbl @ x_proj_weight.float().reshape(-1, D)
    dxw = (dxdbl.t() @ x.reshape(M, D).float()).view(x_proj_weight.shape)
    return (dx.view(B, H, W, D).to(x.dtype), dxw.to(x_proj_weight.dtype),
            r["dw_dt"].transpose(1, 2).to(dt_projs_weight.dtype),
            r["dbias"].reshape(dt_projs_bias.shape).to(dt_projs_bias.dtype),
            (r["dA"] * A).reshape(A_logs.shape).to(A_logs.dtype),
            r["dD"].reshape(Ds.shape).to(Ds.dtype))


class SS2DCoreN1(torch.autograd.Function):
    """Kernel 11 forward, kernel 12 backward; saves x, the parameters, xdbl
    and the checkpoints, as the JAX custom VJP does."""

    @staticmethod
    def forward(ctx, x, x_proj_weight, dt_projs_weight, dt_projs_bias, A_logs, Ds):
        y, (xdbl, ck) = core_n1_parts(x, x_proj_weight, dt_projs_weight, dt_projs_bias,
                                      A_logs, Ds)
        ctx.save_for_backward(x, x_proj_weight, dt_projs_weight, dt_projs_bias, A_logs, Ds,
                              xdbl, ck)
        return y

    @staticmethod
    def backward(ctx, g):
        return core_n1_bwd(*ctx.saved_tensors, g)


def ss2d_core_n1(x, x_proj_weight, dt_projs_weight, dt_projs_bias, A_logs, Ds):
    """The d_state-1 cross2d SS2D core on x (B, H, W, D): (B, H, W, D)
    float32, differentiable in all six arguments (``ss2d_core_pallas_n1``)."""
    return SS2DCoreN1.apply(x, x_proj_weight, dt_projs_weight, dt_projs_bias, A_logs, Ds)

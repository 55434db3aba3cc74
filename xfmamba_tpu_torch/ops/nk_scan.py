"""Whole-map selective scans: the fusion-op kernels 2 and 3
(``csrc/nk_scan_fused.cu``) and the first design's serial scan
(``csrc/nk_scan.cu``), which the serial routes keep.

- `fusion_scan_cuda`: kernels 2 and 3 (K traversal kinds x N states,
  deltas precomputed or in rank form), one block per (image, 32-channel
  slab) staging its map slice on chip, the rank projection on the tensor
  cores, every kind walked in parallel by four lanes per chain and the
  kinds' parts of y summed in a fixed order; `fusion_scan_plan` says how a
  map is staged.  Its plain version is `selective_scan_plain`.
- `selective_scan_cuda`: the serial scan of the first design (one thread
  per chain, the kinds one after another), beside the same plain version.
  ``ops/cross2d_scan.py::serial_scan`` and ``ops/vss_stage.py::SERIAL_OPS``
  call it; no main path does.
- `nk_scan`: port of ``xfmamba_tpu/ops/vss_block_pallas_v2.py::
  nk_scan_call_v2`` (:1076), the dispatcher of the fusion scans from
  precomputed deltas: kernel 2 (TPU kernel ``_nk_scan_kernel_v2`` :890) by
  default, the ablation kernels 17 (``ops/ablations/nk_scan_v4.py``) or 18
  (``ops/ablations/nk_scan_wide.py``) where their switches are on and
  their gates hold (`nk_scan_route`, JAX's :1084-1098).
- `nk_scan_x`: port of ``nk_scan_call_v2r`` (:1005; TPU kernel
  ``_nk_scan_x_kernel_v2`` :944), the Cross_SS2Dv5 scan with the rank->D
  delta projection in the kernel and the out-norm LayerNorm as epilogue.
- `selective_scan_bwd_cuda`: the serial adjoint kernel of
  ``csrc/nk_scan_bwd.cu`` beside `selective_scan_bwd_plain`, which is the
  oracle of kernel 7; the kernel itself serves only the earlier designs
  that ``chip_smoke.py`` times (``ops/cross2d_scan.py::serial_scan_bwd``,
  ``ops/nk_scan_adjoint.py::nk_scan_bwd_serial``).

The kinds name each direction's traversal of the flattened H x W map; all
are flat over L (the state carries across rows, or across columns for the
column kinds, which walk t = w * H + h).  `scan_mode_kinds` is the one
mapping from an SS2D scan mode to kinds.  `kind_pairs` copies the TPU
helper ``nk_scan_v2_kind_pairs`` (:1052), which pairs forward and reverse
chains: kernel 18 interleaves each pair in one loop, and both ablation
gates refuse kinds it cannot pair.  Kernels 2 and 3 walk every kind on its
own chains.

`nk_scan` and `nk_scan_x` take the plain version only for CPU tensors; on
CUDA tensors they launch the kernel, count the launch, or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from xfmamba_tpu_torch.kernels import build
from xfmamba_tpu_torch.ops.primitives import (
    dtype_code, forward_only, layer_norm_cuda, layer_norm_plain, on_cpu, ptr, require,
    require_cuda, stream)
from xfmamba_tpu_torch.ops.cost import nk_flops, reports_cost
from xfmamba_tpu_torch.ops.fast_math import SOFTPLUS_THRESHOLD, softplus
from xfmamba_tpu_torch.ops.selective_scan import selective_scan_seq

# kind -> code of csrc/nk_scan.cu (bit 0: column-major, bit 1: reversed);
# cross2d direction k uses kind CROSS2D_KINDS[k]
KIND_CODES = {"row_f": 0, "col_f": 1, "row_r": 2, "col_r": 3}
CROSS2D_KINDS = ("row_f", "col_f", "row_r", "col_r")

# the switch of kernel 18 (the wide-state scan), off as in JAX
# (``vss_block_pallas_v2.py:109``); kernel 17's, FUSED_V4, lives in
# ``ops/ablations/nk_scan_v4.py`` as in JAX
FUSED_V3 = False


def scan_mode_kinds(scan_mode: str, K: int = 4) -> tuple:
    """Traversal kind of each of the K directions of an SS2D scan mode."""
    if scan_mode == "cross2d" and K == 4:
        return CROSS2D_KINDS
    if scan_mode == "unidi":
        return ("row_f",) * K
    if scan_mode == "bidi" and K == 4:
        return ("row_f", "row_f", "row_r", "row_r")
    raise ValueError(f"unsupported scan_mode {scan_mode!r} with K={K}")


def kind_pairs(kinds) -> list:
    """JAX's pairing of the kinds into (forward k, reverse k or None,
    family) chains (``nk_scan_v2_kind_pairs``, :1052-1071): cross2d gives
    (row_f, row_r) and (col_f, col_r), unidi each forward kind alone, bidi
    (row_f, row_r) twice.  Raises ValueError on a reverse kind left
    unpaired."""
    fwd = {"row_f": "row", "flat_f": "row", "col_f": "col"}
    rev = {"row_r": "row", "flat_r": "row", "col_r": "col"}
    unpaired_r = [(i, rev[k]) for i, k in enumerate(kinds) if k in rev]
    pairs = []
    for i, fam in ((i, fwd[k]) for i, k in enumerate(kinds) if k in fwd):
        match = next(((j, famr) for j, famr in unpaired_r if famr == fam), None)
        if match is not None:
            unpaired_r.remove(match)
        pairs.append((i, None if match is None else match[0], fam))
    if unpaired_r:
        raise ValueError(f"unpaired reverse traversals in {kinds}")
    return pairs


def _kinds_code(kinds) -> int:
    code = 0
    for k, kind in enumerate(kinds):
        if kind not in KIND_CODES:
            raise ValueError(f"unknown traversal kind {kind!r}")
        code |= KIND_CODES[kind] << (2 * k)
    return code


def traversal_order(kind: str, H: int, W: int, device=None) -> torch.Tensor:
    """Positions l = h * W + w of the row-major map in the order the kind
    visits them."""
    if kind not in KIND_CODES:
        raise ValueError(f"unknown traversal kind {kind!r}")
    t = torch.arange(H * W, device=device)
    order = (t % H) * W + t // H if kind in ("col_f", "col_r") else t
    return order.flip(0) if kind in ("row_r", "col_r") else order


# ---------------------------------------------------------------------------
# the shared scan kernel
# ---------------------------------------------------------------------------

def selective_scan_plain(u, Bs, Cs, A, bias, Dsum, kinds, H, W, *, dts=None,
                         ranks=None, w_dt=None, out_dtype=torch.float32):
    """y = u * Dsum + sum_k scan_k, each scan_k run by `selective_scan_seq`
    along its traversal.

    u (n, L, D); deltas either dts (n, L, K, D) or ranks (n, L, K, R) with
    w_dt (K, R, D); Bs/Cs (n, L, K, N); A (K, N, D); bias (K, D); Dsum (D,).
    Returns (n, L, D) in ``out_dtype``."""
    uf = u.float()
    if ranks is not None:
        z = torch.einsum("nlkr,krd->nlkd", ranks.float(), w_dt.float())
    else:
        z = dts.float()
    y = uf * Dsum.float()
    for k, kind in enumerate(kinds):
        order = traversal_order(kind, H, W, u.device)
        y[:, order] += selective_scan_seq(
            uf[:, order], z[:, order, k], A[k].float().t(),
            Bs[:, order, k:k + 1], Cs[:, order, k:k + 1],
            delta_bias=bias[k])
    return y.to(out_dtype)


def _row_strides(t, name):
    """(row, kind, element) strides of a (n, L, K, X) view over rows of one
    (n * L, C) buffer.  The stride of a size-1 axis is never stepped, so it
    is taken as the one the kernel's indexing needs."""
    n, L, K, X = t.shape
    row = t.stride(0) if L == 1 else t.stride(1)
    if n > 1 and t.stride(0) != L * row:
        raise ValueError(f"{name}: images must be consecutive rows")
    return row, t.stride(2) if K > 1 else 0, t.stride(3) if X > 1 else 1


def selective_scan_cuda(u, Bs, Cs, A, bias, Dsum, kinds, H, W, *, dts=None,
                        ranks=None, w_dt=None, out_dtype=torch.float32):
    require_cuda(u, Bs, Cs, A, bias, Dsum, dts, ranks, w_dt)
    n, L, D = u.shape
    K = len(kinds)
    N = A.shape[1]
    if L != H * W:
        raise ValueError(f"u has {L} positions, map is {H}x{W}")
    require(u, (n, L, D), name="u")
    require(A, (K, N, D), torch.float32, name="A")
    require(bias, (K, D), torch.float32, name="bias")
    require(Dsum, (D,), torch.float32, name="Dsum")
    for name, t in (("Bs", Bs), ("Cs", Cs)):
        require(t, (n, L, K, N), u.dtype, name=name, contiguous=False)
    bc = _row_strides(Bs, "Bs")
    if _row_strides(Cs, "Cs") != bc:
        raise ValueError("Bs and Cs must share their strides")
    dt_stride = rank_stride = R = 0
    if ranks is not None:
        R = ranks.shape[3]
        require(ranks, (n, L, K, R), u.dtype, name="ranks", contiguous=False)
        require(w_dt, (K, R, D), torch.float32, name="w_dt")
        rank_stride, k_stride, r_stride = _row_strides(ranks, "ranks")
        if k_stride not in (0, R) or r_stride != 1:
            raise ValueError("ranks: the K x R block of a row must be contiguous")
    else:
        require(dts, (n, L, K, D), u.dtype, name="dts", contiguous=False)
        dt_stride, k_stride, d_stride = _row_strides(dts, "dts")
        if k_stride not in (0, D) or d_stride != 1:
            raise ValueError("dts: the K x D block of a row must be contiguous")
    if u.dtype == torch.float32 and out_dtype != torch.float32:
        raise TypeError("float32 inputs give a float32 output")
    acc = torch.empty(n, L, D, dtype=torch.float32, device=u.device) if K > 1 else None
    out = torch.empty(n, L, D, dtype=out_dtype, device=u.device)
    lib = build.library()
    build.check(lib.xfm_selective_scan(
        ptr(u), ptr(dts), ptr(ranks), ptr(w_dt), ptr(Bs), ptr(Cs), ptr(A),
        ptr(bias), ptr(Dsum), ptr(acc), ptr(out), n, H, W, D, K, N, R,
        _kinds_code(kinds), dt_stride, rank_stride, *bc, dtype_code(u),
        dtype_code(out), stream(u)), "selective_scan")
    selective_scan_cuda.launches += 1
    return out


selective_scan_cuda.launches = 0


# ---------------------------------------------------------------------------
# kernels 2 and 3 (csrc/nk_scan_fused.cu)
# ---------------------------------------------------------------------------

# shared memory a block may take (the H100's 227 KB), and the most it may
# take for two blocks to share an SM
FUSION_SMEM = 227 * 1024
FUSION_PAIR_SMEM = 113 * 1024
# traversal positions the chunked plan stages at once
FUSION_CHUNK = 64
# the phases a block of kernels 2 and 3 stamps (`fusion_scan_cuda`'s
# phase_ns): issuing its copies (the traversal tables computed meanwhile),
# waiting for them, widening B and C, the deltas (with the rank product),
# the walks, the output
FUSION_PHASES = ("staging", "waiting", "widening", "deltas", "walk", "output")


def fusion_scan_plan(L, K, N, R, dtype) -> tuple:
    """(whole, chunk, rk_kinds): the whole-map plan (every kind of a
    32-channel slab in one block, the map staged at once; chunk = L) where
    its shared memory fits in `FUSION_SMEM`, else the chunked plan (a block
    per kind, chunks of `FUSION_CHUNK` positions, the kinds' parts summed by
    a second launch).  The rank form stages the ranks and w_dt of rk_kinds
    kinds at once: the most for which two such blocks still share an SM.
    At the fusion maps (7 x 7, N 16, R up to 64) a whole-map block takes
    25-113 KB."""
    return _plan(L, K, N, R, dtype == torch.bfloat16, FUSION_SMEM, FUSION_PAIR_SMEM,
                 FUSION_CHUNK)


@functools.lru_cache(maxsize=None)
def _plan(L, K, N, R, bf16, smem_limit, pair_limit, chunk_limit):
    def smem(whole, chunk, kinds):
        return build.library().xfm_fusion_scan_smem(int(whole), K, chunk, L, N, R, kinds,
                                                     int(bf16))

    if smem(True, L, 1) > smem_limit:
        return False, min(L, chunk_limit), 1
    pair = min(smem_limit, pair_limit)
    fits = [n for n in range(K, 1, -1) if R and smem(True, L, n) <= pair]
    return True, L, fits[0] if fits else 1


def _rows_aligned(t, row):
    """Rows of ``row`` elements of t may be staged with 16-byte copies."""
    return t is not None and t.data_ptr() % 16 == 0 and row * t.element_size() % 16 == 0


def fusion_scan_cuda(u, Bs, Cs, A, bias, Dsum, kinds, H, W, *, dts=None, ranks=None,
                     w_dt=None, out_dtype=torch.float32, blocks_per_sm=False,
                     phase_ns=False):
    """Kernels 2 (``dts``) and 3 (``ranks``, ``w_dt``) on the operands of
    `selective_scan_plain`, each contiguous: u (n, L, D); dts (n, L, K, D)
    or ranks (n, L, K, R) with w_dt (K, R, D) float32; Bs/Cs (n, L, K, N);
    A (K, N, D), bias (K, D), Dsum (D,) float32.  Returns y (n, L, D): in
    u.dtype from deltas, float32 from ranks (the caller's LayerNorm reads
    it).  ``launches`` counts the calls, ``by_plan`` them by plan.  With
    ``blocks_per_sm`` nothing is launched or counted: the number of the
    call's blocks an SM would hold at once is returned.  With ``phase_ns``
    the call is launched uncounted with the kernel's phase clock on and
    returns {phase: mean ns a block spends in it} (`FUSION_PHASES`, the
    chunked plan's last chunk), with "block" the mean from start to end."""
    require_cuda(u, Bs, Cs, A, bias, Dsum, dts, ranks, w_dt)
    n, L, D = u.shape
    K = len(kinds)
    N = A.shape[1]
    if L != H * W:
        raise ValueError(f"u has {L} positions, map is {H}x{W}")
    require(u, (n, L, D), name="u")
    require(A, (K, N, D), torch.float32, name="A")
    require(bias, (K, D), torch.float32, name="bias")
    require(Dsum, (D,), torch.float32, name="Dsum")
    require(Bs, (n, L, K, N), u.dtype, name="Bs")
    require(Cs, (n, L, K, N), u.dtype, name="Cs")
    if ranks is not None:
        R = ranks.shape[3]
        require(ranks, (n, L, K, R), u.dtype, name="ranks")
        require(w_dt, (K, R, D), torch.float32, name="w_dt")
        if out_dtype != torch.float32:
            raise TypeError("the rank form gives a float32 output")
    else:
        R = 0
        require(dts, (n, L, K, D), u.dtype, name="dts")
        if out_dtype != u.dtype:
            raise TypeError("the dts form gives an output in the inputs' dtype")
    whole, chunk, rk_kinds = fusion_scan_plan(L, K, N, R, u.dtype)
    part = None if whole else torch.empty(K, n, L, D, dtype=torch.float32, device=u.device)
    out = torch.empty(n, L, D, dtype=out_dtype, device=u.device)
    per_channel = all(_rows_aligned(t, D) for t in (bias, Dsum, w_dt) if t is not None)
    vec = (_rows_aligned(u, D) | _rows_aligned(dts, D) << 1 | _rows_aligned(ranks, R) << 2
           | per_channel << 3 | (_rows_aligned(Bs, N) and _rows_aligned(Cs, N)) << 4)
    blocks = ctypes.c_int(0) if blocks_per_sm else None
    stamps = None
    if phase_ns:
        grid = -(-D // 32) * n * (1 if whole else K)
        stamps = torch.zeros(grid, len(FUSION_PHASES) + 1, dtype=torch.int64, device=u.device)
    build.check(build.library().xfm_fusion_scan(
        ptr(u), ptr(dts), ptr(ranks), ptr(w_dt), ptr(Bs), ptr(Cs), ptr(A), ptr(bias),
        ptr(Dsum), ptr(out), ptr(part), n, H, W, D, K, N, R, _kinds_code(kinds), int(whole),
        chunk, vec, rk_kinds, dtype_code(u), None if blocks is None else ctypes.byref(blocks),
        ptr(stamps), stream(u)), "fusion_scan")
    if phase_ns:
        t = stamps.double()
        return dict(zip(FUSION_PHASES, t.diff(dim=1).mean(0).tolist())) | {
            "block": float((t[:, -1] - t[:, 0]).mean())}
    if blocks_per_sm:
        return blocks.value
    # counted once launched
    fusion_scan_cuda.launches += 1
    plan = ("whole" if whole else f"chunked x{-(-L // chunk)}") + (
        f", ranks of {rk_kinds} kinds" if R else "")
    fusion_scan_cuda.by_plan[plan] = fusion_scan_cuda.by_plan.get(plan, 0) + 1
    return out


fusion_scan_cuda.launches = 0
fusion_scan_cuda.by_plan = {}


# ---------------------------------------------------------------------------
# the shared adjoint scan kernel (csrc/nk_scan_bwd.cu)
# ---------------------------------------------------------------------------

def _deltas(dts, ranks, w_dt):
    """z (n, L, K, D) float32: the pre-bias deltas, given or projected."""
    if ranks is not None:
        return torch.einsum("nlkr,krd->nlkd", ranks.float(), w_dt.float())
    return dts.float()


@torch.no_grad()
def selective_scan_bwd_plain(u, Bs, Cs, A, bias, Dsum, kinds, H, W, gy, *,
                             dts=None, ranks=None, w_dt=None, dB=None, dC=None):
    """Adjoint of `selective_scan_plain`, written as the kernel computes it
    (see ``csrc/nk_scan_bwd.cu``): per kind, a forward pass that keeps every
    state h, then the reverse chain g[t] = C[t] gy[t] + a[t+1] g[t+1].

    gy (n, L, D) is the gradient of the float32 output.  Returns a dict:
    du (n, L, D) float32; dz (n, L, K, D) in u.dtype, the gradient of the
    deltas before bias and softplus (the dts gradient in dts form); dB, dC
    (n, L, K, N), dA (K, N, D), dDsum (D,), dbias (K, D), all float32.
    Given ``dB``/``dC`` views, the B and C gradients are written into them,
    as the kernel does."""
    n, L, D = u.shape
    K, N = A.shape[0], A.shape[1]
    uf, gy = u.float(), gy.float()
    z = _deltas(dts, ranks, w_dt)
    du = gy * Dsum.float()
    dz = torch.empty(n, L, K, D, dtype=torch.float32, device=u.device)
    dB_out, dC_out = dB, dC
    dB = torch.empty(n, L, K, N, dtype=torch.float32, device=u.device)
    dC = torch.empty_like(dB)
    dA = torch.empty(K, N, D, dtype=torch.float32, device=u.device)
    dbias = torch.empty(K, D, dtype=torch.float32, device=u.device)
    for k, kind in enumerate(kinds):
        order = traversal_order(kind, H, W, u.device)
        zb = z[:, order, k] + bias[k].float()                  # (n, L, D)
        delta = softplus(zb)
        uo, go = uf[:, order], gy[:, order]
        Bk = Bs[:, order, k].float()[:, :, None, :]            # (n, L, 1, N)
        Ck = Cs[:, order, k].float()[:, :, None, :]
        Ak = A[k].float().t()                                  # (D, N)
        a = torch.exp(delta[..., None] * Ak)                   # (n, L, D, N)
        b = (delta * uo)[..., None] * Bk
        hs = torch.empty_like(a)
        h = torch.zeros_like(a[:, 0])
        for t in range(L):
            h = a[:, t] * h + b[:, t]
            hs[:, t] = h
        gs = torch.empty_like(a)
        g = torch.zeros_like(h)
        for t in range(L - 1, -1, -1):
            g = Ck[:, t] * go[:, t, :, None] + (a[:, t + 1] * g if t + 1 < L else 0.0)
            gs[:, t] = g
        hprev = torch.cat([torch.zeros_like(hs[:, :1]), hs[:, :-1]], 1)
        dB[:, order, k] = (gs * (delta * uo)[..., None]).sum(2)
        dC[:, order, k] = (go[..., None] * hs).sum(2)
        du[:, order] += (gs * delta[..., None] * Bk).sum(-1)
        ddelta = (gs * (uo[..., None] * Bk + hprev * a * Ak)).sum(-1)
        dA[k] = (gs * hprev * a * delta[..., None]).sum((0, 1)).t()
        dzk = ddelta * torch.where(zb > SOFTPLUS_THRESHOLD, torch.ones_like(zb),
                                   torch.sigmoid(zb))
        dz[:, order, k] = dzk
        dbias[k] = dzk.sum((0, 1))
    if dB_out is not None:
        dB, dC = dB_out.copy_(dB), dC_out.copy_(dC)
    return dict(du=du, dz=dz.to(u.dtype), dB=dB, dC=dC, dA=dA,
                dDsum=(gy * uf).sum((0, 1)), dbias=dbias)


def selective_scan_bwd_cuda(u, Bs, Cs, A, bias, Dsum, kinds, H, W, gy, *,
                            dts=None, ranks=None, w_dt=None, dB=None, dC=None):
    """The adjoint kernel.  ``dB``/``dC``, when given, are zeroed float32
    views of Bs's/Cs's shape (for example into one buffer laid out as the
    one Bs and Cs are read from) that receive the B and C gradients."""
    require_cuda(u, Bs, Cs, A, bias, Dsum, gy, dts, ranks, w_dt, dB, dC)
    n, L, D = u.shape
    K = len(kinds)
    N = A.shape[1]
    if L != H * W:
        raise ValueError(f"u has {L} positions, map is {H}x{W}")
    require(u, (n, L, D), name="u")
    require(gy, (n, L, D), torch.float32, name="gy")
    require(A, (K, N, D), torch.float32, name="A")
    require(bias, (K, D), torch.float32, name="bias")
    require(Dsum, (D,), torch.float32, name="Dsum")
    for name, t in (("Bs", Bs), ("Cs", Cs)):
        require(t, (n, L, K, N), u.dtype, name=name, contiguous=False)
    bc = _row_strides(Bs, "Bs")
    if _row_strides(Cs, "Cs") != bc:
        raise ValueError("Bs and Cs must share their strides")
    if dB is None:
        dB = torch.zeros(n, L, K, N, dtype=torch.float32, device=u.device)
        dC = torch.zeros_like(dB)
    for name, t in (("dB", dB), ("dC", dC)):
        require(t, (n, L, K, N), torch.float32, name=name, contiguous=False)
    dbc = _row_strides(dB, "dB")
    if _row_strides(dC, "dC") != dbc:
        raise ValueError("dB and dC must share their strides")
    dt_stride = rank_stride = R = 0
    if ranks is not None:
        R = ranks.shape[3]
        require(ranks, (n, L, K, R), u.dtype, name="ranks", contiguous=False)
        require(w_dt, (K, R, D), torch.float32, name="w_dt")
        rank_stride, k_stride, r_stride = _row_strides(ranks, "ranks")
        if k_stride not in (0, R) or r_stride != 1:
            raise ValueError("ranks: the K x R block of a row must be contiguous")
    else:
        require(dts, (n, L, K, D), u.dtype, name="dts", contiguous=False)
        dt_stride, k_stride, d_stride = _row_strides(dts, "dts")
        if k_stride not in (0, D) or d_stride != 1:
            raise ValueError("dts: the K x D block of a row must be contiguous")
    f32 = dict(dtype=torch.float32, device=u.device)
    hbuf = torch.empty(n * L, N, D, **f32)
    du = torch.empty(n, L, D, **f32)
    dz = torch.empty(n, L, K, D, dtype=u.dtype, device=u.device)
    dA = torch.zeros(K, N, D, **f32)
    dDsum = torch.zeros(D, **f32)
    dbias = torch.zeros(K, D, **f32)
    lib = build.library()
    build.check(lib.xfm_selective_scan_bwd(
        ptr(u), ptr(dts), ptr(ranks), ptr(w_dt), ptr(Bs), ptr(Cs), ptr(A), ptr(bias),
        ptr(Dsum), ptr(gy), ptr(hbuf), ptr(du), ptr(dz), ptr(dB), ptr(dC), ptr(dA),
        ptr(dDsum), ptr(dbias), n, H, W, D, K, N, R, _kinds_code(kinds), dt_stride,
        rank_stride, *bc, *dbc, dtype_code(u), stream(u)), "selective_scan_bwd")
    selective_scan_bwd_cuda.launches += 1
    return dict(du=du, dz=dz, dB=dB, dC=dC, dA=dA, dDsum=dDsum, dbias=dbias)


selective_scan_bwd_cuda.launches = 0


# ---------------------------------------------------------------------------
# kernel 2: ShallowFuse scan from precomputed deltas
# ---------------------------------------------------------------------------

def _nk_operands(u, Bs, Cs, A, Dvec, bias, kinds):
    n, L, D = u.shape
    K = len(kinds)
    N = A.shape[0] // K
    return dict(u=u, Bs=Bs.reshape(n, L, K, N), Cs=Cs.reshape(n, L, K, N),
                A=A.float().reshape(K, N, D).contiguous(),
                bias=bias.float().reshape(K, D).contiguous(),
                Dsum=Dvec.float().reshape(K, D).sum(0).contiguous(),
                kinds=kinds)


def nk_scan_plain(u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds):
    n, L, D = u.shape
    return selective_scan_plain(
        H=H, W=W, dts=dts.reshape(n, L, len(kinds), D), out_dtype=u.dtype,
        **_nk_operands(u, Bs, Cs, A, Dvec, bias, kinds))


def nk_scan_group(B: int, L: int, W: int, group: int) -> int:
    """The image group G of JAX's dispatcher (:1084-1085): ``group`` where
    it divides B and keeps L * G and W * G multiples of 8, else 1."""
    aligned = B % group == 0 and (L * group) % 8 == 0 and (W * group) % 8 == 0
    return group if aligned else 1


def nk_scan_route(B, L, W, D, K, N, group, kinds) -> str:
    """Which kernel `nk_scan` launches for B images of L = H * W positions:
    "v4" (kernel 17) where `FUSED_V4` is on and `nk_scan_v4_supported`
    holds at the group G of `nk_scan_group`, else "v3" (kernel 18) where
    `FUSED_V3` is on and `nk_scan_v3_supported` holds, else "v2" (kernel 2),
    as JAX's :1090-1098.  Where G leaves L * G or W * G unaligned JAX runs
    the v1 kernel; the port's callers send those batches to kernel 9 before
    they reach `nk_scan` (`ops/nk_scan_v1.py`), and both ablation gates
    refuse them, so the route is "v2" there."""
    # imported here: the ablation modules import this one
    from xfmamba_tpu_torch.ops.ablations import nk_scan_v4, nk_scan_wide
    G = nk_scan_group(B, L, W, group)
    if nk_scan_v4.FUSED_V4 and nk_scan_v4.nk_scan_v4_supported(L, W, G, kinds):
        return "v4"
    if FUSED_V3 and nk_scan_wide.nk_scan_v3_supported(L, W, D, K, N, G, kinds):
        return "v3"
    return "v2"


def nk_scan(u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds, group=8):
    """u (B, L, D); dts (B, L, K*D); Bs/Cs (B, L, K*N); A (K*N, D) with rows
    in (k, n) order; Dvec (K, D); bias (K, D); ``group`` the image group the
    caller asks for (JAX's argument; it picks the route only).  Returns (B,
    L, D) in u.dtype: sum_k C_k h_k + u * sum_k D_k.  On CUDA tensors the
    kernel `nk_scan_route` names; ``nk_scan.launches`` counts kernel 2's."""
    if on_cpu(u, dts, Bs, Cs, A, Dvec, bias):
        return nk_scan_plain(u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds)
    forward_only("nk_scan", u, dts, Bs, Cs, A, Dvec, bias)
    n, L, D = u.shape
    K = len(kinds)
    route = nk_scan_route(n, L, W, D, K, A.shape[0] // K, group, kinds)
    if route != "v2":
        from xfmamba_tpu_torch.ops.ablations import nk_scan_v4, nk_scan_wide
        scan = nk_scan_v4.nk_scan_v4 if route == "v4" else nk_scan_wide.nk_scan_v3
        return scan(u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds,
                    group=nk_scan_group(n, L, W, group))
    for name, t in (("u", u), ("dts", dts), ("Bs", Bs), ("Cs", Cs)):
        require(t, (n, L, None), u.dtype, name=name)
    out = fusion_scan_cuda(
        H=H, W=W, dts=dts.view(n, L, len(kinds), D), out_dtype=u.dtype,
        **_nk_operands(u, Bs, Cs, A, Dvec, bias, kinds))
    nk_scan.launches += 1  # counted once launched
    return out


nk_scan.launches = 0


# ---------------------------------------------------------------------------
# kernel 3: Cross_SS2Dv5 rank-form scan with the out-norm epilogue
# ---------------------------------------------------------------------------

def _rank_operands(u, ranks, w_dt, kinds):
    n, L, D = u.shape
    K = len(kinds)
    R = w_dt.shape[0] // K
    return dict(ranks=ranks.reshape(n, L, K, R),
                w_dt=w_dt.float().reshape(K, R, D).contiguous())


def nk_scan_x_plain(u, ranks, Bs, Cs, w_dt, A, Dvec, bias, lno, H, W, kinds):
    n, L, D = u.shape
    y = selective_scan_plain(H=H, W=W, **_rank_operands(u, ranks, w_dt, kinds),
                             **_nk_operands(u, Bs, Cs, A, Dvec, bias, kinds))
    lno = lno.float()
    return layer_norm_plain(y.view(n * L, D), lno[0], lno[1], u.dtype).view(n, L, D)


def _nk_scan_x_flops(u, ranks, Bs, Cs, w_dt, A, Dvec, bias, lno, H, W, kinds):
    """The dt projection from the ranks, and the scan."""
    B, L, D = u.shape
    return 2 * B * L * ranks.shape[-1] * D + nk_flops(u, A, kinds)


@reports_cost(_nk_scan_x_flops)
def nk_scan_x(u, ranks, Bs, Cs, w_dt, A, Dvec, bias, lno, H, W, kinds):
    """u (B, L, D); ranks (B, L, K*R); Bs/Cs (B, L, K*N); w_dt (K*R, D);
    A (K*N, D); Dvec/bias (K, D); lno (2, D) out-norm scale and shift.
    Returns LayerNorm(y) (B, L, D) in u.dtype."""
    if on_cpu(u, ranks, Bs, Cs, w_dt, A, Dvec, bias, lno):
        return nk_scan_x_plain(u, ranks, Bs, Cs, w_dt, A, Dvec, bias, lno,
                               H, W, kinds)
    forward_only("nk_scan_x", u, ranks, Bs, Cs, w_dt, A, Dvec, bias, lno)
    n, L, D = u.shape
    for name, t in (("u", u), ("ranks", ranks), ("Bs", Bs), ("Cs", Cs)):
        require(t, (n, L, None), u.dtype, name=name)
    require(lno, (2, D), name="lno")
    y = fusion_scan_cuda(H=H, W=W, **_rank_operands(u, ranks, w_dt, kinds),
                         **_nk_operands(u, Bs, Cs, A, Dvec, bias, kinds))
    lno = lno.float()
    out = layer_norm_cuda(y.view(n * L, D), lno[0].contiguous(),
                          lno[1].contiguous(), u.dtype).view(n, L, D)
    nk_scan_x.launches += 1  # counted once launched
    return out


nk_scan_x.launches = 0

"""Whole-map selective scans: the shared scan kernel of ``csrc/nk_scan.cu``
and the two fusion-op kernels built on it.

- `selective_scan_cuda`: the CUDA scan (K traversal kinds x N states,
  deltas precomputed or in rank form) beside its plain version
  `selective_scan_plain`.  Kernel 1 (``ops/vss_stage.py``) calls it for the
  backbone's cross2d scans.
- `nk_scan`: port of ``xfmamba_tpu/ops/vss_block_pallas_v2.py::
  nk_scan_call_v2`` (:1076; TPU kernel ``_nk_scan_kernel_v2`` :890), the
  ShallowFuse scan from precomputed deltas.
- `nk_scan_x`: port of ``nk_scan_call_v2r`` (:1005; TPU kernel
  ``_nk_scan_x_kernel_v2`` :944), the Cross_SS2Dv5 scan with the rank->D
  delta projection in the kernel and the out-norm LayerNorm as epilogue.

The kinds name each direction's traversal of the flattened H x W map; all
are flat over L (the state carries across rows, or across columns for the
column kinds, which walk t = w * H + h).  `scan_mode_kinds` is the one
mapping from an SS2D scan mode to kinds.  The TPU helper
``nk_scan_v2_kind_pairs`` has no counterpart: it pairs forward and reverse
chains to interleave them in one TPU loop, while a CUDA thread walks each
kind on its own.

`nk_scan` and `nk_scan_x` take the plain version only for CPU tensors; on
CUDA tensors they launch the kernel, count the launch, or raise.
"""

from __future__ import annotations

import torch

from xfmamba_tpu_torch.kernels import build
from xfmamba_tpu_torch.ops.primitives import (
    dtype_code, layer_norm_cuda, layer_norm_plain, on_cpu, ptr, require,
    require_cuda, stream)
from xfmamba_tpu_torch.ops.selective_scan import selective_scan_seq

# kind -> code of csrc/nk_scan.cu (bit 0: column-major, bit 1: reversed);
# cross2d direction k uses kind CROSS2D_KINDS[k]
KIND_CODES = {"row_f": 0, "col_f": 1, "row_r": 2, "col_r": 3}
CROSS2D_KINDS = ("row_f", "col_f", "row_r", "col_r")


def scan_mode_kinds(scan_mode: str, K: int = 4) -> tuple:
    """Traversal kind of each of the K directions of an SS2D scan mode."""
    if scan_mode == "cross2d" and K == 4:
        return CROSS2D_KINDS
    if scan_mode == "unidi":
        return ("row_f",) * K
    if scan_mode == "bidi" and K == 4:
        return ("row_f", "row_f", "row_r", "row_r")
    raise ValueError(f"unsupported scan_mode {scan_mode!r} with K={K}")


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
    selective_scan_cuda.launches += 1
    build.check(lib.xfm_selective_scan(
        ptr(u), ptr(dts), ptr(ranks), ptr(w_dt), ptr(Bs), ptr(Cs), ptr(A),
        ptr(bias), ptr(Dsum), ptr(acc), ptr(out), n, H, W, D, K, N, R,
        _kinds_code(kinds), dt_stride, rank_stride, *bc, dtype_code(u),
        dtype_code(out), stream(u)), "selective_scan")
    return out


selective_scan_cuda.launches = 0


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


def nk_scan(u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds):
    """u (B, L, D); dts (B, L, K*D); Bs/Cs (B, L, K*N); A (K*N, D) with rows
    in (k, n) order; Dvec (K, D); bias (K, D).  Returns (B, L, D) in
    u.dtype: sum_k C_k h_k + u * sum_k D_k."""
    if on_cpu(u, dts, Bs, Cs, A, Dvec, bias):
        return nk_scan_plain(u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds)
    n, L, D = u.shape
    for name, t in (("u", u), ("dts", dts), ("Bs", Bs), ("Cs", Cs)):
        require(t, (n, L, None), u.dtype, name=name)
    nk_scan.launches += 1
    return selective_scan_cuda(
        H=H, W=W, dts=dts.view(n, L, len(kinds), D), out_dtype=u.dtype,
        **_nk_operands(u, Bs, Cs, A, Dvec, bias, kinds))


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


def nk_scan_x(u, ranks, Bs, Cs, w_dt, A, Dvec, bias, lno, H, W, kinds):
    """u (B, L, D); ranks (B, L, K*R); Bs/Cs (B, L, K*N); w_dt (K*R, D);
    A (K*N, D); Dvec/bias (K, D); lno (2, D) out-norm scale and shift.
    Returns LayerNorm(y) (B, L, D) in u.dtype."""
    if on_cpu(u, ranks, Bs, Cs, w_dt, A, Dvec, bias, lno):
        return nk_scan_x_plain(u, ranks, Bs, Cs, w_dt, A, Dvec, bias, lno,
                               H, W, kinds)
    n, L, D = u.shape
    for name, t in (("u", u), ("ranks", ranks), ("Bs", Bs), ("Cs", Cs)):
        require(t, (n, L, None), u.dtype, name=name)
    require(lno, (2, D), name="lno")
    nk_scan_x.launches += 1
    y = selective_scan_cuda(H=H, W=W, **_rank_operands(u, ranks, w_dt, kinds),
                            **_nk_operands(u, Bs, Cs, A, Dvec, bias, kinds))
    lno = lno.float()
    return layer_norm_cuda(y.view(n * L, D), lno[0].contiguous(),
                           lno[1].contiguous(), u.dtype).view(n, L, D)


nk_scan_x.launches = 0

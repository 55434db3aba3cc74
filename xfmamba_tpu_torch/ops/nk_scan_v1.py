"""Kernel 9, the v1 nk scan, and the two-level scan of its first design
(``csrc/scan_two_level.cu``), which kernel 8's launch sequence still runs.

- `scan_two_level_cuda`: the two-level whole-map scan (K traversal kinds x
  N states, deltas precomputed or in rank form), parallel along L: each
  image row (row kinds) or column (column kinds) is a segment, reduced to
  its pair, chained across the map, and walked again from its carry.  Its
  plain twin `scan_two_level_plain` is the serial `selective_scan_plain`,
  the same function: the two levels reassociate the products of ``a``, so
  float32 agrees to about 1e-5 relative, not bit for bit.
- `nk_scan_v1`: port of ``xfmamba_tpu/ops/vss_block_pallas.py::
  nk_scan_call`` (:720, TPU kernel ``_nk_scan_kernel`` :690, also behind
  ``nk_scan_from_projs`` :756), kernel 2's contract; on the card one launch
  of the whole-map scan (``ops/scan_whole_map.py``, `nk_scan_v1_cuda`);
  inference only, as on the TPU.  `nk_scan_v1_first` is its first design
  on the two-level scan, for old-against-new timings.
- The fusion ops' routing rules of the JAX accelerator path, copied as they
  are (pure Python): `shallow_group` / `shallow_takes_v2` (ShallowFuse,
  ``models/fusion.py:176-180``), `cross_v2_group` (Cross_SS2Dv5,
  ``:391-393``) and `nk_from_projs_group` (``nk_scan_from_projs``,
  ``vss_block_pallas.py:774-779``).  Where the v2 rule finds no image group
  aligned to 8 sublanes, JAX runs the v1 kernel, and so does the port.  A
  group size changes nothing in what a CUDA kernel computes; the rule picks
  the route only.

`nk_scan_v1` takes its plain twin only for CPU tensors; on CUDA tensors it
launches the kernel, adds one to ``nk_scan_v1.launches``, or raises.
"""

from __future__ import annotations

import torch

from xfmamba_tpu_torch.kernels import build
from xfmamba_tpu_torch.ops.cost import nk_flops, reports_cost
from xfmamba_tpu_torch.ops.nk_scan import (
    _kinds_code, _nk_operands, _row_strides, nk_scan_plain, selective_scan_plain)
from xfmamba_tpu_torch.ops.primitives import (
    dtype_code, forward_only, on_cpu, ptr, require, require_cuda, stream)
from xfmamba_tpu_torch.ops.scan_whole_map import scan_whole_map_cuda

# chunks of one (image, kind) chain: the threads along L of a kernel block
MAX_CHUNKS = 16
MAX_RANK = 64


def segments_per_chunk(H: int, W: int) -> int:
    """Image rows (or columns) per chunk: the fewest that keep both
    orientations' chunk counts within `MAX_CHUNKS`."""
    return -(-max(H, W) // MAX_CHUNKS)


# ---------------------------------------------------------------------------
# the routing rules of the fusion ops (JAX accelerator path)
# ---------------------------------------------------------------------------

def shallow_group(B: int, L: int) -> int:
    """ShallowFuse's image group (``fusion.py:176-177``)."""
    return max([g for g in (8, 4, 2, 1) if B % g == 0 and g * L <= 4096] or [1])


def shallow_takes_v2(B: int, L: int, W: int) -> bool:
    """Whether ShallowFuse's inference scan takes the v2 kernel (kernel 2)
    rather than v1 (kernel 9) (``fusion.py:178-180``)."""
    g = shallow_group(B, L)
    return (L * g) % 8 == 0 and (W * g) % 8 == 0


def cross_v2_group(Bc: int, H: int, W: int):
    """Cross_SS2Dv5's v2 image group over its 3B streams, or None: then its
    inference scan takes v1 (``fusion.py:391-393``)."""
    return next((g for g in (8, 4, 2)
                 if Bc % g == 0 and (H * W * g) % 8 == 0 and (W * g) % 8 == 0), None)


def nk_from_projs_group(B: int, L: int) -> int:
    """The v1 group of ``nk_scan_from_projs`` (``vss_block_pallas.py:
    774-779``)."""
    return next((g for g in (8, 4, 2) if B % g == 0 and g * L <= 4096), 1)


# ---------------------------------------------------------------------------
# the two-level scan (csrc/scan_two_level.cu)
# ---------------------------------------------------------------------------

def scan_two_level_plain(u, Bs, Cs, A, bias, Dsum, kinds, H, W, *, dts=None, ranks=None,
                         w_dt=None, out_dtype=torch.float32, round_rank=False):
    """`selective_scan_plain` with the rank values rounded to bfloat16 when
    ``round_rank`` (the v1 block kernel's ``xdbl_mm`` cast)."""
    if round_rank:
        ranks = ranks.to(torch.bfloat16)
    return selective_scan_plain(u, Bs, Cs, A, bias, Dsum, kinds, H, W, dts=dts, ranks=ranks,
                                w_dt=w_dt, out_dtype=out_dtype)


def scan_two_level_cuda(u, Bs, Cs, A, bias, Dsum, kinds, H, W, *, dts=None, ranks=None,
                        w_dt=None, out_dtype=torch.float32, round_rank=False):
    """The two-level scan kernel; operands as `selective_scan_plain` takes
    them: u (n, L, D); dts (n, L, K, D) or ranks (n, L, K, R) with w_dt
    (K, R, D); Bs/Cs (n, L, K, N), strided views of one buffer allowed; A
    (K, N, D); bias (K, D); Dsum (D,).  Returns (n, L, D) in ``out_dtype``."""
    require_cuda(u, Bs, Cs, A, bias, Dsum, dts, ranks, w_dt)
    n, L, D = u.shape
    K = len(kinds)
    N = A.shape[1]
    if L != H * W:
        raise ValueError(f"u has {L} positions, map is {H}x{W}")
    if not 1 <= N <= 16:
        raise ValueError(f"d_state {N}: the two-level scan takes 1..16")
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
        if not 1 <= R <= MAX_RANK:
            raise ValueError(f"dt rank {R} outside 1..{MAX_RANK}")
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
    part = torch.empty(K, n, L, D, dtype=torch.float32, device=u.device)
    out = torch.empty(n, L, D, dtype=out_dtype, device=u.device)
    lib = build.library()
    build.check(lib.xfm_scan_two_level(
        ptr(u), ptr(dts), ptr(ranks), ptr(w_dt), ptr(Bs), ptr(Cs), ptr(A), ptr(bias),
        ptr(Dsum), ptr(part), ptr(out), n, H, W, D, K, N, R, _kinds_code(kinds),
        segments_per_chunk(H, W), dt_stride, rank_stride, *bc, int(round_rank),
        dtype_code(u), dtype_code(out), stream(u)), "scan_two_level")
    return out


# ---------------------------------------------------------------------------
# kernel 9
# ---------------------------------------------------------------------------

def nk_scan_v1_plain(u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds):
    """The serial scan of kernel 2's plain twin: the same function."""
    return nk_scan_plain(u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds)


@reports_cost(lambda u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds: nk_flops(u, A, kinds))
def nk_scan_v1(u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds):
    """Kernel 9; the contract of ``ops.nk_scan.nk_scan``: u (B, L, D); dts
    (B, L, K*D); Bs/Cs (B, L, K*N); A (K*N, D) with rows in (k, n) order;
    Dvec (K, D); bias (K, D).  Returns (B, L, D) in u.dtype: sum_k C_k h_k +
    u * sum_k D_k.  No gradient: inference only, as the TPU kernel."""
    if on_cpu(u, dts, Bs, Cs, A, Dvec, bias):
        return nk_scan_v1_plain(u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds)
    forward_only("nk_scan_v1", u, dts, Bs, Cs, A, Dvec, bias)
    n, L, D = u.shape
    for name, t in (("u", u), ("dts", dts), ("Bs", Bs), ("Cs", Cs)):
        require(t, (n, L, None), u.dtype, name=name)
    out = nk_scan_v1_cuda(u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds)
    nk_scan_v1.launches += 1  # counted once launched
    return out


nk_scan_v1.launches = 0


def nk_scan_v1_cuda(u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds, phase_ns=False):
    """Kernel 9 on the card: one launch of ``csrc/scan_whole_map.cu``,
    sum_k D_k taken in the kernel; ``phase_ns`` as `scan_whole_map_cuda`."""
    n, L, D = u.shape
    K = len(kinds)
    N = A.shape[0] // K
    return scan_whole_map_cuda(
        u, dts.view(n, L, K, D), Bs.view(n, L, K, N), Cs.view(n, L, K, N),
        A.float().reshape(K, N, D).contiguous(), bias.float().reshape(K, D).contiguous(),
        Dvec.float().reshape(K, D).contiguous(), kinds, H, W, cross=False, out_dtype=u.dtype,
        phase_ns=phase_ns)


def nk_scan_v1_first(u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds):
    """Kernel 9's first design, the two-level scan and its merge, kept for
    old-against-new timings."""
    n, L, D = u.shape
    return scan_two_level_cuda(H=H, W=W, dts=dts.view(n, L, len(kinds), D), out_dtype=u.dtype,
                               **_nk_operands(u, Bs, Cs, A, Dvec, bias, kinds))

"""Kernel 17: the inline-a/b nk scan (port of
``xfmamba_tpu/ops/ablations/nk_scan_v4.py``, TPU kernel
``_nk_scan_kernel_v4`` :50, host ``nk_scan_call_v4`` :174).

Kernel 2's function under kernel 2's contract (``ops/nk_scan.py::nk_scan``,
which launches this kernel where JAX's dispatcher runs v4: `FUSED_V4` on
and `nk_scan_v4_supported` true).  On the card (``csrc/nk_scan_ablations.cu``,
launched by ``ablation_scan.py``) one launch a call: a block per (image,
slab of channels) with every kind stages its map slice on chip, and a lane
per (kind, channel, state) walks one state of one chain, forming a and b
inline at every step; shuffles within the lane group sum C h over the
states at every step, with no barrier in the walk.  The kinds' parts of y
stay in shared memory and are summed in kind order, as the plain twin adds
them; nothing goes to device memory as scratch.  What bounds it: the
exponentials on the special-function units, as for kernel 2, and the
shared-memory pipe (two loads and four shuffles a lane and step at N = 16,
4x kernel 2's per state).

`nk_scan_v4` takes its plain twin only for CPU tensors; on CUDA tensors it
launches the kernel (`nk_scan_v4_cuda`), adds one to ``nk_scan_v4.launches``,
or raises.  `nk_scan_v4_first` is the first design
(``csrc/nk_scan_ablations_v1.cu``: a thread per (image, channel, state),
operands loaded from device memory inside the walk, the kinds one after
another through a float32 scratch), kept for old-against-new timings.
"""

from __future__ import annotations

import torch

from xfmamba_tpu_torch.kernels import build
from xfmamba_tpu_torch.ops.ablations.ablation_scan import ablation_scan_cuda
from xfmamba_tpu_torch.ops.nk_scan import _kinds_code, _nk_operands, kind_pairs, nk_scan_plain
from xfmamba_tpu_torch.ops.primitives import (
    dtype_code, forward_only, on_cpu, ptr, require, require_cuda, stream)

# off by default, as in JAX (measured slower than v2 on the TPU)
FUSED_V4 = False


def nk_scan_v4_supported(L: int, W: int, G: int, kinds) -> bool:
    """JAX's gate (:162-169): the kinds pair up and the image group is 8
    with the row-major tiling aligned."""
    try:
        kind_pairs(kinds)
    except ValueError:
        return False
    return G == 8 and (L * G) % 8 == 0 and (W * G) % 8 == 0


def nk_scan_v4_plain(u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds):
    """Kernel 2's plain twin: the same function; the kernel sums the states
    per position in another order."""
    return nk_scan_plain(u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds)


def nk_scan_v4(u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds, group=8):
    """u (B, L, D); dts (B, L, K*D); Bs/Cs (B, L, K*N); A (K*N, D) with rows
    in (k, n) order; Dvec (K, D); bias (K, D); ``group`` the image group G
    of the gate, which must hold, as JAX asserts.  Returns (B, L, D) in
    u.dtype."""
    if on_cpu(u, dts, Bs, Cs, A, Dvec, bias):
        return nk_scan_v4_plain(u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds)
    forward_only("nk_scan_v4", u, dts, Bs, Cs, A, Dvec, bias)
    n, L, D = u.shape
    K = len(kinds)
    N = A.shape[0] // K
    if L != H * W:
        raise ValueError(f"u has {L} positions, map is {H}x{W}")
    if not nk_scan_v4_supported(L, W, group, kinds) or n % group:
        raise ValueError(f"kernel 17 takes an image group of 8 dividing the batch and paired "
                         f"kinds: B={n} L={L} W={W} group={group} kinds={kinds}")
    if not 1 <= N <= 16:
        raise ValueError(f"d_state {N}: kernel 17 takes 1..16")
    require(u, (n, L, D), name="u")
    require(dts, (n, L, K * D), u.dtype, name="dts")
    require(Bs, (n, L, K * N), u.dtype, name="Bs")
    require(Cs, (n, L, K * N), u.dtype, name="Cs")
    return nk_scan_v4_cuda(u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds)


nk_scan_v4.launches = 0


def nk_scan_v4_cuda(u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds, phase_ns=False):
    """Kernel 17 on the card: one launch of ``csrc/nk_scan_ablations.cu``,
    which sums Dvec over the kinds itself (no other device launch), counted
    in ``nk_scan_v4.launches``; ``phase_ns`` as
    ``ablation_scan.ablation_scan_cuda``."""
    n, L, D = u.shape
    K = len(kinds)
    return ablation_scan_cuda(
        "v4", u, dts, Bs, Cs, A.float().reshape(K, -1, D).contiguous(),
        bias.float().reshape(K, D).contiguous(), Dvec.float().reshape(K, D).contiguous(), kinds,
        H, W, counter=nk_scan_v4, phase_ns=phase_ns)


def nk_scan_v4_first(u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds):
    """Kernel 17's first design (``csrc/nk_scan_ablations_v1.cu``), kept for
    old-against-new timings; ``nk_scan_v4_first.launches`` counts it."""
    require_cuda(u, dts, Bs, Cs, A, Dvec, bias)
    n, L, D = u.shape
    K = len(kinds)
    N = A.shape[0] // K
    ops = _nk_operands(u, Bs, Cs, A, Dvec, bias, kinds)
    acc = torch.empty(n, L, D, dtype=torch.float32, device=u.device) if K > 1 else None
    out = torch.empty_like(u)
    build.check(build.library().xfm_nk_scan_v4_first(
        ptr(u), ptr(dts), ptr(Bs), ptr(Cs), ptr(ops["A"]), ptr(ops["bias"]), ptr(ops["Dsum"]),
        ptr(acc), ptr(out), n, H, W, D, K, N, _kinds_code(kinds), dtype_code(u), stream(u)),
        "nk_scan_v4_first")
    nk_scan_v4_first.launches += 1
    return out


nk_scan_v4_first.launches = 0

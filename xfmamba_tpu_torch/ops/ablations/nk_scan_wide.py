"""Kernel 18: the wide-state nk scan (port of
``xfmamba_tpu/ops/ablations/nk_scan_wide.py``, TPU kernel
``_nk_scan_kernel_v3`` :40, host ``nk_scan_call_v3`` :198).

Kernel 2's function under kernel 2's contract (``ops/nk_scan.py::nk_scan``,
which launches this kernel where JAX's dispatcher runs v3: ``FUSED_V3`` of
``ops/nk_scan.py`` on and `nk_scan_v3_supported` true).  On the card
(``csrc/nk_scan_ablations.cu``, launched by ``ablation_scan.py``) one
launch a call: a block per (image, slab of channels) with every kind pair
stages its map slice on chip, and a thread per (pair, channel) holds all N
states and the log2(e)-scaled decay rates of the pair's forward and reverse
chains in registers and advances both in one loop with exp2, reading B and
C as 16-byte vectors that broadcast to the warp.  Each chain's part of y
stays in shared memory; the parts are summed with u Dsum in the plain
twin's order and written once, with no scratch in device memory.  What
bounds it: the exponentials on the special-function units, as for kernel 2.

- `nk_scan_v3_supported` and `_vmem_estimate_v3`: JAX's gate, copied
  (:168-193).  The VMEM estimate is the TPU's rule, kept so that the port
  runs kernel 18 exactly where JAX runs v3 (the policy of
  ``ops/nk_scan_adjoint.py::nk_train_supported``); the card has no such
  limit.
- `nk_scan_v3_plain`: the plain twin, written as the kernel computes it
  (pairs walked together, exp2 of A log2(e)).

`nk_scan_v3` takes its plain twin only for CPU tensors; on CUDA tensors it
launches the kernel (`nk_scan_v3_cuda`), adds one to ``nk_scan_v3.launches``,
or raises.  `nk_scan_v3_first` is the first design
(``csrc/nk_scan_ablations_v1.cu``: 64-thread blocks, the pairs one after
another, operands loaded from device memory inside the step and y added
into a float32 scratch there), kept for old-against-new timings.
"""

from __future__ import annotations

import torch

from xfmamba_tpu_torch.kernels import build
from xfmamba_tpu_torch.ops.ablations.ablation_scan import ablation_scan_cuda
from xfmamba_tpu_torch.ops.fast_math import softplus
from xfmamba_tpu_torch.ops.nk_scan import (
    _kinds_code, _nk_operands, kind_pairs, traversal_order)
from xfmamba_tpu_torch.ops.primitives import (
    dtype_code, forward_only, on_cpu, ptr, require, require_cuda, stream)

LOG2E = 1.4426950408889634
_V3_VMEM_BUDGET = 100 * 1024 * 1024


def _vmem_estimate_v3(L, W, D, K, N, G, has_col):
    """The TPU kernel's live float32 working set and double-buffered input
    blocks in bytes (:171-179)."""
    Lg, WG, ND = L * G, W * G, N * D
    blocks = Lg * (D + K * D) * 2 * 2 + Lg * K * N * 2 * 2 * 2
    scratch = 2 * Lg * D * 4
    row_ws = 4 * 8 * ND * 4 + 2 * G * ND * 4
    col_ws = (8 * WG * ND * 4) if has_col else 0
    y_val = 2 * Lg * D * 4
    return blocks + scratch + max(row_ws, col_ws) + y_val + N * ND * 4


def nk_scan_v3_supported(L, W, D, K, N, G, kinds, budget=_V3_VMEM_BUDGET) -> bool:
    """JAX's gate (:182-193): D a multiple of 128, G in (1, 2, 4, 8), L * G
    and W * G multiples of 8, paired kinds, the VMEM estimate under budget."""
    if D % 128 != 0 or G not in (1, 2, 4, 8):
        return False
    if (L * G) % 8 or (W * G) % 8:
        return False
    try:
        kind_pairs(kinds)
    except ValueError:
        return False
    has_col = any(k.startswith("col") for k in kinds)
    return _vmem_estimate_v3(L, W, D, K, N, G, has_col) < budget


def _pair_codes(kinds):
    """(number of pairs, forward kind indices, reverse kind indices + 1)
    packed 4 bits per pair, as ``xfm_nk_scan_v3`` and ``xfm_nk_scan_v3_first``
    read them."""
    pairs = kind_pairs(kinds)
    pair_f = pair_r = 0
    for i, (kf, kr, _) in enumerate(pairs):
        pair_f |= kf << (4 * i)
        pair_r |= (0 if kr is None else kr + 1) << (4 * i)
    return len(pairs), pair_f, pair_r


@torch.no_grad()
def nk_scan_v3_plain(u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds):
    """y = u * Dsum, then for each kind pair both chains advanced together,
    step t of the forward chain and step t of the reverse chain, every state
    at once, a = exp2(delta * A log2(e)); each step's C h added into y."""
    n, L, D = u.shape
    K = len(kinds)
    ops = _nk_operands(u, Bs, Cs, A, Dvec, bias, kinds)
    N = ops["A"].shape[1]
    uf = u.float()
    z = dts.float().reshape(n, L, K, D)
    A2 = ops["A"] * LOG2E                                      # (K, N, D)
    Bk, Ck = ops["Bs"].float(), ops["Cs"].float()              # (n, L, K, N)
    y = uf * ops["Dsum"]
    for kf, kr, _ in kind_pairs(kinds):
        chains = [(k, traversal_order(kinds[k], H, W).tolist())
                  for k in (kf, kr) if k is not None]
        h = [torch.zeros(n, N, D, device=u.device) for _ in chains]
        for t in range(L):
            for i, (k, order) in enumerate(chains):
                l = order[t]
                delta = softplus(z[:, l, k] + ops["bias"][k])   # (n, D)
                a = torch.exp2(delta[:, None] * A2[k])
                h[i] = a * h[i] + (delta * uf[:, l])[:, None] * Bk[:, l, k, :, None]
                y[:, l] += (Ck[:, l, k, :, None] * h[i]).sum(1)
    return y.to(u.dtype)


def nk_scan_v3(u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds, group=8):
    """u (B, L, D); dts (B, L, K*D); Bs/Cs (B, L, K*N); A (K*N, D) with rows
    in (k, n) order; Dvec (K, D); bias (K, D); ``group`` the image group G
    of the gate (it must divide B; the kernel itself needs none).  Returns
    (B, L, D) in u.dtype."""
    if on_cpu(u, dts, Bs, Cs, A, Dvec, bias):
        return nk_scan_v3_plain(u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds)
    forward_only("nk_scan_v3", u, dts, Bs, Cs, A, Dvec, bias)
    n, L, D = u.shape
    K = len(kinds)
    N = A.shape[0] // K
    if L != H * W:
        raise ValueError(f"u has {L} positions, map is {H}x{W}")
    if n % group:
        raise ValueError(f"image group {group} does not divide the batch {n}")
    if not 1 <= N <= 16:
        raise ValueError(f"d_state {N}: kernel 18 takes 1..16")
    require(u, (n, L, D), name="u")
    require(dts, (n, L, K * D), u.dtype, name="dts")
    require(Bs, (n, L, K * N), u.dtype, name="Bs")
    require(Cs, (n, L, K * N), u.dtype, name="Cs")
    return nk_scan_v3_cuda(u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds)


nk_scan_v3.launches = 0


def nk_scan_v3_cuda(u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds, phase_ns=False):
    """Kernel 18 on the card: one launch of ``csrc/nk_scan_ablations.cu``,
    which sums Dvec over the kinds itself (no other device launch), counted
    in ``nk_scan_v3.launches``; ``phase_ns`` as
    ``ablation_scan.ablation_scan_cuda``."""
    n, L, D = u.shape
    K = len(kinds)
    return ablation_scan_cuda(
        "v3", u, dts, Bs, Cs, A.float().reshape(K, -1, D).contiguous(),
        bias.float().reshape(K, D).contiguous(), Dvec.float().reshape(K, D).contiguous(), kinds,
        H, W, pairs=_pair_codes(kinds), counter=nk_scan_v3, phase_ns=phase_ns)


def nk_scan_v3_first(u, dts, Bs, Cs, A, Dvec, bias, H, W, kinds):
    """Kernel 18's first design (``csrc/nk_scan_ablations_v1.cu``), kept for
    old-against-new timings; ``nk_scan_v3_first.launches`` counts it."""
    require_cuda(u, dts, Bs, Cs, A, Dvec, bias)
    n, L, D = u.shape
    K = len(kinds)
    N = A.shape[0] // K
    ops = _nk_operands(u, Bs, Cs, A, Dvec, bias, kinds)
    a_log2e = (ops["A"] * LOG2E).contiguous()
    n_pairs, pair_f, pair_r = _pair_codes(kinds)
    acc = torch.empty(n, L, D, dtype=torch.float32, device=u.device)
    out = torch.empty_like(u)
    build.check(build.library().xfm_nk_scan_v3_first(
        ptr(u), ptr(dts), ptr(Bs), ptr(Cs), ptr(a_log2e), ptr(ops["bias"]), ptr(ops["Dsum"]),
        ptr(acc), ptr(out), n, H, W, D, K, N, _kinds_code(kinds), n_pairs, pair_f, pair_r,
        dtype_code(u), stream(u)), "nk_scan_v3_first")
    nk_scan_v3_first.launches += 1
    return out


nk_scan_v3_first.launches = 0

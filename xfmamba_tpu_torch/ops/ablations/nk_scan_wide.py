"""Kernel 18: the wide-state nk scan (port of
``xfmamba_tpu/ops/ablations/nk_scan_wide.py``, TPU kernel
``_nk_scan_kernel_v3`` :40, host ``nk_scan_call_v3`` :198).

Kernel 2's function under kernel 2's contract (``ops/nk_scan.py::nk_scan``,
which launches this kernel where JAX's dispatcher runs v3: ``FUSED_V3`` of
``ops/nk_scan.py`` on and `nk_scan_v3_supported` true).  On the card one
thread per (image, channel) advances the forward and the reverse chain of
each kind pair in one loop, all N states of a chain together, with A
pre-scaled by log2(e) and exp2 (``csrc/nk_scan_ablations.cu``).

- `nk_scan_v3_supported` and `_vmem_estimate_v3`: JAX's gate, copied
  (:168-193).  The VMEM estimate is the TPU's rule, kept so that the port
  runs kernel 18 exactly where JAX runs v3 (the policy of
  ``ops/nk_scan_adjoint.py::nk_train_supported``); the card has no such
  limit.
- `nk_scan_v3_plain`: the plain twin, written as the kernel computes it
  (pairs walked together, exp2 of A log2(e)).

`nk_scan_v3` takes its plain twin only for CPU tensors; on CUDA tensors it
launches the kernel, adds one to ``nk_scan_v3.launches``, or raises.
"""

from __future__ import annotations

import torch

from xfmamba_tpu_torch.kernels import build
from xfmamba_tpu_torch.ops.fast_math import softplus
from xfmamba_tpu_torch.ops.nk_scan import (
    _kinds_code, _nk_operands, kind_pairs, traversal_order)
from xfmamba_tpu_torch.ops.primitives import dtype_code, on_cpu, ptr, require, stream

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
    packed 4 bits per pair, as ``xfm_nk_scan_v3`` reads them."""
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
    ops = _nk_operands(u, Bs, Cs, A, Dvec, bias, kinds)
    a_log2e = (ops["A"] * LOG2E).contiguous()
    n_pairs, pair_f, pair_r = _pair_codes(kinds)
    acc = torch.empty(n, L, D, dtype=torch.float32, device=u.device)
    out = torch.empty_like(u)
    lib = build.library()
    nk_scan_v3.launches += 1
    build.check(lib.xfm_nk_scan_v3(
        ptr(u), ptr(dts), ptr(Bs), ptr(Cs), ptr(a_log2e), ptr(ops["bias"]), ptr(ops["Dsum"]),
        ptr(acc), ptr(out), n, H, W, D, K, N, _kinds_code(kinds), n_pairs, pair_f, pair_r,
        dtype_code(u), stream(u)), "nk_scan_v3")
    return out


nk_scan_v3.launches = 0

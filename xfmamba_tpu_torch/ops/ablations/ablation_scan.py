"""The launch and the plan of kernels 17 and 18 (``csrc/nk_scan_ablations.cu``):
a block per (image, slab of channels) with every kind, the map slice staged
on chip, the kinds' parts summed in shared memory in the plain twins' fixed
order, one launch a call, no scratch in device memory.

- `ablation_plan`: the "whole" plan (the slice staged at once, every kind
  walked in parallel) at the slab of `SLABS` whose blocks spread best over
  the SMs (``scan_whole_map.spread_key``), where it fits in
  `ABLATION_SMEM`; else the "chunked" plan (kernel 17's kinds or kernel
  18's pairs in turns, each traversal staged `CHUNK` steps at a time, the
  parts added into one float32 accumulator in the plain twins' order) at
  the widest slab of `CHUNK_SLABS` whose accumulator holds the map.  Past
  about 56,000 positions (237 x 237) no slab's does: the accumulator holds
  a band of positions at one channel, and the block walks every traversal
  once a band.  No map is refused.
- `ablation_scan_cuda`: the launch, behind ``nk_scan_v4.nk_scan_v4_cuda``
  (kernel 17: a lane per (kind, channel, state)) and
  ``nk_scan_wide.nk_scan_v3_cuda`` (kernel 18: a thread per (kind pair,
  channel)), which name the wrapper whose ``launches`` it counts;
  ``ablation_scan_cuda.by_plan`` counts the calls by kernel and plan.
"""

from __future__ import annotations

import functools

import torch

from xfmamba_tpu_torch.kernels import build
from xfmamba_tpu_torch.ops.nk_scan import _kinds_code
from xfmamba_tpu_torch.ops.primitives import dtype_code, ptr, require, require_cuda, stream
from xfmamba_tpu_torch.ops.scan_whole_map import band_plan, spread_key

KERNELS = ("v4", "v3")               # the C entry's kernel code: 0 kernel 17, 1 kernel 18
# the whole plan's slab widths, widest first: kernel 17's block holds K x S
# lane groups of up to 16 lanes (at most 1024 threads), kernel 18's a thread
# per pair and channel (at most 384)
SLABS = {"v4": (32, 16, 8, 4), "v3": (128, 64, 32)}
CHUNK_SLABS = {"v4": (32, 16, 8, 4, 2, 1), "v3": (128, 64, 32, 16, 8, 4, 2, 1)}
MAX_THREADS = {"v4": 1024, "v3": 384}
# registers a thread takes, for the blocks an SM holds (the build's
# -Xptxas -v report: chip_smoke.py phase 10 prints them)
REGS = {"v4": 32, "v3": 168}
CHUNK = 64                           # traversal steps a chunk
ABLATION_SMEM = 227 * 1024           # dynamic shared memory a block may take
MIN_THREADS = 128                    # a block's threads at least (kAbMinThreads)
H100_SMS = 132                       # the SMs a plan spreads over off the card
MAX_STATE = 16
# a block's phases (the kernel's phase clock)
PHASES = ("staging", "waiting", "widening", "deltas", "walk", "output")


def lanes(kernel: str, N: int) -> int:
    """States a chain's walk holds: kernel 17's lanes a chain (N rounded up
    to a power of two), kernel 18's states a thread (4 or 16)."""
    if kernel == "v3":
        return 4 if N <= 4 else 16
    return 1 << (N - 1).bit_length()


def threads(kernel: str, K: int, n_pairs: int, S: int, N: int) -> int:
    chains = K * S * lanes(kernel, N) if kernel == "v4" else n_pairs * S
    return max(chains, MIN_THREADS)


def ablation_plan(kernel, n, L, K, N, D, n_pairs, dtype, sms=H100_SMS) -> tuple:
    """(whole, slab, chunk, band) of ``kernel`` ("v4" or "v3") for n images
    of L positions and D channels, K kinds (n_pairs pairs), N states.  The
    whole plan takes the slab with the fewest waves of blocks, then the
    least work an SM holds, then the most SMs busy, then the widest, as
    ``ops/scan_whole_map.py::whole_map_plan``; the chunked plan the widest
    slab at the fewest bands of positions (``band`` positions each, L for
    one)."""
    return _plan(kernel, n, L, K, N, D, n_pairs, dtype == torch.bfloat16, sms, ABLATION_SMEM,
                 CHUNK)


@functools.lru_cache(maxsize=None)
def _plan(kernel, n, L, K, N, D, n_pairs, bf16, sms, smem_limit, chunk_limit):
    code = KERNELS.index(kernel)

    def smem(whole, chunk, slab, band):
        return build.library().xfm_nk_ablation_smem(code, int(whole), K, L, chunk, N, slab,
                                                     band, int(bf16))

    def threads_at(s):
        return threads(kernel, K, n_pairs, s, N)

    whole = [s for s in SLABS[kernel]
             if threads_at(s) <= MAX_THREADS[kernel] and smem(True, L, s, L) <= smem_limit]
    if whole:
        key = spread_key(n, D, sms, threads_at, lambda s: smem(True, L, s, L), REGS[kernel])
        return True, min(whole, key=key), L, L
    chunk = min(L, chunk_limit)
    # a band's accumulator takes 4 bytes a position and channel
    slabs = [s for s in CHUNK_SLABS[kernel] if threads_at(s) <= MAX_THREADS[kernel]]
    slab, band = band_plan(L, slabs, lambda s: (smem_limit - smem(False, chunk, s, 0)) // (4 * s))
    return False, slab, chunk, band


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    if device.type != "cuda":
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def _aligned(t) -> bool:
    return t.data_ptr() % 16 == 0


def ablation_scan_cuda(kernel, u, dts, Bs, Cs, A, bias, Dk, kinds, H, W, pairs=(0, 0, 0),
                       counter=None, phase_ns=False):
    """One launch of ``kernel`` ("v4": kernel 17, "v3": kernel 18): u (n, L,
    D); dts (n, L, K * D); Bs/Cs (n, L, K * N), all contiguous in u's
    dtype; A (K, N, D), bias and Dk (K, D) float32; ``pairs`` kernel 18's
    (n_pairs, pair_f, pair_r) codes.  Returns y = u * sum_k Dk[k] (summed
    in kind order in the kernel) + the kinds' parts, (n, L, D) in u's
    dtype; adds one to ``counter.launches`` (the wrapper named by the
    caller) where it launches the kernel.  With ``phase_ns`` the call is
    launched uncounted with the kernel's phase clock on and returns {phase:
    mean ns a block spends in it} (`PHASES`; the chunked plan's last chunk),
    with "block" the mean from start to end."""
    require_cuda(u, dts, Bs, Cs, A, bias, Dk)
    n, L, D = u.shape
    K = len(kinds)
    N = A.shape[1]
    if L != H * W:
        raise ValueError(f"u has {L} positions, map is {H}x{W}")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"d_state {N}: kernels 17 and 18 take 1..{MAX_STATE}")
    require(u, (n, L, D), name="u")
    require(dts, (n, L, K * D), u.dtype, name="dts")
    require(Bs, (n, L, K * N), u.dtype, name="Bs")
    require(Cs, (n, L, K * N), u.dtype, name="Cs")
    require(A, (K, N, D), torch.float32, name="A")
    require(bias, (K, D), torch.float32, name="bias")
    require(Dk, (K, D), torch.float32, name="Dk")
    whole, slab, chunk, band = ablation_plan(kernel, n, L, K, N, D, pairs[0], u.dtype,
                                             _sm_count(u.device))
    out = torch.empty_like(u)
    vec = (_aligned(u) | _aligned(dts) << 1 | (_aligned(Bs) and _aligned(Cs)) << 2
           | (_aligned(bias) and _aligned(Dk)) << 3)
    stamps = None
    if phase_ns:
        stamps = torch.zeros(n * -(-D // slab), len(PHASES) + 1, dtype=torch.int64,
                             device=u.device)
    lib = build.library()
    operands = (ptr(u), ptr(dts), ptr(Bs), ptr(Cs), ptr(A), ptr(bias), ptr(Dk), ptr(out),
                n, H, W, D, K, N, _kinds_code(kinds))
    plan_args = (int(whole), slab, chunk, band, vec, dtype_code(u), ptr(stamps), stream(u))
    if kernel == "v4":
        status = lib.xfm_nk_scan_v4(*operands, *plan_args)
    else:
        status = lib.xfm_nk_scan_v3(*operands, *pairs, *plan_args)
    build.check(status, f"nk_scan_{kernel}")
    if phase_ns:
        t = stamps.double()
        return dict(zip(PHASES, t.diff(dim=1).mean(0).tolist())) | {
            "block": float((t[:, -1] - t[:, 0]).mean())}
    # counted once launched, by plan and for the wrapper
    plan = f"{kernel} " + (f"whole, slab {slab}" if whole
                           else f"chunked x{-(-L // chunk)}, slab {slab}")
    if band < L:
        plan += f", {-(-L // band)} bands"
    ablation_scan_cuda.by_plan[plan] = ablation_scan_cuda.by_plan.get(plan, 0) + 1
    if counter is not None:
        counter.launches += 1
    return out


ablation_scan_cuda.by_plan = {}

"""The whole-map scan of kernels 9 and 10 (``csrc/scan_whole_map.cu``): a
block per (image, slab of channels) with every traversal kind, the map
slice staged on chip, lanes per chain, the kinds' parts summed in shared
memory in the plain versions' fixed order, one launch a call.

- `whole_map_plan`: the "whole" plan (the slice staged at once) at the
  slab of `SLABS` whose blocks spread best over the SMs, where it fits in
  `WHOLE_MAP_SMEM`; else the "chunked" plan (the traversals staged
  `CHUNK` steps at a time, each kind's part kept by position) at the
  widest slab of `CHUNK_SLABS` whose parts of the whole map fit.  Past
  about 10,000 positions at K 4 and N 16 (117 x 117 at N 1) no slab's do:
  the parts of a band of positions are kept at one channel, and the block
  walks every traversal once a band.  No map is refused.
- `scan_whole_map_cuda`: the launch, behind ``ops/nk_scan_v1.py::
  nk_scan_v1`` (kernel 9) and ``ops/fused_cross_scan.py::
  fused_cross_scan`` (kernel 10), which count their calls once the launch
  has returned; ``scan_whole_map_cuda.by_plan`` counts them by plan.
"""

from __future__ import annotations

import functools

import torch

from xfmamba_tpu_torch.kernels import build
from xfmamba_tpu_torch.ops.nk_scan import _kinds_code
from xfmamba_tpu_torch.ops.primitives import dtype_code, ptr, require, require_cuda, stream

SLABS = (32, 16, 8)                  # the whole plan's slab widths, widest first
CHUNK_SLABS = (32, 16, 8, 4, 2, 1)   # the chunked plan's
CHUNK = 64                           # traversal steps a chunk
WHOLE_MAP_SMEM = 227 * 1024          # dynamic shared memory a block may take
SM_SMEM, SM_REGS, SM_THREADS = 228 * 1024, 65536, 2048  # an H100 SM's
MIN_THREADS = 128                    # a block's threads at least (kWmMinThreads)
H100_SMS = 132                       # the SMs a plan spreads over off the card
MAX_STATE = 16
# a block's phases (the kernel's phase clock)
PHASES = ("staging", "waiting", "widening", "deltas", "walk", "output")


def lanes(N: int) -> int:
    """Lanes a (kind, channel) chain: 1 for N = 1, else 4."""
    return 1 if N == 1 else 4


def whole_map_plan(n, L, K, N, D, dtype, sms=H100_SMS) -> tuple:
    """(whole, slab, chunk, band) for n images of L positions and D
    channels, K kinds, N states.  The whole plan takes the slab with the
    fewest waves of blocks, then the least work an SM holds (its blocks,
    rounded up, times their threads), then the most SMs busy, then the
    widest: one study's K=1 call (48 blocks of 32 channels at D 1536)
    spreads over 96 blocks of 16; 36 images of K=4 keep blocks of 32 (7
    waves, against 9 of 16 and 11 of 8).  The chunked plan takes the widest
    slab at the fewest bands of positions (``band`` positions each, L for
    one)."""
    return _plan(n, L, K, N, D, dtype == torch.bfloat16, sms, WHOLE_MAP_SMEM, CHUNK)


def spread_key(n, D, sms, threads, smem, regs):
    """The order of a whole plan's slabs for n images of D channels on
    ``sms`` SMs: the fewest waves of blocks, then the least work an SM
    holds (its blocks, rounded up, times their threads), then the most SMs
    busy, then the widest.  ``threads(s)`` and ``smem(s)`` are a block's at
    slab s, ``regs`` a thread's registers (kernels 9/10 and 17/18)."""
    def key(s):
        blocks, thr = n * -(-D // s), threads(s)
        # blocks an SM holds: its shared memory (1 KB a block reserved), its
        # registers, its threads and its 32 block slots
        per_sm = min(SM_SMEM // (smem(s) + 1024), SM_REGS // (regs * thr), SM_THREADS // thr, 32)
        return (-(-blocks // (sms * per_sm)), -(-blocks // sms) * thr, -min(blocks, sms), -s)
    return key


def band_plan(L, slabs, room):
    """The chunked plan's (slab, band): the widest of ``slabs`` at the
    fewest bands of L positions, ``room(s)`` positions of a band fitting
    beside the rest of a block at slab s (none where it is 0 or less);
    ``band`` positions each (L for one).  Kernels 9/10 and 17/18."""
    bands = {s: -(-L // room(s)) for s in slabs if room(s) > 0}
    slab = min(bands, key=lambda s: (bands[s], -s))
    return slab, -(-L // bands[slab])


@functools.lru_cache(maxsize=None)
def _plan(n, L, K, N, D, bf16, sms, smem_limit, chunk_limit):
    def smem(whole, chunk, slab, band):
        return build.library().xfm_whole_map_smem(int(whole), K, L, chunk, N, slab, band,
                                                  int(bf16))

    fits = [s for s in SLABS if smem(True, L, s, L) <= smem_limit]
    if fits:
        # at most 64 registers a thread by the launch bounds
        key = spread_key(n, D, sms, lambda s: max(K * s * lanes(N), MIN_THREADS),
                         lambda s: smem(True, L, s, L), 64)
        return True, min(fits, key=key), L, L
    chunk = min(L, chunk_limit)
    # a band's parts take 4 bytes a kind, position and channel
    slab, band = band_plan(L, CHUNK_SLABS,
                           lambda s: (smem_limit - smem(False, chunk, s, 0)) // (4 * K * s))
    return False, slab, chunk, band


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    if device.type != "cuda":
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def _aligned(t) -> bool:
    return t.data_ptr() % 16 == 0


def scan_whole_map_cuda(u, dts, Bs, Cs, A, bias, Dk, kinds, H, W, *, cross, out_dtype,
                        round_part=False, phase_ns=False):
    """One launch: u (n, L, D); dts (n, L, K, D); Bs/Cs (n, L, K, N), all
    contiguous in u's dtype; A float32 (K, N, D), or (K, D, N) for
    ``cross``; bias and Dk (K, D) float32.  ``cross`` False (kernel 9):
    y = u * sum_k Dk[k] + sum_k part_k in kind order, in ``out_dtype``;
    True (kernel 10, the cross2d kinds): part_k = C h + Dk[k] u, each
    rounded to bfloat16 with ``round_part``, y = (part_0 + part_2) +
    (part_1 + part_3) in float32.  With ``phase_ns`` the call is launched
    uncounted with the kernel's phase clock on and returns {phase: mean ns
    a block spends in it} (`PHASES`; the chunked plan's last chunk), with
    "block" the mean from start to end."""
    require_cuda(u, dts, Bs, Cs, A, bias, Dk)
    n, L, D = u.shape
    K = len(kinds)
    N = A.shape[2] if cross else A.shape[1]
    if L != H * W:
        raise ValueError(f"u has {L} positions, map is {H}x{W}")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"d_state {N}: the whole-map scan takes 1..{MAX_STATE}")
    require(u, (n, L, D), name="u")
    require(dts, (n, L, K, D), u.dtype, name="dts")
    require(Bs, (n, L, K, N), u.dtype, name="Bs")
    require(Cs, (n, L, K, N), u.dtype, name="Cs")
    require(A, (K, D, N) if cross else (K, N, D), torch.float32, name="A")
    require(bias, (K, D), torch.float32, name="bias")
    require(Dk, (K, D), torch.float32, name="Dk")
    whole, slab, chunk, band = whole_map_plan(n, L, K, N, D, u.dtype, _sm_count(u.device))
    out = torch.empty(n, L, D, dtype=out_dtype, device=u.device)
    vec = (_aligned(u) | _aligned(dts) << 1 | (_aligned(Bs) and _aligned(Cs)) << 2
           | (_aligned(bias) and _aligned(Dk)) << 3)
    stamps = None
    if phase_ns:
        stamps = torch.zeros(n * -(-D // slab), len(PHASES) + 1, dtype=torch.int64,
                             device=u.device)
    build.check(build.library().xfm_whole_map_scan(
        ptr(u), ptr(dts), ptr(Bs), ptr(Cs), ptr(A), ptr(bias), ptr(Dk), ptr(out), n, H, W, D,
        K, N, _kinds_code(kinds), int(cross), int(round_part), int(whole), slab,
        chunk, band, vec, dtype_code(u), dtype_code(out), ptr(stamps), stream(u)),
        "scan_whole_map")
    if phase_ns:
        t = stamps.double()
        return dict(zip(PHASES, t.diff(dim=1).mean(0).tolist())) | {
            "block": float((t[:, -1] - t[:, 0]).mean())}
    # counted once launched
    plan = f"whole, slab {slab}" if whole else f"chunked x{-(-L // chunk)}, slab {slab}"
    if band < L:
        plan += f", {-(-L // band)} bands"
    scan_whole_map_cuda.by_plan[plan] = scan_whole_map_cuda.by_plan.get(plan, 0) + 1
    return out


scan_whole_map_cuda.by_plan = {}

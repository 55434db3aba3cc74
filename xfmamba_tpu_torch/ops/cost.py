"""Analytic costs of the scan ops, each reported by the op that owns it.

A dispatch-mode counter (``torch.utils.flop_counter.FlopCounterMode``)
sees no CUDA kernel launched through ctypes, and on the CPU it sees the
plain versions' inner products, which differ from route to route.  So
every scan or stage entry point that the models call is wrapped by
`reports_cost` with its analytic FLOPs, written beside the op: while a
count is open on this thread (`open_count`, used by
``utils.flops.model_flops``), a call hands the count its function, its
arguments and its formula, and the count adds the formula in place of
whatever the dispatch modes see inside the call.  Calls inside a
reporting call report nothing.  With no count open the wrapper only
calls the op.

The formulas are the JAX package's (``xfmamba_tpu/utils/flops.py``):
`flops_selective_scan_fn` for the selective scans, `flops_ssd_chunk_scan`
for the chunked SSD scan.
"""

from __future__ import annotations

import contextlib
import functools
import threading

_OPEN = threading.local()


def flops_selective_scan_fn(B: int = 1, L: int = 256, D: int = 768, N: int = 16,
                            with_D: bool = True, with_Z: bool = False,
                            with_complex: bool = False) -> int:
    """Analytic selective-scan FLOPs (``csms6s.py:155-159`` of the
    reference): 9 B L D N for the recurrence and its einsums, + B D L for
    the D skip and the same for the z gate."""
    if with_complex:
        raise ValueError("a complex SSM is not supported (nor in the reference)")
    flops = 9 * B * L * D * N
    if with_D:
        flops += B * D * L
    if with_Z:
        flops += B * D * L
    return flops


def flops_ssd_chunk_scan(B: int, L: int, H: int, P: int, N: int, chunk: int) -> int:
    """Analytic chunked-SSD FLOPs: the intra-chunk quadratic term 2 B L
    chunk H (N + P), the state build and emit 2 B L H N P each, and the
    O(nc^2) state passing."""
    nc = max(L // max(chunk, 1), 1)
    intra = 2 * B * L * chunk * H * (N + P)
    states = 4 * B * L * H * N * P
    passing = 2 * B * H * (nc + 1) ** 2 * P * N
    return intra + states + passing


def scan_flops(B: int, L: int, KD: int, N: int) -> int:
    """A selective scan of KD channels with the D skip (every scan here)."""
    return flops_selective_scan_fn(B, L, KD, N, with_D=True)


def nk_flops(u, A, kinds) -> int:
    """The nk scans' contract: u (B, L, D), A (K*N, D), K = len(kinds)."""
    B, L, D = u.shape
    K = len(kinds)
    return scan_flops(B, L, K * D, A.shape[0] // K)


def vss_block_flops(B: int, L: int, p) -> int:
    """One VSS block on B maps of L positions from its packed operands
    (``ops.vss_block.VSSBlockOperands``, d_state 1, four directions): 2 per
    multiply-add of in_proj, the depthwise 3x3 conv, x_proj, the dt
    projection, out_proj and the MLP (where the block has one), plus the scan."""
    products = sum(t.numel() for t in (p.w_in, p.w_conv, p.w_xp, p.w_dt, p.w_out,
                                       p.w_fc1, p.w_fc2) if t is not None)
    return 2 * B * L * products + scan_flops(B, L, 4 * (p.w_conv.numel() // 9), 1)


def reports_cost(flops):
    """Decorator: the op reports ``flops(*args, **kwargs)`` to the count
    open on this thread, if any (module docstring)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            count = getattr(_OPEN, "count", None)
            if count is None:
                return fn(*args, **kwargs)
            _OPEN.count = None
            try:
                return count.add(fn, flops, args, kwargs)
            finally:
                _OPEN.count = count
        return call
    return wrap


@contextlib.contextmanager
def open_count(count):
    """Send this thread's reports to ``count``, an object whose
    ``add(fn, flops, args, kwargs)`` runs ``fn(*args, **kwargs)``, books
    its cost and returns its result."""
    outer = getattr(_OPEN, "count", None)
    _OPEN.count = count
    try:
        yield count
    finally:
        _OPEN.count = outer

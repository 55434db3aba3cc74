"""Profiling and timing (port of ``xfmamba_tpu/utils/profiling.py``).

- `trace`: a ``torch.profiler`` trace of the CPU and, with a card, CUDA
  activity, written as a Chrome trace into ``logdir`` (the JAX package's
  ``jax.profiler`` trace).  The profiler drops the first device events of
  a session, more of them the longer the process has been profiled (on an
  H100 host one more every 16 s or so; a trace taken twelve minutes after
  the process's first held none of its 20 kernels), whatever idle time
  precedes them.  So ``EDGE`` launches of a spin kernel of no length open
  each session and take that loss; `trace` warns when none of them is
  left, as the block's first events may then be gone too.
- `do_bench`: ``triton.testing.do_bench``'s counterpart, the JAX keys:
  warm-up calls, then each call timed on the host clock with
  ``torch.cuda.synchronize()`` before and after it where CUDA is in use.
- `timing_stats` / `format_timing_report`: the per-batch times and FPS of
  ``inference_timing.txt`` (the reference's
  ``2_inference_chexpert.py:233-266``), in the JAX package's text.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
import warnings
from typing import Callable, Dict, Sequence

import torch

# spin kernels of no length that open a trace's session (see the module
# docstring): about four hours of a process's profiling on an H100 host
EDGE = 1024


@contextlib.contextmanager
def trace(logdir: str, filename: str = "trace.json", edge: int = EDGE):
    """``with trace(dir) as prof: run()``: profiles the block (CPU, and CUDA
    where a card is present) and writes ``dir/filename`` as a Chrome trace;
    yields the ``torch.profiler.profile`` for ``key_averages()``.  With a
    card, ``edge`` launches of ``torch.cuda._sleep(0)`` (``spin_kernel``)
    open the session, ahead of the block."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        if cuda and edge:
            for _ in range(edge):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, filename))
    if cuda and edge and not any("spin_kernel" in r.key for r in prof.key_averages()):
        warnings.warn(f"the profiler dropped all {edge} spin kernels that open the trace: "
                      f"the block's first device events may be missing")


def do_bench(fn: Callable, *args, warmup: int = 2, iters: int = 10, **kwargs) -> Dict[str, float]:
    """Median, mean, min and max seconds of ``fn(*args, **kwargs)`` over
    ``iters`` calls after ``warmup``, each call between two
    ``torch.cuda.synchronize()`` where CUDA has been initialised (its queued
    work is in the time, another's is not)."""
    sync = torch.cuda.synchronize if torch.cuda.is_initialized() else (lambda: None)
    for _ in range(warmup):
        fn(*args, **kwargs)
    times = []
    for _ in range(iters):
        sync()
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        sync()
        times.append(time.perf_counter() - t0)
    return {"median_s": statistics.median(times), "mean_s": statistics.fmean(times),
            "min_s": min(times), "max_s": max(times), "iters": iters}


def timing_stats(times_s: Sequence[float], batch_size: int = 1) -> Dict[str, float]:
    """Per-call timing statistics with FPS, the fields of
    ``inference_timing.txt``."""
    n = len(times_s)
    mean = statistics.fmean(times_s) if n else float("nan")
    return {
        "num_batches": n,
        "batch_size": batch_size,
        "mean_ms": mean * 1e3,
        "std_ms": (statistics.pstdev(times_s) * 1e3 if n > 1 else 0.0),
        "min_ms": min(times_s) * 1e3 if n else float("nan"),
        "max_ms": max(times_s) * 1e3 if n else float("nan"),
        "fps": (batch_size / mean) if n and mean > 0 else float("nan"),
    }


def format_timing_report(stats: Dict[str, float], header: str = "Inference timing") -> str:
    """The text block of the reference's txt artefact."""
    lines = [header, "=" * len(header)]
    lines.append(f"batches measured : {stats['num_batches']}")
    lines.append(f"batch size       : {stats['batch_size']}")
    lines.append(f"mean time        : {stats['mean_ms']:.3f} ms")
    lines.append(f"std time         : {stats['std_ms']:.3f} ms")
    lines.append(f"min time         : {stats['min_ms']:.3f} ms")
    lines.append(f"max time         : {stats['max_ms']:.3f} ms")
    lines.append(f"throughput (FPS) : {stats['fps']:.2f} images/sec")
    return "\n".join(lines)

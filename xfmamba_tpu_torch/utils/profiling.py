"""Timing statistics for the inference CLIs (port of the host-side part of
``xfmamba_tpu/utils/profiling.py``): the per-batch times and FPS written to
``inference_timing.txt`` (the reference's ``2_inference_chexpert.py:233-266``),
in the JAX package's text.  ``trace`` and ``do_bench`` wait for the
utilities item of ROADMAP.md, queue 1."""

from __future__ import annotations

import statistics
from typing import Dict, Sequence


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

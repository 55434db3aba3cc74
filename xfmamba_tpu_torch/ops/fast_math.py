"""Elementwise math shared by the scan functions (port of
``xfmamba_tpu/ops/fast_math.py``).

The JAX module also carries a polynomial exp for the TPU (``FAST_EXP``, off
there); on the GPU ``expf`` is a hardware instruction, so only the builtin
forms are ported."""

from __future__ import annotations

import torch

SOFTPLUS_THRESHOLD = 20.0


def softplus(z: torch.Tensor) -> torch.Tensor:
    """``torch.nn.functional.softplus`` with threshold 20, written out as the
    reference CUDA scan computes it: ``z if z > 20 else log1p(exp(z))``."""
    return torch.where(z > SOFTPLUS_THRESHOLD, z,
                       torch.log1p(torch.exp(torch.clamp(z, max=SOFTPLUS_THRESHOLD))))


def exp(z: torch.Tensor) -> torch.Tensor:
    return torch.exp(z)

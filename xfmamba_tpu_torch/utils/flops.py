"""FLOP and parameter counts (port of ``xfmamba_tpu/utils/flops.py``).

- `flops_selective_scan_fn`, `flops_ssd_chunk_scan`: the analytic scan
  counts, the JAX package's formulas (kept in ``ops/cost.py``).
- `count_params`: the parameters of a module, or the leaves of a tree.
- `model_flops(model, *inputs)`: ``flops``, ``bytes_accessed`` and
  ``params`` of one forward (``--cal_flops``).

``flops`` is defined here as: 2 per multiply-add of every matrix product
and convolution the forward computes in PyTorch (counted by
``torch.utils.flop_counter.FlopCounterMode``), plus for every call of a
scan or stage op the cost that the op reports (``ops/cost.py``):
`flops_selective_scan_fn` (B, L, K D, N, with the D skip) for the
selective scans, `flops_ssd_chunk_scan` for the m2 models' SSD scans, and
the products an op computes besides its scan (kernel 11's x_proj and dt
projection, kernel 3's dt projection from ranks, the stage kernels' whole
blocks) as the torch route computes them.  What runs inside a reporting
op is not counted: a CUDA kernel is invisible to the FLOP counter, and the
plain versions' inner products differ from route to route.  Elementwise
work (activations, norms, softmax, the scans' exponentials beyond their
formula) is not counted.  The forward runs in eval mode, without
gradients, on the model's device with the inputs in float32, so the count
is the same on the card and on the CPU, for bfloat16 inputs and on every
route.  The JAX package's ``model_flops`` is XLA's cost analysis, which
also counts elementwise operations: the two numbers are defined
differently (CHANGES.md gives their ratio at the test geometry).

``bytes_accessed`` is the bytes of every tensor each aten operation of that
forward reads or writes, its tensor arguments and results (view and
metadata operations count none), where a reporting op counts as one
operation: its tensor arguments and results; at float32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from xfmamba_tpu_torch.ops.cost import flops_selective_scan_fn, flops_ssd_chunk_scan, open_count

__all__ = ["flops_selective_scan_fn", "flops_ssd_chunk_scan", "count_params", "model_flops"]


def count_params(tree) -> int:
    """Parameters of an ``nn.Module``, or the elements of every tensor or
    array leaf of a nested dict / list."""
    if isinstance(tree, torch.nn.Module):
        return int(sum(p.numel() for p in tree.parameters()))
    return int(sum(x.numel() if isinstance(x, torch.Tensor) else x.size
                   for x in tree_leaves(tree) if hasattr(x, "shape")))


class _Bytes(TorchDispatchMode):
    """Sums the bytes of the tensor arguments and results of every aten
    operation that is not a view."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += sum(t.nbytes for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def _tensor_bytes(tree) -> int:
    """Bytes of the tensors in ``tree``, packed operands' fields included."""
    total = 0
    for t in tree_leaves(tree):
        if dataclasses.is_dataclass(t):
            total += _tensor_bytes(list(vars(t).values()))
        elif isinstance(t, torch.Tensor):
            total += t.nbytes
    return total


class _Count:
    """What the reporting ops add to the dispatch modes' totals: each call's
    reported FLOPs and the bytes of its tensor arguments and results, less
    what the modes saw inside it."""

    def __init__(self, flop_mode: FlopCounterMode, byte_mode: _Bytes):
        self.flop_mode, self.byte_mode = flop_mode, byte_mode
        self.flops = self.bytes = 0

    def add(self, fn, flops, args, kwargs):
        f0, b0 = self.flop_mode.get_total_flops(), self.byte_mode.bytes
        out = fn(*args, **kwargs)
        self.flops += flops(*args, **kwargs) - (self.flop_mode.get_total_flops() - f0)
        self.bytes += _tensor_bytes((args, kwargs, out)) - (self.byte_mode.bytes - b0)
        return out


def model_flops(model: torch.nn.Module, *inputs: torch.Tensor) -> Dict[str, float]:
    """``flops`` and ``bytes_accessed`` of one forward of ``model`` on
    ``inputs`` (per batch), as the module docstring defines them, and
    ``params`` (`count_params`); the ``--cal_flops`` counterpart
    (``2_inference_mura.py:123-131``).  The model's mode is restored."""
    device = next(model.parameters()).device
    xs = [x.detach().to(device=device, dtype=torch.float32) for x in inputs]
    training = model.training
    model.eval()
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as fc, _Bytes() as nbytes, \
                open_count(_Count(fc, nbytes)) as count:
            model(*xs)
    finally:
        model.train(training)
    return {"flops": float(fc.get_total_flops() + count.flops),
            "bytes_accessed": float(nbytes.bytes + count.bytes),
            "params": count_params(model)}

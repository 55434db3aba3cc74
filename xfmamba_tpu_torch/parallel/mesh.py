"""Data parallelism over a process group (port of
``xfmamba_tpu/parallel/mesh.py``).

JAX's mesh is a 1-axis ``Mesh("data")`` of devices: a ``jit`` step with
the batch sharded and the state replicated, whose GSPMD partitioning keeps
the function of the unsharded step.  Here the mesh is the ranks of a
``torch.distributed`` process group, one process and one device each
(`Mesh`), and each step keeps that function with explicit collectives:

- `make_parallel_train_step`: the train step of ``train/loop.py`` (or the
  mutual step of ``train/mutual.py``) with the gradients averaged over the
  ranks between ``backward`` (after ``zero_missing_grads``) and
  ``optimizer.step``, one all-reduce of the flattened gradients, and the
  loss the global mean.  The step runs inside `models.layers.batch_shard`,
  so BatchNorm takes the global batch's statistics and DropPath (and the
  device stage's augmentation draw) the global batch's masks: W ranks
  compute what one computes on the global batch;
- `make_parallel_eval_step` (JAX's ``shard_map``): each rank runs the
  inference kernels on its rows; the loss sum and count are all-reduced
  and the valid rows' logits and labels gathered in rank order;
- `make_parallel_infer`: outputs gathered in rank order.

Gathers go through an all-reduce of a zero-filled buffer (each rank writes
its rows): gloo and NCCL both take it, on the CPU and on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from xfmamba_tpu_torch.models.layers import BatchShard, batch_shard


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``world`` ranks of ``group`` (None: the default group), this process
    being ``rank`` on ``device``.  A world of one without a process group
    runs every collective as the identity."""
    world: int
    rank: int
    device: torch.device
    axis: str = "data"
    group: Any = None

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        if dist.is_initialized():
            dist.all_reduce(t, group=self.group)
        return t

    def _flat_(self, tensors: Sequence[torch.Tensor], collective) -> None:
        """``collective(flat)`` on the tensors flattened together, one call
        a dtype, written back into them."""
        by_dtype: Dict[torch.dtype, list] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            collective(flat)
            for t, part in zip(group, flat.split([t.numel() for t in group])):
                t.copy_(part.view_as(t))

    def mean_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Replace each tensor by its mean over the ranks."""
        def mean(flat):
            self._all_reduce(flat)
            flat /= self.world
        self._flat_(tensors, mean)

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the ranks (a new tensor)."""
        return self._all_reduce(t.clone()) / self.world

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (a new tensor)."""
        return self._all_reduce(t.clone())

    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0) -> None:
        """Every rank's tensors become rank ``src``'s."""
        if dist.is_initialized() and self.world > 1:
            self._flat_(tensors, lambda flat: dist.broadcast(flat, src, group=self.group))

    def gather_rows(self, t: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
        """The first ``rows`` (default: all) rows of ``t`` from every rank,
        concatenated in rank order; every rank's ``t`` has the same shape."""
        rows = t.shape[0] if rows is None else rows
        if self.world == 1:
            return t[:rows]
        buf = t.new_zeros((self.world,) + tuple(t.shape))
        buf[self.rank] = t
        counts = torch.zeros(self.world, dtype=torch.int64, device=t.device)
        counts[self.rank] = rows
        self._all_reduce(buf)
        counts = self._all_reduce(counts).tolist()
        return torch.cat([buf[r, :n] for r, n in enumerate(counts)])

    def gather_steps(self, t: torch.Tensor, steps: int) -> torch.Tensor:
        """An epoch's per-step rows (``steps`` equal blocks of rows on each
        rank, in step order) as one rank holds them over the global
        batches: step by step, each step's rows in rank order."""
        if self.world == 1:
            return t
        buf = t.new_zeros((self.world,) + tuple(t.shape))
        buf[self.rank] = t
        self._all_reduce(buf)
        buf = buf.reshape(self.world, steps, -1, *t.shape[1:]).transpose(0, 1)
        return buf.reshape(-1, *t.shape[1:])


def make_mesh(n_devices: Optional[int] = None, axis: str = "data", device=None) -> Mesh:
    """The mesh of every rank of the default process group (one rank, on
    ``device``, without one); ``n_devices``, when given, must be the
    world's size: each rank holds one device.  ``device``: this rank's,
    default `distributed.local_device` of CUDA where a card is visible, else
    the CPU."""
    from xfmamba_tpu_torch.parallel.distributed import (
        local_device, process_count, process_index)
    world = process_count()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices in a world of {world} processes: "
                         f"each process holds one device")
    if device is None:
        device = local_device("cuda" if torch.cuda.is_available() else "cpu")
    return Mesh(world, process_index(), torch.device(device), axis)


def batch_sharding(mesh: Mesh, axis: str = "data"):
    """The placement of a batch over the mesh: rows split (``Shard(0)``)."""
    from torch.distributed.tensor import Shard
    return (Shard(0),)


def replicated(mesh: Mesh):
    """The placement of the parameters: every rank a copy (``Replicate``)."""
    from torch.distributed.tensor import Replicate
    return (Replicate(),)


def shard_batch(batch: Dict[str, Any], mesh: Mesh, axis: str = "data") -> Dict[str, Any]:
    """This rank's rows of a global batch (every value batch-leading, the
    batch divisible by the world), as tensors on its device; an
    ``n_valid`` count of a padded batch becomes this rank's count."""
    out = {}
    for k, v in batch.items():
        if k == "n_valid":
            continue
        v = torch.as_tensor(v)
        if v.shape[0] % mesh.world:
            raise ValueError(f"batch of {v.shape[0]} rows not divisible by "
                             f"{mesh.world} ranks")
        per = v.shape[0] // mesh.world
        out[k] = v[mesh.rank * per:(mesh.rank + 1) * per].to(mesh.device)
        rows = per
    if "n_valid" in batch:
        out["n_valid"] = min(max(int(batch["n_valid"]) - mesh.rank * rows, 0), rows)
    return out


def _shard(mesh: Mesh, batch) -> BatchShard:
    return BatchShard(mesh.rank, mesh.world, batch["image1"].shape[0], mesh.group)


def make_parallel_train_step(train_step, mesh: Mesh, axis: str = "data"):
    """Wrap a ``train_step(batch, lr=None, reduce=None)`` (`train.loop.
    make_train_step`, `train.mutual.make_mutual_train_step`) for the mesh:
    each rank passes its rows of the global batch; the step averages the
    gradients over the ranks before the optimizer's update and returns the
    global mean loss, and runs inside `models.layers.batch_shard`.  The
    logits stay this rank's rows."""
    def step(batch, lr=None):
        with batch_shard(_shard(mesh, batch)):
            return train_step(batch, lr, reduce=mesh)
    return step


def make_parallel_eval_step(eval_step, mesh: Mesh, axis: str = "data"):
    """Wrap an ``eval_step(batch)`` (`train.loop.make_train_step`: its
    ``loss_sum``, ``count``, ``logits`` and ``label`` of the batch's
    ``n_valid`` rows) for the mesh: each rank runs its rows (a padded
    batch's rank may hold none valid); returns the same keys over the global
    batch, ``loss`` the mean over its valid rows, logits and labels in rank
    order."""
    def step(batch):
        out = eval_step(batch)
        rows = batch["label"].shape[0]
        valid = out["logits"].shape[0]

        def gather(t):
            pad = t.new_zeros((rows - valid,) + tuple(t.shape[1:]))
            return mesh.gather_rows(torch.cat([t, pad]), valid)

        sums = mesh.sum(torch.stack([out["loss_sum"].double(),
                                     torch.tensor(float(out["count"]), dtype=torch.float64,
                                                  device=out["loss_sum"].device)]))
        return {"loss": sums[0] / sums[1], "loss_sum": sums[0], "count": int(sums[1]),
                "logits": gather(out["logits"].float()), "label": gather(out["label"])}
    return step


def make_parallel_infer(infer_fn, mesh: Mesh, axis: str = "data"):
    """Wrap an inference function ``infer_fn(batch) -> outputs`` (a tensor,
    or a tuple, list or dict of batch-leading tensors) for the mesh: each
    rank runs its rows; every output is gathered in rank order."""
    def gather(x):
        if isinstance(x, torch.Tensor):
            return mesh.gather_rows(x)
        if isinstance(x, dict):
            return {k: gather(v) for k, v in x.items()}
        return type(x)(gather(v) for v in x)

    def infer(batch):
        return gather(infer_fn(batch))
    return infer

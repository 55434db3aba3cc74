"""Multi-process set-up (port of ``xfmamba_tpu/parallel/distributed.py``).

One process per card, joined by ``torch.distributed``: NCCL between cards,
gloo on the CPU (or where the caller names it, as for two ranks sharing one
card).  `ensure_initialized` starts the process group once, from explicit
arguments or torchrun's environment, and does nothing without either, so
one-process runs are untouched, as in JAX.  The helpers every data-parallel
loop needs: `is_primary` (the rank that writes files), `make_global_mesh`
(the world as a `parallel.mesh.Mesh`), `process_batch_slice` (the rows of
a global batch this rank loads) and `host_local_batch_to_global`.
"""

from __future__ import annotations

import os
import socket
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

# the process group's backend where the caller names none: this variable,
# else NCCL with a card and gloo without one
BACKEND_ENV = "XFMAMBA_DIST_BACKEND"


def ensure_initialized(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None,
                       backend: Optional[str] = None) -> None:
    """Start the default process group exactly once.

    Explicit arguments win (``coordinator_address`` "host:port", where rank
    0 serves the rendezvous); otherwise torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) through ``env://``.
    With neither this is a no-op.  ``backend``: the caller's, else
    ``$XFMAMBA_DIST_BACKEND``, else ``nccl`` where CUDA is available and
    ``gloo`` where it is not."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and num_processes is None and process_id is None:
        if "WORLD_SIZE" not in env or "RANK" not in env:
            return      # one process, nothing to do
        init, world, rank = "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        if coordinator_address is None:
            if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
                raise ValueError("a process group needs a coordinator address "
                                 "(--coordinator_address or MASTER_ADDR/MASTER_PORT)")
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        world = num_processes if num_processes is not None else int(env.get("WORLD_SIZE", 1))
        rank = process_id if process_id is not None else int(env.get("RANK", 0))
        init = f"tcp://{coordinator_address}"
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} is outside a world of {world} processes")
    backend = backend or env.get(BACKEND_ENV) or (
        "nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)


def free_port() -> int:
    """A TCP port of this host that is free now, for a rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs (rank 0, or the
    only process)."""
    return process_index() == 0


def local_device(device="cuda") -> torch.device:
    """This process's device of ``device``'s type, made the current CUDA
    device (the kernels launch on the current device's stream): in a
    process group the card of ``LOCAL_RANK`` (torchrun's), else of the rank
    modulo the visible cards; without one the device as given; the CPU as
    it is."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if dist.is_initialized():
        index = (int(os.environ["LOCAL_RANK"]) if "LOCAL_RANK" in os.environ
                 else dist.get_rank() % max(torch.cuda.device_count(), 1))
        device = torch.device("cuda", index)
    if device.index is not None:
        torch.cuda.set_device(device)
    return device


def make_global_mesh(axis: str = "data", device=None):
    """The 1-axis mesh over every process of the group (one device each)."""
    from xfmamba_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(axis=axis, device=device)


def process_batch_slice(global_batch_size: int) -> slice:
    """The half-open range of a global batch's rows that this process
    loads, each process an equal share."""
    n = process_count()
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by {n} processes")
    per = global_batch_size // n
    i = process_index()
    return slice(i * per, (i + 1) * per)


def host_local_batch_to_global(batch: Dict[str, Any], mesh,
                               axis: str = "data") -> Dict[str, torch.Tensor]:
    """This process's slice of a global batch (`process_batch_slice`) as
    tensors on its device.  JAX assembles the slices of every process into
    one global array sharded over the mesh; torch has no global array, so
    each rank keeps its rows, and the collectives of the parallel steps
    (`parallel.mesh`) join what the global batch needs: the gradients, the
    loss, the batch statistics and the gathered outputs."""
    return {k: torch.as_tensor(v).to(mesh.device) for k, v in batch.items()}

"""Multi-process execution: joining the process group and owning shards.

The port of ``connectome_gnn_tpu/parallel/distributed.py``.  JAX joins a
multi-process job with ``jax.distributed.initialize`` and spans every
process's devices with one mesh; here :func:`initialize_distributed`
calls ``torch.distributed.init_process_group`` with the backend of the
rank's device (NCCL for ``cuda``, gloo for ``cpu``), and each rank then
builds a :class:`~connectome_gnn_tpu_torch.parallel.mesh.Mesh` over its
one device.  Each process materializes only its own shards (the loader's
``process_index`` / ``process_count``, the partitioners' ``shard_range``)
and :func:`assemble_global` places them on its device.

NCCL refuses two ranks on one card, so a machine with one card runs one
rank, in a group of size 1, holding every shard.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from connectome_gnn_tpu_torch.parallel.mesh import backend_for


def initialize_distributed(
    init_method: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device="cuda",
) -> None:
    """Join (or start) a multi-process job.

    Call once per process before building a mesh.  ``init_method`` is a
    rendezvous such as ``file:///tmp/rdv`` or ``tcp://localhost:29500``;
    with ``num_processes`` and ``process_id`` it names this rank.  The
    backend is ``device``'s (NCCL for ``cuda``, gloo for ``cpu``; a build
    without it raises); a group already initialized with another backend
    raises too.  A no-op when ``init_method`` is None and one process is
    asked for (a single-process run needs no group).
    """
    device = torch.device(device)
    backend = backend_for(device)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}, not {backend}")
        return
    if init_method is None:
        if (num_processes or 1) == 1:
            return
        raise ValueError("a multi-process job needs init_method")
    kwargs = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        kwargs["device_id"] = device if device.index is not None else torch.device(
            "cuda", torch.cuda.current_device())
    dist.init_process_group(backend, init_method=init_method, world_size=int(num_processes or 1),
                            rank=int(process_id or 0), **kwargs)


def shutdown_distributed() -> None:
    """Leave the process group, where one was joined."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def local_shard_range(num_shards: int) -> tuple[int, int]:
    """The contiguous ``[lo, hi)`` of ``num_shards`` shards this process
    owns (shard ``d`` on rank ``d // (num_shards / process_count)``, as a
    mesh places them)."""
    procs = process_count()
    if num_shards % procs:
        raise ValueError(f"num_shards={num_shards} not divisible by process_count={procs}")
    per = num_shards // procs
    lo = process_index() * per
    return lo, lo + per


def assemble_global(stacked, mesh):
    """Place a stacked pytree, this process's shards or all of them, on the
    mesh's device as the rank's local stack (:meth:`Mesh.place`)."""
    return mesh.place(stacked)

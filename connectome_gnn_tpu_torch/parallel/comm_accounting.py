"""Counted, not modelled, collective payload.

The port of ``connectome_gnn_tpu/parallel/comm_accounting.py``.  JAX walks
a traced program's jaxpr for collective primitives.  The port has no
jaxpr: :func:`count_collective_bytes` runs the program once and reads what
the :class:`~connectome_gnn_tpu_torch.parallel.mesh.Mesh` counted at each
call (``bytes_moved``: the bytes this rank handed to each collective,
forward and backward apart), so the number is what the program exchanged,
backward collectives included.

It reports JAX's per-device received-bytes conventions
(``comm_accounting.py:38-46`` of the JAX package), with ``D`` the mesh's
shard count and ``D_local`` the rank's:

* ``all_gather``: a shard's operand × (D-1), the other shards' blocks;
* ``all_to_all``: a shard's operand × (D-1)/D, the block kept for itself
  stays;
* ``psum`` (every all-reduce: sums, sync-BatchNorm's moments, the gradient
  reduction, the backward of a gather) and ``pmax``: the operand × 2(D-1)/D,
  the ring's reduce-scatter and all-gather;
* ``ppermute`` (a :meth:`Mesh.shift`): a shard's operand.

A shard's operand is the rank's bytes over ``D_local`` for the stacked
collectives (``all_gather``, ``all_to_all``, ``shift``); an all-reduce's
operand is one tensor a rank, the size of JAX's one a device.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable

from connectome_gnn_tpu_torch.parallel.mesh import Mesh

#: the Mesh's counter kinds → (JAX primitive, stacked a shard?)
_KINDS = {
    "all_gather": ("all_gather", True),
    "all_to_all": ("all_to_all", True),
    "all_to_all (backward)": ("all_to_all", True),
    "shift": ("ppermute", True),
    "shift (backward)": ("ppermute", True),
    "psum": ("psum", False),
    "psum (backward)": ("psum", False),
    "gradient all_reduce": ("psum", False),
    "all_gather (backward)": ("psum", False),
    "pmax": ("pmax", False),
}

#: JAX primitive → f(operand bytes, D) = received bytes a device
_RECEIVED = {
    "all_gather": lambda b, d: b * (d - 1),
    "all_to_all": lambda b, d: b * (d - 1) / d,
    "psum": lambda b, d: b * 2 * (d - 1) / d,
    "pmax": lambda b, d: b * 2 * (d - 1) / d,
    "ppermute": lambda b, d: b,
}


def received_bytes(mesh: Mesh, moved: Counter) -> dict:
    """Counts of :attr:`Mesh.bytes_moved` (or a difference of two) as a
    device's received bytes by JAX primitive, plus ``"total"``."""
    D, Dl = mesh.size, mesh.local_shards
    totals: dict = {}
    for kind, b in moved.items():
        if kind not in _KINDS:
            raise ValueError(f"no convention for the collective kind {kind!r}")
        name, stacked = _KINDS[kind]
        if D > 1 and b:
            totals[name] = totals.get(name, 0.0) + _RECEIVED[name](b / Dl if stacked else b, D)
    out = {k: int(round(v)) for k, v in totals.items()}
    out["total"] = int(round(sum(totals.values())))
    return out


def count_collective_bytes(mesh: Mesh, fn: Callable, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and return a device's received bytes
    by collective primitive over ``mesh``, plus ``"total"``
    (:func:`received_bytes`).  The mesh's counters keep counting as they
    would: the result is what this call added to them."""
    before = Counter(mesh.bytes_moved)
    fn(*args, **kwargs)
    return received_bytes(mesh, mesh.bytes_moved - before)

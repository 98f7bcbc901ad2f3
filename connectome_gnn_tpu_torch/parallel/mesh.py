"""A named mesh of shards over ``torch.distributed``, and its collectives.

The port of ``connectome_gnn_tpu/parallel/mesh.py``.  JAX runs one shard
per device and lets ``shard_map`` insert the collectives.  Here a process
(a *rank*) drives one device and owns the contiguous shards ``[lo, hi)`` of
the mesh's ``D`` shards, carried as a leading tensor axis ``[D_local, ...]``
(the counterpart of JAX's devices per process).  So one process holding
eight shards is the JAX tests' one-process, eight-device mesh, and one card
runs one rank with all of its shards.

Shards are numbered row-major over the mesh's axes (``("data", "edge")``:
shard ``d · De + e``).  Each collective is an operation over the local
shard axis and, where the mesh has a process group, the matching
``torch.distributed`` call; every collective goes through the group, even
one of size 1.  Each is a ``torch.autograd.Function`` with the backward
that JAX's autodiff gives it:

* :meth:`Mesh.psum` sums over every shard (its backward is a ``psum``);
* :meth:`Mesh.pmax` takes the largest value over every shard (no backward);
* :meth:`Mesh.all_gather` stacks every shard (backward: the sum of the
  cotangents, sliced back to the rank's shards);
* :meth:`Mesh.shift` moves each shard's block one step along an axis, a
  *chain*, not a ring: the end shards receive zeros (backward: the shift
  the other way);
* :meth:`Mesh.all_to_all` sends block ``i`` of a shard to the ``i``-th
  shard of its group along an axis (backward: the same exchange).

``shift`` and ``all_to_all`` are one routing primitive: every message is
gathered into one send buffer ordered by destination rank and moved by one
``all_to_all_single``.  The backend follows the device: NCCL for ``cuda``,
gloo for ``cpu``, with no fallback either way.  Without an initialized
process group a mesh lives in one process and its collectives are local
operations on its device.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from connectome_gnn_tpu_torch.data.batch import card_by_default


def backend_for(device: torch.device) -> str:
    """The collective backend of ``device``: ``nccl`` for ``cuda``, ``gloo``
    for ``cpu``.  Raises where the build lacks it."""
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a mesh on cuda needs NCCL, and this torch build has none")
        return "nccl"
    if device.type == "cpu":
        if not dist.is_gloo_available():
            raise RuntimeError("a mesh on the CPU needs gloo, and this torch build has none")
        return "gloo"
    raise ValueError(f"no collective backend for device {device}")


class Mesh:
    """Shards over named axes, and this rank's part of them.

    Attributes
    ----------
    axis_names / shape
        The axes and the global shard count of each.
    size
        ``D``, the number of shards.
    device
        The rank's one device.
    group
        The process group (``None``: one process, local collectives).
    rank / world
        This process and the number of processes.
    lo / hi / local_shards
        The rank's shards ``[lo, hi)``, ``D / world`` of them.
    bytes_moved / calls
        Bytes this rank handed to each collective, and its calls (forward
        and backward apart), counted at the call.
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], device, group=None):
        if len(shape) != len(axis_names) or not shape:
            raise ValueError(f"mesh shape {tuple(shape)} does not match axes {tuple(axis_names)}")
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        self.size = math.prod(self.shape)
        self.device = torch.device(device)
        self.group = group
        self.world = dist.get_world_size(group) if group is not None else 1
        self.rank = dist.get_rank(group) if group is not None else 0
        if self.size % self.world:
            raise ValueError(f"{self.size} shards do not divide over {self.world} processes")
        self.local_shards = self.size // self.world
        self.lo = self.rank * self.local_shards
        self.hi = self.lo + self.local_shards
        self.strides = tuple(math.prod(self.shape[i + 1:]) for i in range(len(self.shape)))
        self.bytes_moved: Counter = Counter()
        self.calls: Counter = Counter()
        self._plans: dict = {}

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={s}" for a, s in zip(self.axis_names, self.shape))
        return (f"Mesh({axes}; rank {self.rank} of {self.world}, shards [{self.lo}, {self.hi}) "
                f"on {self.device})")

    def axis_size(self, axis: str) -> int:
        return self.shape[self._axis(axis)]

    def _axis(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r} (axes {self.axis_names})")
        return self.axis_names.index(axis)

    def coordinate(self, shard: int, axis: str) -> int:
        """Shard ``shard``'s index along ``axis``."""
        a = self._axis(axis)
        return (shard // self.strides[a]) % self.shape[a]

    def owner(self, shard: int) -> int:
        return shard // self.local_shards

    # ------------------------------------------------------------------
    # Data placement
    # ------------------------------------------------------------------

    def place(self, stacked):
        """A stacked pytree (a dataclass, NamedTuple, dict or tensor whose
        tensors carry a leading shard axis) on this rank's device, holding
        the rank's shards: leaves of leading size ``D`` are sliced to
        ``[lo, hi)``, leaves of leading size ``D_local`` are taken as they
        are.  The counterpart of JAX's ``assemble_global``."""
        return _map_tensors(stacked, self._place_leaf)

    def _place_leaf(self, t: torch.Tensor) -> torch.Tensor:
        if t.dim() == 0:
            raise ValueError("a sharded leaf needs a leading shard axis")
        lead = int(t.shape[0])
        if lead == self.size and self.size != self.local_shards:
            t = t[self.lo:self.hi]
        elif lead != self.local_shards:
            raise ValueError(
                f"leading axis {lead} is neither the mesh's {self.size} shards nor this "
                f"rank's {self.local_shards}"
            )
        return t.to(self.device)

    def shard_generators(self, seed: int) -> list[torch.Generator]:
        """One generator per local shard on the mesh's device, shard ``g``
        seeded ``seed · D + g``: the same streams however the shards are
        spread over processes."""
        return [torch.Generator(device=self.device).manual_seed(int(seed) * self.size + g)
                for g in range(self.lo, self.hi)]

    # ------------------------------------------------------------------
    # Collectives
    # ------------------------------------------------------------------

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """``x [D_local, ...]`` summed over every shard of the mesh;
        ``[...]``, the same on every rank."""
        return self.all_reduce(x.sum(dim=0))

    def all_reduce(self, t: torch.Tensor, constant_prefix: int = 0) -> torch.Tensor:
        """A per-rank value summed over ranks (differentiable).  The first
        ``constant_prefix`` entries of a 1-D ``t`` are data with no
        gradient: the backward leaves them out of its all-reduce."""
        return _AllReduce.apply(t, self, constant_prefix)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """``x [D_local, ...]``'s largest value over every shard of the mesh
        (no autograd); ``[...]``, the same on every rank."""
        out = x.amax(dim=0)
        self._count("pmax", out)
        if self.group is not None:
            dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``x [D_local, ...]`` from every rank, stacked ``[D, ...]``."""
        return _AllGather.apply(x, self)

    def shift(self, x: torch.Tensor, axis: str, offset: int) -> torch.Tensor:
        """Each shard receives ``x`` of the shard ``offset`` (±1) before it
        along ``axis``; a shard with none there receives zeros (a chain)."""
        if offset not in (-1, 1):
            raise ValueError(f"shift offset must be ±1, got {offset}")
        plan = self._plan(("shift", axis, offset))
        return _Route.apply(x.unsqueeze(1), self, plan, "shift").squeeze(1)

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x [D_local, A, ...]`` (``A`` the axis size): block ``i`` of a
        shard goes to the ``i``-th shard of its group along ``axis``, and
        block ``j`` of the result came from the group's ``j``-th shard."""
        if x.shape[1] != self.axis_size(axis):
            raise ValueError(f"all_to_all over {axis!r} needs {self.axis_size(axis)} blocks, "
                             f"got {x.shape[1]}")
        return _Route.apply(x, self, self._plan(("all_to_all", axis)), "all_to_all")

    def _count(self, kind: str, t: torch.Tensor) -> None:
        self.bytes_moved[kind] += t.numel() * t.element_size()
        self.calls[kind] += 1

    def reduce_(self, t: torch.Tensor, kind: str) -> None:
        """Sum ``t`` over ranks in place (no autograd), counted as ``kind``."""
        self._count(kind, t)
        if self.group is not None:
            dist.all_reduce(t, group=self.group)

    def _exchange(self, send: torch.Tensor, in_splits, out_splits, kind: str) -> torch.Tensor:
        """Rows of ``send`` to the ranks by ``in_splits``; rows received by
        ``out_splits`` (one ``all_to_all_single``)."""
        self._count(kind, send)
        if self.group is None:
            return send
        recv = send.new_empty((sum(out_splits),) + tuple(send.shape[1:]))
        dist.all_to_all_single(recv, send.contiguous(), output_split_sizes=list(out_splits),
                               input_split_sizes=list(in_splits), group=self.group)
        return recv

    def _plan(self, key):
        if key not in self._plans:
            self._plans[key] = self._make_plan(key)
        return self._plans[key]

    def _make_plan(self, key):
        """Messages ``(src shard, src block, dst shard, dst block)`` of a
        shift or an all-to-all, and this rank's side of them: the local rows
        it sends, by destination rank, and the local rows it fills, by
        source rank, both in the one order every rank derives."""
        kind, axis = key[0], key[1]
        a = self._axis(axis)
        A, stride = self.shape[a], self.strides[a]
        messages = []
        for g in range(self.size):
            c = self.coordinate(g, axis)
            if kind == "shift":
                if 0 <= c + key[2] < A:
                    messages.append((g, 0, g + key[2] * stride, 0))
            else:
                messages.extend((g, i, g + (i - c) * stride, c) for i in range(A))
        k_in = 1 if kind == "shift" else A
        send_rows, recv_rows = [], []
        in_splits, out_splits = [0] * self.world, [0] * self.world
        for q in range(self.world):
            for src, sk, dst, dk in messages:
                if self.owner(src) == self.rank and self.owner(dst) == q:
                    send_rows.append((src - self.lo) * k_in + sk)
                    in_splits[q] += 1
                if self.owner(src) == q and self.owner(dst) == self.rank:
                    recv_rows.append((dst - self.lo) * k_in + dk)
                    out_splits[q] += 1
        return (torch.tensor(send_rows, dtype=torch.long, device=self.device),
                torch.tensor(recv_rows, dtype=torch.long, device=self.device),
                in_splits, out_splits, k_in)


def _map_tensors(tree, fn):
    """``tree`` with ``fn`` applied to every tensor leaf (dataclasses,
    NamedTuples, dicts, lists and tuples; other leaves kept)."""
    import dataclasses

    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_tensors(getattr(tree, f.name), fn)
            for f in dataclasses.fields(tree) if f.init
        })
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tensors(v, fn) for v in tree))
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


class _AllReduce(torch.autograd.Function):
    """Sum over ranks; the backward sums the cotangents over ranks."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, mesh: Mesh, constant_prefix: int) -> torch.Tensor:
        ctx.mesh, ctx.prefix = mesh, constant_prefix
        out = t.clone()
        mesh.reduce_(out, "psum")
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.clone()
        g[: ctx.prefix] = 0.0
        ctx.mesh.reduce_(g[ctx.prefix:], "psum (backward)")
        return g, None, None


class _AllGather(torch.autograd.Function):
    """``[D_local, ...]`` → ``[D, ...]``; the backward sums the cotangents
    over ranks and keeps the rank's slice."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.mesh = mesh
        x = x.contiguous()
        mesh._count("all_gather", x)
        if mesh.group is None:
            return x.clone()
        parts = [torch.empty_like(x) for _ in range(mesh.world)]
        dist.all_gather(parts, x, group=mesh.group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        mesh = ctx.mesh
        g = g.clone()
        mesh.reduce_(g, "all_gather (backward)")
        return g[mesh.lo:mesh.hi], None


class _Route(torch.autograd.Function):
    """Move blocks between shards by a plan (:meth:`Mesh._make_plan`):
    ``x [D_local, K, ...]`` → ``y [D_local, K, ...]``, zeros where no block
    arrives.  The backward routes the cotangents back the same way."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: Mesh, plan, kind: str) -> torch.Tensor:
        send_rows, recv_rows, in_splits, out_splits, k = plan
        ctx.mesh, ctx.plan, ctx.kind, ctx.shape = mesh, plan, kind, x.shape
        flat = x.reshape(x.shape[0] * k, -1)
        recv = mesh._exchange(flat.index_select(0, send_rows), in_splits, out_splits, kind)
        out = flat.new_zeros(flat.shape)
        out.index_copy_(0, recv_rows, recv)
        return out.view(x.shape)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        send_rows, recv_rows, in_splits, out_splits, k = ctx.plan
        flat = g.reshape(ctx.shape[0] * k, -1)
        back = ctx.mesh._exchange(flat.index_select(0, recv_rows), out_splits, in_splits,
                                  ctx.kind + " (backward)")
        out = flat.new_zeros(flat.shape)
        out.index_add_(0, send_rows, back)
        return out.view(ctx.shape), None, None, None


def create_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("data",),
    device=None,
) -> Mesh:
    """A named mesh over the process group (``init_process_group``, see
    :func:`~connectome_gnn_tpu_torch.parallel.distributed.
    initialize_distributed`), or over this process alone when none is
    initialized.

    ``shape`` defaults to one shard per process on a 1-D mesh.  ``device``
    (default ``cuda``; without a card that raises, and ``device="cpu"`` asks
    for the CPU) is this rank's device; an initialized group's backend must
    be its backend (NCCL for ``cuda``, gloo for ``cpu``), or this raises.
    """
    device = torch.device(card_by_default(device, "create_mesh"))
    backend = backend_for(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    group = None
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
        if dist.get_backend(group) != backend:
            raise RuntimeError(
                f"a mesh on {device.type} needs the {backend} backend; the process group "
                f"runs {dist.get_backend(group)}"
            )
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("shape is required for multi-axis meshes")
        shape = (dist.get_world_size(group) if group is not None else 1,)
    return Mesh(shape, axis_names, device, group)

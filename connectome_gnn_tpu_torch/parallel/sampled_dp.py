"""Data-parallel device-side sampled training over a mesh.

The port of ``connectome_gnn_tpu/parallel/sampled_dp.py``.  Device-side
neighbor sampling (``data/device_sampling.py``: the graph on the device,
one ~8 KB seed row a step) composed with exact data parallelism
(``parallel/data_parallel.py``): the :class:`~connectome_gnn_tpu_torch.data.
device_sampling.DeviceGraphCSR` is replicated, one copy a rank on its device
(:func:`replicate_csr`), and only the stacked seed rows ``[D_local, 3 + 2S]``
are sharded.  Each local row is sampled with its own key (streamed by the
global shard index, so several processes agree with one), the rank's shards
are merged into one batch (:func:`~connectome_gnn_tpu_torch.parallel.
data_parallel.merge_sampled`) and run with sync-BatchNorm over the mesh;
the gradients are reduced once (:func:`~connectome_gnn_tpu_torch.parallel.
shard_forward.reduce_gradients`).

:func:`make_device_sampled_dp_epoch_runner` runs an epoch from one uploaded
``[steps, D_local, 3 + 2S]`` buffer: on the card one step, collectives
included, is captured as a CUDA graph and replayed a row, the counterpart
of JAX's ``lax.scan`` inside one ``shard_map``; on the CPU the same steps run
eagerly.  A replay does not tick the mesh's Python counters, so the runner
adds one captured step's counts a replay.
"""

from __future__ import annotations

import dataclasses
from collections import Counter

import torch

from connectome_gnn_tpu_torch.data.device_sampling import DeviceGraphCSR, SeedBatch, device_sample
from connectome_gnn_tpu_torch.parallel.data_parallel import merge_sampled
from connectome_gnn_tpu_torch.parallel.mesh import Mesh
from connectome_gnn_tpu_torch.parallel.shard_forward import (
    masked_ce_sum,
    reduce_gradients,
    synced_batch_norm,
    use_shard_generators,
)


def replicate_csr(csr: DeviceGraphCSR, mesh: Mesh) -> DeviceGraphCSR:
    """The CSR on the mesh's device (a one-time copy; the same object when
    it is there already).  Every rank holds a whole copy, built from the
    same graph: nothing graph-sized crosses processes."""
    return csr if csr.device == mesh.device else csr.to(mesh.device)


def sample_shards(model, packed: torch.Tensor, csr: DeviceGraphCSR, labeled: bool = True):
    """The rank's seed rows ``packed [D_local, 3 + 2S]`` sampled each with
    its own key and merged into one batch (seeds first)."""
    S = (int(packed.shape[-1]) - 3) // 2
    parts = []
    for row in packed:
        seeds = SeedBatch(packed=row, csr=csr, num_seeds=S, labeled=labeled)
        s = device_sample(csr, seeds.seeds, seeds.key_words, model.fanout, dedup=model.dedup)
        parts.append(dataclasses.replace(s, labels=seeds.labels, label_mask=seeds.label_mask,
                                         seed_mask=seeds.seed_mask))
    return merge_sampled(parts)


def _check_rows(packed: torch.Tensor, mesh: Mesh) -> None:
    if packed.dim() != 2 or packed.shape[0] != mesh.local_shards:
        raise ValueError(f"seed rows must be stacked [D_local, 3 + 2S] with D_local = "
                         f"{mesh.local_shards}, got {tuple(packed.shape)}")


def dp_seed_loss_and_grads(model, mesh: Mesh, packed: torch.Tensor, csr: DeviceGraphCSR,
                           labeled: bool = True):
    """Forward and backward of a device-sampled data-parallel step (train
    mode, sync-BatchNorm), the gradients reduced once; the global ``(loss,
    n)``."""
    _check_rows(packed, mesh)
    batch = sample_shards(model, packed, csr, labeled)
    model.train()
    with synced_batch_norm(model, mesh):
        logits = model.inner(batch)
    local_sum, local_n = masked_ce_sum(logits, batch.labels, batch.label_mask)
    local_sum.backward()
    return reduce_gradients(mesh, list(model.parameters()), local_sum, local_n)


def dp_seed_eval_sums(model, mesh: Mesh, packed: torch.Tensor, csr: DeviceGraphCSR,
                      labeled: bool = True) -> torch.Tensor:
    """Eval mode: ``[Σ loss, correct, n_real]`` over every shard of the
    mesh (each row sampled with its own key, running BatchNorm moments)."""
    _check_rows(packed, mesh)
    model.eval()
    with torch.no_grad():
        batch = sample_shards(model, packed, csr, labeled)
        logits = model.inner(batch)
        loss_sum, n = masked_ce_sum(logits, batch.labels, batch.label_mask)
        correct = ((logits.argmax(dim=1) == batch.labels) & batch.label_mask).sum()
        return mesh.all_reduce(torch.stack([loss_sum, correct.to(loss_sum.dtype), n]))


def make_device_sampled_dp_step(model, optimizer: torch.optim.Optimizer, mesh: Mesh,
                                axis_name: str = "data", *, labeled: bool = True,
                                guard: bool = False, seed: int = 0):
    """A data-parallel device-sampled train step of a ``DeviceSampledModel``:
    ``step(packed, csr) -> (loss, n)`` (``(loss, n, ok)`` with ``guard``,
    the non-finite step guard on the global values), with ``packed`` the
    rank's stacked seed rows and ``csr`` the replicated graph.  Dropout
    draws each shard's mask from its own generator, seeded from ``seed``."""
    from connectome_gnn_tpu_torch.train.trainer import guarded_step

    mesh.axis_size(axis_name)
    use_shard_generators(model, mesh, seed)

    def step(packed, csr):
        out = guarded_step(model, optimizer,
                           lambda: dp_seed_loss_and_grads(model, mesh, packed, csr, labeled), guard)
        return out if guard else out[:2]

    return step


def make_device_sampled_dp_eval_step(model, mesh: Mesh, axis_name: str = "data", *,
                                     labeled: bool = True):
    """``ev(packed, csr) -> (loss_sum, correct, n_real)`` over the whole
    mesh, as device scalars."""
    mesh.axis_size(axis_name)

    def ev(packed, csr):
        sums = dp_seed_eval_sums(model, mesh, packed, csr, labeled)
        return sums[0], sums[1], sums[2]

    return ev


def capture_step(step, device, generators=(), params=()):
    """Run ``step()`` once eagerly on a side stream (the warm-up that makes
    the optimizer's state, the mesh's routing plans and the communicators),
    then capture one call as a CUDA graph; returns the graph.  The capture
    gives ``params`` new gradient buffers, which hold nothing until a
    replay: the warm-up's gradients are copied in, so they hold the last
    step's as after an eager one.  A failed capture raises with its cause:
    nothing falls back to eager steps."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream(device).wait_stream(side)
    warm = [p.grad for p in params]
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    try:
        with torch.cuda.graph(graph):
            step()
    except RuntimeError as exc:
        raise RuntimeError(f"could not capture the train step as a CUDA graph: {exc}") from exc
    with torch.no_grad():
        for p, g in zip(params, warm):
            if g is not None and p.grad is not None:
                p.grad.copy_(g)
    return graph


def make_device_sampled_dp_epoch_runner(model, optimizer: torch.optim.Optimizer, mesh: Mesh,
                                        axis_name: str = "data", *, labeled: bool = True,
                                        seed: int = 0):
    """A whole device-sampled data-parallel epoch from one buffer:
    ``run(packed_all, csr) -> (losses [steps], ns [steps])`` with
    ``packed_all`` the rank's ``[steps, D_local, 3 + 2S]`` rows
    (:func:`~connectome_gnn_tpu_torch.data.device_sampling.
    pack_epoch_sharded`) on the mesh's device.

    The steps are :func:`make_device_sampled_dp_step`'s (no guard, as in
    JAX's scanned epoch).  On the card the first row's step runs eagerly
    and one step is captured as a CUDA graph (per row shape and CSR), whose
    replays read each row from a slot on the device; the mesh's counters
    grow by the captured step's counts a replay.  On the CPU the rows run
    eagerly.
    """
    mesh.axis_size(axis_name)
    gens = use_shard_generators(model, mesh, seed)
    captured: dict = {}

    def one(row, csr, out):
        optimizer.zero_grad(set_to_none=True)
        loss, n = dp_seed_loss_and_grads(model, mesh, row, csr, labeled)
        optimizer.step()
        out.copy_(torch.stack([loss, n]))

    def run(packed_all, csr):
        steps = int(packed_all.shape[0])
        out = torch.zeros(steps, 2, device=packed_all.device)
        if steps == 0:
            return out[:, 0], out[:, 1]
        if packed_all.device.type != "cuda":
            for i in range(steps):
                one(packed_all[i], csr, out[i])
            return out[:, 0], out[:, 1]
        key = (tuple(packed_all.shape[1:]), id(csr))
        start = 0
        if key not in captured:
            slot, res = packed_all[0].clone(), torch.zeros(2, device=packed_all.device)
            before = counts_of(mesh)
            graph = capture_step(lambda: one(slot, csr, res), packed_all.device,
                                 gens if any(m.p > 0 for m in _dropouts(model)) else (),
                                 list(model.parameters()))
            delta = keep_one_run(mesh, before)
            captured[key] = graph, slot, res, delta, csr
            out[0].copy_(res)
            start = 1
        graph, slot, res, delta, _ = captured[key]
        for i in range(start, steps):
            slot.copy_(packed_all[i])
            graph.replay()
            out[i].copy_(res)
        add_replays(mesh, delta, steps - start)
        return out[:, 0], out[:, 1]

    return run


def _dropouts(model):
    from connectome_gnn_tpu_torch.nn.layers import Dropout

    return [m for m in model.modules() if isinstance(m, Dropout)]


def counts_of(mesh: Mesh) -> tuple:
    """Copies of the mesh's ``(bytes_moved, calls)`` counters."""
    return Counter(mesh.bytes_moved), Counter(mesh.calls)


def keep_one_run(mesh: Mesh, before: tuple) -> tuple:
    """After :func:`capture_step` (the step ran once and was recorded once,
    both counted, though only the first ran): set the mesh's counters to
    ``before`` plus one step's counts, and return those counts."""
    delta = []
    for now, was in zip((mesh.bytes_moved, mesh.calls), before):
        one = Counter({k: (now[k] - was.get(k, 0)) // 2 for k in now})
        now.clear()
        now.update(was)
        now.update(one)
        delta.append(one)
    return tuple(delta)


def add_replays(mesh: Mesh, delta: tuple, times: int) -> None:
    """The mesh's counters after ``times`` replays of a captured step whose
    counts are ``delta``: a replay runs the collectives but no Python."""
    for counter, d in zip((mesh.bytes_moved, mesh.calls), delta):
        for k, v in d.items():
            counter[k] += v * times

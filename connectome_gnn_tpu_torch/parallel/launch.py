"""Run the parallel modes in N real processes and hold them to one.

The port of ``benchmarks/multiprocess.py``'s rig (programs ``dp``,
``banded``, ``hybrid`` and ``trainer_fit``).  The parent starts ``--procs``
worker processes, each joined to one process group by a ``file://``
rendezvous (NCCL on ``--device cuda``, the default: one process a card;
gloo on ``--device cpu``), over a mesh of ``--shards`` shards.  Each
worker builds only its own shards (the loader's ``process_index`` /
``process_count``, the partitioners' ``shard_range``), runs the programs
and prints one JSON line:
per-step losses, the checksum ``Σ|p|`` of the parameters after the
steps, the count of real examples, and ``Σ|g|`` of the first step's
reduced gradients, which a gradient counted once per process would scale.
Then the parent runs the same programs in one process holding every shard
and compares: every rank must agree with that run within ``RTOL``
(1e-4, the bound of the JAX rig's two-step programs).  Every child has a
time limit and is killed when it expires.

    python -m connectome_gnn_tpu_torch.parallel.launch --procs 2 --shards 4 --device cpu

prints one JSON object and exits 0 when every program agrees.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from connectome_gnn_tpu_torch.data.batch import card_by_default

PROGRAMS = ("dp", "banded", "hybrid", "trainer_fit")
#: the JAX rig's bound for its two-step programs (benchmarks/multiprocess.py:30-37)
RTOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _checksum(tensors) -> float:
    return float(sum(t.detach().double().abs().sum() for t in tensors))


def _grad_checksum(model) -> float:
    return _checksum(p.grad for p in model.parameters() if p.grad is not None)


def _loader_kw(mesh) -> dict:
    if mesh.world == 1:
        return {}
    return dict(process_index=mesh.rank, process_count=mesh.world)


def _shard_range(mesh):
    return None if mesh.world == 1 else (mesh.lo, mesh.hi)


def run_dp(mesh) -> dict:
    """Two data-parallel GCN train steps."""
    from connectome_gnn_tpu_torch import ConnectomeDataLoader, GCNConnectome, generate_dataset
    from connectome_gnn_tpu_torch.parallel import make_dp_train_step

    D = mesh.size
    graphs = generate_dataset(num_subjects=2 * D, num_regions=20, seed=3)
    loader = ConnectomeDataLoader(graphs, batch_size=2 * D, shuffle=False, num_shards=D,
                                  **_loader_kw(mesh))
    model = GCNConnectome(in_channels=5, hidden_dim=16, num_layers=2, dropout=0.0,
                          generator=torch.Generator().manual_seed(0)).to(mesh.device)
    step = make_dp_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3), mesh)
    losses, grads = [], None
    for _ in range(2):
        loss, n = step(mesh.place(next(iter(loader))))
        losses.append(float(loss))
        grads = grads if grads is not None else _grad_checksum(model)
    return {"losses": losses, "params_sum": _checksum(model.parameters()), "n": float(n),
            "grads_sum": grads}


def _giant_graph(shortcut_frac: float):
    from connectome_gnn_tpu_torch import generate_spatial_graph

    g = generate_spatial_graph(128, degree=4, band=12, seed=5, shortcut_frac=shortcut_frac)
    return g, (g.degree() > np.median(g.degree())).astype(np.int32)


def _node_steps(mesh, model, sharded, make_step) -> dict:
    model.to(mesh.device)
    step = make_step(model, torch.optim.Adam(model.parameters(), lr=1e-3), mesh)
    losses, grads = [], None
    for _ in range(2):
        loss, n = step(sharded)
        losses.append(float(loss))
        grads = grads if grads is not None else _grad_checksum(model)
    return {"losses": losses, "params_sum": _checksum(model.parameters()), "n": float(n),
            "grads_sum": grads}


def run_banded(mesh) -> dict:
    """Two halo-exchange banded GCN steps (the halo crosses processes)."""
    from connectome_gnn_tpu_torch.ops import to_banded
    from connectome_gnn_tpu_torch.parallel import (
        ShardedBandedGCN,
        make_sharded_banded_train_step,
        partition_banded,
    )

    g, labels = _giant_graph(0.0)
    # band 12 spans more than one 8-node block: W = 2, halos cross shards
    a = to_banded(g.edge_index[0], g.edge_index[1], g.edge_weight, g.num_nodes, block=8,
                  bandwidth=2)
    pb = partition_banded(a, g.node_features, mesh.size, labels=labels,
                          shard_range=_shard_range(mesh))
    model = ShardedBandedGCN(5, 16, num_layers=2, generator=torch.Generator().manual_seed(0))
    return _node_steps(mesh, model, mesh.place(pb), make_sharded_banded_train_step)


def run_hybrid(mesh) -> dict:
    """Two hybrid GCN steps: the band's halo and the remainder's all-to-all
    both ways."""
    from connectome_gnn_tpu_torch.ops import to_hybrid
    from connectome_gnn_tpu_torch.parallel import (
        ShardedBandedGCN,
        make_sharded_banded_train_step,
        partition_hybrid,
    )

    g, labels = _giant_graph(0.2)
    h = to_hybrid(g.edge_index[0], g.edge_index[1], g.edge_weight, g.num_nodes, block=8,
                  bandwidth=1)
    ph = partition_hybrid(h, g.node_features, mesh.size, labels=labels,
                          shard_range=_shard_range(mesh))
    model = ShardedBandedGCN(5, 16, num_layers=2, generator=torch.Generator().manual_seed(0))
    return _node_steps(mesh, model, mesh.place(ph), make_sharded_banded_train_step)


def run_trainer_fit(mesh) -> dict:
    """The user's path: three epochs of mesh-mode ``Trainer.fit``."""
    from connectome_gnn_tpu_torch import (
        ConnectomeDataLoader,
        GCNConnectome,
        Trainer,
        generate_dataset,
    )

    D = mesh.size
    graphs = generate_dataset(num_subjects=6 * D, num_regions=20, seed=13)
    kw = _loader_kw(mesh)
    train = ConnectomeDataLoader(graphs[: 4 * D], batch_size=2 * D, shuffle=True, seed=0,
                                 num_shards=D, **kw)
    val = ConnectomeDataLoader(graphs[4 * D :], batch_size=2 * D, shuffle=False, num_shards=D,
                               **kw)
    model = GCNConnectome(in_channels=5, hidden_dim=16, num_layers=2, dropout=0.0,
                          generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, seed=0, mesh=mesh, prefetch_depth=0)
    hist = trainer.fit(train, val, num_epochs=3, patience=10, verbose=False)
    ev = trainer.evaluate(val)
    return {"losses": hist["train_loss"] + hist["val_loss"],
            "params_sum": _checksum(trainer.model.parameters()), "n": float(ev["total"]),
            "val_acc": hist["val_acc"][-1]}


RUNNERS = {"dp": run_dp, "banded": run_banded, "hybrid": run_hybrid,
           "trainer_fit": run_trainer_fit}


def worker_main(args) -> None:
    from connectome_gnn_tpu_torch.parallel import (
        create_mesh,
        initialize_distributed,
        shutdown_distributed,
    )

    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", args.worker % torch.cuda.device_count())
    torch.set_num_threads(1)
    initialize_distributed(f"file://{args.rendezvous}", args.procs, args.worker, device=device)
    try:
        results = {}
        for name in args.programs.split(","):
            mesh_axis = "data" if name in ("dp", "trainer_fit") else "edge"
            mesh = create_mesh((args.shards,), (mesh_axis,), device=device)
            t0 = time.perf_counter()
            results[name] = RUNNERS[name](mesh)
            results[name]["seconds"] = time.perf_counter() - t0
        print(json.dumps({"rank": args.worker, "procs": args.procs, "results": results}),
              flush=True)
    finally:
        shutdown_distributed()


def launch(procs: int, shards: int, programs=PROGRAMS, *, device=None,
           timeout_s: float = 300.0) -> list[dict]:
    """Run ``programs`` in ``procs`` worker processes over ``shards``
    shards; returns each rank's results, in rank order.  ``device``
    defaults to the card (``"cuda"``, NCCL; raises without one); pass
    ``device="cpu"`` for gloo.  Raises when a worker fails or outlives
    ``timeout_s`` (every worker is then killed)."""
    device = str(card_by_default(device, "launch"))
    if shards % procs:
        raise ValueError(f"{shards} shards do not divide over {procs} processes")
    with tempfile.TemporaryDirectory(prefix="cgt_launch_") as tmp:
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        env.setdefault("OMP_NUM_THREADS", "1")
        cmd = [sys.executable, "-m", "connectome_gnn_tpu_torch.parallel.launch", "--procs",
               str(procs), "--shards", str(shards), "--programs", ",".join(programs),
               "--device", device, "--rendezvous", os.path.join(tmp, "rendezvous")]
        logs = [open(os.path.join(tmp, f"worker{r}.log"), "w+") for r in range(procs)]
        children = [subprocess.Popen(cmd + ["--worker", str(r)], env=env, stdout=logs[r],
                                     stderr=subprocess.STDOUT, cwd=REPO)
                    for r in range(procs)]
        deadline = time.monotonic() + timeout_s
        try:
            for child in children:
                child.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for child in children:
                child.kill()
            for child in children:
                child.wait()
            raise RuntimeError(f"a worker of {procs} outlived {timeout_s} s and was killed:\n"
                               + _tails(logs)) from None
        finally:
            for child in children:
                if child.poll() is None:
                    child.kill()
                    child.wait()
        if any(child.returncode for child in children):
            raise RuntimeError(f"workers exited {[c.returncode for c in children]}:\n"
                               + _tails(logs))
        out = []
        for log in logs:
            log.seek(0)
            lines = [line for line in log.read().splitlines() if line.startswith("{")]
            log.close()
            out.append(json.loads(lines[-1]))
        return out


def _tails(logs) -> str:
    text = []
    for r, log in enumerate(logs):
        log.flush()
        log.seek(0)
        text.append(f"--- worker {r} ---\n{log.read()[-3000:]}")
    return "\n".join(text)


def max_rel_err(got: dict, ref: dict) -> float:
    """The largest relative difference of a program's numbers."""
    pairs = list(zip(ref["losses"], got["losses"]))
    pairs += [(ref[k], got[k]) for k in ("params_sum", "n", "grads_sum") if k in ref]
    if len(got["losses"]) != len(ref["losses"]):
        return float("inf")
    return max(abs(b - a) / max(abs(a), 1e-12) for a, b in pairs)


def compare(reference: list[dict], runs: list[dict], rtol: float = RTOL) -> dict:
    """Every rank of ``runs`` against the one-process ``reference``:
    ``{program: {"max_rel_err": e, "bound": rtol, "ok": e <= rtol}}``."""
    ref = reference[0]["results"]
    out = {}
    for name, want in ref.items():
        err = max(max_rel_err(r["results"][name], want) for r in runs)
        out[name] = {"max_rel_err": err, "bound": rtol, "ok": err <= rtol}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--procs", type=int, default=2)
    parser.add_argument("--shards", type=int, default=4)
    parser.add_argument("--programs", default=",".join(PROGRAMS))
    parser.add_argument("--device", default=None,
                        help="cuda (NCCL, the default) or cpu (gloo)")
    parser.add_argument("--timeout", type=float, default=300.0)
    parser.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--rendezvous", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker is not None:
        worker_main(args)
        return 0
    programs = args.programs.split(",")
    args.device = str(card_by_default(args.device, "connectome_gnn_tpu_torch.parallel.launch"))
    runs = launch(args.procs, args.shards, programs, device=args.device, timeout_s=args.timeout)
    reference = launch(1, args.shards, programs, device=args.device, timeout_s=args.timeout)
    drift = compare(reference, runs)
    ok = all(d["ok"] for d in drift.values())
    print(json.dumps({"procs": args.procs, "shards": args.shards, "device": args.device,
                      "drift": drift, "reference": reference[0]["results"],
                      "ranks": [r["results"] for r in runs], "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""Giant-graph node classification demo, through the PyTorch port.

``examples/giant_graph_demo.py``'s eleven sections, printed lines and
defaults on the port: one large spatially-embedded connectome (BASELINE
config 5's regime), trained for node-level prediction:

  1. synthesize a spatially-local giant graph (voxel-like locality),
  2. scramble it and recover the band with Reverse-Cuthill-McKee,
  3. convert to banded block-dense form,
  4. train a float32 BandedNodeGCN,
  5. run the same parameters through the halo-exchange sharded model,
     confirming identical predictions,
  6. the small-world variant: a hybrid band + shortcut remainder, single
     and sharded,
  7. one 2-hop minibatch from the native NeighborSampler,
  8. sampled-minibatch training (SampledNodeLoader, NodeGCN),
  9. device-side multiset sampling trained with ``scan_epochs``,
  10. graph-sharded sampled training with the compacted exchange,
  11. the exchange's planner (``plan_compaction``) and ``in_degree_cap``.

The JAX demo shards over ``len(jax.devices())`` devices; here a mesh of
``--shards`` shards lives in this one process, on its one device (the
port's counterpart of a device count), so sections 5, 6 and 10-11 run on
one card.  With ``--shards 1`` they print the JAX demo's skip lines.

The band and the hybrid's band are built on the host (``to_banded`` /
``to_hybrid`` without ``device``, bitwise the JAX package's) and then moved
to the demo's device; every model and its training run there.

Usage:
    python examples/giant_graph_demo_torch.py             # on the CUDA card (raises without one)
    python examples/giant_graph_demo_torch.py --cpu       # on the CPU
    python examples/giant_graph_demo_torch.py --cpu --nodes 2048 --steps 4 --shards 2

``main(argv)`` returns a dict of every number the demo prints, with each
section's seconds and, on the card, its peak ``max_memory_allocated``.
"""

import argparse
import contextlib
import os
import sys
import time

# allow running from the repo root without installing
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from connectome_gnn_tpu_torch.data.batch import card_by_default  # noqa: E402

BLOCK = 128
HIDDEN = 64
FANOUT = (10, 10)
BATCH = 1024


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--nodes", type=int, default=20_000)
    parser.add_argument("--degree", type=int, default=12)
    parser.add_argument("--band", type=int, default=256)
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--shards", type=int, default=4,
                        help="shards of the mesh in this process (the JAX demo's device count)")
    return parser.parse_args(argv)


@contextlib.contextmanager
def section(out: dict, number: int, device: torch.device):
    """Time a section (device work included) and, on the card, record its
    peak ``max_memory_allocated``."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    yield
    if cuda:
        torch.cuda.synchronize(device)
        out["peak_bytes"][number] = torch.cuda.max_memory_allocated(device)
    out["seconds"][number] = time.perf_counter() - t0


def band_to(a, device):
    return a._replace(band=a.band.to(device))


def hybrid_to(h, device):
    return h._replace(band=band_to(h.band, device),
                      remainder_senders=h.remainder_senders.to(device),
                      remainder_receivers=h.remainder_receivers.to(device),
                      remainder_weights=h.remainder_weights.to(device))


def require_same_device(band: torch.Tensor, model: torch.nn.Module) -> None:
    """Refuse a band and a model on different devices rather than compute
    anywhere else."""
    devices = {p.device for p in model.parameters()}
    if devices != {band.device}:
        raise RuntimeError(f"the band is on {band.device} and the model on {sorted(map(str, devices))}")


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = torch.device(card_by_default("cpu" if args.cpu else None, "giant_graph_demo_torch"))
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())

    from connectome_gnn_tpu_torch.data import (
        NeighborSampler,
        SampledNodeLoader,
        apply_ordering,
        bandwidth,
        device_sampled_sage,
        generate_spatial_graph,
        reverse_cuthill_mckee,
    )
    from connectome_gnn_tpu_torch.models import BandedNodeGCN, NodeGCN
    from connectome_gnn_tpu_torch.ops import to_banded, to_hybrid
    from connectome_gnn_tpu_torch.train import Trainer

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "host"
    print(f"torch device: {device} ({name})")
    out: dict = {"device": str(device), "seconds": {}, "peak_bytes": {}}
    placed: set = set()

    # ------------------------------------------------------------------
    # 1. Spatially-local giant graph (voxel-like: neighbors in index space)
    # ------------------------------------------------------------------
    n, deg, band = args.nodes, args.degree, args.band
    rng = np.random.default_rng(0)
    with section(out, 1, device):
        graph = generate_spatial_graph(n, degree=deg, band=band, seed=0)
        print(f"graph: {n:,} nodes, {graph.num_edges:,} edges, band ±{band}")

        # labels: a 2-hop-smoothing task (needs message passing to solve)
        senders, receivers = graph.edge_index
        deg_w = graph.degree()
        smooth = np.zeros(n, np.float32)
        np.add.at(smooth, receivers, deg_w[senders] * graph.edge_weight)
        labels = (smooth > np.median(smooth)).astype(np.int32)
    out.update(nodes=n, edges=graph.num_edges, band=band)

    # ------------------------------------------------------------------
    # 2. Scramble + recover locality with RCM
    # ------------------------------------------------------------------
    with section(out, 2, device):
        scramble = rng.permutation(n)
        scrambled = apply_ordering(graph, scramble)
        out["scrambled_bandwidth"] = bandwidth(scrambled.edge_index)
        print(f"scrambled bandwidth: {out['scrambled_bandwidth']:,}")
        t0 = time.perf_counter()
        perm = reverse_cuthill_mckee(scrambled.edge_index, n)
        recovered = apply_ordering(scrambled, perm)
        out["rcm_bandwidth"] = bandwidth(recovered.edge_index)
        out["rcm_seconds"] = time.perf_counter() - t0
        print(f"RCM bandwidth: {out['rcm_bandwidth']:,} ({out['rcm_seconds']:.1f}s host-side)")
        labels_rcm = labels[scramble][perm]

    # ------------------------------------------------------------------
    # 3. Banded form (built on the host, then moved to the device)
    # ------------------------------------------------------------------
    with section(out, 3, device):
        a = to_banded(recovered.edge_index[0], recovered.edge_index[1], recovered.edge_weight, n,
                      block=BLOCK)
        mb = a.band.numel() * 4 / 1e6
        a = band_to(a, device)
        out.update(row_blocks=a.num_blocks, diagonals=2 * a.bandwidth + 1, band_mb=mb)
        print(f"banded: {a.num_blocks} row blocks × {2 * a.bandwidth + 1} diagonals "
              f"of {BLOCK}² ({mb:.0f} MB)")
    placed.add(a.band.device)

    # ------------------------------------------------------------------
    # 4. Train on one device
    # ------------------------------------------------------------------
    with section(out, 4, device):
        model = BandedNodeGCN(in_channels=5, hidden_dim=HIDDEN, num_layers=3).to(device)
        require_same_device(a.band, model)
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        x = torch.from_numpy(recovered.node_features).to(device)
        y = torch.from_numpy(labels_rcm).long().to(device)
        adj_norm, dinv = model.prepare(a)
        losses, evals = [], []
        model.train()
        t0 = time.perf_counter()
        # dropout draws (none at the default rate 0) from a generator seeded 1,
        # the JAX demo's key
        with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
            torch.manual_seed(1)
            for step_idx in range(args.steps):
                loss = F.cross_entropy(model.apply_normalized(adj_norm, dinv, x), y)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                losses.append(loss.detach())
                if (step_idx + 1) % max(args.steps // 4, 1) == 0:
                    model.eval()
                    with torch.no_grad():
                        acc = float((model.apply_normalized(adj_norm, dinv, x).argmax(1) == y)
                                    .float().mean())
                    model.train()
                    evals.append((step_idx + 1, float(loss.detach()), acc))
                    print(f"  step {step_idx + 1:4d}: loss {evals[-1][1]:.4f}, node acc {acc:.3f}")
        out["train_seconds"] = time.perf_counter() - t0
        print(f"trained {args.steps} steps in {out['train_seconds']:.1f}s")
        model.eval()
    out["losses"] = torch.stack(losses).tolist() if losses else []
    out["evals"] = evals
    placed.update(p.device for p in model.parameters())

    # ------------------------------------------------------------------
    # 5. Same parameters through the halo-exchange sharded model
    # ------------------------------------------------------------------
    # halo exchange needs bandwidth <= blocks-per-shard; clamp the shard
    # count for small graphs instead of crashing after training
    max_shards = max(a.num_blocks // max(a.bandwidth, 1), 1)
    num_dev = min(args.shards, max_shards)
    out["shards"] = num_dev
    out["sharded_max_diff"] = out["hybrid_sharded_max_diff"] = None
    with section(out, 5, device):
        if num_dev > 1:
            from connectome_gnn_tpu_torch.parallel import (
                ShardedBandedGCN,
                create_mesh,
                partition_banded,
            )

            mesh = create_mesh((num_dev,), ("edge",), device=device)
            sharded = ShardedBandedGCN(in_channels=5, hidden_dim=HIDDEN, num_layers=3).to(device)
            sharded.load_state_dict(model.state_dict())
            sharded.eval()
            require_same_device(a.band, sharded)
            placed.update(p.device for p in sharded.parameters())
            with torch.no_grad():
                pb = mesh.place(partition_banded(a, recovered.node_features, num_dev))
                flat = sharded(pb, mesh).reshape(-1, 2)[:n]
                single_logits = model.apply_normalized(adj_norm, dinv, x)
                out["sharded_max_diff"] = float((flat - single_logits).abs().max())
            del pb, flat
            print(f"sharded ({num_dev} shards, halo exchange) vs single-device "
                  f"max |Δlogit| = {out['sharded_max_diff']:.2e}")
        else:
            print("(single shard — skipping the sharded cross-check; run with --shards 4)")
    del adj_norm, dinv, a

    # ------------------------------------------------------------------
    # 6. Small-world variant: hybrid (band + shortcut remainder) sharding
    # ------------------------------------------------------------------
    with section(out, 6, device):
        sw = generate_spatial_graph(n, degree=deg, band=band, seed=3, shortcut_frac=0.1)
        h = to_hybrid(sw.edge_index[0], sw.edge_index[1], sw.edge_weight, n,
                      block=BLOCK, bandwidth=-(-band // BLOCK))
        rem = int((h.remainder_weights > 0).sum())
        h = hybrid_to(h, device)
        placed.add(h.band.band.device)
        out.update(sw_edges=sw.num_edges, shortcuts=rem)
        print(f"small-world graph: {sw.num_edges:,} edges, {rem:,} long-range "
              f"shortcuts routed through the sparse remainder")
        hx = torch.from_numpy(sw.node_features).to(device)
        require_same_device(h.band.band, model)
        with torch.no_grad():
            h_logits = model(h, hx)
            if num_dev > 1:
                from connectome_gnn_tpu_torch.parallel import partition_hybrid

                ph = mesh.place(partition_hybrid(h, sw.node_features, num_dev))
                flat = sharded(ph, mesh).reshape(-1, 2)[:n]
                out["hybrid_sharded_max_diff"] = float((flat - h_logits).abs().max())
                del ph, flat
                print(f"sharded hybrid ({num_dev} shards, halo shift + remainder "
                      f"all_to_all) vs single-device max |Δlogit| = "
                      f"{out['hybrid_sharded_max_diff']:.2e}")
    del h, h_logits, hx

    # ------------------------------------------------------------------
    # 7. Minibatch sampling with the native NeighborSampler
    # ------------------------------------------------------------------
    with section(out, 7, device):
        sampler = NeighborSampler(sw)
        t0 = time.perf_counter()
        sub, _ = sampler.sample(rng.integers(0, n, 512), fanout=[10, 10], seed=0)
        out["sample_ms"] = (time.perf_counter() - t0) * 1e3
        out.update(sampled_nodes=sub.num_nodes, sampled_edges=sub.num_edges)
        print(f"sampled 2-hop minibatch: {sub.num_nodes:,} nodes / {sub.num_edges:,} edges "
              f"in {out['sample_ms']:.0f} ms (native sampler)")

    # ------------------------------------------------------------------
    # 8. End-to-end sampled-minibatch training (seed-node supervision)
    # ------------------------------------------------------------------
    with section(out, 8, device):
        src, dst = sw.edge_index
        msum = np.zeros(n)
        wsum = np.zeros(n)
        np.add.at(msum, dst, sw.edge_weight * sw.node_features[src, 0])
        np.add.at(wsum, dst, sw.edge_weight)
        labels = ((msum / (wsum + 1e-8)) > 0).astype(np.int32)

        order = np.random.default_rng(7).permutation(n)
        n_train = int(0.8 * n)
        train_loader = SampledNodeLoader(sw, labels, seed_nodes=order[:n_train], batch_size=BATCH,
                                         fanout=FANOUT, seed=0, drop_last=True, device=device)
        val_loader = SampledNodeLoader(sw, labels, seed_nodes=order[n_train:], batch_size=BATCH,
                                       fanout=FANOUT, shuffle=False, device=device)
        trainer = Trainer(NodeGCN(in_channels=5, hidden_dim=HIDDEN, num_layers=2), device=device)
        placed.update(p.device for p in trainer.model.parameters())
        t0 = time.perf_counter()
        hist = trainer.fit(train_loader, val_loader, num_epochs=3, patience=10, verbose=False)
        dt = time.perf_counter() - t0
        steps = 3 * len(train_loader)
        out.update(sampled_val_acc=hist["val_acc"][-1], sampled_steps=steps,
                   sampled_steps_per_s=steps / dt, sampled_losses=hist["train_loss"])
        print(f"sampled training on the {n:,}-node graph: val acc {hist['val_acc'][-1]:.3f} "
              f"after 3 epochs ({steps} sampled steps, {steps / dt:.1f} steps/s end-to-end)")
    del trainer, train_loader, val_loader

    # ------------------------------------------------------------------
    # 9. Device-side sampling, multiset mode, scanned epochs: the graph
    #    lives on the device, each step's fanout sample is drawn there,
    #    and scan_epochs replays one captured step per batch on the card
    #    (~8 KB of seeds a step is all that crosses the link).
    # ------------------------------------------------------------------
    with section(out, 9, device):
        sampled = device_sampled_sage(sw, hidden_dim=HIDDEN, fanout=FANOUT, dedup=False,
                                      device=device)
        tr = sampled.make_loader(order[:n_train], labels, batch_size=BATCH, seed=0, drop_last=True)
        va = sampled.make_loader(order[n_train:], labels, batch_size=BATCH, shuffle=False)
        trainer = Trainer(sampled, scan_epochs=True, device=device)
        placed.update(p.device for p in trainer.model.parameters())
        t0 = time.perf_counter()
        hist = trainer.fit(tr, va, num_epochs=3, patience=10, verbose=False)
        dt = time.perf_counter() - t0
        steps = 3 * (n_train // BATCH)
        out.update(device_sampled_val_acc=hist["val_acc"][-1], device_sampled_steps=steps,
                   device_sampled_steps_per_s=steps / dt, device_sampled_losses=hist["train_loss"])
        print(f"device-sampled multiset training (scanned epochs): val acc "
              f"{hist['val_acc'][-1]:.3f} after 3 epochs ({steps} steps, {steps / dt:.1f} "
              f"steps/s end-to-end)")
    del trainer, sampled, tr, va

    # ------------------------------------------------------------------
    # 10. Graph-sharded sampling with the compacted exchange: nodes
    #     partitioned across the mesh, no shard holds the whole graph;
    #     each hop's remote rows resolve through capacity-bounded
    #     all_to_all rounds (locally-owned requests never touch the
    #     wire).  overflow == 0 certifies the exchange was exact (bitwise
    #     the broadcast oracle) this run.
    # ------------------------------------------------------------------
    if num_dev >= 2:
        from connectome_gnn_tpu_torch.parallel import (
            CompactionConfig,
            create_mesh,
            graph_sharded_sage,
            plan_compaction,
            sharded_sampling_comm_model,
        )

        gs_dev = args.shards  # num_dev may be capped by max_shards
        gs_mesh = create_mesh((gs_dev,), ("data",), device=device)
        with section(out, 10, device):
            gs = graph_sharded_sage(sw, num_shards=gs_dev, hidden_dim=HIDDEN, fanout=FANOUT,
                                    compaction=CompactionConfig(alpha=2.0, rounds=2), device=device)
            tr = gs.make_loader(order[:n_train], labels, batch_size=BATCH, seed=0, drop_last=True)
            # val batch smaller than the pool (drop_last would otherwise
            # leave zero eval batches at small --nodes; divisible by shards)
            va = gs.make_loader(order[n_train:], labels,
                                batch_size=max(gs_dev, min(512, (len(order) - n_train) // gs_dev * gs_dev)),
                                shuffle=False, drop_last=True)
            trainer = Trainer(gs, mesh=gs_mesh)
            placed.update(p.device for p in trainer.model.parameters())
            hist = trainer.fit(tr, va, num_epochs=2, patience=10, verbose=False)
            out.update(graph_sharded_val_acc=hist["val_acc"][-1],
                       overflow=trainer.last_sampling_overflow,
                       graph_sharded_losses=hist["train_loss"])
            print(f"graph-sharded sampled training ({gs_dev} node shards, compacted exchange): "
                  f"val acc {hist['val_acc'][-1]:.3f}, exchange overflow "
                  f"{trainer.last_sampling_overflow} (0 = exact)")
        del trainer, tr, va

        # --------------------------------------------------------------
        # 11. Exchange auto-tuning + skew control.  plan_compaction probes
        #     real frontiers (the broadcast oracle instrumented to count
        #     each stage's peak bucket load) and returns per-stage
        #     capacities exact on the probed steps at near-minimal payload;
        #     in_degree_cap clamps the draw buffers a power-law hub would
        #     otherwise price for every step.
        # --------------------------------------------------------------
        with section(out, 11, device):
            probe = rng.choice(order[:n_train], size=(3, gs_dev, 256)).astype(np.int32)
            cfg, loads = plan_compaction(gs.csr, gs_mesh, probe, 1, FANOUT, return_loads=True)
            kw = dict(D=gs_dev, S=256, fanout=FANOUT, F=int(sw.node_features.shape[1]),
                      max_deg=max(gs.csr.max_in_degree, 10))

            def _mb(c):
                return sharded_sampling_comm_model(compaction=c, **kw)["per_device_bytes_per_step"] / 1e6

            out.update(plan_alpha=cfg.alpha, plan_alpha_features=cfg.alpha_features,
                       draw_loads=loads["draw_loads"], feature_load=loads["feature_load"],
                       payload_mb={"planned": _mb(cfg), "default": _mb(CompactionConfig()),
                                   "broadcast": _mb(None)})
            print(f"plan_compaction: draw alpha {cfg.alpha:.2f}, feature alpha "
                  f"{cfg.alpha_features:.2f} (probed peak loads {loads['draw_loads']} / "
                  f"{loads['feature_load']}); payload {_mb(cfg):.2f} MB/step/device planned vs "
                  f"{_mb(CompactionConfig()):.2f} default vs {_mb(None):.2f} broadcast")

            capped = graph_sharded_sage(sw, num_shards=gs_dev, fanout=FANOUT, in_degree_cap=8,
                                        device=device)
            out.update(max_in_degree=gs.csr.max_in_degree,
                       capped_max_in_degree=capped.csr.max_in_degree)
            print(f"in_degree_cap=8: max_in_degree {gs.csr.max_in_degree} -> "
                  f"{capped.csr.max_in_degree} (every [*, max_deg] draw buffer shrinks with it)")
        del gs, capped
    else:
        print("(single shard — skipping the graph-sharded sampling section; run with --shards 4)")

    out["devices"] = sorted(str(d) for d in placed)
    seconds = ", ".join(f"{k}: {v:.2f}" for k, v in out["seconds"].items())
    peaks = ", ".join(f"{k}: {v / 1e9:.2f}" for k, v in out["peak_bytes"].items())
    print(f"section seconds {{{seconds}}}" + (f"; peak GB a section {{{peaks}}}" if peaks else ""))
    return out


if __name__ == "__main__":
    main()

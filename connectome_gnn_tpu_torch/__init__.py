"""connectome-gnn-tpu in PyTorch, for NVIDIA Hopper.

The port of ``connectome_gnn_tpu`` (JAX/XLA/Pallas), which stays beside it
as the reference.  This package imports torch and numpy, never JAX and
never the JAX package.  Module names follow the JAX package, so each
counterpart sits at the same relative path.

Ported so far, graph-classification training and serving, giant-graph
int8 serving and training, and every TPU kernel of the JAX package:

* graph classification: synthetic connectomes, COO and dense batches, the
  loader and its prefetch thread, ``GCNConnectome`` and
  ``GraphSAGEConnectome`` (``compute_dtype=torch.bfloat16``: bfloat16
  operands, float32 sums, as the JAX package's), and ``Trainer``: ``fit``
  (early stopping, the non-finite step guard, preemption-safe checkpoints
  that resume bitwise), ``evaluate`` and ``predict``, which serves dense
  batches on CUDA through hand-written fused forward kernels; the flagship
  model ready to run in ``connectome_gnn_tpu_torch.entry``;
* giant-graph node classification: ``generate_spatial_graph``, RCM and
  spectral reordering, the layout planner (``data.layout``: ``plan_layout``,
  ``build_layout``, ``auto_layout``), the native host helpers
  (``native``), the block band (``ops.banded``) and its int8 form, and
  ``BandedNodeGCN`` / ``BandedNodeSAGE``, which serve through hand-written
  int8 band SpMM kernels (``prepare_quantized`` / ``apply_quantized``);
  ``BandedNodeGCN`` also trains on the int8 band
  (``prepare_quant_trainable`` / ``apply_quant_trainable`` and its blocked
  variant), with the kernels in both directions;
* sampled node training (slice D): the host sampler and its loader
  (``SampledNodeLoader``, the native traversal), the COO node models
  (``NodeGCN``, ``NodeSAGE`` and their blocked forms), device-side sampling
  (``device_sampled_gcn`` / ``device_sampled_sage`` with a
  ``DeviceSeedLoader``), and ``Trainer(scan_epochs=True)``, one captured
  CUDA graph a step replayed from one buffer an epoch;
* the parallel modes (``connectome_gnn_tpu_torch.parallel``, a mesh of
  shards on ``torch.distributed``): data-parallel graph and sampled node
  training (``Trainer(mesh=...)`` over sharded loaders, host- or
  device-sampled, stepwise or ``scan_epochs`` as one captured step), the
  edge-, band- and hybrid-partitioned giant-graph models and the 2-D
  step, graph-sharded sampling (``graph_sharded_sage``: no device holds
  the whole graph; the broadcast or compacted exchange and its planner)
  and the collective-bytes census (``count_collective_bytes``);
* the kernels no model path calls: K7 over a float32 or bfloat16 band
  (``ops.banded_direct``), the bfloat16, w8a8 and fused-dot band kernels
  B2a-B2c (``ops.band_variants``), the band-pipeline probes B3a-B3d
  (``ops.fm_variants``) and the random-row gather B1 (``ops.gather_dma``).

``Trainer`` runs on ``cuda`` unless given ``device=``; without a card it
raises rather than fall back to the CPU.

The kernels are CUDA C++ in ``csrc/``, built by ``nvcc`` at first use.

Quickstart
----------
    from connectome_gnn_tpu_torch import (
        GCNConnectome, ConnectomeDataLoader, Trainer, generate_dataset)

    graphs = generate_dataset(num_subjects=64, seed=42)
    loader = ConnectomeDataLoader(graphs, batch_size=16, shuffle=False,
                                  layout="dense", device="cuda")
    model = GCNConnectome(in_channels=5, hidden_dim=64, num_classes=2)
    logits = Trainer(model, device="cuda").predict(loader)

Training (on ``cuda`` unless ``device=`` says otherwise):

    train = ConnectomeDataLoader(graphs[:48], batch_size=16, shuffle=True)
    val = ConnectomeDataLoader(graphs[48:], batch_size=16, shuffle=False)
    trainer = Trainer(GCNConnectome(in_channels=5, hidden_dim=64))
    history = trainer.fit(train, val, num_epochs=30, patience=8,
                          checkpoint_dir="runs/gcn", resume=True)

Giant graph, int8 serving:

    import torch
    from connectome_gnn_tpu_torch import BandedNodeGCN, generate_spatial_graph
    from connectome_gnn_tpu_torch.ops import to_banded

    g = generate_spatial_graph(1 << 20, degree=38, band=512, num_features=64)
    a = to_banded(*g.edge_index, g.edge_weight, g.num_nodes, device="cuda")
    model = BandedNodeGCN(in_channels=64, num_layers=2).cuda().eval()
    adj_q, dinv = model.prepare_quantized(a)
    logits = model.apply_quantized(adj_q, dinv,
                                   torch.from_numpy(g.node_features).cuda())

Giant graph, one int8 training step:

    model.train()
    adj_q, adj_qT, dinv = model.prepare_quant_trainable(a)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    logits = model.apply_quant_trainable(adj_q, adj_qT, dinv, x)
    torch.nn.functional.cross_entropy(logits, labels).backward()
    opt.step()

Giant graph, device-sampled training (on ``cuda`` unless ``device=``):

    import numpy as np
    from connectome_gnn_tpu_torch.data import device_sampled_gcn

    sampled = device_sampled_gcn(g, hidden_dim=64, fanout=(10, 10))
    labels = (g.node_features[:, 0] > 0).astype(np.int32)
    loader = sampled.make_loader(np.arange(g.num_nodes), labels, batch_size=1024)
    Trainer(sampled, scan_epochs=True).train_epoch(loader)

Graph-sharded sampled training over a mesh of 4 shards on one card:

    from connectome_gnn_tpu_torch import parallel

    parallel.initialize_distributed("file:///tmp/rendezvous", 1, 0, device="cuda")
    mesh = parallel.create_mesh((4,), ("data",))
    model = parallel.graph_sharded_sage(g, 4, hidden_dim=64, fanout=(10, 10))
    loader = model.make_loader(np.arange(g.num_nodes), labels, batch_size=1024)
    trainer = Trainer(model, mesh=mesh)
    trainer.train_epoch(loader), trainer.last_sampling_overflow
"""

from connectome_gnn_tpu_torch.data import (
    NUM_REGIONS,
    REGION_NAMES,
    ConnectomeBatch,
    ConnectomeDataLoader,
    ConnectomeGraph,
    collate_graphs,
    generate_connectome,
    generate_dataset,
    DeviceSeedLoader,
    SampledNodeLoader,
    device_sampled_gcn,
    device_sampled_sage,
    generate_spatial_graph,
    small_world_stats,
)
from connectome_gnn_tpu_torch.models import (
    BandedNodeGCN,
    BandedNodeSAGE,
    GCNConnectome,
    GraphSAGEConnectome,
    NodeGCN,
    NodeSAGE,
)
from connectome_gnn_tpu_torch.train import Trainer

__version__ = "0.1.0"

__all__ = [
    "NUM_REGIONS",
    "REGION_NAMES",
    "BandedNodeGCN",
    "BandedNodeSAGE",
    "ConnectomeBatch",
    "ConnectomeDataLoader",
    "ConnectomeGraph",
    "DeviceSeedLoader",
    "GCNConnectome",
    "GraphSAGEConnectome",
    "NodeGCN",
    "NodeSAGE",
    "SampledNodeLoader",
    "Trainer",
    "collate_graphs",
    "device_sampled_gcn",
    "device_sampled_sage",
    "generate_connectome",
    "generate_dataset",
    "generate_spatial_graph",
    "small_world_stats",
    "__version__",
]

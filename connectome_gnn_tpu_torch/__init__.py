"""connectome-gnn-tpu in PyTorch, for NVIDIA Hopper.

The port of ``connectome_gnn_tpu`` (JAX/XLA/Pallas), which stays beside it
as the reference.  This package imports torch and numpy, never JAX and
never the JAX package.  Module names follow the JAX package, so each
counterpart sits at the same relative path.

Ported so far: the serving path — synthetic connectomes, COO and dense
batches, the loader, ``GCNConnectome`` and ``GraphSAGEConnectome``, and
``Trainer.evaluate`` / ``Trainer.predict``, which serves dense batches on
CUDA through hand-written fused forward kernels (``csrc/``, built by
``nvcc`` at first use).

Quickstart
----------
    from connectome_gnn_tpu_torch import (
        GCNConnectome, ConnectomeDataLoader, Trainer, generate_dataset)

    graphs = generate_dataset(num_subjects=64, seed=42)
    loader = ConnectomeDataLoader(graphs, batch_size=16, shuffle=False,
                                  layout="dense", device="cuda")
    model = GCNConnectome(in_channels=5, hidden_dim=64, num_classes=2)
    logits = Trainer(model, device="cuda").predict(loader)
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
    small_world_stats,
)
from connectome_gnn_tpu_torch.models import GCNConnectome, GraphSAGEConnectome
from connectome_gnn_tpu_torch.train import Trainer

__version__ = "0.1.0"

__all__ = [
    "NUM_REGIONS",
    "REGION_NAMES",
    "ConnectomeBatch",
    "ConnectomeDataLoader",
    "ConnectomeGraph",
    "GCNConnectome",
    "GraphSAGEConnectome",
    "Trainer",
    "collate_graphs",
    "generate_connectome",
    "generate_dataset",
    "small_world_stats",
    "__version__",
]

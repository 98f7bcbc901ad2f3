"""Training, evaluation and serving loop, fault handling and checkpoints."""

from connectome_gnn_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from connectome_gnn_tpu_torch.train.fault import PreemptionGuard
from connectome_gnn_tpu_torch.train.trainer import Trainer, reference_adam

__all__ = [
    "PreemptionGuard",
    "Trainer",
    "reference_adam",
    "restore_checkpoint",
    "save_checkpoint",
]

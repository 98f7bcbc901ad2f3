"""Serving and evaluation loop."""

from connectome_gnn_tpu_torch.train.trainer import Trainer

__all__ = ["Trainer"]

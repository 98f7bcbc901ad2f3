"""Serving and evaluation loop for connectome GNN classifiers.

The port of ``connectome_gnn_tpu.train.trainer.Trainer``'s single-device
serving half: :meth:`Trainer.evaluate` (masked cross-entropy and accuracy,
reference ``connectome_gnn/train.py:56-74``) and :meth:`Trainer.predict`
(per-graph logits through :func:`~connectome_gnn_tpu_torch.ops.fused.
forward_auto`).  Padded graph slots are excluded from loss and metrics via
``label_mask`` and from predictions via ``graph_mask``.

Training (``fit``, ``train_epoch``, the optimizer, fault handling and
checkpoints) and mesh mode are not ported yet.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F

from connectome_gnn_tpu_torch.ops.fused import forward_auto


class Trainer:
    """Drives a :class:`GCNConnectome` / :class:`GraphSAGEConnectome` on one
    device.

    Parameters
    ----------
    model
        The model; it is moved to ``device``.
    device
        Where the model runs (default: ``cuda``; without a CUDA card that
        raises ``RuntimeError``, and ``device="cpu"`` asks for the CPU).
        Batches from a loader on another device are moved here.
    """

    def __init__(self, model: torch.nn.Module, device=None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Trainer runs on the CUDA card by default and none is available; "
                    'pass device="cpu" to run on the CPU'
                )
            device = "cuda"
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self._warned_unfusable = False

    @torch.inference_mode()
    def evaluate(self, loader) -> dict:
        """Masked accuracy and mean loss over ``loader`` (eval mode)."""
        self.model.eval()
        total_loss = torch.zeros((), device=self.device)
        correct = torch.zeros((), dtype=torch.long, device=self.device)
        total = torch.zeros((), device=self.device)
        for batch in loader:
            batch = batch.to(self.device)
            logits = self.model(batch)
            ce = F.cross_entropy(logits, batch.labels, reduction="none")
            mask = batch.label_mask.to(logits.dtype)
            total_loss += (ce * mask).sum()
            correct += ((logits.argmax(dim=1) == batch.labels) & batch.label_mask).sum()
            total += mask.sum()
        # one host sync for the whole pass
        total_loss, correct, total = float(total_loss), int(correct), int(total)
        return {
            "accuracy": correct / max(total, 1),
            "loss": total_loss / max(total, 1),
            "correct": correct,
            "total": total,
        }

    @torch.inference_mode()
    def predict(self, loader, prefer_fused: bool = True) -> np.ndarray:
        """Per-graph logits over ``loader`` (eval mode), real graphs only.

        Returns a ``[num_real_graphs, num_classes]`` numpy array in loader
        order.  With ``prefer_fused`` (default) each batch goes through
        :func:`~connectome_gnn_tpu_torch.ops.fused.forward_auto`, which
        runs dense-layout batches on CUDA through the fused kernel; a COO
        batch cannot fuse, so it warns once and takes ``model(batch)``.
        """
        self.model.eval()
        chunks = []
        for batch in loader:
            batch = batch.to(self.device)
            if prefer_fused:
                if not hasattr(batch, "adj") and not self._warned_unfusable:
                    warnings.warn(
                        "predict(prefer_fused=True) got a COO-layout batch; "
                        "using the unfused path (build the loader with "
                        "layout='dense' for fused serving)",
                        UserWarning,
                        stacklevel=3,  # past the inference_mode wrapper
                    )
                    self._warned_unfusable = True
                logits = forward_auto(self.model, batch)
            else:
                logits = self.model(batch)
            # real-graph mask, not label_mask: unlabeled graphs still get
            # predictions
            chunks.append(logits[batch.graph_mask])
        return torch.cat(chunks).cpu().numpy()

"""The flagship model and an example batch, ready to run: the analog of the
JAX package's ``__graft_entry__.entry()`` (``__graft_entry__.py:27-35``).

``entry()`` returns ``(forward, (model, batch))``: the flagship
:class:`~connectome_gnn_tpu_torch.models.GCNConnectome` (hidden 64, 3
layers, weights from a generator seeded 0) and a COO batch of 16 subjects
× 84 regions (``generate_dataset(seed=42)``, ``collate_graphs``), both on
``device`` (default ``cuda``; without a card it raises, and
``device="cpu"`` asks for the CPU).  ``forward(model, batch)`` gives the
eval-mode logits ``[16, 2]``.

    python -m connectome_gnn_tpu_torch.entry    # prints: entry forward ok: (16, 2)

The JAX entry point's other half, ``dryrun_multichip``, waits for the
port's parallel modes.
"""

from __future__ import annotations

import argparse

import torch

from connectome_gnn_tpu_torch.data import collate_graphs, generate_dataset
from connectome_gnn_tpu_torch.data.batch import card_by_default
from connectome_gnn_tpu_torch.models import GCNConnectome


def forward(model: torch.nn.Module, batch) -> torch.Tensor:
    """Eval-mode logits ``[B, num_classes]`` of ``model`` on ``batch``."""
    model.eval()
    with torch.inference_mode():
        return model(batch)


def entry(device=None):
    """``(forward, (model, batch))`` on the flagship GCN, on ``device``."""
    device = card_by_default(device, "entry()")
    model = GCNConnectome(in_channels=5, hidden_dim=64, num_classes=2, num_layers=3,
                          generator=torch.Generator().manual_seed(0)).to(device)
    graphs = generate_dataset(num_subjects=16, num_regions=84, seed=42)
    return forward, (model, collate_graphs(graphs, device=device))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="default: cuda")
    args = parser.parse_args(argv)
    fn, example = entry(args.device)
    logits = fn(*example)
    if not bool(torch.isfinite(logits).all()):
        raise SystemExit(f"entry forward gave non-finite logits: {logits}")
    print(f"entry forward ok: {tuple(logits.shape)}")


if __name__ == "__main__":
    main()

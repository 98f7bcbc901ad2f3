#!/usr/bin/env python3
"""connectome-gnn-tpu demo, through the PyTorch port.

``examples/demo.py``'s flow and printed sections on the port: generate
synthetic connectome data, train GCN and GraphSAGE classifiers with
``Trainer.fit`` (early stopping), compare accuracy on a held-out test set.

Usage:
    python examples/demo_torch.py          # on the CUDA card (raises without one)
    python examples/demo_torch.py --cpu    # on the CPU

Each test accuracy is printed beside ``BASELINE.md``'s reference run (GCN
0.556, GraphSAGE 0.533) and the published 55-70 % band.  Nothing is gated
on it: the signal is weak (the validation loss stays near 0.69) and 45
test graphs spread about ±7 points.
"""

import argparse
import os
import sys
import time

# allow running from the repo root without installing
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from connectome_gnn_tpu_torch import (  # noqa: E402
    ConnectomeDataLoader,
    GCNConnectome,
    GraphSAGEConnectome,
    Trainer,
    generate_dataset,
    small_world_stats,
)
from connectome_gnn_tpu_torch.train import reference_adam  # noqa: E402

NUM_SUBJECTS = 300
NUM_REGIONS = 84
BATCH_SIZE = 16
HIDDEN_DIM = 64
NUM_LAYERS = 3
DROPOUT = 0.3
EPOCHS = 30
PATIENCE = 8
SEED = 42
#: test accuracy of the reference demo run (BASELINE.md, seed 42)
BASELINE_ACCURACY = {"GCN": 0.556, "GraphSAGE": 0.533}
MODELS = {"GCN": GCNConnectome, "GraphSAGE": GraphSAGEConnectome}


def print_section(title: str) -> None:
    print(f"\n{'=' * 60}\n  {title}\n{'=' * 60}")


def split(graphs):
    """The demo's 70 / 15 / 15 split, in order."""
    n_train, n_val = int(0.7 * len(graphs)), int(0.15 * len(graphs))
    return graphs[:n_train], graphs[n_train : n_train + n_val], graphs[n_train + n_val :]


def make_loaders(graphs):
    """Train (shuffled from the seed), validation and test loaders, COO
    batches of :data:`BATCH_SIZE`."""
    train, val, test = split(graphs)
    return (
        ConnectomeDataLoader(train, batch_size=BATCH_SIZE, shuffle=True, seed=SEED),
        ConnectomeDataLoader(val, batch_size=BATCH_SIZE, shuffle=False),
        ConnectomeDataLoader(test, batch_size=BATCH_SIZE, shuffle=False),
    )


def train_and_test(name, loaders, in_channels, *, device=None, verbose=True):
    """Train ``MODELS[name]`` with ``Trainer.fit`` and evaluate it on the
    test loader; returns ``(history, test_metrics, fit_seconds)``."""
    train_loader, val_loader, test_loader = loaders
    print_section(f"Training {name}")
    model = MODELS[name](
        in_channels=in_channels,
        hidden_dim=HIDDEN_DIM,
        num_classes=2,
        num_layers=NUM_LAYERS,
        dropout=DROPOUT,
        generator=torch.Generator().manual_seed(SEED),
    )
    trainer = Trainer(model, optimizer=reference_adam(1e-3, 1e-4), seed=SEED, device=device)
    print(f"  Parameters: {model.num_params():,}  (on {trainer.device})")
    t0 = time.perf_counter()
    history = trainer.fit(
        train_loader, val_loader, num_epochs=EPOCHS, patience=PATIENCE, verbose=verbose
    )
    if trainer.device.type == "cuda":
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    test_metrics = trainer.evaluate(test_loader)
    print(
        f"\n  {name} test accuracy: {test_metrics['accuracy']:.3f} "
        f"({test_metrics['correct']}/{test_metrics['total']})  "
        f"[{elapsed:.1f}s train, {len(history['train_loss'])} epochs]"
    )
    return history, test_metrics, elapsed


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else None
    where = "cpu" if args.cpu else (
        torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cuda (none available)")
    print(f"torch {torch.__version__}  device: {where}")

    print_section("1. Generating synthetic connectome dataset")
    print(f"  {NUM_SUBJECTS} subjects × {NUM_REGIONS} brain regions")
    print("  Graph type: Watts-Strogatz small-world (k=8, β=0.15)")
    print("  Task: predict fluid intelligence (binary, above/below median)")
    graphs = generate_dataset(
        num_subjects=NUM_SUBJECTS, num_regions=NUM_REGIONS, k=8, beta=0.15, trait_idx=0,
        seed=SEED,
    )
    g0 = graphs[0]
    print(f"\n  Example subject: {g0.subject_id}")
    print(f"    nodes = {g0.num_nodes}, edges = {g0.num_edges}, features/node = {g0.num_features}")
    print(f"    edge weight range: [{g0.edge_weight.min():.3f}, {g0.edge_weight.max():.3f}]")
    stats = small_world_stats(graphs[:20])
    print("\n  Small-world check (sample of 20 subjects):")
    print(f"    mean clustering coefficient = {stats['mean_clustering']:.3f}")
    print(f"    mean avg path length        = {stats['mean_avg_path_length']:.3f}")
    label_counts = [0, 0]
    for g in graphs:
        label_counts[g.label] += 1
    print(f"\n  Label balance: class 0 = {label_counts[0]}, class 1 = {label_counts[1]}")

    print_section("2. Data split")
    train, val, test = split(graphs)
    print(f"  train: {len(train)}  |  val: {len(val)}  |  test: {len(test)}")
    loaders = make_loaders(graphs)

    results = {name: train_and_test(name, loaders, g0.num_features, device=device)[1]
               for name in MODELS}

    print_section("3. Results summary")
    print(f"  {'Model':<20}  {'Test Acc':>10}  {'reference run':>14}")
    print(f"  {'-' * 48}")
    for name, metrics in results.items():
        print(f"  {name:<20}  {metrics['accuracy']:>10.3f}  {BASELINE_ACCURACY[name]:>14.3f}")
    print()
    print("  Published band: ~55-70% accuracy, realistic for weak brain-behaviour")
    print("  correlations (r~0.2-0.3) typical in neuroimaging studies; 45 test")
    print("  graphs spread about ±7 points, so no run is held to it.")
    return results


if __name__ == "__main__":
    main()

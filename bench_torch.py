#!/usr/bin/env python3
"""Headline benchmark of the PyTorch port: GCN forward edge-message throughput.

``bench.py``'s measurement for the port: the steady-state eval forward of
the flagship ``GCNConnectome`` at the reference demo config (batch 16
subjects × 84 regions from ``generate_dataset(seed=42)``, dense layout,
hidden 64, 3 layers, weights from a generator seeded 0), served by
``forward_auto`` (the fused kernel K1 with its wrapper and weight prep), in
edge messages a second: 3 layers × the batch's real edges over the time of
one call.  ``vs_baseline`` is against the reference's torch CPU number,
3.96e6 (``BASELINE.md``; ``bench.py:33``).

Before any timing, ``forward_auto`` must match the unfused ``model(batch)``
on the same device at rtol 1e-4 / atol 1e-5 with TF32 off (``bench.py``'s
gate).  Then each of ``--windows`` windows times ``--iters`` back-to-back
calls between two CUDA events; the value is the median window's time a
call.  Earlier lines give the card's name and power limit, K1 alone on
prepared weights (the same events) and the host's µs to issue one call.

    python3 bench_torch.py                 # on the CUDA card (raises without one)
    python3 bench_torch.py --device cpu    # the plain version, a quick check

On the CPU the times are the host clock's and the unit says so.  The last
line is one JSON object: ``{"metric", "value", "unit", "vs_baseline"}``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from connectome_gnn_tpu_torch.data import collate_dense, generate_dataset  # noqa: E402
from connectome_gnn_tpu_torch.models import GCNConnectome  # noqa: E402
from connectome_gnn_tpu_torch.ops import fused  # noqa: E402

BASELINE_EDGE_MSGS_PER_S = 3.96e6  # reference torch CPU, BASELINE.md
LAYERS = 3
RTOL, ATOL = 1e-4, 1e-5


def card_name() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def window_ms(fn, iters: int, on_card: bool) -> float:
    """ms a call over ``iters`` back-to-back calls: CUDA events on the card,
    the host clock on the CPU."""
    if not on_card:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def median_ms(fn, iters: int, windows: int, on_card: bool) -> float:
    fn()  # warm-up: builds the kernels on first use
    if on_card:
        torch.cuda.synchronize()
    return statistics.median(window_ms(fn, iters, on_card) for _ in range(windows))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="default: cuda")
    parser.add_argument("--iters", type=int, default=1000, help="calls a timed window")
    parser.add_argument("--windows", type=int, default=5, help="timed windows; the median is kept")
    args = parser.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        raise SystemExit("bench_torch: no CUDA card (torch.cuda.is_available() is false); "
                         "pass --device cpu for the plain version")
    device = torch.device(args.device or "cuda")
    on_card = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[bench] device: {card_name() if on_card else 'cpu'} | torch {torch.__version__}", flush=True)

    graphs = generate_dataset(num_subjects=16, num_regions=84, seed=42)
    batch = collate_dense(graphs, device=device)
    real_edges = sum(g.num_edges for g in graphs)
    model = GCNConnectome(in_channels=5, hidden_dim=64, num_classes=2, num_layers=LAYERS,
                          generator=torch.Generator().manual_seed(0)).to(device).eval()

    with torch.inference_mode():
        launches = fused.fused_gcn_kernel.launches
        served = fused.forward_auto(model, batch)
        oracle = model(batch)
        torch.testing.assert_close(served, oracle, rtol=RTOL, atol=ATOL)
        if on_card and fused.fused_gcn_kernel.launches != launches + 1:
            raise SystemExit("bench_torch: forward_auto did not launch K1 on the card")
        print(f"[bench] gate: forward_auto against the unfused model(batch) on {device.type}, "
              f"max|diff| {float((served - oracle).abs().max()):.3e} (rtol {RTOL}, atol {ATOL}, "
              f"TF32 off): passed", flush=True)

        call_ms = median_ms(lambda: fused.forward_auto(model, batch), args.iters, args.windows,
                            on_card)
        what, clock = ("K1 with its wrapper and weight prep", "CUDA events") if on_card else (
            "model(batch) on the CPU", "host clock")
        print(f"[bench] forward_auto ({what}): {call_ms:.6f} ms a call ({clock}, median of "
              f"{args.windows} windows of {args.iters} calls)", flush=True)
        if on_card:
            w = fused.gcn_weights(model)
            args_k1 = (batch.node_features, batch.adj, batch.node_mask, w)
            k1_ms = median_ms(lambda: fused.fused_gcn_kernel(*args_k1), args.iters, args.windows,
                              on_card)
            print(f"[bench] K1 alone on prepared weights (fused_gcn_kernel): {k1_ms:.6f} ms a call "
                  f"(CUDA events, median of {args.windows} windows of {args.iters} calls)", flush=True)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            fused.forward_auto(model, batch)
        host_us = (time.perf_counter() - t0) * 1e6 / args.iters
        if on_card:
            torch.cuda.synchronize()
        print(f"[bench] host: {host_us:.2f} µs to issue one forward_auto call (mean of {args.iters} "
              f"calls, no sync among them)", flush=True)

    rate = LAYERS * real_edges / (call_ms * 1e-3)
    unit = "edge-messages/s (bs=16, h=64, L=3, 84-node WS graphs)"
    print(json.dumps({
        "metric": "gcn_fwd_edge_messages_per_s",
        "value": round(rate, 1),
        "unit": unit if on_card else unit + " on the CPU, host clock",
        "vs_baseline": round(rate / BASELINE_EDGE_MSGS_PER_S, 3),
    }))


if __name__ == "__main__":
    main()

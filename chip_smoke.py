#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA card.

Run from the repository root, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one line each:

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
   TF32 is switched off for every f32 product;
2. the build: ``nvcc`` compiles ``connectome_gnn_tpu_torch/csrc`` for sm_90a;
3. each fused kernel (K1 GCN, K2 SAGE) against its plain PyTorch version on
   the card at four (B, n, F, H, L) shapes, rtol 1e-4 / atol 1e-5 (the
   repository's f32 gate);
4. the main path: ``generate_dataset`` → dense ``ConnectomeDataLoader`` on
   CUDA → ``Trainer.predict`` for GCN and SAGE at the flagship width
   (hidden 64, 3 layers, random weights from seed 0 and non-trivial
   BatchNorm state), checked against the unfused path on the card and on
   the CPU, with each kernel's launch count; then ``Trainer.evaluate``;
5. times: each kernel and its plain version per call by CUDA events (median
   of 100 after warm-up) and as device time by ``torch.profiler``, at batch
   16 and 512, and ``predict`` over the 64 graphs by the host clock.

It prints the kernels' JSON line, then ``{"ok": true, "device": ...}`` as
the last line.  Any failure raises and exits non-zero; without CUDA it
fails at once.  JAX is not imported: the machine with the card has none.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from connectome_gnn_tpu_torch import (
    ConnectomeDataLoader,
    GCNConnectome,
    GraphSAGEConnectome,
    Trainer,
    generate_dataset,
)
from connectome_gnn_tpu_torch.ops import _build
from connectome_gnn_tpu_torch.ops.fused import (
    fused_gcn_forward_reference,
    fused_gcn_kernel,
    fused_sage_forward_reference,
    fused_sage_kernel,
    gcn_weights,
    sage_weights,
)

RTOL, ATOL = 1e-4, 1e-5
#: (B, n, F, H, L): flagship batch 16 and 512, the largest fused shape, a small one
SHAPES = [(16, 88, 5, 64, 3), (512, 88, 5, 64, 3), (7, 128, 5, 128, 1), (3, 24, 5, 32, 2)]
TIMED_BATCHES = (16, 512)
KERNELS = {
    "gcn": dict(
        name="fused_gcn_forward", model=GCNConnectome, weights=gcn_weights,
        kernel=fused_gcn_kernel, plain=fused_gcn_forward_reference,
        replaces="connectome_gnn_tpu/ops/fused_pallas.py:218",
    ),
    "sage": dict(
        name="fused_sage_forward", model=GraphSAGEConnectome, weights=sage_weights,
        kernel=fused_sage_kernel, plain=fused_sage_forward_reference,
        replaces="connectome_gnn_tpu/ops/fused_pallas.py:487",
    ),
}
SOURCE = "connectome_gnn_tpu_torch/csrc/fused_forward.cu"


def check(ok: bool, what) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def randomize_batch_norms(model, rng: np.random.Generator) -> None:
    """Non-trivial BatchNorm affine and running moments, drawn from numpy."""
    with torch.no_grad():
        for bn in model.batch_norms:
            H = bn.num_features
            bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, H).astype(np.float32)))
            bn.bias.copy_(torch.from_numpy(rng.normal(0.0, 0.2, H).astype(np.float32)))
            bn.running_mean.copy_(torch.from_numpy(rng.normal(0.0, 0.5, H).astype(np.float32)))
            bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, H).astype(np.float32)))


def make_model(kind, F, H, L, seed=0):
    model = KERNELS[kind]["model"](
        in_channels=F, hidden_dim=H, num_classes=2, num_layers=L,
        generator=torch.Generator().manual_seed(seed),
    )
    randomize_batch_norms(model, np.random.default_rng(seed))
    return model.eval()


def random_dense_batch(B, n, F, seed, device):
    """Dense inputs with ragged real node counts and ~10% edge density."""
    rng = np.random.default_rng(seed)
    real = rng.integers(max(1, 3 * n // 4), n + 1, size=B)
    mask = np.arange(n)[None, :] < real[:, None]
    x = rng.normal(size=(B, n, F)).astype(np.float32) * mask[:, :, None]
    adj = rng.beta(2, 5, size=(B, n, n)) * (rng.random((B, n, n)) < 0.1)
    adj = (adj * mask[:, :, None] * mask[:, None, :]).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (x, adj, mask))


def cuda_ms(fns, iters=100, warmup=10):
    """Median CUDA-event time (ms) of each function, sampled in turns."""
    for fn in fns:
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    events = [[] for _ in fns]
    for _ in range(iters):
        for fn, ev in zip(fns, events):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            ev.append((start, end))
    torch.cuda.synchronize()
    return [statistics.median(s.elapsed_time(e) for s, e in ev) for ev in events]


def host_ms(fns, iters=20):
    """Median host-clock time (ms) of each function ending in a
    synchronize, sampled in turns."""
    for fn in fns:
        fn()
    times = [[] for _ in fns]
    for _ in range(iters):
        for fn, ts in zip(fns, times):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
    return [statistics.median(ts) for ts in times]


def device_ms(fn, iters=20):
    """Device time (ms) per call: the kernels and copies it puts on the
    card, from torch.profiler (CUDA-typed events only; a CPU op's device
    time repeats its kernels')."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(
        e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA
    )
    return busy_us / 1e3 / iters


def main() -> None:
    # 1. the card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"[1 card] {card} | torch {torch.__version__} | cuda {torch.version.cuda}", flush=True)

    # 2. the build
    t0 = time.perf_counter()
    _build.library()
    print(f"[2 build] nvcc {' '.join(_build.NVCC_FLAGS)}: {time.perf_counter() - t0:.1f} s", flush=True)

    # 3. each kernel against its plain version on the card
    max_err = {kind: 0.0 for kind in KERNELS}
    timing_inputs = {}
    for B, n, F, H, L in SHAPES:
        inputs = random_dense_batch(B, n, F, seed=B + n, device=dev)
        for kind, k in KERNELS.items():
            w = k["weights"](make_model(kind, F, H, L).to(dev))
            got = k["kernel"](*inputs, w)
            torch.cuda.synchronize()
            want = k["plain"](*inputs, w)
            torch.cuda.synchronize()
            check(got.shape == (B, 2) and bool(torch.isfinite(got).all()), (kind, B, n))
            torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
            err = float((got - want).abs().max())
            max_err[kind] = max(max_err[kind], err)
            print(f"[3 kernel] {kind} B={B} n={n} F={F} H={H} L={L}: max|kernel-plain| = {err:.3e}", flush=True)
            if (n, F, H, L) == (88, 5, 64, 3) and B in TIMED_BATCHES:
                timing_inputs[kind, B] = (inputs, w)

    # 4. the main path
    graphs = generate_dataset(num_subjects=64, seed=42)
    loader = ConnectomeDataLoader(graphs, batch_size=16, shuffle=False, layout="dense", device=dev)
    cpu_loader = ConnectomeDataLoader(graphs, batch_size=16, shuffle=False, layout="dense")
    trainers = {kind: Trainer(make_model(kind, 5, 64, 3), device=dev) for kind in KERNELS}
    cpu_logits = {
        kind: Trainer(copy.deepcopy(tr.model), device="cpu").predict(cpu_loader, prefer_fused=False)
        for kind, tr in trainers.items()
    }
    fused_gcn_kernel.launches = 0
    fused_sage_kernel.launches = 0
    logits = {kind: tr.predict(loader) for kind, tr in trainers.items()}
    torch.cuda.synchronize()
    launches = {"gcn": fused_gcn_kernel.launches, "sage": fused_sage_kernel.launches}
    for kind, tr in trainers.items():
        out = logits[kind]
        check(out.shape == (64, 2) and np.isfinite(out).all(), (kind, out.shape))
        check(launches[kind] == len(loader) == 4, ("launches", kind, launches[kind]))
        plain = tr.predict(loader, prefer_fused=False)
        np.testing.assert_allclose(out, plain, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(out, cpu_logits[kind], rtol=RTOL, atol=ATOL)
        ev = tr.evaluate(loader)
        check(ev["total"] == 64 and np.isfinite(ev["loss"]), ev)
        print(
            f"[4 main path] {kind}: predict {out.shape} finite, {launches[kind]} kernel launches, "
            f"max|fused-unfused| = {np.abs(out - plain).max():.3e}, "
            f"max|fused-cpu| = {np.abs(out - cpu_logits[kind]).max():.3e}; "
            f"evaluate loss={ev['loss']:.4f} acc={ev['accuracy']:.3f} total={ev['total']}",
            flush=True,
        )

    # 5. times (nothing asserted)
    times = {}
    for (kind, B), (inputs, w) in sorted(timing_inputs.items()):
        k = KERNELS[kind]
        run_kernel = lambda: k["kernel"](*inputs, w)  # noqa: E731
        run_plain = lambda: k["plain"](*inputs, w)  # noqa: E731
        times[kind, B] = cuda_ms([run_kernel, run_plain])
        dev_kernel, dev_plain = device_ms(run_kernel), device_ms(run_plain)
        print(
            f"[5 times] {card} | {kind} B={B} n=88 H=64 L=3: kernel {times[kind, B][0]:.4f} ms, "
            f"plain {times[kind, B][1]:.4f} ms per call (CUDA events, median of 100); "
            f"device time kernel {dev_kernel:.4f} ms, plain {dev_plain:.4f} ms (torch.profiler, mean of 20)",
            flush=True,
        )
    edge_messages = 3 * sum(g.num_edges for g in graphs)
    for kind, tr in trainers.items():
        fused_ms, plain_ms = host_ms(
            [lambda: tr.predict(loader), lambda: tr.predict(loader, prefer_fused=False)]
        )
        print(
            f"[5 times] {card} | {kind} predict, 64 graphs in 4 batches of 16: fused {fused_ms:.3f} ms "
            f"({64 / fused_ms * 1e3:.1f} graphs/s, {edge_messages / fused_ms * 1e3:.4g} edge-messages/s), "
            f"unfused {plain_ms:.3f} ms ({64 / plain_ms * 1e3:.1f} graphs/s) (host clock, median of 20, in turns)",
            flush=True,
        )

    print(json.dumps({"kernels": [
        {
            "name": k["name"], "route": "cuda", "source": SOURCE, "replaces": k["replaces"],
            "launches": launches[kind], "max_abs_err": max_err[kind],
            "ms": times[kind, 16][0], "plain_ms": times[kind, 16][1],
        }
        for kind, k in KERNELS.items()
    ]}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()

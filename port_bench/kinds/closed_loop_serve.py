"""Closed-loop whole-graph serving: one client, one request at a time.
Each request is a fresh feature snapshot over the fixed graph and one
eval-mode forward of the configuration's model through the workload's
route (``routes/<route>.py``), timed from issue to its logits ready.  The
snapshot is drawn into one buffer before the clock starts."""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench import inputs, parts
from port_bench.reference import compare
from port_bench.reference import model as ref
from port_bench.traffic import Traffic, sync


class Kind(Traffic):
    def setup(self) -> None:
        with self.span("model_build_s"):
            route = parts.route(self.workload["route"])
            model = self.program_model(self.weights(serving=True), train=False)
        with self.span("graph_build_s"):
            band, _ = self.program_band()
            self.forward = route.prepare(model, band)
            del band
        cfg = self.config
        self.features = torch.empty((cfg["num_nodes"], cfg["in_channels"]), device=self.device)
        self.kept: dict = {}
        self.next_request = 0

    def plan(self) -> None:
        rng = np.random.default_rng(inputs.sub_seed(self.seed, "kept"))
        self.keep = sorted(rng.choice(self.workload["kept_from_first"],
                                      self.workload["kept_requests"], replace=False).tolist())

    def request(self, index: int) -> None:
        inputs.request_features(self.config, self.seed, index, self.device, out=self.features)

    def warm_up(self, seconds: float) -> None:
        """Requests of their own (negative indices), untimed."""
        i, t0 = 0, time.perf_counter()
        while i < 2 or time.perf_counter() - t0 < seconds:
            self.request(-1 - i)
            with torch.no_grad():
                self.forward(self.features)
            sync(self.device)
            i += 1

    def serve(self, deadline: float | None, count: int | None) -> list:
        """Requests until ``count`` are served, or until ``deadline``
        seconds have passed and the range the check samples from
        (``kept_from_first``) is served."""
        latencies, t_start = [], time.perf_counter()
        least = self.workload["kept_from_first"]
        while True:
            i = self.next_request
            self.request(i)
            sync(self.device)
            t0 = time.perf_counter()
            with torch.no_grad():
                out = self.forward(self.features)
            sync(self.device)
            t1 = time.perf_counter()
            latencies.append(t1 - t0)
            if i in self.keep:
                self.kept[i] = out.clone()
            self.next_request += 1
            if (deadline is not None and t1 - t_start >= deadline and len(latencies) >= least) \
                    or (count is not None and len(latencies) >= count):
                return latencies

    def window(self, seconds: float) -> dict:
        lat = np.asarray(self.serve(seconds, None))
        p95 = float(np.percentile(lat, 95))
        self.log(f"window: {len(lat)} requests, median {np.median(lat) * 1e3:.4f} ms, "
                 f"p95 {p95 * 1e3:.4f} ms, p99 {np.percentile(lat, 99) * 1e3:.4f} ms")
        return {"units": len(lat), "attempted": len(lat), "failed": 0, "serve_p95_ms": p95 * 1e3}

    def traced(self) -> int:
        return len(self.serve(None, self.workload["trace_units"]))

    def release(self) -> None:
        self.forward = self.features = None

    def reference_logits(self, indices, bits, tf32: bool) -> list:
        cfg, dev, model = self.config, self.device, self.model_file
        g = inputs.make_graph(cfg, self.seed, dev)
        adj = ref.Adjacency.coalesce(g.senders, g.receivers, g.weights, cfg["num_nodes"])
        del g
        operator = model.reference_operator(adj, cfg, bits)
        del adj
        p = self.weights(serving=True)
        with ref.exact_float32(), torch.no_grad():
            return [model.reference_logits(p, operator,
                                           inputs.request_features(cfg, self.seed, i, dev), cfg,
                                           train=False, tf32=tf32) for i in indices]

    def readings(self) -> dict:
        missing = [i for i in self.keep if i not in self.kept]
        if missing:
            self.log(f"check: requests {missing} never finished")
            return {"logit_rel_err": float("inf"), "logit_max_gap": float("inf")}
        return compare.serve_readings([self.kept[i] for i in self.keep],
                                      self.reference_logits(self.keep, self.band_bits(), False))

    def control_readings(self) -> dict:
        """int4 for an int8 band; TF32 products for a float32 one."""
        bits = self.band_bits()
        lower = (bits // 2, False) if bits else (None, True)
        return compare.serve_readings(self.reference_logits(self.keep, *lower),
                                      self.reference_logits(self.keep, bits, False))

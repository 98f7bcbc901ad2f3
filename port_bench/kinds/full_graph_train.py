"""Full-graph training: the configuration's model trained on the whole
graph through the workload's route (``routes/<route>.py``: the band
prepared once, then a differentiable forward a step), the mean
cross-entropy over the labelled nodes, backward and the program's Adam.
The first three steps of the one model and optimizer are the
comparison's; the window continues them."""

from __future__ import annotations

import time

import torch
import torch.nn.functional as F

from port_bench import inputs, parts
from port_bench.reference import model as ref
from port_bench.traffic import COMPARED_STEPS, Traffic, sync


class Kind(Traffic):
    def setup(self) -> None:
        with self.span("model_build_s"):
            from connectome_gnn_tpu_torch.train.trainer import reference_adam

            self.weights0 = self.weights(serving=False)
            self.model = self.program_model(self.weights0, train=True)
        with self.span("graph_build_s"):
            band, self.x = self.program_band()
            self.logits_of = parts.route(self.workload["route"]).prepare(self.model, band)
            del band
        self.opt = reference_adam()(self.model.parameters())
        self.labels, self.labelled = inputs.node_labels(self.config, self.seed, self.device)
        with self.span("first_steps_s"):
            self.produced = self.first_steps()

    def loss(self, logits, labels, labelled):
        ce = F.cross_entropy(logits, labels, reduction="none")
        m = labelled.to(ce.dtype)
        return (ce * m).sum() / m.sum().clamp(min=1.0)

    def step(self):
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss(self.logits_of(self.x), self.labels, self.labelled)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def first_steps(self) -> dict:
        names = dict(self.model.named_parameters())
        losses, grads = [], None
        beta1 = self.opt.param_groups[0]["betas"][0]
        for i in range(COMPARED_STEPS):
            losses.append(float(self.step()))
            if i == 0:
                grads = {k: self.opt.state[p].get("exp_avg", torch.zeros_like(p)) / (1 - beta1)
                         for k, p in names.items()}
        change = {k: p.detach() - self.weights0[k] for k, p in names.items()}
        return {"losses": losses, "grads": grads, "change": change}

    def window(self, seconds: float) -> dict:
        steps, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.step()
            steps += 1
        sync(self.device)
        elapsed = time.perf_counter() - t0
        self.log(f"window: {steps} steps in {elapsed:.4f} s")
        return {"units": steps, "attempted": steps, "failed": 0,
                "train_nodes_per_s": self.config["num_nodes"] * steps / elapsed}

    def traced(self) -> int:
        for _ in range(self.workload["trace_units"]):
            self.step()
        return self.workload["trace_units"]

    def release(self) -> None:
        self.model = self.opt = self.logits_of = self.x = None

    def reference(self, bits, tf32: bool = False, half: bool = False) -> dict:
        """The reference's three steps, the band at ``bits`` (None:
        float32), TF32 products with ``tf32``; ``half`` plants the fault
        that leaves out every other labelled node and takes the mean over
        the rest."""
        cfg, dev, model = self.config, self.device, self.model_file
        g = inputs.make_graph(cfg, self.seed, dev)
        adj = ref.Adjacency.coalesce(g.senders, g.receivers, g.weights, cfg["num_nodes"])
        operator = model.reference_operator(adj, cfg, bits)
        x = g.features
        del g, adj
        labels, labelled = inputs.node_labels(cfg, self.seed, dev)
        if half:
            labelled = labelled & (torch.arange(labelled.numel(), device=dev) % 2 == 0)
        params0 = self.weights(serving=False)
        trainable = [k for k in params0 if "running" not in k]

        def loss_of(p, step):
            logits = model.reference_logits(p, operator, x, cfg, train=True, tf32=tf32)
            return ref.masked_cross_entropy(logits, labels, labelled)

        with ref.exact_float32():
            return ref.train_steps(params0, trainable, COMPARED_STEPS, loss_of)

    def readings(self) -> dict:
        return self.train_readings(self.produced, self.reference(self.band_bits()))

    def control_readings(self) -> dict:
        """int4 for an int8 band; TF32 products for a float32 one."""
        bits = self.band_bits()
        lower = (bits // 2, False) if bits else (None, True)
        return self.train_readings(self.reference(*lower), self.reference(bits))

    def fault_readings(self) -> dict:
        bits = self.band_bits()
        return self.train_readings(self.reference(bits, half=True), self.reference(bits))

"""Device-sampled training: the configuration's model behind the program's
device sampler (the model file's ``sampled_program``) trained by
``Trainer(scan_epochs=True)``: each epoch is packed once, and on the card
each step replays one captured graph.  The first three steps are one-step
epochs of seed rows that all differ, through the same ``train_epoch``; the
window then runs whole epochs of a shuffled seed pool."""

from __future__ import annotations

import time

import torch

from port_bench import inputs
from port_bench.reference import model as ref
from port_bench.traffic import COMPARED_STEPS, Traffic


class Kind(Traffic):
    def setup(self) -> None:
        with self.span("model_build_s"):
            from connectome_gnn_tpu_torch.data.graph import ConnectomeGraph
            from connectome_gnn_tpu_torch.train.trainer import Trainer

        cfg, dev = self.config, self.device
        with self.span("graph_build_s"):
            g = inputs.make_graph(cfg, self.seed, dev)
            graph = ConnectomeGraph(
                node_features=g.features.cpu().numpy(),
                edge_index=torch.stack([g.senders, g.receivers]).int().cpu().numpy(),
                edge_weight=g.weights.cpu().numpy(),
            )
            del g
            model = self.model_file.sampled_program(graph, cfg, dev)
            del graph
        self.weights0 = self.weights(serving=False)
        self.load_weights(model.inner, self.weights0)
        self.trainer = Trainer(model, seed=inputs.sub_seed(self.seed, "trainer") % (1 << 31),
                               device=dev, scan_epochs=True)
        labels, _ = inputs.node_labels(cfg, self.seed, dev)
        labels = labels.cpu().numpy()
        self.loader = model.make_loader(self.pool, labels, batch_size=cfg["batch_size"],
                                        shuffle=True,
                                        seed=inputs.sub_seed(self.seed, "loader") % (1 << 31))
        self.check_loaders = [model.make_loader(s, labels, batch_size=cfg["batch_size"],
                                                shuffle=False, seed=b)
                              for s, b in zip(self.check_seeds, self.check_bases)]
        with self.span("first_steps_s"):
            self.produced = self.first_steps()

    def plan(self) -> None:
        cfg, wl = self.config, self.workload
        S, k = cfg["batch_size"], COMPARED_STEPS
        pools = inputs.seed_pool(cfg, self.seed, wl["pool_size"] + k * S, self.device).cpu().numpy()
        self.check_seeds = [pools[i * S : (i + 1) * S] for i in range(k)]
        self.check_bases = [inputs.sub_seed(self.seed, "check", i) % (1 << 31) for i in range(k)]
        self.pool = pools[k * S :]
        self.sample_sizes: list = []

    def first_steps(self) -> dict:
        trainer = self.trainer
        names = dict(trainer.model.inner.named_parameters())
        beta1 = trainer.optimizer.param_groups[0]["betas"][0]
        losses, grads = [], None
        for i, loader in enumerate(self.check_loaders):
            losses.append(trainer.train_epoch(loader))
            if i == 0:
                state = trainer.optimizer.state
                grads = {k: state[p].get("exp_avg", torch.zeros_like(p)) / (1 - beta1)
                         for k, p in names.items()}
        change = {k: p.detach() - self.weights0[k] for k, p in names.items()}
        return {"losses": losses, "grads": grads, "change": change}

    def epoch(self) -> int:
        self.trainer.train_epoch(self.loader)
        return len(self.loader)

    def window(self, seconds: float) -> dict:
        steps, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            steps += self.epoch()
        elapsed = time.perf_counter() - t0
        self.log(f"window: {steps} steps in {elapsed:.4f} s")
        seeds = steps * self.config["batch_size"]
        return {"units": steps, "attempted": steps, "failed": 0,
                "sampled_seeds_per_s": seeds / elapsed}

    def traced(self) -> int:
        return sum(self.epoch() for _ in range(self.workload["trace_units"]))

    def release(self) -> None:
        self.trainer = self.loader = self.check_loaders = None

    def unit_shapes(self):
        """The sampled nodes and edges of a step, the mean over the compared
        steps' samples as the reference draws them (set by ``readings``),
        and the seeds the head reads."""
        if not self.sample_sizes:
            return None
        nodes, edges = (sum(s[i] for s in self.sample_sizes) / len(self.sample_sizes)
                        for i in (0, 1))
        return {"nodes": nodes, "edges": edges, "head_rows": self.config["batch_size"]}

    def reference(self, tf32: bool, half: bool = False) -> dict:
        """The reference's three steps; ``half`` plants the fault that
        leaves out the second half of each step's seeds and takes the
        mean over the rest."""
        cfg, dev = self.config, self.device
        g = inputs.make_graph(cfg, self.seed, dev)
        labels, _ = inputs.node_labels(cfg, self.seed, dev)
        labelled = torch.ones_like(labels, dtype=torch.bool)
        params0 = self.weights(serving=False)
        trainable = [k for k in params0 if "running" not in k]
        seeds = [torch.from_numpy(s).to(dev) for s in self.check_seeds]
        keys = [ref.sample_key(b, 0, 0) for b in self.check_bases]
        sizes = []

        def loss_of(p, step):
            mask = labelled
            if half:
                mask = labelled.clone()
                mask[seeds[step][seeds[step].numel() // 2 :]] = False
            loss, size = self.model_file.sampled_reference_loss(
                p, seeds[step], keys[step], g, labels, mask, cfg, tf32=tf32)
            sizes.append(size)
            return loss

        with ref.exact_float32():
            out = ref.train_steps(params0, trainable, COMPARED_STEPS, loss_of)
        self.sample_sizes = sizes
        return out

    def readings(self) -> dict:
        return self.train_readings(self.produced, self.reference(False))

    def control_readings(self) -> dict:
        return self.train_readings(self.reference(True), self.reference(False))

    def fault_readings(self) -> dict:
        return self.train_readings(self.reference(False, half=True), self.reference(False))

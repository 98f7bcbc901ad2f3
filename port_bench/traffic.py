"""What every traffic kind shares.  A kind (``kinds/<kind>.py``, named by a
workload file's ``kind``) builds the program's state from the inputs
(``setup``), runs the measured window (``window``) or a profiled one
(``traced``), frees the program's state (``release``) and then computes
what the plain reference gives for the same inputs (``readings``).  Only
``setup`` and the windows touch the program.

The configuration's ``model`` names the model file (``models/<model>.py``)
that builds the program's model and gives the reference's forward; a band
kind's workload ``route`` names the route file (``routes/<route>.py``) that
prepares the program's band and runs over it.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch

from port_bench import inputs, parts
from port_bench.reference import compare

#: training steps the reference follows: the first three of the one
#: trained object
COMPARED_STEPS = 3


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Traffic:
    def __init__(self, config: dict, workload: dict, seed: int, device, log):
        self.config, self.workload, self.seed, self.device = config, workload, seed, device
        self.log = log
        self.spans: dict = {}
        self.model_file = parts.model(config["model"])
        self.plan()

    def plan(self) -> None:
        """What the comparison will read, drawn from the seed alone (no
        program): which requests, which seed rows."""

    @contextmanager
    def span(self, name: str):
        """Host seconds of a set-up piece, ending in a synchronize."""
        t0 = time.perf_counter()
        yield
        sync(self.device)
        self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t0
        self.log(f"set-up: {name} {self.spans[name]:.3f} s")

    def weights(self, serving: bool) -> dict:
        return inputs.make_weights(self.config, self.seed, self.device, serving=serving,
                                   shapes=self.model_file.parameter_shapes(self.config))

    def program_model(self, weights: dict, train: bool):
        """The program's model of the configuration, holding ``weights``, on
        the device, in train or eval mode."""
        module = self.model_file.program_model(self.config).to(self.device).train(train)
        self.load_weights(module, weights)
        return module

    @staticmethod
    def load_weights(module, weights: dict) -> None:
        state = module.state_dict()
        with torch.no_grad():
            for k, v in weights.items():
                state[k].copy_(v)

    def program_band(self):
        """The graph drawn from the seed, as the program's block band."""
        from connectome_gnn_tpu_torch.ops.banded import to_banded

        g = inputs.make_graph(self.config, self.seed, self.device)
        host = [t.cpu().numpy() for t in (g.senders, g.receivers, g.weights)]
        features = g.features
        del g
        return to_banded(*host, self.config["num_nodes"], block=self.config["block"],
                         device=self.device), features

    def band_bits(self):
        """The band's stored width on the workload's route: the
        configuration's ``band_bits``, or None for a float32 band."""
        return self.config["band_bits"] if parts.route(self.workload["route"]).QUANTIZED else None

    def warm_up(self, seconds: float) -> None:
        """The window's own loop, untimed, so the device runs warm when the
        window opens."""
        self.window(seconds)

    def unit_shapes(self):
        """The nodes, edges and head rows of one unit's forward where the
        sample sets them (None: the configuration's whole graph)."""
        return None

    def train_readings(self, got: dict, want: dict) -> dict:
        return compare.train_readings(got, want)

    def readings(self) -> dict:
        """The comparison's numbers: what the program produced against the
        reference at the configuration's precision."""
        raise NotImplementedError

    def control_readings(self) -> dict:
        """The same numbers for the reference in the next lower precision
        put in the program's place."""
        raise NotImplementedError

"""The port's profiling utilities (``utils/profiling.py``) against the JAX
package's: ``trace`` writes a trace file, and ``StepTimer`` keeps JAX's
interface and statistics on the same ``times`` lists."""

import dataclasses
import json
import os

import pytest
import torch

from connectome_gnn_tpu.utils.profiling import StepTimer as JaxStepTimer
from connectome_gnn_tpu_torch.utils import StepTimer, trace
from connectome_gnn_tpu_torch.utils import profiling


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "run")):
        x = torch.ones(64, 64) @ torch.ones(64, 64)
    assert float(x[0, 0]) == 64.0
    produced = [os.path.join(root, f) for root, _, files in os.walk(tmp_path) for f in files]
    assert len(produced) == 1 and produced[0].endswith(".pt.trace.json")
    with open(produced[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


@pytest.mark.parametrize("skip_first", [0, 1])
@pytest.mark.parametrize("times", [[], [0.5], [0.3, 0.1, 0.2, 0.4]], ids=["empty", "one", "several"])
def test_summary_is_the_jax_timers(times, skip_first):
    port, jax_timer = StepTimer(), JaxStepTimer()
    port.times, jax_timer.times = list(times), list(times)
    assert port.summary(skip_first=skip_first) == jax_timer.summary(skip_first=skip_first)
    assert (port.total, port.mean) == (jax_timer.total, jax_timer.mean)


def test_toc_without_tic_raises():
    timer = StepTimer()
    with pytest.raises(RuntimeError, match="without tic"):
        timer.toc()
    timer.tic()
    assert timer.toc() >= 0.0
    with pytest.raises(RuntimeError, match="without tic"):
        timer.toc(torch.ones(2))
    assert len(timer.times) == 1 and timer.summary()["steps"] == 1


def test_a_cpu_result_names_no_device_to_wait_on():
    nested = {"a": [torch.ones(1), (torch.zeros(2),)], "b": 1.0, "c": None}
    assert profiling._cuda_devices(nested) == set()
    assert profiling._cuda_devices(torch.ones(3)) == set()


def test_toc_synchronizes_each_cuda_device_of_its_result_once(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    monkeypatch.setattr(profiling, "_cuda_devices",
                        lambda result: {torch.device("cuda", 0), torch.device("cuda", 1)})
    timer = StepTimer()
    timer.tic()
    timer.toc([torch.ones(1), torch.ones(1)])
    assert sorted(map(str, synced)) == ["cuda:0", "cuda:1"]
    timer.tic()
    timer.toc()  # toc(None) waits for nothing, as JAX's
    assert len(synced) == 2 and len(timer.times) == 2


@dataclasses.dataclass
class _Result:
    logits: torch.Tensor
    state: dict
    num_graphs: int = 2


def test_toc_synchronizes_each_cuda_device_of_a_dataclass_result_once(monkeypatch):
    """A dataclass result is walked to its tensor leaves, as JAX's
    ``block_until_ready`` walks a registered dataclass; the devices are
    stubbed (there is no card here) by the tensors' ``is_cuda`` and
    ``device``."""

    class OnCard(torch.Tensor):
        is_cuda = True

        @property
        def device(self):
            return torch.device("cuda", self.card)

    def on_card(index):
        t = torch.ones(1).as_subclass(OnCard)
        t.card = index
        return t

    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    result = _Result(on_card(0), {"a": (on_card(1), on_card(0)), "b": None})
    assert profiling._cuda_devices(result) == {torch.device("cuda", 0), torch.device("cuda", 1)}
    timer = StepTimer()
    timer.tic()
    timer.toc(result)
    assert sorted(map(str, synced)) == ["cuda:0", "cuda:1"]
    assert profiling._cuda_devices(_Result(torch.ones(1), {})) == set()

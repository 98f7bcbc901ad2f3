"""The port's application surface on the CPU: ``bench_torch.py``,
``connectome_gnn_tpu_torch.entry`` and ``examples/demo_torch.py``.

* ``bench_torch.py --device cpu`` (a small iteration count) prints its
  gate line and exactly one JSON line with ``bench.py``'s four keys.
* ``entry(device="cpu")``: with the JAX entry point's initial weights
  carried over by ``load_jax_params``, the logits equal JAX's ``entry()``
  forward at rtol 1e-4 / atol 1e-5.
* The demo runs with its constants patched small and prints its summary
  beside the reference run's accuracies.
"""

import importlib.util
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
import bench_torch
from connectome_gnn_tpu_torch import entry as tentry
from connectome_gnn_tpu_torch.models import load_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_prints_one_json_line_with_the_four_keys():
    proc = subprocess.run(
        [sys.executable, "bench_torch.py", "--device", "cpu", "--iters", "3", "--windows", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    json_lines = [line for line in lines if line.startswith("{")]
    assert len(json_lines) == 1 and json_lines[0] == lines[-1]
    result = json.loads(lines[-1])
    assert set(result) == {"metric", "value", "unit", "vs_baseline"}
    assert result["metric"] == "gcn_fwd_edge_messages_per_s"
    assert result["value"] > 0 and result["vs_baseline"] == pytest.approx(result["value"] / 3.96e6, abs=1e-3)
    assert "CPU" in result["unit"]
    assert any(line.startswith("[bench] gate:") and line.endswith("passed") for line in lines)


def test_bench_without_a_card_refuses_by_default(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        bench_torch.main([])
    assert '"metric"' not in capsys.readouterr().out


def test_entry_matches_the_jax_entry_point():
    jforward, (params, state, jbatch) = jax_entry.entry()
    want = np.asarray(jforward(params, state, jbatch))
    forward, (model, batch) = tentry.entry(device="cpu")
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, params),
                    jax.tree_util.tree_map(np.asarray, state))
    got = forward(model, batch)
    assert got.shape == want.shape == (16, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    assert not model.training and batch.num_graphs == 16


def test_entry_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tentry.entry()


def test_entry_module_prints_its_line(capsys):
    tentry.main(["--device", "cpu"])
    assert capsys.readouterr().out.strip().splitlines()[-1] == "entry forward ok: (16, 2)"


def test_demo_runs_small_on_the_cpu(monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location("demo_torch", os.path.join(REPO, "examples", "demo_torch.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    monkeypatch.setattr(demo, "NUM_SUBJECTS", 40)
    monkeypatch.setattr(demo, "EPOCHS", 2)
    # one intra-op thread: at these sizes more threads only contend with
    # the other test processes (8 threads alone took 5 s, 1 thread 3 s)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t0 = time.perf_counter()
        results = demo.main(["--cpu"])
        assert time.perf_counter() - t0 < 15
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert "3. Results summary" in out and "Published band" in out
    assert set(results) == {"GCN", "GraphSAGE"}
    for name, metrics in results.items():
        assert metrics["total"] == 6 and 0.0 <= metrics["accuracy"] <= 1.0
        assert f"{demo.BASELINE_ACCURACY[name]:.3f}" in out

"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module name (the port's name begins with the JAX
package's), and the reference loads nothing of the program."""

import subprocess
import sys
from pathlib import Path

from port_bench import harness

ROOT = Path(__file__).resolve().parents[2]


def loaded_after(statement: str) -> set:
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); {statement}; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT, timeout=300)
    return set(out.stdout.split())


def test_the_harness_and_the_program_load_no_jax():
    tops = loaded_after("import port_bench.harness, port_bench.readings; "
                        "import connectome_gnn_tpu_torch.models.node_gcn, "
                        "connectome_gnn_tpu_torch.models.node_sage, "
                        "connectome_gnn_tpu_torch.data.device_sampling, "
                        "connectome_gnn_tpu_torch.train.trainer")
    assert "connectome_gnn_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    tops = loaded_after("import port_bench.reference.model, port_bench.reference.compare, "
                        "port_bench.inputs")
    assert not tops & (set(harness.FORBIDDEN) | {"connectome_gnn_tpu_torch"})


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "connectome_gnn_tpu_torch_probe", sys)
    assert "connectome_gnn_tpu_torch_probe" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "connectome_gnn_tpu.probe", sys)
    assert harness.forbidden_modules() == ["connectome_gnn_tpu.probe"]


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                          "giant_gcn.train_int8", "--seed", "5", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 2 and out.stdout == ""


def test_the_benchmark_alone_gives_no_result(tmp_path):
    """A directory with only BENCHMARK.json and port_bench/ has no program
    to measure: the run fails and prints nothing."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path.insert(0, '.'); from port_bench import harness; "
            "print(harness.run_cell('giant_gcn.train_int8', 1, 0.1, False, 'cpu', "
            "t_start=time.perf_counter(), overrides={'num_nodes': 1024}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and "connectome_gnn_tpu_torch" in out.stderr
    assert "correct" not in out.stdout

"""Run one cell of the port's benchmark once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
Prints the set-up pieces and each compared number beside its limit on
standard error (the compared numbers last), and one JSON line on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or its per-layer ones with ``--trace 1``), ``device``,
``breakdown`` (traced runs) and ``compared``.  Exits non-zero, printing no
result, without enough CUDA cards, or if ``jax``, ``jaxlib``, ``flax`` or
``connectome_gnn_tpu`` is loaded in this process once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".port_bench_cache"
# every build and kernel cache of the run at a fixed place in the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
sys.path.insert(0, str(ROOT))


def log(message: str) -> None:
    print(message, file=sys.stderr, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from port_bench import harness

    bench = harness.load_benchmark()
    entry, _ = harness.find_cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        log(f"{args.workload} needs {entry['chips']} CUDA card(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  "cuda", t_start=T_START, log=log, bench=bench)
    except RuntimeError as exc:
        log(f"no result: {exc}")
        return 3
    found = harness.forbidden_modules()
    if found:
        log(f"no result: loaded in the reporting process: {', '.join(found)}")
        return 3
    for name, c in result["compared"].items():
        log(f"{name} {c['value']:.6g} limit {c['limit']:.6g}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

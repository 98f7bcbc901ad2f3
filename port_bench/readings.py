"""Readings from which a cell's limits are set, in one process:

    python3 port_bench/readings.py --workload <cell> --seeds 1 2 ... [--seconds 1]
        [--control-seeds 7 8 9] [--fault-seeds 4 5 6] [--out <file>.json]

For each of ``--seeds`` one run of the cell at its own size (a short
window: the compared steps are set-up's, the compared requests the
window's first ones) and its compared numbers; for each of
``--control-seeds`` the same numbers for the control, the reference in the
next lower precision put in the program's place; for each of
``--fault-seeds`` (training cells) the reference with half of each step's
batch left out put in the program's place.  Prints one JSON line:
every reading, the program's largest and the control's smallest of each
number.  The benchmark's own runs do not run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out")
    args = parser.parse_args(argv)

    from port_bench import harness, parts

    def log(m):
        print(m, file=sys.stderr, flush=True)

    bench = harness.load_benchmark()
    _, config_entry = harness.find_cell(bench, args.workload)
    config, workload = harness.load_config(config_entry), harness.load_workload(args.workload)
    runs, controls, faults = [], [], []
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = harness.run_cell(args.workload, seed, args.seconds, False, args.device, t_start=t0,
                             log=log, bench=bench)
        runs.append({"seed": seed, "correct": r["correct"], "metrics": r["metrics"],
                     "compared": {k: v["value"] for k, v in r["compared"].items()}})
        log(f"seed {seed}: {json.dumps(runs[-1])}")
    kind = parts.kind(workload["kind"])
    for seed in args.control_seeds:
        runner = kind(config, workload, seed, harness.torch.device(args.device), log)
        controls.append({"seed": seed, "compared": runner.control_readings()})
        log(f"control seed {seed}: {json.dumps(controls[-1])}")
    for seed in args.fault_seeds:
        runner = kind(config, workload, seed, harness.torch.device(args.device), log)
        faults.append({"seed": seed, "compared": runner.fault_readings()})
        log(f"fault seed {seed}: {json.dumps(faults[-1])}")
    names = list(workload["limits"])
    out = {
        "workload": args.workload, "runs": runs, "controls": controls, "faults": faults,
        "program_max": {k: max((r["compared"][k] for r in runs), default=None) for k in names},
        "control_min": {k: min((c["compared"][k] for c in controls), default=None) for k in names},
        "fault_min": {k: min((c["compared"][k] for c in faults), default=None) for k in names},
        "limits": workload["limits"],
    }
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

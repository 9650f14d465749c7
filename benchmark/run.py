"""Run one cell of `BENCHMARK.json` once on the card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It loads the cell's configuration and traffic mix (files found by name,
`harness/cells.py`), makes the inputs and weights from `--seed`, warms up
(counted in `setup_s`), measures for `--seconds`, checks the outputs
against the plain reference, and prints one JSON line: with `--trace 0`
the cell's end-to-end metrics, with `--trace 1` its per-layer metrics
(each read by `metrics/<name>.py` from a profiled slice after the window),
the device, and the numbers compared with their limits. It exits non-zero
without a result when it finds no card or fewer than the cell asks for,
and when a JAX module was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
for path in (str(ROOT), str(BENCH_DIR)):
    if path not in sys.path:
        sys.path.insert(0, path)

from harness.common import (NoDevice, emit, forbidden_modules, judge,  # noqa: E402
                            require_cards, set_environment)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def measure(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
            fault=None):
    """Run the cell's driver (by its traffic's `mode`) -> `Outcome`."""
    from harness import serve, train

    drivers = {"train": train.run, "serve": serve.run}
    return drivers[cell.traffic["mode"]](cell, seed, seconds, trace, device, t_start, fault)


def layer_metrics(cell, ctx) -> dict:
    """Each per-layer metric of the cell that its reader finds (None: left out)."""
    from harness.cells import metric_reader

    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(cell, outcome, trace: bool, kind: str, count: int) -> tuple:
    correct, table = judge(outcome.checks, cell.limits)
    if trace:
        metrics = layer_metrics(cell, outcome.layer_ctx)
    else:
        metrics = {m["name"]: {"value": outcome.end_to_end[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = {"platform": "gpu", "kind": kind, "count": count,
              "memory_peak_bytes": outcome.memory_peak_bytes}
    result = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed,
              "metrics": metrics, "device": device}
    if trace:
        device.update(busy_s=outcome.busy_s, window_s=outcome.window_s)
        result["breakdown"] = outcome.breakdown
    return result, table


def power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unknown ({e})"


def main(argv=None) -> int:
    args = parse(argv)
    set_environment(ROOT)
    from harness.cells import load_bench, resolve

    cell = resolve(load_bench(ROOT), args.workload)
    try:
        require_cards(cell.chips)
    except NoDevice as e:
        print(f"error: {e}", file=sys.stderr)
        return 3
    import torch

    outcome = measure(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda:0"),
                      T_START)
    found = forbidden_modules()
    if found:
        print(f"error: JAX modules were loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    if args.trace:
        print(f"card: {power_limit()}", file=sys.stderr)
    result, table = result_line(cell, outcome, bool(args.trace),
                                torch.cuda.get_device_name(0), cell.chips)
    emit(result, table)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""A cell of `BENCHMARK.json` resolved to its files, found by name:

- the configuration: `configs[].file` (a JSON object with the family, the
  reference YAML tree as it is run and the compute type);
- the traffic mix: `traffic/<traffic>.json`;
- the limits of the numbers `correct` compares: `limits/<cell>.json`;
- each per-layer metric's reader: `metrics/<name>.py`, a module with
  `read(ctx) -> float | None`;
- the family's frozen reference: `reference/<family>.py`.

Adding a cell, a mix or a metric is adding files and entries; nothing here
names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]       # the configuration file's object
    config_entry: Dict[str, Any]  # its entry in BENCHMARK.json
    traffic_name: str
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]  # the end-to-end metrics this cell reports
    per_layer: List[Dict[str, Any]]   # the per-layer metrics this cell reports


def load_bench(root: Path = ROOT) -> Dict[str, Any]:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"{path}: no BENCHMARK.json at the checkout's root")
    return json.loads(path.read_text())


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(bench: Dict[str, Any], workload: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell named `workload`, its files read."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    root = bench_dir.parent
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    limits_path = bench_dir / "limits" / f"{workload}.json"
    limits = json.loads(limits_path.read_text()) if limits_path.exists() else {}
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, workload) and m["moves"] in moved]
    return Cell(workload, int(w["chips"]), config, entry, w["traffic"], traffic,
                {k: float(v) for k, v in limits.items() if not k.startswith("_")}, e2e, layer)


def _load_file(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: Path = BENCH_DIR) -> Callable[[Any], Optional[float]]:
    """`metrics/<name>.py`'s `read`."""
    path = bench_dir / "metrics" / f"{name}.py"
    return _load_file(path, "bench_metric_" + re.sub(r"\W", "_", name)).read


def reference_family(family: str):
    """`reference/<family>.py` as a module (`build`)."""
    return importlib.import_module(f"reference.{family}")

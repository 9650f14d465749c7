"""The harness: every cell resolves to its files, names and units keep to
the allowed characters, a cell added as new files is found without an
edit, the no-JAX check compares whole top-level names, a run without a
card prints no result, and a tiny run on the CPU is correct while each
fault planted in the timed path makes it not correct."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

import run as run_mod
from harness import cells
from harness.common import forbidden_modules, judge
from tiny import tiny_cell

BENCH = cells.BENCH_DIR
ROOT = cells.ROOT
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]


def test_top_level_keys_and_entries():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs", "workloads",
                              "end_to_end", "per_layer"}
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in BENCHMARK["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"}
               for w in BENCHMARK["workloads"])
    for m in BENCHMARK["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCHMARK["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert any(m["name"] == "setup_s" for m in BENCHMARK["end_to_end"])


def test_names_units_and_lines():
    named = (BENCHMARK["configs"] + BENCHMARK["workloads"] + BENCHMARK["end_to_end"]
             + BENCHMARK["per_layer"])
    names = [x["name"] for x in named]
    assert all(cells.NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    assert all(cells.NAME.match(w["traffic"]) and cells.NAME.match(w["config"])
               for w in BENCHMARK["workloads"])
    assert all(cells.UNIT.match(m["unit"]) for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"])
    texts = [x["why"] for x in BENCHMARK["configs"] + BENCHMARK["workloads"]]
    texts += [c["source"] for c in BENCHMARK["configs"]] + [m["layer"] for m in BENCHMARK["per_layer"]]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_to_its_files(name):
    cell = cells.resolve(BENCHMARK, name)
    assert cell.config["family"] in ("ff_raft", "ff_flowformer")
    assert cells.reference_family(cell.config["family"]).build
    assert cell.traffic["mode"] in ("train", "serve")
    assert cell.limits, f"limits/{name}.json holds no limit"
    core = {"train": {"aug_gap", "loss_gap", "grad_gap", "update_gap"}, "serve": {"flow_gap"}}
    assert core[cell.traffic["mode"]] <= set(cell.limits)
    assert any(m["name"] == "setup_s" for m in cell.end_to_end) and len(cell.end_to_end) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(cells.metric_reader(m["name"]))
    moved = {m["name"] for m in cell.end_to_end}
    for m in BENCHMARK["per_layer"]:
        if name in m.get("workloads", ()):
            assert m["moves"] in moved


def test_a_cell_added_as_new_files_is_found(tmp_path):
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench_dir, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (bench_dir / "traffic" / "serve.sintel_b1.json").write_text(json.dumps(
        dict(json.loads((BENCH / "traffic" / "serve.sintel_b4.json").read_text()), batch=1)))
    (bench_dir / "limits" / "ff_raft.serve.sintel_b1.json").write_text('{"flow_gap": 0.1}')
    (bench_dir / "metrics" / "requests.serve.py").write_text(
        "def read(ctx):\n    return float(ctx.window_steps)\n")
    bench = json.loads(json.dumps(BENCHMARK))
    bench["workloads"].append({"name": "ff_raft.serve.sintel_b1", "config": "ff_raft",
                               "traffic": "serve.sintel_b1", "chips": 1, "why": "one pair"})
    bench["per_layer"].append({"name": "requests.serve", "unit": "requests", "better": "higher",
                               "source": "program_counter", "layer": "Entry",
                               "moves": "serve_pairs_per_s"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "ff_raft.serve.sintel_b4" in m["workloads"]:
            m["workloads"].append("ff_raft.serve.sintel_b1")
    cell = cells.resolve(bench, "ff_raft.serve.sintel_b1", bench_dir=bench_dir)
    assert cell.traffic["batch"] == 1 and cell.limits == {"flow_gap": 0.1}
    assert "requests.serve" in [m["name"] for m in cell.per_layer]
    reader = cells.metric_reader("requests.serve", bench_dir=bench_dir)
    assert reader(type("Ctx", (), {"window_steps": 7})()) == 7.0


def test_no_jax_check_compares_whole_top_level_names():
    assert forbidden_modules(["jax.numpy", "numpy", "focusflow_official_tpu.ops",
                              "focusflow_official_tpu_torch.ops", "jaxtyping", "flax.linen",
                              "optax", "orbax.checkpoint", "jaxlib.xla_client"]) == [
        "flax", "focusflow_official_tpu", "jax", "jaxlib", "optax", "orbax"]
    assert forbidden_modules(["focusflow_official_tpu_torch", "torch"]) == []


def test_judge_needs_every_number_under_its_limit():
    assert judge({"a": 1.0, "b": 0.0}, {"a": 1.0, "b": 0.0})[0]
    assert not judge({"a": 1.5}, {"a": 1.0})[0]
    assert not judge({"a": 1.0}, {})[0]
    assert not judge({"a": float("nan")}, {"a": 1.0})[0]
    assert not judge({}, {})[0]


def _run(cwd, *args):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run(ROOT, "--workload", CELLS[0], "--seed", "2200000011", "--seconds", "1",
             "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path, "--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == ""


def _tiny_run(name, fault=None, trace=False):
    cell = tiny_cell(name)
    out = run_mod.measure(cell, 2200000021, 0.5, trace, torch.device("cpu"), 0.0, fault)
    return cell, out, judge(out.checks, cell.limits)


@pytest.mark.parametrize("name", CELLS)
def test_tiny_run_is_correct(name):
    cell, out, (correct, table) = _tiny_run(name, trace=True)
    assert correct, table
    assert out.attempted >= 1 and out.failed == 0
    assert set(out.end_to_end) == {m["name"] for m in cell.end_to_end}
    assert out.layer_ctx.flops_per_step > 0
    if cell.traffic["mode"] == "serve":  # timed apart from the profiled slice
        assert len(out.layer_ctx.host_s["enqueue"]) == cell.traffic["trace_requests"]


FAULTS = {"serve": ["answer"], "train": ["half_batch", "unchanged"]}


@pytest.mark.parametrize("name,fault", [(c, f) for c in CELLS
                                        for f in FAULTS[cells.resolve(BENCHMARK, c).traffic["mode"]]])
def test_a_fault_in_the_timed_path_is_not_correct(name, fault):
    _, _, (correct, table) = _tiny_run(name, fault)
    assert not correct, table

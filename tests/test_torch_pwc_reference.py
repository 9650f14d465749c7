"""The benchmark's plain reference for FF-PWCNet
(`benchmark/reference/ff_pwcnet.py`, `frozen/pwc.py`) on the CPU, in f32:

- it imports neither the port nor JAX;
- the port's FF-PWCNet equals it on the same seeded weights, at the model
  level (the five levels' flows and the flow) and through the harness's
  serving path on a shrunk copy of the cell `ff_pwcnet_kitti.serve.4k`, at
  64x128 (a multiple of 64) and at 72x136 (resized to 128x192 inside and
  back);
- the port in bf16 is correct under the cell's `flow_gap` limit, the fp8
  control parts from the reference many times farther, and the `answer`
  fault reads over the limit;
- the cell resolves to its files, and its configuration file is the
  published YAML as run.

With seeded weights this family's flows are hundredths of a pixel to half
a pixel, where the harness's `flow_gap` is an absolute end-point error: the
limit is set from the card's readings at 4K (PERF.md), and at the sizes
here the fp8 control reads under it, so the test holds the control to a
multiple of bf16's gap on the same sample instead.

Tolerance: the two sides part by rounding alone. The port warps by
gathers at pixel coordinates, the reference by `F.grid_sample` on the
published normalised grid (the same bilinear taps from coordinates rounded
another way), and both sum the convolutions' products in another order;
with seeded weights the flows are a few hundredths of a pixel, and the
sides part by under 1e-7 px (measured: 6e-8), so 1e-6 of the larger of 1
and the largest value holds them with room.
"""

import copy
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import serve  # noqa: E402
from harness.cells import load_bench, reference_family, resolve  # noqa: E402
from harness.common import judge  # noqa: E402
from harness.weights import seeded_state  # noqa: E402

ROOT = BENCH.parent
CELL = "ff_pwcnet_kitti.serve.4k"
SEED = 2600000026
TOL = 1e-6
SIZES = [(64, 128), (72, 136)]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs its files in parallel worker
    processes."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _cell(height: int, width: int, compute_dtype: str = "float32"):
    """The cell at one pair of `height` x `width` in `compute_dtype`,
    one-request pools."""
    cell = copy.deepcopy(resolve(load_bench(), CELL))
    cell.config["compute_dtype"] = compute_dtype
    cell.traffic.update(batch=1, height=height, width=width, pool_requests=1,
                        warmup_requests=1, trace_requests=1, check_requests=1)
    return cell


def _close(got, want):
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= TOL * scale


def test_reference_imports_neither_the_port_nor_jax():
    code = ("import sys; sys.path.insert(0, %r); import reference.ff_pwcnet; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd="/", timeout=120, check=True).stdout
    assert not {"focusflow_official_tpu_torch", "focusflow_official_tpu", "jax", "flax",
                "harness"} & set(eval(out))


@pytest.mark.parametrize("height,width", SIZES)
def test_the_model_equals_the_reference(height, width):
    from focusflow_official_tpu_torch.models import FFPWCNet, FFPWCNetConfig

    cell = _cell(height, width)
    model = FFPWCNet(FFPWCNetConfig())
    state = seeded_state(model.state_dict(), SEED, "cpu")
    ref = reference_family("ff_pwcnet").build(cell.config["yaml"])
    assert set(state) == set(ref.state_dict())
    model.load_state_dict(state)
    ref.load_state_dict(state)
    inputs = [torch.as_tensor(a) for a in serve.make_pool(cell.traffic, SEED, "cpu")[0]]
    with torch.no_grad():
        flow, levels = model.eval()(*inputs)
        want_levels, want = ref.eval()(*inputs)
    assert flow.shape == want.shape == (1, height, width, 2)
    assert [t.shape for t in levels] == [t.shape for t in want_levels]
    assert len(levels) == 5 and levels[0].shape[1:3] == ((height + 63) // 64 * 16,
                                                          (width + 63) // 64 * 16)
    for got, ref_flow in zip([flow, *levels], [want, *want_levels]):
        _close(got, ref_flow)


@pytest.mark.parametrize("height,width", SIZES)
def test_the_served_flow_equals_the_reference(height, width):
    cell = _cell(height, width)
    p, state = serve.build_predictor(cell.config, SEED, "cpu")
    assert type(p.model).__name__ == "FFPWCNet" and p.iters is None
    pool = serve.make_pool(cell.traffic, SEED, "cpu")
    got = p(*pool[0])
    want = serve.reference_flows(cell.config, state, [pool[0]], "cpu")[0]
    assert got.shape == want.shape == (1, height, width, 2)
    assert serve.flow_gap(got, want) < TOL


def test_bf16_is_correct_and_the_answer_fault_and_the_fp8_control_are_caught():
    """At 128x192 in the configuration's bf16 (seeded flows of about
    0.03 px): the program parts from the reference by rounding alone, under
    the cell's limit; the fp8 control many times farther (held at 4 x;
    12-21 x measured on six seeds, 15 x on this one; at this size it reads
    about 1e-3, under the limit set from the 4K readings, so the multiple
    is what is held here); and the `answer` fault, which moves the flow by
    1 px on each axis, reads sqrt(2) px over 1 px plus the mean flow: over
    the limit, hundreds of times the control."""
    cell = _cell(128, 192, "bfloat16")
    p, state = serve.build_predictor(cell.config, SEED, "cpu")
    pool = serve.make_pool(cell.traffic, SEED, "cpu")
    want = serve.reference_flows(cell.config, state, [pool[0]], "cpu")[0]
    gap = serve.flow_gap(p(*pool[0]), want)
    correct, table = judge({"flow_gap": gap}, cell.limits)
    assert correct, table
    low = serve.flow_gap(
        serve.reference_flows(cell.config, state, [pool[0]], "cpu", lower=True)[0], want)
    assert 0 < 4 * gap < low
    serve._plant(p, "answer")
    fault = serve.flow_gap(p(*pool[0]), want)
    correct, table = judge({"flow_gap": fault}, cell.limits)
    assert not correct and fault > max(1.0, 100 * low), table


def test_the_cell_resolves_to_its_files():
    cell = resolve(load_bench(), CELL)
    assert cell.chips == 1 and cell.traffic_name == "serve.4k"
    assert cell.config_entry["file"] == "benchmark/configs/ff_pwcnet_kitti.json"
    assert cell.config_entry["reduced"] == []
    assert set(cell.limits) == {"flow_gap"} and 0 < cell.limits["flow_gap"] < 0.01
    traffic = json.loads((BENCH / "traffic" / "serve.4k.json").read_text())
    assert cell.traffic == traffic
    reported = {m["name"] for m in cell.per_layer}
    assert {f"pwc_{n}_ms.serve" for n in ("warp", "corr", "dense", "context")} <= reported
    assert {"encode_ms.serve", "refine_ms.serve", "copy_ms.serve", "kernels_roofline.serve",
            "mfu.serve"} <= reported
    assert not {n for n in reported if n.startswith(("corr_", "cost_"))}
    for name in reported:
        assert (BENCH / "metrics" / f"{name}.py").exists(), name


def test_the_configuration_is_the_published_yaml_as_run():
    import yaml

    config = resolve(load_bench(), CELL).config
    published = yaml.safe_load((ROOT / "configs" / "ff-pwcnet" / "ffpwc_kitti.yaml").read_text())
    assert config["yaml"] == published
    assert config["family"] == "ff_pwcnet" and config["compute_dtype"] == "bfloat16"
    assert config["reduced"] == [] and config["yaml_source"] == "configs/ff-pwcnet/ffpwc_kitti.yaml"
    assert type(reference_family(config["family"]).build(config["yaml"])).__name__ == "FFPWCNet"

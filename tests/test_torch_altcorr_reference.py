"""The benchmark's plain reference for FF-RAFT with ALT_CORR
(`benchmark/reference/ff_raft_altcorr.py`, `frozen/alt_corr.py`) on the
CPU, in f32:

- it imports neither the port nor JAX;
- its correlation (RAFT's alternate correlation: fmap2 pooled, the window
  sampled from each level and dotted with fmap1) and its whole forward
  equal the frozen materialized reference (`frozen/raft.py`: the volume,
  its pyramid, the lookup) on the same seeded weights, at chunks that
  divide the 96 queries of a 64x96 pair and at one that leaves a tail;
- the port's FF-RAFT with ALT_CORR equals it, through the harness's
  serving path on a shrunk copy of the cell `ff_raft_altcorr.serve.4k` and
  at the model level with 40-query chunks;
- the `answer` fault and the fp8 control read over the cell's `flow_gap`
  limit.

Tolerances: f32 sums in another order (the pooled features against the
pooled products, the window against the volume's lookup) part by rounding
alone, 1e-5 of the larger of 1 and the largest value.
"""

import copy
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
from reference.frozen.alt_corr import AlternateCorrBlock  # noqa: E402
from reference.frozen.corr import all_pairs_corr, corr_pyramid  # noqa: E402
from reference.frozen.plain import lookup_plain  # noqa: E402

CELL = "ff_raft_altcorr.serve.4k"
SEED = 2200000022
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs its files in parallel worker
    processes."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _cell(iters: int = 2, height: int = 64, width: int = 96):
    """The cell in f32 at one pair of `height` x `width`, `iters`
    refinements, one-request pools."""
    cell = copy.deepcopy(resolve(load_bench(), CELL))
    cell.config["compute_dtype"] = "float32"
    cell.config["yaml"]["MODEL"]["ITERS"] = iters
    cell.traffic.update(batch=1, height=height, width=width, pool_requests=1,
                        warmup_requests=1, trace_requests=1, check_requests=1)
    return cell


def _close(got, want):
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= TOL * scale


def test_reference_imports_neither_the_port_nor_jax():
    code = ("import sys; sys.path.insert(0, %r); import reference.ff_raft_altcorr; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd="/", timeout=120, check=True).stdout
    assert not {"focusflow_official_tpu_torch", "focusflow_official_tpu", "jax", "flax",
                "harness"} & set(eval(out))


@pytest.mark.parametrize("chunk", [32, 48, 40])
def test_the_correlation_equals_the_volume_lookup(chunk):
    g = torch.Generator().manual_seed(3)
    b, h, w, c = 2, 8, 12, 256
    f1, f2 = (torch.randn(b, h, w, c, generator=g) for _ in range(2))
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    # displacements up to 6 cells: windows that reach past every edge
    coords = torch.stack([xs, ys], -1)[None] + 6 * (2 * torch.rand(b, h, w, 2, generator=g) - 1)
    got = AlternateCorrBlock(f1, f2, 4, 4, chunk)(coords)
    want = lookup_plain(corr_pyramid(all_pairs_corr(f1, f2), 4), coords, 4)
    assert got.shape == want.shape == (b, h, w, 4 * 81)
    _close(got, want)


@pytest.mark.parametrize("chunk", [32, 48, 40])
def test_the_forward_equals_the_materialized_reference(chunk):
    cell = _cell(iters=3)
    y = cell.config["yaml"]
    alt = reference_family("ff_raft_altcorr").build(y)
    flat = copy.deepcopy(y)
    flat["MODEL"]["ALT_CORR"] = False
    mat = reference_family("ff_raft").build(flat)
    state = seeded_state(mat.state_dict(), SEED, "cpu")
    assert set(state) == set(alt.state_dict())
    alt.flow_net.chunk = chunk
    for m in (alt, mat):
        m.load_state_dict(state)
        m.eval()
    inputs = [torch.as_tensor(a) for a in serve.make_pool(cell.traffic, SEED, "cpu")[0]]
    with torch.no_grad():
        got, want = alt(*inputs), mat(*inputs)
    assert got[1].shape == want[1].shape == (1, 64, 96, 2)
    for a, b in zip(got, want):
        _close(a, b)


def test_the_served_flow_equals_the_reference():
    cell = _cell()
    p, state = serve.build_predictor(cell.config, SEED, "cpu")
    assert p.model.flow_net.alt_corr
    pool = serve.make_pool(cell.traffic, SEED, "cpu")
    got = p(*pool[0])
    want = serve.reference_flows(cell.config, state, [pool[0]], "cpu")[0]
    assert got.shape == want.shape == (1, 64, 96, 2)
    assert serve.flow_gap(got, want) < TOL


def test_the_model_in_chunks_of_40_equals_the_reference():
    from focusflow_official_tpu_torch.models import FFRaft, FFRaftConfig

    cell = _cell()
    model = FFRaft(FFRaftConfig(alt_corr=True, alt_corr_chunk=40, fuse_cnet=True, iters=2))
    state = seeded_state(model.state_dict(), SEED, "cpu")
    model.load_state_dict(state)
    ref = reference_family("ff_raft_altcorr").build(cell.config["yaml"])
    ref.load_state_dict(state)
    ref.flow_net.chunk = 40
    inputs = [torch.as_tensor(a) for a in serve.make_pool(cell.traffic, SEED, "cpu")[0]]
    with torch.no_grad():
        got = model.eval()(*inputs)[1]
        want = ref.eval()(*inputs)[1]
    assert serve.flow_gap(got.numpy(), want.numpy()) < TOL


def test_the_answer_fault_and_the_fp8_control_are_not_correct():
    """At the cell's 12 refinements on a 96x160 pair (the card's readings
    at 4K are `readings.py`'s)."""
    cell = _cell(iters=12, height=96, width=160)
    p, state = serve.build_predictor(cell.config, SEED, "cpu")
    serve._plant(p, "answer")
    pool = serve.make_pool(cell.traffic, SEED, "cpu")
    shifted = p(*pool[0])
    want = serve.reference_flows(cell.config, state, [pool[0]], "cpu")[0]
    low = serve.reference_flows(cell.config, state, [pool[0]], "cpu", lower=True)[0]
    for got in (shifted, low):
        correct, table = judge({"flow_gap": serve.flow_gap(got, want)}, cell.limits)
        assert not correct, table

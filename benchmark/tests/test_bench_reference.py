"""The frozen reference against the port at a tiny size on the CPU, where
the port runs its kernels' plain versions: the same forward and the same
training step. The reference imports nothing of the port and nothing of
JAX. The control (the reference in fp8) comes out not correct under each
cell's limits, at the tiny size; its readings at the cells' own sizes are
taken on the card (`readings.py`)."""

import subprocess
import sys

import pytest
import torch

from harness import serve, train
from harness.cells import BENCH_DIR, ROOT, reference_family
from harness.common import judge
from harness.weights import seeded_state
from tiny import control_cell, tiny_cell

SERVE = ["ff_raft.serve.sintel_b4", "ff_flowformer.serve.sintel_b4"]
TRAIN = ["ff_raft.train.chairs", "ff_flowformer.train.chairs"]
SEED = 2200000031


def test_reference_imports_neither_the_port_nor_jax():
    code = ("import sys; sys.path.insert(0, %r); import reference.ff_raft, "
            "reference.ff_flowformer, reference.train_step, reference.lowp; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(BENCH_DIR))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd="/", timeout=120, check=True).stdout
    tops = eval(out)
    assert not {"focusflow_official_tpu_torch", "focusflow_official_tpu", "jax", "flax",
                "harness"} & set(tops)


@pytest.mark.parametrize("name", SERVE)
def test_forward_equals_the_port(name):
    cell = tiny_cell(name)
    p, state = serve.build_predictor(cell.config, SEED, "cpu")
    pool = serve.make_pool(cell.traffic, SEED, "cpu")
    got = p(*pool[0])
    want = serve.reference_flows(cell.config, state, [pool[0]], "cpu")[0]
    assert got.shape == want.shape == (2, 60, 90, 2)
    assert serve.flow_gap(got, want) < 1e-5


@pytest.mark.parametrize("name", TRAIN)
def test_training_steps_equal_the_port(name):
    cell = tiny_cell(name)
    p, rec = train.setup(cell.config, cell.traffic, SEED, "cpu")
    ref = train.reference_steps(cell.config, cell.traffic, rec, "cpu")
    got = train.compare(rec, ref)
    # the f32 reference augmentor is the port's, to the bit; the f64 one that
    # `aug_gap` reads parts from it by the f32 rounding of 0..255 values
    # (the masks' 0 and 255 through the warp's weights) alone
    assert train.compare_augmented(rec["augmented"], ref[0]) == 0.0
    assert 0.0 < got["aug_gap"] < 1e-2
    # the first step's loss and gradient are the port's to rounding; Adam's update of
    # rounding-sized gradients parts the later steps by a little more
    assert got["grad_gap"] < 1e-5
    assert got["loss_gap"] < 1e-3 and got["update_gap"] < 2e-2


def test_seeded_weights_repeat_and_differ_by_seed():
    cell = tiny_cell(SERVE[0])
    model = reference_family("ff_raft").build(cell.config["yaml"])
    a = seeded_state(model.state_dict(), 7, "cpu")
    b = seeded_state(model.state_dict(), 7, "cpu")
    c = seeded_state(model.state_dict(), 8, "cpu")
    k = "flow_net.update_block.gru.convz1.weight"
    assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
    assert a["flow_net.update_block.gru.convz1.bias"].abs().sum() == 0
    fan_in = a[k][0].numel()
    assert a[k].std().item() == pytest.approx(0.5 * fan_in ** -0.5, rel=0.05)


@pytest.mark.parametrize("name", SERVE)
def test_the_fp8_control_is_not_correct_serving(name):
    cell = control_cell(name)
    _, state = serve.build_predictor(cell.config, SEED, "cpu")
    pool = serve.make_pool(cell.traffic, SEED, "cpu")
    want = serve.reference_flows(cell.config, state, [pool[0]], "cpu")[0]
    low = serve.reference_flows(cell.config, state, [pool[0]], "cpu", lower=True)[0]
    correct, table = judge({"flow_gap": serve.flow_gap(low, want)}, cell.limits)
    assert not correct, table


@pytest.mark.parametrize("name", TRAIN)
def test_the_fp8_control_is_not_correct_training(name):
    cell = control_cell(name)
    _, rec = train.setup(cell.config, cell.traffic, SEED, "cpu")
    ref = train.reference_steps(cell.config, cell.traffic, rec, "cpu")
    batches, losses, grads, changes, _ = train.reference_steps(cell.config, cell.traffic, rec,
                                                               "cpu", lower=True)
    low = dict(rec, augmented=batches, losses=losses, grads=grads, changes=changes)
    correct, table = judge(train.compared(train.compare(low, ref), cell.limits), cell.limits)
    assert not correct, table


@pytest.mark.cuda
@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_readings_on_the_card(name, card):
    """The program's and the control's readings of one seed on the card
    (the full set is `readings.py`'s)."""
    out = subprocess.run([sys.executable, str(BENCH_DIR / "readings.py"), "--workload", name,
                          "--seeds", str(SEED), "--control", str(SEED)],
                         capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]

"""Query sharding of FF-RAFT's correlation volume (`train/mesh.py`:
`make_mesh` with a model axis, `spatial_sharding`, `shard_queries`;
`ops/corr.py::ShardedCorr`) on the CPU over gloo, against the unsharded
port and the JAX package's unsharded functions.

Six processes (this file run as a script, `_worker`): a group of two
ranks (model extent 2) and a group of four (model extent 4, and the data
x model hybrid, data 2 x model 2), each joined through a `file://` store
with a timeout of its own, one thread each; the parent waits for them
under a deadline and kills them past it, so a hang fails the tests
instead of stalling the suite. The workers import no JAX.

- The sharded lookup + convc1 (kernel G's plain version on each rank's
  block of query rows, then the gather over the model group) at extents
  2 and 4, on a level-0 grid of 8x12 queries and on one of 9x15 (135
  queries, which neither extent divides), against the unsharded port and
  against JAX's `lookup_corr_fused(all_pairs_corr(...))` followed by
  convc1: 1e-5, the bound of JAX's `test_sharded_fused_lookup_exact`.
- FlowPredictor's forward on the trained fixture (`trained_smoke.npz`),
  f32, 96x128, 6 refinements: at extent 2 on two samples, and in the
  hybrid on four (each data rank its two rows), against the port's
  unsharded forward (1e-5) and JAX's unsharded forward (atol 5e-3, rtol
  1e-4, the bound of JAX's `test_hybrid_dp_sp_forward_trained`). Every
  rank returns the whole batch; no rank builds the full volume: each
  product is its block's rows.
- The no-op contract, and the train-mode refusal.
"""

import datetime
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "trained_smoke.npz")
GRIDS = ((8, 12), (9, 15))
WORLDS = (2, 4)
C, OUT, RADIUS, LEVELS = 32, 64, 4, 4
B, H, W, ITERS = 4, 96, 128, 6
DEADLINE_S = 240


def _lookup_inputs(grid):
    """Feature maps (1, h, w, C), coordinates about the grid (1, h, w, 2)
    and a convc1 weight (OUT, 324) and bias, seeded by the grid."""
    h, w = grid
    rng = np.random.RandomState(31 + h)
    f1 = rng.randn(1, h, w, C).astype(np.float32)
    f2 = rng.randn(1, h, w, C).astype(np.float32)
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    coords = (np.stack([gx, gy], -1)[None] + rng.randn(1, h, w, 2) * 3).astype(np.float32)
    k = LEVELS * (2 * RADIUS + 1) ** 2
    wc = (rng.randn(OUT, k) * 0.05).astype(np.float32)
    bias = (rng.randn(OUT) * 0.1).astype(np.float32)
    return f1, f2, coords, wc, bias


def _conv(wc, bias):
    conv = torch.nn.Conv2d(wc.shape[1], wc.shape[0], 1)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(wc)[:, :, None, None])
        conv.bias.copy_(torch.from_numpy(bias))
    return conv


def _port_lookup(grid, mesh=None):
    """The port's lookup + convc1 on `grid`'s inputs: unsharded, or inside
    `spatial_sharding(mesh)` on this rank's rows -> (1, h, w, OUT), and
    the rows each level holds."""
    from focusflow_official_tpu_torch.ops.corr import (
        ShardedCorr, all_pairs_corr, corr_pyramid, corr_rows, lookup_convc1)
    from focusflow_official_tpu_torch.train.mesh import (
        query_block, shard_queries, spatial_sharding)

    f1, f2, coords, wc, bias = map(torch.from_numpy, _lookup_inputs(grid))
    conv = _conv(wc.numpy(), bias.numpy())
    with torch.no_grad():
        if mesh is None:
            corr = corr_pyramid(all_pairs_corr(f1, f2), LEVELS)
        else:
            with spatial_sharding(mesh):
                q = grid[0] * grid[1]
                rows = shard_queries(f1.reshape(1, q, C), axis=1)
                corr = ShardedCorr(corr_pyramid(corr_rows(rows, f2), LEVELS),
                                   query_block(q, mesh), mesh.model_group)
        out = lookup_convc1(corr, coords, RADIUS, conv)
    levels = corr.levels if mesh is not None else corr
    return out, [lv.shape[1] for lv in levels]


def _forward_inputs():
    rng = np.random.RandomState(7)
    return (
        (rng.rand(B, H, W, 3) * 255).astype(np.float32),
        (rng.rand(B, H, W, 3) * 255).astype(np.float32),
        ((rng.rand(B, H, W, 1) > 0.97) * 255).astype(np.float32),
        ((rng.rand(B, H, W, 1) > 0.97) * 255).astype(np.float32),
    )


def _cfg():
    from focusflow_official_tpu_torch.models import FFRaftConfig

    return FFRaftConfig(fusion="parallel", fusion_type="1x1conv", fuse_cnet=True,
                        compute_dtype="float32")


def _port_flow(batch: int, mesh=None):
    """FlowPredictor's forward on the first `batch` samples -> (flow, the
    query rows of every volume product a rank computed)."""
    import focusflow_official_tpu_torch.models.ff_raft as ff_raft
    from focusflow_official_tpu_torch.predict import FlowPredictor

    p = FlowPredictor(_cfg(), FIXTURE, device="cpu", iters=ITERS, mesh=mesh)
    products = []
    corr_rows, all_pairs = ff_raft.corr_rows, ff_raft.all_pairs_corr

    def rows(f1, f2):
        products.append(f1.shape[1])
        return corr_rows(f1, f2)

    def full(f1, f2):
        products.append(f1.shape[1] * f1.shape[2])
        return all_pairs(f1, f2)

    ff_raft.corr_rows, ff_raft.all_pairs_corr = rows, full
    try:
        with torch.no_grad():
            flow = p.forward(*(torch.from_numpy(a[:batch]) for a in _forward_inputs()))[0]
    finally:
        ff_raft.corr_rows, ff_raft.all_pairs_corr = corr_rows, all_pairs
    return flow, products


def _worker(world: int, rank: int, store: str, out_path: str) -> None:
    import torch.distributed as dist

    from focusflow_official_tpu_torch.train.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh("cpu", model_axis=world)
        out = dict(axes=(mesh.data, mesh.data_rank, mesh.model, mesh.model_rank),
                   lookup={grid: _port_lookup(grid, mesh) for grid in GRIDS})
        if world == 2:
            out["forward"] = _port_flow(2, mesh)
        else:
            hybrid = make_mesh("cpu", model_axis=2)
            out["hybrid_axes"] = (hybrid.data, hybrid.data_rank, hybrid.model,
                                  hybrid.model_rank)
            out["hybrid_data_sum"] = float(hybrid.global_sum(torch.tensor([float(rank)])))
            out["forward"] = _port_flow(B, hybrid)
        torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The six processes; they start before the one-process references are
    computed here and are waited for after."""
    out = tmp_path_factory.mktemp("spatial")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = {}
    for world in WORLDS:
        for r in range(world):
            with open(out / f"w{world}r{r}.log", "wb") as log:
                procs[world, r] = subprocess.Popen(
                    [sys.executable, __file__, str(world), str(r), str(out / f"store{world}"),
                     str(out / f"w{world}r{r}.pt")],
                    env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    yield procs, out
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def one_process(ranks):
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return dict(lookup={grid: _port_lookup(grid)[0] for grid in GRIDS},
                    forward=_port_flow(B))
    finally:
        torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def results(ranks, one_process):
    procs, out = ranks
    t_end = time.monotonic() + DEADLINE_S
    for p in procs.values():
        try:
            p.wait(timeout=max(1.0, t_end - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            pytest.fail(f"the ranks did not finish within {DEADLINE_S} s")
    for (world, r), p in procs.items():
        log = (out / f"w{world}r{r}.log").read_text()[-4000:]
        assert p.returncode == 0, f"rank {r} of {world} exited {p.returncode}:\n{log}"
    return {key: torch.load(out / f"w{key[0]}r{key[1]}.pt", weights_only=False)
            for key in procs}


def test_shard_queries_noop_outside_context():
    from focusflow_official_tpu_torch.train.mesh import Mesh, shard_queries, spatial_sharding

    x = torch.ones((1, 16, 4, 4))
    assert shard_queries(x) is x
    with spatial_sharding(Mesh(0, 1, torch.device("cpu"))):
        assert shard_queries(x) is x
    # the mesh's data and model indices: the model axis is the fastest
    mesh = Mesh(5, 8, torch.device("cpu"), model=2)
    assert (mesh.data, mesh.data_rank, mesh.model_rank) == (4, 2, 1)


def test_predictor_at_model_extent_one_is_unsharded():
    """A predictor given a one-rank mesh (model extent 1) runs the forward
    it runs without one."""
    import torch.distributed as dist

    from focusflow_official_tpu_torch.train.mesh import Mesh

    want, products = _port_flow(1)
    assert products == [(H // 8) * (W // 8)] and not dist.is_initialized()
    got, _ = _port_flow(1, Mesh(0, 1, torch.device("cpu")))
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1, 7, 63, 96, 135, 7040])
@pytest.mark.parametrize("model", [1, 2, 3, 4])
def test_query_blocks_are_tensor_splits_blocks(n, model):
    from focusflow_official_tpu_torch.train.mesh import Mesh, query_block

    x = torch.arange(n)
    parts = torch.tensor_split(x, model)
    for i, part in enumerate(parts):
        blk = query_block(n, Mesh(i, model, torch.device("cpu"), model=model))
        assert torch.equal(x[blk], part)
    assert max(len(p) for p in parts) - min(len(p) for p in parts) <= 1


def test_train_mode_refuses_sharding():
    """A train-mode forward inside `spatial_sharding` with a model extent
    above 1 raises, naming the ROADMAP item; it does so before any
    collective, so no process group is needed."""
    from focusflow_official_tpu_torch.models import FFRaft
    from focusflow_official_tpu_torch.train.mesh import Mesh, spatial_sharding

    model = FFRaft(_cfg()).train()
    x = torch.zeros((1, 64, 64, 3))
    m = torch.zeros((1, 64, 64, 1))
    with spatial_sharding(Mesh(0, 2, torch.device("cpu"), model=2)):
        with pytest.raises(NotImplementedError, match="Query sharding in training"):
            model(x, x, m, m, iters=1)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_axes(results, world):
    for r in range(world):
        assert results[world, r]["axes"] == (1, 0, world, r)
    if world == 4:
        assert [results[4, r]["hybrid_axes"] for r in range(4)] == [
            (2, 0, 2, 0), (2, 0, 2, 1), (2, 1, 2, 0), (2, 1, 2, 1)]
        # the data axis: the ranks of one model index, {0, 2} and {1, 3}
        assert [results[4, r]["hybrid_data_sum"] for r in range(4)] == [2.0, 4.0, 2.0, 4.0]


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_lookup_matches_unsharded_port(results, one_process, world, grid):
    want = one_process["lookup"][grid]
    q = grid[0] * grid[1]
    held = []
    for r in range(world):
        got, rows = results[world, r]["lookup"][grid]
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
        assert len(set(rows)) == 1  # every level holds the block's rows
        held.append(rows[0])
    assert held == [len(p) for p in torch.tensor_split(torch.arange(q), world)]


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_lookup_matches_jax(results, world, grid):
    import jax.numpy as jnp

    from focusflow_official_tpu.ops.corr import all_pairs_corr, lookup_corr_fused

    f1, f2, coords, wc, bias = _lookup_inputs(grid)
    window = np.asarray(lookup_corr_fused(all_pairs_corr(jnp.asarray(f1), jnp.asarray(f2)),
                                          jnp.asarray(coords), RADIUS, LEVELS,
                                          dtype=jnp.float32))
    want = window @ wc.T + bias
    for r in range(world):
        got = results[world, r]["lookup"][grid][0].numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_forward_matches_unsharded_port(results, one_process, world):
    """Extent 2 on two samples, the hybrid on four: every rank returns the
    whole batch's flow, and each rank's volume holds its block of the
    rows (its data rank's samples, half the queries)."""
    want, products = one_process["forward"]
    q = (H // 8) * (W // 8)
    assert products == [q]
    batch = 2 if world == 2 else B
    for r in range(world):
        got, rows = results[world, r]["forward"]
        assert got.shape == (batch, H, W, 2) and torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want[:batch].numpy(), atol=1e-5, rtol=1e-5)
        assert rows == [len(torch.tensor_split(torch.arange(q), 2)[r % 2])]


def test_hybrid_forward_matches_jax(results, one_process, monkeypatch):
    """The data x model hybrid against JAX's unsharded test-mode forward on
    the same weights and inputs (atol 5e-3, rtol 1e-4, as JAX's
    `test_hybrid_dp_sp_forward_trained` holds its hybrid)."""
    for knob in ("FF_CHUNKED_FNET", "FF_PACKED_CCE", "FF_PACKED_CCE_BN", "FF_PACKED_STEM"):
        monkeypatch.setenv(knob, "0")
    import jax.numpy as jnp
    from flax import traverse_util

    from focusflow_official_tpu.models import FFRaft as JFFRaft
    from focusflow_official_tpu.models import FFRaftConfig as JConfig

    with np.load(FIXTURE) as raw:
        v = traverse_util.unflatten_dict(
            {tuple(k.split("/")): jnp.asarray(raw[k], jnp.float32) for k in raw.files})
    jcfg = JConfig(fusion="parallel", fusion_type="1x1conv", fuse_cnet=True,
                   compute_dtype="float32", corr_impl="xla")
    _, want = JFFRaft(jcfg).apply(v, *map(jnp.asarray, _forward_inputs()), iters=ITERS,
                                  test_mode=True)
    want = np.asarray(want)
    for r in range(4):
        np.testing.assert_allclose(results[4, r]["forward"][0].numpy(), want,
                                   atol=5e-3, rtol=1e-4)
    np.testing.assert_allclose(one_process["forward"][0].numpy(), want, atol=5e-3, rtol=1e-4)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])

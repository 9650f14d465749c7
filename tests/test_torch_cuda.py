"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small and ragged shapes. The kernels at the main paths' shapes are
`chip_smoke.py`'s rows; whole paths at those shapes are checked by the
benchmark cells' `correct`. Each test skips where there is no card:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(`--noconftest` where JAX is not installed: the suite's conftest imports
it, and these tests need only the port.)
"""

import math
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from focusflow_official_tpu_torch.kernels import attention as ka
from focusflow_official_tpu_torch.kernels import fold as kf
from focusflow_official_tpu_torch.kernels import instance_norm as kin
from focusflow_official_tpu_torch.kernels import launch_counts, launch_shapes
from focusflow_official_tpu_torch.kernels import layer_norm as kln
from focusflow_official_tpu_torch.kernels import local_corr as klc
from focusflow_official_tpu_torch.kernels import lookup as kl
from focusflow_official_tpu_torch.kernels import lookup_fold as klf
from focusflow_official_tpu_torch.kernels import window_attention as kw
from focusflow_official_tpu_torch.ops.corr import corr_pyramid

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _hard_coords(g, b, h1, w1, span, dev):
    """(B, H1, W1, 2) f32 coordinates of five kinds, mixed per value: the
    largest f32 below (or the least above) an integer at some level's scale,
    uniform over [-40, span + 40] (negative, past every edge of every
    level), 1000 + u and -1000 - u, and uniform inside (as the CPU model's
    test, `test_torch_lookup_patch.py`)."""
    shape = (b, h1, w1, 2)
    scale = 2.0 ** torch.randint(0, 4, shape, generator=g, device=dev)
    ints = (torch.randint(-4, span + 4, shape, generator=g, device=dev) * scale).float()
    below = torch.nextafter(ints, torch.full_like(ints, -math.inf))
    above = torch.nextafter(ints, torch.full_like(ints, math.inf))
    u = torch.rand(shape, generator=g, device=dev)
    wide = u * (span + 80) - 40
    far = torch.where(u < 0.5, 1000 + 2 * u, -1000 - 2 * u + 1)
    inside = u * span
    kind = torch.randint(0, 5, shape, generator=g, device=dev)
    out = torch.stack([below, above, wide, far, inside]).gather(0, kind[None])[0]
    out.view(-1, 2)[0] = 1.0 - 2.0 ** -24  # + 4 rounds to 5
    return out.contiguous()


def _check_lookup(levels, coords, r):
    """A writes the levels' type: f32 levels give the plain f32 window's
    bits, bf16 levels the bits of its cast. One launch."""
    n = launch_counts["lookup"]
    want = kl.lookup_plain([lv.float() for lv in levels], coords, r)
    got = kl.lookup(levels, coords, r)
    assert got.dtype == levels[0].dtype and torch.equal(got, want.to(got.dtype))
    assert launch_counts["lookup"] == n + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h1,w1", [(8, 12), (12, 16)])  # level 3 >= 1x1
def test_lookup_kernel(dev, dtype, h1, w1):
    g = torch.Generator(device=dev).manual_seed(1)
    levels = corr_pyramid(torch.randn((2, h1 * w1, h1, w1), generator=g,
                                      device=dev), 4, dtype)
    coords = torch.rand((2, h1, w1, 2), generator=g, device=dev) * 30 - 10
    _check_lookup(levels, coords, 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lookup_kernel_one_level(dev, dtype):
    """The FlowFormer decoder's lookup: one level, the cost maps of a
    (h1, w1) grid against themselves."""
    g = torch.Generator(device=dev).manual_seed(4)
    h1, w1 = 11, 16
    level = torch.randn((1, h1 * w1, h1, w1), generator=g, device=dev).to(dtype)
    coords = torch.rand((1, h1, w1, 2), generator=g, device=dev) * 24 - 4
    assert kl.lookup([level], coords, 4).shape == (1, h1, w1, 81)
    _check_lookup([level], coords, 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nl", [1, 4])
@pytest.mark.parametrize("r", [3, 4])
def test_lookup_kernel_hard_coords(dev, dtype, nl, r):
    """Coordinates just below integers (a tap pair at offset 2r+1 of the
    patch), negative, past every edge, near 1000, and 1x1 coarse levels; B
    = 2 and 3 (not a multiple of the 32 units of a block)."""
    g = torch.Generator(device=dev).manual_seed(11)
    for b, h1, w1 in ((2, 8, 12), (3, 8, 9)):
        levels = corr_pyramid(torch.randn((b, h1 * w1, h1, w1), generator=g,
                                          device=dev), nl, dtype)
        _check_lookup(levels, _hard_coords(g, b, h1, w1, w1, dev), r)


def test_lookup_refusals(dev):
    """Radii the kernel is not built for (3 and 4 are) and f16 levels are
    refused, with no launch."""
    level = torch.randn((1, 12, 3, 4), device=dev)
    coords = torch.rand((1, 3, 4, 2), device=dev)
    n = launch_counts["lookup"]
    for lv, radius in ((level, 0), (level, 2), (level, 5), (level.half(), 4)):
        with pytest.raises(ValueError):
            kl.lookup([lv], coords, radius)
    assert launch_counts["lookup"] == n


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("m,n,k", [
    (7040, 256, 324), (100, 70, 33), (704, 64, 81), (704, 256, 81),
    (40, 64, 81),     # fewer rows than a tile
    (63, 256, 324),   # an odd count of values: the last pair is half outside
    (129, 70, 81),    # one row into a third tile, a ragged column tile
    (100, 33, 324),   # an odd row length of the output: 2-byte stores
    (1, 8, 16),       # K a multiple of 4: 8-byte pieces
    (90, 64, 72),     # the same with K rounded up (80) and a ragged tile
    (100, 70, 34),    # K even, no multiple of 4: pairs that straddle no row
    (70, 40, 1),      # every pair of values straddles two rows
    (65, 64, 896),    # the most K whose bf16 tiles fit shared memory
    (65, 64, 900),    # K past that: bf16 is refused, f32 runs
    # enough 128 x 128 tiles for the large tile, ragged both ways
    (1300, 1290, 81),  # N no multiple of 8: stores from the fragments
    (1281, 1288, 40),  # N a multiple of 8: the tile leaves through shared memory
])
def test_fold_kernel(dev, dtype, tol, m, n, k):
    """bf16 runs the tensor-core entry (K = 900 does not fit its tiles and is
    refused), f32 the FMA tiles; bf16 x bf16 products are exact in f32, so
    both tolerances are those of f32 sums in another order (and one bf16
    rounding)."""
    g = torch.Generator(device=dev).manual_seed(2)
    a = torch.randn((m, k), generator=g, device=dev).to(dtype)
    w = (torch.randn((n, k), generator=g, device=dev) * 0.1).to(dtype)
    b = torch.randn((n,), generator=g, device=dev).to(dtype)
    assert kf.design(a) == ("mma" if dtype == torch.bfloat16 else "fma")
    before = launch_counts["fold"]
    if dtype == torch.bfloat16 and k > kf.MMA_MAX_K:
        with pytest.raises(ValueError):
            kf.fold(a, w, b)
        assert launch_counts["fold"] == before
        return
    got = kf.fold(a, w, b)
    assert launch_counts["fold"] == before + 1
    torch.testing.assert_close(got.float(), kf.fold_plain(a, w, b).float(),
                               rtol=tol, atol=tol)


def _check_lookup_fold(levels, coords, r, w, bias):
    """The fused kernel against its plain version, and against kernel A
    then kernel B. In f32 it must equal them bit for bit (the same f32 taps
    and the same FMA tile in the same k order). In bf16, against A then B
    (B's tensor cores): one bf16 ulp of the largest output. Returns the
    plan the launch was counted under."""
    b, h1, w1, _ = coords.shape
    n, k = w.shape
    dtype = w.dtype
    before = dict(launch_counts)
    shapes = dict(launch_shapes)
    got = klf.lookup_fold(levels, coords, r, w, bias)
    assert launch_counts["lookup_fold"] == before["lookup_fold"] + 1
    assert launch_counts["lookup"] == before["lookup"]
    (key,) = [key for key, c in launch_shapes.items() if c != shapes.get(key, 0)]
    assert got.shape == (b, h1, w1, n) and got.dtype == dtype
    want = klf.lookup_fold_plain(levels, coords, r, w, bias)
    tol = 1e-4 if dtype == torch.float32 else 2e-2  # as test_fold_kernel
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    window = kl.lookup(levels, coords, r).reshape(b * h1 * w1, k)
    two_step = kf.fold(window, w, bias).reshape(b, h1, w1, n)
    top = float(two_step.float().abs().max())
    ulp = 0.0 if dtype == torch.float32 else 2.0 ** (math.floor(math.log2(top)) - 7)
    torch.testing.assert_close(got.float(), two_step.float(), rtol=0, atol=ulp)
    return dict(zip(("entry", "grid", "slices"), key[-3:]))


def _fold_operands(g, dev, dtype, b, h1, w1, nl, n, r=4):
    levels = corr_pyramid(torch.randn((b, h1 * w1, h1, w1), generator=g,
                                      device=dev), nl, dtype)
    k = nl * (2 * r + 1) ** 2
    w = (torch.randn((n, k), generator=g, device=dev) * 0.1).to(dtype)
    bias = torch.randn((n,), generator=g, device=dev).to(dtype)
    return levels, w, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h1,w1,nl,n", [
    (2, 8, 12, 4, 256),   # three whole query tiles, the RAFT widths
    (1, 10, 14, 4, 70),   # Q = 140: a ragged query tile, ragged outputs
    (1, 12, 16, 1, 300),  # one level (K = 81: a ragged k slice), two output tiles
    (1, 9, 11, 2, 64),
])
def test_lookup_fold_kernel(dev, dtype, b, h1, w1, nl, n):
    g = torch.Generator(device=dev).manual_seed(7)
    levels, w, bias = _fold_operands(g, dev, dtype, b, h1, w1, nl, n)
    coords = torch.rand((b, h1, w1, 2), generator=g, device=dev) * 30 - 10
    _check_lookup_fold(levels, coords, 4, w, bias)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h1,w1,nl,n,r", [
    (2, 8, 12, 4, 256, 4),
    (3, 8, 9, 4, 256, 4),   # Q = 216: a ragged last tile of either height
    (2, 8, 12, 1, 64, 4),
    (1, 8, 12, 4, 96, 3),   # radius 3: K = 196, a 9 x 9 patch
])
def test_lookup_fold_kernel_hard_coords(dev, dtype, b, h1, w1, nl, n, r):
    g = torch.Generator(device=dev).manual_seed(12)
    levels, w, bias = _fold_operands(g, dev, dtype, b, h1, w1, nl, n, r)
    _check_lookup_fold(levels, _hard_coords(g, b, h1, w1, w1, dev), r, w, bias)


@pytest.mark.parametrize("b,h1,w1,nl,n", [
    (1, 10, 14, 4, 256),  # Q = 140: 9 blocks of 15 or 16 rows, fewer than the SMs
    (2, 40, 60, 4, 256),  # Q = 4800: runs of 36 or 37 rows, a ragged last pass
    (1, 40, 60, 1, 600),  # three column slices (256, 256, 88), N % 8 == 0
    (1, 20, 30, 2, 300),  # two slices, N % 8 != 0: 2-byte stores
])
def test_lookup_fold_plan_run(dev, b, h1, w1, nl, n):
    """The bf16 launch runs the plan `plan` names for the call from the
    library's layout (the launch is counted under it), and is right at
    every column slicing."""
    g = torch.Generator(device=dev).manual_seed(13)
    levels, w, bias = _fold_operands(g, dev, torch.bfloat16, b, h1, w1, nl, n)
    coords = _hard_coords(g, b, h1, w1, w1, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = klf.plan(b * h1 * w1, n, 4, torch.bfloat16, sms, **klf.layout())
    ran = _check_lookup_fold(levels, coords, 4, w, bias)
    assert ran == {key: want[key] for key in ("entry", "grid", "slices")}
    assert want["slices"] == -(-n // klf.layout()["cols"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h1,w1", [
    (55, 128),   # 1024x436: 3 chunks of 2048 queries and a tail of 896
    (135, 240),  # 1920x1080: 15 chunks and a tail of 1680
])
def test_alt_corr_chunks_match_the_materialized_lookup(dev, dtype, h1, w1):
    """ALT_CORR (`ops/corr.py::alternate_corr_fold`): G once a chunk, at
    the full chunk's and the tail's shapes, against G on the materialized
    pyramid of the same feature maps (bf16 values in both types). f32:
    1e-4 of the largest output (the same sums, the product taken a chunk
    at a time); the chunks' levels from the product and the pyramid kernel
    P, one P launch a chunk. bf16: 2e-2, as `test_lookup_fold_kernel` (G's
    products in bf16; the chunks' levels from the chunk-levels kernel, one
    launch a chunk and no P, each level rounded once from f32 sums taken in
    another order than the materialized volume's)."""
    from focusflow_official_tpu_torch.ops.corr import AltCorr, all_pairs_corr, \
        alternate_corr_fold

    g = torch.Generator(device=dev).manual_seed(21)
    f1, f2 = (torch.randn((1, h1, w1, 256), generator=g, device=dev).bfloat16()
              for _ in range(2))
    w = (torch.randn((256, 324), generator=g, device=dev) * 0.05).to(dtype)
    bias = torch.randn((256,), generator=g, device=dev).to(dtype)
    coords = _hard_coords(g, 1, h1, w1, w1, dev)
    q, chunk = h1 * w1, 2048
    before = dict(launch_shapes)
    n = launch_counts["lookup_fold"]
    n_p, n_cl = launch_counts["pyramid"], launch_counts["corr_levels"]
    got = alternate_corr_fold(AltCorr(f1.to(dtype), f2.to(dtype), 4, chunk), coords, 4, w,
                              bias)
    assert launch_counts["lookup_fold"] == n + -(-q // chunk)
    walked = (launch_counts["pyramid"] - n_p, launch_counts["corr_levels"] - n_cl)
    assert walked == ((-(-q // chunk), 0) if dtype == torch.float32 else (0, -(-q // chunk)))
    new = {key: c - before.get(key, 0) for key, c in launch_shapes.items()
           if c != before.get(key, 0)}
    assert {key[2]: c for key, c in new.items()} == {chunk: q // chunk, q % chunk: 1}
    levels = corr_pyramid(all_pairs_corr(f1.float(), f2.float()), 4, dtype)
    want = klf.lookup_fold(levels, coords, 4, w, bias)
    del levels
    top = float(want.float().abs().max())
    tol = (1e-4 if dtype == torch.float32 else 2e-2) * top
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h1,w1,model", [
    (55, 128, 2),  # 1024x436 over two ranks: blocks of 3520 queries
    (9, 15, 4),    # 135 queries over four: blocks of 34, 34, 34 and 33
])
def test_lookup_fold_on_a_query_block(dev, dtype, h1, w1, model):
    """G as a query-sharded volume launches it (`ops/corr.py::ShardedCorr`):
    on each rank's block of the queries (`train/mesh.py::query_block`),
    the levels the pyramid of the block's rows of the volume and the
    coordinates (1, 1, n, 2), against its plain version and A then B
    (`_check_lookup_fold`); and the blocks' outputs against the rows of G on
    the whole pyramid: f32 within 1e-4 of the largest output, bf16 within
    2e-2 (as `test_alt_corr_chunks_match_the_materialized_lookup`: the
    block's product may take another cuBLAS kernel than the whole one)."""
    from focusflow_official_tpu_torch.ops.corr import all_pairs_corr, corr_rows
    from focusflow_official_tpu_torch.train.mesh import Mesh, query_block

    g = torch.Generator(device=dev).manual_seed(23)
    c, q = 64, h1 * w1
    f1, f2 = (torch.randn((1, h1, w1, c), generator=g, device=dev) for _ in range(2))
    w = (torch.randn((256, 324), generator=g, device=dev) * 0.05).to(dtype)
    bias = torch.randn((256,), generator=g, device=dev).to(dtype)
    coords = _hard_coords(g, 1, h1, w1, w1, dev)
    full = klf.lookup_fold(corr_pyramid(all_pairs_corr(f1, f2), 4, dtype), coords, 4, w,
                           bias).reshape(1, q, -1)
    tol = (1e-4 if dtype == torch.float32 else 2e-2) * float(full.float().abs().max())
    sizes = []
    for i in range(model):
        rows = query_block(q, Mesh(i, model, torch.device("cpu"), model=model))
        levels = corr_pyramid(corr_rows(f1.reshape(1, q, c)[:, rows], f2), 4, dtype)
        cq = coords.reshape(1, 1, q, 2)[:, :, rows].contiguous()
        _check_lookup_fold(levels, cq, 4, w, bias)
        got = klf.lookup_fold(levels, cq, 4, w, bias).reshape(1, -1, 256)
        torch.testing.assert_close(got.float(), full[:, rows].float(), rtol=0, atol=tol)
        sizes.append(got.shape[1])
    assert sizes == [len(p) for p in torch.tensor_split(torch.arange(q), model)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_alt_corr_backward_matches_its_plain_chunks(dev, dtype):
    """ALT_CORR's Function (`alternate_corr_fold`, backward
    `alternate_corr_vjp`) at the chairs crop's grid (46x62, B=2: chunks of
    2048 and a tail of 804) against autograd through its plain chunks (the
    chunk's product, `corr_pyramid`, `lookup_fold_plain`, one chunk after
    another): the maps', the weight's and the bias's gradients within 1e-4
    (f32) or 2e-2 (bf16, the plain chunks' gradients summed in bf16) of
    each one's largest; the backward launches A once a chunk and no G.
    The plain chunk is the walk's function: `corr_pyramid` of the f32
    product, in the compute type."""
    from focusflow_official_tpu_torch.ops.corr import AltCorr, alternate_corr_fold

    g = torch.Generator(device=dev).manual_seed(41)
    b, h1, w1, c, chunk = 2, 46, 62, 256, 2048
    q = h1 * w1
    f1, f2 = (torch.randn((b, h1, w1, c), generator=g, device=dev).to(dtype)
              for _ in range(2))
    w = (torch.randn((256, 324), generator=g, device=dev) / 18).to(dtype)
    bias = (torch.randn(256, generator=g, device=dev) * 0.1).to(dtype)
    coords = (torch.stack(torch.meshgrid(torch.arange(w1, device=dev),
                                         torch.arange(h1, device=dev), indexing="xy"), -1)
              .float()[None].repeat(b, 1, 1, 1)
              + torch.randn((b, h1, w1, 2), generator=g, device=dev) * 4).contiguous()
    cot = torch.randn((b, h1, w1, 256), generator=g, device=dev).to(dtype)

    def plain(f1_, f2_, w_, b_):
        a = (f1_.reshape(b, q, c).float() * c ** -0.5).to(dtype)
        f2t = f2_.reshape(b, q, c).to(dtype).transpose(1, 2)
        cq = coords.reshape(b, 1, q, 2)
        outs = [klf.lookup_fold_plain(
            corr_pyramid(torch.matmul(a[:, s:s + chunk].float(), f2t.float())
                         .reshape(b, -1, h1, w1), 4, dtype),
            cq[:, :, s:s + chunk].contiguous(), 4, w_, b_) for s in range(0, q, chunk)]
        return torch.cat(outs, 2).reshape(b, h1, w1, -1)

    leaves = [t.detach().requires_grad_(True) for t in (f1, f2, w, bias)]
    out = alternate_corr_fold(AltCorr(leaves[0], leaves[1], 4, chunk), coords, 4, *leaves[2:])
    assert out.grad_fn is not None
    n_a, n_g = launch_counts["lookup"], launch_counts["lookup_fold"]
    got = torch.autograd.grad(out, leaves, cot)
    assert launch_counts["lookup"] == n_a + 2 and launch_counts["lookup_fold"] == n_g
    ref = [t.detach().requires_grad_(True) for t in (f1, f2, w, bias)]
    want = torch.autograd.grad(plain(*ref), ref, cot)
    for a, e in zip(got, want):
        assert a.dtype == e.dtype and torch.isfinite(a).all()
        tol = (1e-4 if dtype == torch.float32 else 2e-2) * float(e.float().abs().max())
        assert float((a.float() - e.float()).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lookup_fold_refusals(dev, dtype):
    """No plan for a radius the gather is not built for (3 and 4 are), for
    either type; a bf16 weight off a 16-byte boundary is refused. None
    launches."""
    g = torch.Generator(device=dev).manual_seed(14)
    coords = torch.rand((1, 6, 8, 2), generator=g, device=dev) * 8
    n = launch_counts["lookup_fold"]
    for radius in (2, 5):
        levels, w, bias = _fold_operands(g, dev, dtype, 1, 6, 8, 1, 64, radius)
        with pytest.raises(ValueError):
            klf.lookup_fold(levels, coords, radius, w, bias)
    if dtype == torch.bfloat16:
        levels, w, bias = _fold_operands(g, dev, dtype, 1, 6, 8, 1, 64)
        shifted = torch.empty(w.numel() + 1, dtype=dtype, device=dev)[1:].view_as(w)
        shifted.copy_(w)
        with pytest.raises(ValueError):
            klf.lookup_fold(levels, coords, 4, shifted, bias)
    assert launch_counts["lookup_fold"] == n


LOCAL_CORR_SHAPES = [
    # how the launch (`klc.plan`) spreads rows, dy rows and channel slices
    # over blocks and warps depends on the pixel count against the card's
    # SMs; f32 runs 8 x 8 tiles, bf16 16-pixel segments
    ((2, 12, 16, 32), 4),    # 8 tiles: one dy row a block
    ((1, 9, 13, 24), 3),     # odd sizes, radius 3
    ((1, 7, 16, 196), 4),    # PWC level 6: a frame lower than the window
    ((1, 20, 27, 6), 4),     # C not a multiple of 4: scalar loads
    ((2, 17, 23, 12), 2),    # C a multiple of 4, not of 8
    ((1, 5, 3, 7), 1),       # radius 1, a frame narrower than a tile
    ((1, 40, 150, 32), 4),   # 95 tiles: two dy groups of 5 and 4 rows
    ((1, 40, 150, 40), 4),   # the same with a ragged channel chunk (32 + 8)
    ((1, 56, 100, 32), 4),   # 91 tiles at 7 x 13, still two groups
    ((1, 28, 64, 96), 4),    # PWC level 4, 32 tiles: groups of 2, 2, 2, 2, 1
    ((1, 90, 100, 16), 4),   # 156 tiles: all dy rows in one block
    ((1, 14, 32, 128), 4),   # PWC level 5
    ((1, 56, 128, 64), 4),   # PWC level 3
    ((1, 112, 256, 32), 4),  # PWC level 2
    ((1, 20, 27, 3), 4),     # C = 3: one k16 step of 13 pad channels, plain loads
    ((2, 30, 50, 24), 3),    # B = 2, W not a multiple of 16, 8-byte copies
    ((1, 9, 40, 300), 4),    # three channel chunks through the ring
    ((1, 33, 70, 40), 2),    # radius 2, a last band of one row
    # FF-PWCNet's levels 6 to 2 at 3840x2176 (a 3840x2160 frame resized)
    ((1, 34, 60, 196), 4),
    ((1, 68, 120, 128), 4),
    ((1, 136, 240, 96), 4),
    ((1, 272, 480, 64), 4),
    ((1, 544, 960, 32), 4),  # 4,080 blocks of 8 rows
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,r", LOCAL_CORR_SHAPES)
def test_local_corr_kernel(dev, dtype, shape, r):
    g = torch.Generator(device=dev).manual_seed(8)
    f1 = torch.randn(shape, generator=g, device=dev).to(dtype)
    f2 = torch.randn(shape, generator=g, device=dev).to(dtype)
    before = launch_counts["local_corr"]
    got = klc.local_corr(f1, f2, r)
    assert launch_counts["local_corr"] == before + 1
    assert got.shape == shape[:3] + ((2 * r + 1) ** 2,) and got.dtype == dtype
    want = klc.local_corr_plain(f1, f2, r)
    # f32: sums of C products in another order; bf16: exact products on the
    # tensor cores, summed in f32 in another order and rounded once, so one
    # bf16 ulp (8 significant bits) of the largest output
    top = float(want.float().abs().max())
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** (math.floor(math.log2(top)) - 7)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


def test_local_corr_border_is_zero_padding(dev):
    """Every displacement that leaves f2 must read zero: with f2 all ones
    and f1 all ones the output counts nothing but in-range pixels."""
    f = torch.ones((1, 11, 19, 8), device=dev)
    got = klc.local_corr(f, f, 4)
    torch.testing.assert_close(got, klc.local_corr_plain(f, f, 4), rtol=0, atol=0)
    assert float(got[0, 0, 0, 0]) == 0.0 and float(got[0, 0, 0, 40]) == 1.0
    assert float(got[0, 10, 18, 80]) == 0.0 and float(got[0, 5, 9].min()) == 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,r", LOCAL_CORR_SHAPES)
def test_local_corr_leaky_relu_kernel(dev, dtype, shape, r):
    """The fused form (one launch) bit-equal to the plain-form kernel then
    F.leaky_relu: both launches sum in the same order (the plan does not
    depend on the slope), and the epilogue rounds before the slope."""
    g = torch.Generator(device=dev).manual_seed(9)
    f1 = torch.randn(shape, generator=g, device=dev).to(dtype)
    f2 = torch.randn(shape, generator=g, device=dev).to(dtype)
    before = launch_counts["local_corr"]
    got = klc.local_corr(f1, f2, r, negative_slope=0.1)
    assert launch_counts["local_corr"] == before + 1
    torch.testing.assert_close(got, F.leaky_relu(klc.local_corr(f1, f2, r), 0.1),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_local_corr_border_in_both_forms(dev, dtype):
    """As `test_local_corr_border_is_zero_padding`, in both types and in the
    fused form, over a frame lower than the window (PWC level 6's 7 rows)."""
    for shape in ((1, 11, 19, 8), (1, 7, 16, 196)):
        f = torch.ones(shape, device=dev, dtype=dtype)
        for slope in (None, 0.1):
            got = klc.local_corr(f, f, 4, negative_slope=slope)
            torch.testing.assert_close(got, klc.local_corr_plain(f, f, 4, slope),
                                       rtol=0, atol=0)


def test_local_corr_misaligned_view(dev):
    """A contiguous map one element into its storage: the 16- and 8-byte
    copies would read misaligned, so the launch takes plain loads and gives
    the plain version's result within one bf16 ulp."""
    g = torch.Generator(device=dev).manual_seed(10)
    for shape in ((1, 14, 32, 128), (1, 12, 20, 36)):
        n = math.prod(shape)
        base = torch.randn(2 * n + 1, generator=g, device=dev).bfloat16()
        f1, f2 = base[1:n + 1].view(shape), base[n + 1:].view(shape)
        assert f1.is_contiguous() and f1.data_ptr() % 4 == 2
        got = klc.local_corr(f1, f2, 4)
        want = klc.local_corr_plain(f1, f2, 4)
        torch.cuda.synchronize()
        tol = 2.0 ** (math.floor(math.log2(float(want.float().abs().max()))) - 7)
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("shape,r", LOCAL_CORR_SHAPES)
def test_local_corr_plan_smem_is_the_librarys(dev, shape, r):
    p = klc.plan(*shape, r, torch.bfloat16,
                 torch.cuda.get_device_properties(dev).multi_processor_count)
    assert klc.smem_built(shape[3], r, p) == p["smem"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 20, 24, 64), (1, 13, 17, 96),
                                   (2, 9, 11, 300)])
def test_instance_norm_kernels(dev, dtype, shape):
    g = torch.Generator(device=dev).manual_seed(3)
    x = (torch.randn(shape, generator=g, device=dev) * 3 + 1).to(dtype)
    mean, inv = kin.instance_norm_stats(x)
    rmean, rinv = kin.stats_plain(x)
    torch.testing.assert_close(mean, rmean, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(inv, rinv, rtol=1e-4, atol=1e-5)
    for relu in (False, True):
        torch.testing.assert_close(kin.instance_norm_apply(x, mean, inv, relu),
                                   kin.apply_plain(x, mean, inv, relu),
                                   rtol=0, atol=0)


def _stats_entry(x):
    """C1 on x -> (mean, inv, the entry its launch was counted under)."""
    before = dict(launch_shapes)
    n = launch_counts["in_stats"]
    mean, inv = kin.instance_norm_stats(x)
    assert launch_counts["in_stats"] == n + 1
    (key,) = [key for key, c in launch_shapes.items() if c != before.get(key, 0)]
    return mean, inv, key[-1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 220, 512, 64), (2, 110, 256, 96), (2, 55, 128, 128),  # the fnet's, S from the SMs
    (1, 7, 143, 96),   # H*W = 1001: a short last slab
    (3, 5, 7, 8),      # one vector a row, one slab
])
def test_in_stats_one_launch_repeats_its_bits(dev, dtype, shape):
    """One launch a call on the vector entry, right, and the same bits on a
    second call: the last block adds the partials in index order, whichever
    block finished last."""
    g = torch.Generator(device=dev).manual_seed(15)
    x = (torch.randn(shape, generator=g, device=dev) * 3 + 1).to(dtype)
    assert kin.design(x) == "vector"
    mean, inv, entry = _stats_entry(x)
    assert entry == "vector"
    rmean, rinv = kin.stats_plain(x)
    torch.testing.assert_close(mean, rmean, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(inv, rinv, rtol=1e-4, atol=1e-5)
    mean2, inv2 = kin.instance_norm_stats(x)
    assert torch.equal(mean, mean2) and torch.equal(inv, inv2)


def test_in_stats_counters_reset(dev):
    """50 calls in a row with B going 1, 2, 3: each finishing block puts its
    sample's counter back to 0, so every call still matches the plain
    version."""
    g = torch.Generator(device=dev).manual_seed(16)
    xs = [(torch.randn((b, 40, 70, 64), generator=g, device=dev) * 2 + 1).bfloat16()
          for b in (1, 2, 3)]
    wants = [kin.stats_plain(x) for x in xs]
    for i in range(50):
        x, (rmean, rinv) = xs[i % 3], wants[i % 3]
        mean, inv = kin.instance_norm_stats(x)
        torch.testing.assert_close(mean, rmean, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(inv, rinv, rtol=1e-4, atol=1e-5)


def test_in_stats_two_streams_at_once(dev):
    """C1 launches on two streams at the same time, 20 on each, each stream
    with its own ticket buffer: every result matches the plain version,
    and a later call on each stream, at another batch size, does too (its
    counters are back at 0)."""
    g = torch.Generator(device=dev).manual_seed(20)
    xs = [(torch.randn(shape, generator=g, device=dev) * 3 + 1).bfloat16()
          for shape in ((2, 220, 512, 64), (3, 110, 256, 96))]
    wants = [kin.stats_plain(x) for x in xs]
    streams = [torch.cuda.Stream(dev) for _ in xs]
    main = torch.cuda.current_stream(dev)
    for s in streams:
        s.wait_stream(main)
    got = [[], []]
    for _ in range(20):
        for i, (x, s) in enumerate(zip(xs, streams)):
            with torch.cuda.stream(s):
                got[i].append(kin.instance_norm_stats(x))
    torch.cuda.synchronize(dev)
    assert {(dev, s.cuda_stream) for s in streams} <= set(kin._counters)
    for (rmean, rinv), results in zip(wants, got):
        for mean, inv in results:
            torch.testing.assert_close(mean, rmean, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(inv, rinv, rtol=1e-4, atol=1e-5)
    for x, s in zip(xs, streams):
        with torch.cuda.stream(s):
            mean, inv = kin.instance_norm_stats(x[:1])
        torch.cuda.synchronize(dev)
        rmean, rinv = kin.stats_plain(x[:1])
        torch.testing.assert_close(mean, rmean, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(inv, rinv, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_in_stats_misaligned_view_takes_scalar_entry(dev, dtype):
    """A contiguous view that starts one value past a 16-byte boundary,
    and C = 300 in bf16 (no multiple of 8), take the scalar entry, with the
    same one-launch finish."""
    g = torch.Generator(device=dev).manual_seed(17)
    shape = (2, 30, 41, 64)
    flat = (torch.randn(1 + 2 * 30 * 41 * 64, generator=g, device=dev) * 3 + 1).to(dtype)
    for x in (flat[1:].view(shape),
              (torch.randn((2, 9, 11, 300), generator=g, device=dev) * 3 + 1).bfloat16()):
        assert x.is_contiguous() and kin.design(x) == "scalar"
        mean, inv, entry = _stats_entry(x)
        assert entry == "scalar"
        rmean, rinv = kin.stats_plain(x)
        torch.testing.assert_close(mean, rmean, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(inv, rinv, rtol=1e-4, atol=1e-5)
        mean2, inv2 = kin.instance_norm_stats(x)
        assert torch.equal(mean, mean2) and torch.equal(inv, inv2)


def test_raft_forward_profile_has_one_stats_kernel_a_norm(dev):
    """A bf16 FF-RAFT forward: 30 C1 launches (the fnet's 15 instance norms
    on each frame), each one kernel on the card, and no finishing kernel."""
    from torch.profiler import ProfilerActivity, profile

    from focusflow_official_tpu_torch.models import FFRaftConfig
    from focusflow_official_tpu_torch.predict import FlowPredictor

    fixture = os.path.join(os.path.dirname(__file__), "fixtures", "trained_smoke.npz")
    cfg = FFRaftConfig(fusion="parallel", fusion_type="1x1conv", fuse_cnet=True, iters=2)
    p = FlowPredictor(cfg, fixture, device=dev, dtype=torch.bfloat16)
    rng = np.random.RandomState(3)
    i1 = (rng.rand(96, 128, 3) * 255).astype(np.float32)
    i2 = np.roll(i1, 2, 1)
    p(i1, i2)  # warm-up
    n = launch_counts["in_stats"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        p(i1, i2)
        torch.cuda.synchronize()
    assert launch_counts["in_stats"] == n + 30
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("in_stats<" in name for name in names) == 30
    assert not any("stats_finish" in name or "stats_partial" in name for name in names)


def _normalize(x, mean, inv, relu, residual=None):
    """C2 on x -> (y, the key its launch was counted under: ..., entry, form)."""
    before = dict(launch_shapes)
    y = kin.instance_norm_apply(x, mean, inv, relu, residual)
    (key,) = [key for key, c in launch_shapes.items() if c != before.get(key, 0)]
    return y, key


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("b", [1, 2, 3])
@pytest.mark.parametrize("case", ["vector", "misaligned x", "misaligned r", "odd C"])
def test_in_normalize_both_forms_each_entry(dev, dtype, relu, b, case):
    """C2's plain and residual forms on each entry: `vector` (C = 96: 12
    threads a row, 252 a block), `scalar` for a view one value past a
    16-byte boundary (of x or of the residual alone) and for C = 50 (no
    multiple of 8 or 4). Both bit-equal to the plain version, and the
    residual form to the plain-form kernel then PyTorch's add and ReLU."""
    g = torch.Generator(device=dev).manual_seed(30 + b)
    c = 50 if case == "odd C" else 96
    shape = (b, 13, 17, c)
    n = math.prod(shape)

    def make(scale, shift, misaligned):
        flat = (torch.randn(n + 1, generator=g, device=dev) * scale + shift).to(dtype)
        return (flat[1:] if misaligned else flat[:n]).view(shape)

    x = make(3, 1, case == "misaligned x")
    r = make(1, 0, case == "misaligned r")
    assert x.is_contiguous() and r.is_contiguous()
    entry = "vector" if case == "vector" else "scalar"
    assert kin.design(x, r) == entry
    mean, inv = kin.instance_norm_stats(x)
    y, key = _normalize(x, mean, inv, relu)
    assert key[-2:] == (kin.design(x), "plain")
    torch.testing.assert_close(y, kin.apply_plain(x, mean, inv, relu), rtol=0, atol=0)
    yr, key = _normalize(x, mean, inv, relu, r)
    assert key[-2:] == (entry, "residual")
    torch.testing.assert_close(yr, kin.apply_plain(x, mean, inv, relu, r), rtol=0, atol=0)
    torch.testing.assert_close(yr, torch.relu(r + y), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 220, 512, 32), (2, 220, 512, 8), (2, 220, 512, 16), (2, 110, 256, 16),
    (2, 110, 256, 64), (2, 110, 256, 24), (2, 55, 128, 24), (2, 55, 128, 96),
])
def test_instance_norm_at_the_small_encoder_widths(dev, dtype, shape):
    """C1 and C2 (both forms) at the SmallEncoder fnet's shapes (both frames
    of 1024x436): 32 channels at H/2, the bottlenecks' 8, 16 and 24, and
    64 and 96. Every width is a whole number of 16-byte vectors, so each
    takes the vector entry; the stats within f32 rounding and the
    normalisation bit-equal to the plain version."""
    g = torch.Generator(device=dev).manual_seed(34)
    x = (torch.randn(shape, generator=g, device=dev) * 3 + 1).to(dtype)
    r = torch.randn(shape, generator=g, device=dev).to(dtype)
    assert kin.design(x) == kin.design(x, r) == "vector"
    mean, inv, entry = _stats_entry(x)
    assert entry == "vector"
    rmean, rinv = kin.stats_plain(x)
    torch.testing.assert_close(mean, rmean, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(inv, rinv, rtol=1e-4, atol=1e-5)
    for res in (None, r):
        y, key = _normalize(x, mean, inv, True, res)
        assert key[-2:] == ("vector", "plain" if res is None else "residual")
        torch.testing.assert_close(y, kin.apply_plain(x, mean, inv, True, res), rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(2, 220, 512, 64), (2, 110, 256, 96), (2, 55, 128, 128)])
def test_in_normalize_residual_at_the_fnet_shapes(dev, shape):
    """bf16 at the fnet's three shapes: the vector entry, both forms
    bit-equal to the plain version."""
    g = torch.Generator(device=dev).manual_seed(33)
    x = (torch.randn(shape, generator=g, device=dev) * 3 + 1).bfloat16()
    r = torch.randn(shape, generator=g, device=dev).bfloat16()
    mean, inv = kin.instance_norm_stats(x)
    y, key = _normalize(x, mean, inv, True, r)
    assert key[-2:] == ("vector", "residual")
    torch.testing.assert_close(y, kin.apply_plain(x, mean, inv, True, r), rtol=0, atol=0)


def test_in_normalize_refuses_a_residual_it_cannot_read(dev):
    x = torch.randn((2, 6, 7, 32), device=dev)
    mean, inv = kin.instance_norm_stats(x)
    for r in (x.permute(0, 2, 1, 3),  # strided
              x.bfloat16(),  # another type
              x[:1].contiguous(),  # another shape
              x.cpu()):
        with pytest.raises(ValueError):
            kin.instance_norm_apply(x, mean, inv, True, r)


def _raft(dev, dtype):
    from focusflow_official_tpu_torch.models import FFRaftConfig
    from focusflow_official_tpu_torch.predict import FlowPredictor

    fixture = os.path.join(os.path.dirname(__file__), "fixtures", "trained_smoke.npz")
    cfg = FFRaftConfig(fusion="parallel", fusion_type="1x1conv", fuse_cnet=True, iters=2)
    return FlowPredictor(cfg, fixture, device=dev, dtype=dtype)


def test_raft_forward_profile_fnet_takes_the_residual_in_c2(dev):
    """A bf16 FF-RAFT forward at 96x128: 30 C2 kernels, 12 of them the
    residual form; at the fnet's shapes (B = 2: both frames) no ReLU, no
    copy, and no add but the fusion units' 8 (fusion1-4, each direction):
    the 12 blocks' add and ReLU run inside C2."""
    from torch.profiler import ProfilerActivity, profile

    p = _raft(dev, torch.bfloat16)
    rng = np.random.RandomState(4)
    i1 = (rng.rand(96, 128, 3) * 255).astype(np.float32)
    i2 = np.roll(i1, 2, 1)
    p(i1, i2)  # warm-up
    before = dict(launch_shapes)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        p(i1, i2)
        torch.cuda.synchronize()
    forms = {}
    for key, n in launch_shapes.items():
        if key[0] == "in_normalize" and n != before.get(key, 0):
            forms[key[-1]] = forms.get(key[-1], 0) + n - before.get(key, 0)
    assert forms == {"plain": 18, "residual": 12}
    events = prof.events()
    kernels = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("normalize<" in name for name in kernels) == 30
    fnet = {(2, 64, 48, 64), (2, 96, 24, 32), (2, 128, 12, 16)}
    ops = {}
    for e in events:
        shapes = e.input_shapes if e.device_type == torch.autograd.DeviceType.CPU else None
        if shapes and tuple(shapes[0]) in fnet:
            ops[e.name] = ops.get(e.name, 0) + 1
    assert ops.get("aten::add", 0) == 8, ops
    assert not [name for name in ops if any(w in name for w in ("relu", "clamp", "copy"))], ops


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fnet_output_equals_the_unfused_blocks(dev, dtype):
    """The fnet with C2's residual form against the same fnet whose 12
    blocks run, module by module, conv, C2's plain form, then
    torch.relu(x + y): the same bits."""
    import types

    from focusflow_official_tpu_torch.nn.blocks import ResidualBlock

    fnet = _raft(dev, dtype).model.flow_net.fnet
    g = torch.Generator(device=dev).manual_seed(34)
    x = (torch.rand((2, 96, 128, 3), generator=g, device=dev) * 2 - 1).to(dtype)
    mask = torch.where(torch.rand((2, 96, 128, 3), generator=g, device=dev) > 0.97,
                       1.0, -1.0).to(dtype)

    def unfused(self, x):
        y = self.norm1(self.conv1(x), relu=True)
        y = self.norm2(self.conv2(y), relu=True)
        if self.stride != 1:
            x = self.norm3(self.downsample_conv(x))
        return torch.relu(x + y)

    blocks = [m for m in fnet.modules() if isinstance(m, ResidualBlock)]
    assert len(blocks) == 12
    with torch.inference_mode():
        fused = fnet(x, mask)
        for blk in blocks:
            blk.forward = types.MethodType(unfused, blk)
        try:
            plain = fnet(x, mask)
        finally:
            for blk in blocks:
                del blk.forward
    assert torch.equal(fused, plain)


# bf16: both sides take f32 scores and sums from the same bf16 inputs and
# round once to bf16 at the end: one bf16 ulp of outputs of size ~1. This
# holds for F and for E's FMA entries. E's tensor-core entry also rounds
# the softmax weights to bf16 before the value sum, which moves an output by
# up to 2^-8 of its row's sum of p |v|: E's tensor-core entry is held to
# `ka.bf16_bound` at every output instead (that term plus one bf16 ulp of
# the output: about 0.004 at a typical output of these inputs, about 0.008
# at the largest).
_ATTN_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
             torch.bfloat16: dict(rtol=1e-2, atol=2e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,m,c,cv,heads", [
    (2, 300, 448, 128, 128, 4),  # query tiles, Twins-like 448 keys
    (3, 200, 45, 64, 64, 8),     # head width 8: the FMA entry in both types
    (2, 100, 30, 256, 128, 8),   # query tiles, v narrower (d 32, dv 16)
    (50, 8, 112, 128, 128, 8),   # many batch entries: the input layer
    (70, 1, 8, 64, 64, 8),       # the decoder's cross-attend
    (6, 8, 20, 128, 64, 8),      # many batch entries, v narrower
    # ragged N (no multiple of 16) and M around the 16-key tiles, the 32-key
    # softmax steps and the 64-key chunks; head widths 16 and 32, d != dv
    (1, 77, 1, 64, 64, 4),       # one key
    (2, 130, 15, 128, 64, 4),    # d 32, dv 16
    (1, 203, 17, 64, 128, 4),    # d 16, dv 32
    (2, 333, 100, 128, 128, 4),
    (1, 1001, 448, 256, 256, 8),
    (1, 64, 65, 32, 32, 2),      # the least tiled N; one key into a chunk
    (3, 257, 33, 64, 64, 2),     # one query and one key into a second tile
    (2, 90, 200, 128, 128, 8),   # four chunks: the ring wraps
])
def test_attention_kernel(dev, dtype, b, n, m, c, cv, heads):
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((b, n, c), generator=g, device=dev).to(dtype)
    k = torch.randn((b, m, c), generator=g, device=dev).to(dtype)
    v = torch.randn((b, m, cv), generator=g, device=dev).to(dtype)
    scale = (c // heads) ** -0.5
    before = launch_counts["attention"]
    got = ka.small_kv_attention(q, k, v, heads, scale)
    assert launch_counts["attention"] == before + 1
    assert got.shape == (b, n, cv) and got.dtype == dtype
    want = ka.small_kv_attention_plain(q, k, v, heads, scale)
    mma = (dtype == torch.bfloat16 and n >= 64 and (c // heads) % 16 == 0
           and (cv // heads) % 16 == 0)
    assert ka.design(q, k, v, heads) == ("mma" if mma else "staged" if n < 64 else "tiled")
    if mma:
        bound = ka.bf16_bound(want, q, k, v, heads, scale)
        assert bool(((got.float() - want.float()).abs() <= bound).all())
    else:
        torch.testing.assert_close(got.float(), want.float(), **_ATTN_TOL[dtype])


@pytest.mark.parametrize("scale", [-0.3, 0.0])
def test_attention_kernel_scale_sign(dev, scale):
    """The tensor-core entry folds |scale| into the exponent: a negative
    scale moves into q's sign, a zero one gives the plain mean of v."""
    g = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn((1, 100, 64), generator=g, device=dev).bfloat16()
    k = torch.randn((1, 37, 64), generator=g, device=dev).bfloat16()
    v = torch.randn((1, 37, 64), generator=g, device=dev).bfloat16()
    got = ka.small_kv_attention(q, k, v, 2, scale)
    want = ka.small_kv_attention_plain(q, k, v, 2, scale)
    bound = ka.bf16_bound(want, q, k, v, 2, scale)
    assert bool(((got.float() - want.float()).abs() <= bound).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,m,c,cv,heads,scale", [
    (7040, 8, 112, 128, 128, 8, 0.25),  # the perceiver's input layer
    (7040, 8, 8, 128, 128, 8, 0.25),    # its latent self-attention
    (7040, 1, 8, 64, 64, 8, 8 ** -0.5),  # the decoder's cross-attend
    (37, 8, 1, 128, 128, 8, 0.25),      # one key
    (37, 8, 113, 128, 128, 8, -0.3),    # a ragged last chunk; a negative scale
    (5, 63, 113, 256, 256, 8, 0.2),     # 63 queries: four heads a unit; d 32
    (5, 63, 40, 64, 64, 8, -1.0),       # d 8
    (300, 1, 113, 64, 128, 8, 0.35),    # d 8, dv 16
    (70, 1, 1, 256, 128, 8, 0.1),       # d 32, dv 16, one key
    (3, 5, 17, 96, 48, 3, 0.3),         # three heads (d 32, dv 16)
])
def test_attention_staged_entry(dev, dtype, b, n, m, c, cv, heads, scale):
    """E's small-N entry at the path's shapes and ragged ones, every head
    width, both types: the staged launch (`staged_plan`'s layout, at least
    two blocks an SM) within the FMA tolerance of the plain version."""
    g = torch.Generator(device=dev).manual_seed(12)
    q = torch.randn((b, n, c), generator=g, device=dev).to(dtype)
    k = torch.randn((b, m, c), generator=g, device=dev).to(dtype)
    v = torch.randn((b, m, cv), generator=g, device=dev).to(dtype)
    assert ka.design(q, k, v, heads) == "staged"
    plan = ka.staged_launch(q, k, v, heads)
    assert plan["blocks_per_sm"] >= 2  # the registers its launch bounds allow
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert plan["grid"] == min(plan["rounds"], sms * plan["blocks_per_sm"])
    before = dict(launch_shapes)
    got = ka.small_kv_attention(q, k, v, heads, scale)
    (key,) = [key for key, n_ in launch_shapes.items() if n_ != before.get(key, 0)]
    assert key[-1] == "staged"
    want = ka.small_kv_attention_plain(q, k, v, heads, scale)
    torch.testing.assert_close(got.float(), want.float(), **_ATTN_TOL[dtype])
    # the same bits on a second call: no order between blocks enters a sum
    assert torch.equal(got, ka.small_kv_attention(q, k, v, heads, scale))


@pytest.mark.parametrize("b,n,m,c,heads,dtype,entry", [
    (4, 63, 30, 128, 8, torch.bfloat16, "staged"),  # N < 64
    (2, 64, 30, 128, 8, torch.bfloat16, "mma"),     # N >= 64, bf16, d 16
    (2, 64, 30, 128, 8, torch.float32, "tiled"),    # f32: keys staged a head
    (2, 64, 30, 64, 8, torch.bfloat16, "tiled"),    # d 8
    (1, 64, 1000, 32, 1, torch.float32, "direct"),  # 256 KB of f32 keys a head
    (65536, 64, 1, 8, 1, torch.float32, "direct"),  # more than 65535 entries
])
def test_attention_every_entry(dev, b, n, m, c, heads, dtype, entry):
    """Every branch of the library's entry choice, each against the plain
    version."""
    g = torch.Generator(device=dev).manual_seed(13)
    q = torch.randn((b, n, c), generator=g, device=dev).to(dtype)
    k = torch.randn((b, m, c), generator=g, device=dev).to(dtype)
    v = torch.randn((b, m, c), generator=g, device=dev).to(dtype)
    scale = (c // heads) ** -0.5
    assert ka.design(q, k, v, heads) == entry
    got = ka.small_kv_attention(q, k, v, heads, scale)
    want = ka.small_kv_attention_plain(q, k, v, heads, scale)
    if entry == "mma":
        bound = ka.bf16_bound(want, q, k, v, heads, scale)
        assert bool(((got.float() - want.float()).abs() <= bound).all())
    else:
        torch.testing.assert_close(got.float(), want.float(), **_ATTN_TOL[dtype])


def _check_window(q, k, v, heads, scale):
    """F against its plain version: the tensor-core entry (bf16, head
    widths 16 and 32) at every output within `kw.bf16_bound`, the FMA
    entry (f32, or head width 8) within `_ATTN_TOL`. One launch, counted
    under the entry that `design` names. Returns the output."""
    d = q.shape[-1] // heads
    mma = q.dtype == torch.bfloat16 and d in (16, 32)
    assert kw.design(q, heads) == ("mma" if mma else "fma")
    before = dict(launch_shapes)
    n = launch_counts["window_attention"]
    got = kw.window_attention(q, k, v, 7, heads, scale)
    assert launch_counts["window_attention"] == n + 1
    (key,) = [key for key, c in launch_shapes.items() if c != before.get(key, 0)]
    assert key[-1] == ("mma" if mma else "fma")
    assert got.shape == q.shape and got.dtype == q.dtype
    want = kw.window_attention_plain(q, k, v, 7, heads, scale)
    if mma:
        bound = kw.bf16_bound(want, q, k, v, heads, scale)
        assert bool(((got.float() - want.float()).abs() <= bound).all())
    else:
        torch.testing.assert_close(got.float(), want.float(), **_ATTN_TOL[q.dtype])
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hp,wp,c,heads", [
    (2, 14, 259, 128, 4),  # odd width, 37 windows a row (Twins stage 1)
    (8, 14, 133, 128, 8),  # the vertical local layer's widths
    (1, 7, 7, 32, 2),      # a single window
    (1, 14, 133, 256, 8),  # Twins stage 2's widths: two groups of 4 heads a window
    (2, 14, 133, 256, 8),
    (1, 7, 7, 128, 8),     # a single window at head width 16, 4 heads a block
    (1, 7, 14, 96, 3),     # 3 heads of 32: one head a block (2 do not divide 3)
    (1, 7, 14, 64, 8),     # head width 8: the FMA entry in both types
])
def test_window_attention_kernel(dev, dtype, b, hp, wp, c, heads):
    g = torch.Generator(device=dev).manual_seed(6)
    q, k, v = (torch.randn((b, hp, wp, c), generator=g, device=dev).to(dtype)
               for _ in range(3))
    _check_window(q, k, v, heads, (c // heads) ** -0.5)


@pytest.mark.parametrize("scale", [-0.3, 0.0, 4.0])
def test_window_attention_kernel_scale(dev, scale):
    """The tensor-core entry folds |scale| into the exponent: a negative
    scale moves into q's sign, a zero one gives the window's mean of v, a
    large one a near one-hot softmax."""
    g = torch.Generator(device=dev).manual_seed(18)
    q, k, v = (torch.randn((2, 7, 21, 64), generator=g, device=dev).bfloat16()
               for _ in range(3))
    _check_window(q, k, v, 2, scale)


@pytest.mark.parametrize("b,hp,wp,c,heads", [
    (1, 14, 133, 256, 8),   # Twins stage 2: 2 heads (64 columns) a block
    (2, 14, 259, 128, 4),   # Twins stage 1: the same
    (2, 14, 133, 128, 8),   # the vertical local layer: 4 heads of width 16
    (1, 7, 14, 96, 3),      # 3 heads of 32: one head a block
])
def test_window_mma_head_groups(dev, b, hp, wp, c, heads):
    """A block takes a group of heads (one warp a head), as many as fit 64
    columns and divide H. Each head's output has the bits of that head run
    alone (a launch of one head, one head a block): a head's arithmetic
    does not depend on its group."""
    g = torch.Generator(device=dev).manual_seed(19)
    q, k, v = (torch.randn((b, hp, wp, c), generator=g, device=dev).bfloat16()
               for _ in range(3))
    d = c // heads
    scale = d ** -0.5
    got = _check_window(q, k, v, heads, scale)
    for h in range(heads):
        one = [t[..., h * d:(h + 1) * d].contiguous() for t in (q, k, v)]
        alone = kw.window_attention(*one, 7, 1, scale)
        assert torch.equal(got[..., h * d:(h + 1) * d], alone), h


def test_wrappers_reject_strided_input(dev):
    x = torch.randn((1, 8, 8, 16), device=dev).permute(0, 2, 1, 3)
    with pytest.raises(ValueError):
        kin.instance_norm_stats(x)
    a = torch.randn((16, 8), device=dev)
    with pytest.raises(ValueError):
        kf.fold(a.t(), torch.randn((4, 16), device=dev), torch.randn(4, device=dev))
    a = torch.randn((17, 25), device=dev)
    wt, bias = torch.randn((8, 25), device=dev), torch.randn(8, device=dev)
    # a row slice that starts off a 16-byte boundary: f32 takes it, bf16 does not
    torch.testing.assert_close(kf.fold(a[1:], wt, bias), kf.fold_plain(a[1:], wt, bias),
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        kf.fold(a.bfloat16()[1:, :], wt.bfloat16(), bias.bfloat16())
    with pytest.raises(ValueError):  # bf16 stages all of K: K = 0 is refused
        kf.fold(a.bfloat16()[:, :0], wt.bfloat16()[:, :0].contiguous(), bias.bfloat16())
    q = torch.randn((2, 16, 64), device=dev)
    with pytest.raises(ValueError):
        ka.small_kv_attention(q.transpose(0, 1), q, q, 4, 0.25)
    with pytest.raises(ValueError):  # head width 12 is not built
        ka.small_kv_attention(q[..., :48].contiguous(), q[..., :48].contiguous(),
                              q[..., :48].contiguous(), 4, 0.25)
    x = torch.randn((1, 14, 14, 64), device=dev)
    with pytest.raises(ValueError):
        kw.window_attention(x.transpose(1, 2), x, x, 7, 4, 0.25)
    with pytest.raises(ValueError):  # an NCHW tensor viewed as NHWC
        klc.local_corr(x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), x, 4)
    with pytest.raises(ValueError):  # radius 5 is not built
        klc.local_corr(x, x, 5)
    level = torch.randn((1, 16, 4, 4), device=dev)
    coords = torch.zeros((1, 4, 4, 2), device=dev)
    w = torch.randn((8, 81), device=dev)
    with pytest.raises(ValueError):  # a strided weight
        klf.lookup_fold([level], coords, 4, torch.randn((81, 8), device=dev).t(),
                        torch.zeros(8, device=dev))
    with pytest.raises(ValueError):  # levels and weight of two types
        klf.lookup_fold([level.bfloat16()], coords, 4, w, torch.zeros(8, device=dev))


def test_predictor_on_card_matches_cpu(dev):
    """The whole main path on the card (the fused lookup + convc1, C1 and
    C2 launched) against the same f32 forward on the CPU (plain versions),
    at 96x128.
    f32 on both sides, sums in other orders over 12 iterations: 1e-2 px,
    the port's parity bound with the JAX package."""
    from focusflow_official_tpu_torch.models import FFRaftConfig
    from focusflow_official_tpu_torch.predict import FlowPredictor

    fixture = os.path.join(os.path.dirname(__file__), "fixtures",
                           "trained_smoke.npz")
    rng = np.random.RandomState(0)
    i1 = (rng.rand(96, 128, 3) * 255).astype(np.float32)
    i2 = np.roll(np.roll(i1, -2, 0), 3, 1)
    m1 = ((rng.rand(96, 128, 1) > 0.97) * 255).astype(np.float32)
    m2 = ((rng.rand(96, 128, 1) > 0.97) * 255).astype(np.float32)
    cfg = FFRaftConfig(fuse_cnet=True)
    raft_kernels = ("lookup_fold", "in_stats", "in_normalize")
    before = dict(launch_counts)
    on_card = FlowPredictor(cfg, fixture, device=dev)(i1, i2, m1, m2)
    assert all(launch_counts[k] > before[k] for k in raft_kernels)
    on_cpu = FlowPredictor(cfg, fixture, device="cpu")(i1, i2, m1, m2)
    assert float(np.abs(on_card - on_cpu).max()) <= 1e-2


@pytest.mark.parametrize("matmul", ["medium", "highest"])
def test_f32_predictor_under_default_tf32_matches_cpu(dev, matmul):
    """An f32 predictor on the card with cuDNN's TF32 flag on (PyTorch's
    default; the fixture `dev` turns it off) and the caller's matmul
    precision runs full f32 inside (each backend's `fp32_precision`
    "ieee") and leaves both as they were: it tracks the f32 CPU run within
    the bound of `test_predictor_on_card_matches_cpu`."""
    from focusflow_official_tpu_torch.models import FFRaftConfig
    from focusflow_official_tpu_torch.predict import FlowPredictor

    fixture = os.path.join(os.path.dirname(__file__), "fixtures",
                           "trained_smoke.npz")
    rng = np.random.RandomState(0)
    i1 = (rng.rand(96, 128, 3) * 255).astype(np.float32)
    i2 = np.roll(np.roll(i1, -2, 0), 3, 1)
    cfg = FFRaftConfig(fuse_cnet=True)
    on_cpu = FlowPredictor(cfg, fixture, device="cpu", dtype=torch.float32)(i1, i2)
    saved = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision(matmul)
    torch.backends.cudnn.allow_tf32 = True
    try:
        p = FlowPredictor(cfg, fixture, device=dev, dtype=torch.float32)
        inside = []
        p.model.register_forward_hook(lambda *_: inside.append(
            (torch.backends.cuda.matmul.fp32_precision,
             torch.backends.cudnn.conv.fp32_precision)))
        on_card = p(i1, i2)
        assert inside == [("ieee", "ieee")]
        assert torch.backends.cudnn.allow_tf32
        assert torch.get_float32_matmul_precision() == matmul
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]
    assert float(np.abs(on_card - on_cpu).max()) <= 1e-2


def test_flowformer_predictor_on_card_matches_cpu(dev):
    """FF-FlowFormer on the card (kernels A, B, E and F launched) against
    the same f32 forward on the CPU, at 64x96 with 4 refinements. f32 on
    both sides, sums in other orders: 1e-2 px, the port's parity bound."""
    from focusflow_official_tpu_torch.models import FlowFormerConfig
    from focusflow_official_tpu_torch.predict import FlowPredictor

    fixture = os.path.join(os.path.dirname(__file__), "fixtures",
                           "trained_smoke_ff.npz")
    rng = np.random.RandomState(1)
    i1 = (rng.rand(64, 96, 3) * 255).astype(np.float32)
    i2 = np.roll(np.roll(i1, -2, 0), 3, 1)
    cfg = FlowFormerConfig(encoder_depth=1, decoder_depth=4)
    before = dict(launch_counts)
    on_card = FlowPredictor(cfg, fixture, device=dev)(i1, i2)
    for name in ("lookup", "fold", "attention", "window_attention"):
        assert launch_counts[name] > before[name], name
    on_cpu = FlowPredictor(cfg, fixture, device="cpu")(i1, i2)
    assert float(np.abs(on_card - on_cpu).max()) <= 1e-2


def test_pwc_predictor_on_card_matches_cpu(dev):
    """FF-PWCNet on the card (kernel D launched once a decoder level, one
    device kernel a launch in the profile) against the same f32 forward on
    the CPU, at 100x150 (resized to 128x192 inside). f32 on both sides,
    sums in other orders through five levels of warps: 1e-2 px, the port's
    parity bound."""
    from torch.profiler import ProfilerActivity, profile

    from focusflow_official_tpu_torch.models import FFPWCNetConfig
    from focusflow_official_tpu_torch.predict import FlowPredictor

    fixture = os.path.join(os.path.dirname(__file__), "fixtures",
                           "trained_smoke_pwc.npz")
    rng = np.random.RandomState(2)
    i1 = (rng.rand(100, 150, 3) * 255).astype(np.float32)
    i2 = np.roll(np.roll(i1, -2, 0), 3, 1)
    m1 = ((rng.rand(100, 150, 1) > 0.97) * 255).astype(np.float32)
    m2 = ((rng.rand(100, 150, 1) > 0.97) * 255).astype(np.float32)
    cfg = FFPWCNetConfig()
    p = FlowPredictor(cfg, fixture, device=dev)
    before = launch_counts["local_corr"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        on_card = p(i1, i2, m1, m2)
        torch.cuda.synchronize()
    assert launch_counts["local_corr"] == before + 5
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("local_corr" in name for name in names) == 5
    on_cpu = FlowPredictor(cfg, fixture, device="cpu")(i1, i2, m1, m2)
    assert on_card.shape == (100, 150, 2)
    assert float(np.abs(on_card - on_cpu).max()) <= 1e-2


# ---- the evaluation path's new shapes (chairs 384x512; KITTI 375x1242 and
# 370x1224 padded per shape to 376x1248 and 376x1224) ----------------------

EVAL_GRIDS = [(48, 64), (47, 156), (47, 153)]  # the /8 grids


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h1,w1", EVAL_GRIDS)
def test_lookup_fold_at_the_eval_grids(dev, dtype, h1, w1):
    """G over the 4-level pyramid of these grids (an odd H/8 at KITTI's),
    coords a multi-pixel flow away, at the RAFT widths."""
    g = torch.Generator(device=dev).manual_seed(40)
    levels, w, bias = _fold_operands(g, dev, dtype, 1, h1, w1, 4, 256)
    from focusflow_official_tpu_torch.ops.coords import coords_grid
    coords = (coords_grid(1, h1, w1, device=dev)
              + torch.randn((1, h1, w1, 2), generator=g, device=dev) * 8).contiguous()
    _check_lookup_fold(levels, coords, 4, w, bias)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h1,w1", EVAL_GRIDS)
def test_instance_norm_at_the_eval_fnet_shapes(dev, dtype, h1, w1):
    """C1 and C2 (both forms) at the fnet's three shapes for these grids:
    (2, 4 h1, 4 w1, 64), (2, 2 h1, 2 w1, 96), (2, h1, w1, 128)."""
    g = torch.Generator(device=dev).manual_seed(41)
    for shape in ((2, 4 * h1, 4 * w1, 64), (2, 2 * h1, 2 * w1, 96), (2, h1, w1, 128)):
        x = (torch.randn(shape, generator=g, device=dev) * 3 + 1).to(dtype)
        r = torch.randn(shape, generator=g, device=dev).to(dtype)
        mean, inv, entry = _stats_entry(x)
        assert entry == "vector"
        rmean, rinv = kin.stats_plain(x)
        torch.testing.assert_close(mean, rmean, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(inv, rinv, rtol=1e-4, atol=1e-5)
        for res in (None, r):
            y, key = _normalize(x, mean, inv, True, res)
            assert key[-2:] == ("vector", "plain" if res is None else "residual")
            torch.testing.assert_close(y, kin.apply_plain(x, mean, inv, True, res),
                                       rtol=0, atol=0)


def test_validate_kitti_card_against_cpu(dev):
    """The validation protocol on two mixed-shape sparse pairs (the
    multi-pixel affine input, per-shape 'kitti' padding), FF-RAFT at full
    width on the trained fixture, 8 refinements, f32: the card's metrics
    within 1e-3 of the same code's CPU run (f32 on both; TF32 off)."""
    from focusflow_official_tpu_torch.data import synthetic
    from focusflow_official_tpu_torch.models import FFRaftConfig
    from focusflow_official_tpu_torch.predict import FlowPredictor
    from focusflow_official_tpu_torch.train.evaluate import validate_kitti

    fixture = os.path.join(os.path.dirname(__file__), "fixtures", "trained_smoke.npz")
    cfg = FFRaftConfig(fuse_cnet=True)
    ds = synthetic.kitti_layout(0, shapes=((125, 414), (120, 408)))
    got = validate_kitti(FlowPredictor(cfg, fixture, device="cuda", dtype=torch.float32).model,
                         ds, iters=8)
    want = validate_kitti(FlowPredictor(cfg, fixture, device="cpu", dtype=torch.float32).model,
                          ds, iters=8)
    assert got.keys() == want.keys() and len(got) == 3
    for k in want:
        assert np.isfinite(got[k]) and abs(got[k] - want[k]) <= 1e-3 * max(1.0, abs(want[k])), (
            k, got[k], want[k])


# ---- training: each Function's backward on the card against autograd
# through its plain version on the same inputs (the plain versions run on
# the card too); one small shape and one of the training step's (B=10 at
# 368x496: a 46x62 grid; the fnet at B=20). bf16 gradients within one bf16
# ulp of the largest plain gradient (2^-7 of it), f32 within 1e-5 of it.
GRAD_SHAPES = {"small": (2, 8, 16), "train": (10, 46, 62)}


def _grad_tol(want):
    return (2.0 ** -7 if want.dtype == torch.bfloat16 else 1e-5) * float(want.float().abs().max())


def _grad_pair(fn, plain, inputs, cot):
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    got = torch.autograd.grad(fn(*leaves), leaves, cot)
    ref = [t.detach().requires_grad_(True) for t in inputs]
    want = torch.autograd.grad(plain(*ref), ref, cot)
    return got, want


def _grad_levels(g, b, h1, w1, dtype, dev):
    corr = torch.randn((b, h1 * w1, h1, w1), generator=g, device=dev)
    levels = corr_pyramid(corr, 4, dtype)
    coords = _hard_coords(g, b, h1, w1, max(h1, w1), dev)
    return levels, coords


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size", sorted(GRAD_SHAPES))
def test_lookup_fold_backward(dev, dtype, size):
    """G's Function: a grad_fn on a CUDA tensor with grad enabled, and the
    weight's, the bias's and every level's gradient against autograd
    through `lookup_fold_plain`; its backward launches kernel A once."""
    g = torch.Generator(device=dev).manual_seed(31)
    b, h1, w1 = GRAD_SHAPES[size]
    levels, coords = _grad_levels(g, b, h1, w1, dtype, dev)
    w = (torch.randn((256, 324), generator=g, device=dev) / 18).to(dtype)
    bias = (torch.randn(256, generator=g, device=dev) * 0.1).to(dtype)
    cot = torch.randn((b, h1, w1, 256), generator=g, device=dev).to(dtype)
    out = klf.lookup_fold([lv.requires_grad_(True) for lv in levels], coords, 4,
                          w.requires_grad_(True), bias)
    assert out.grad_fn is not None
    before = launch_counts["lookup"]
    out.backward(cot)
    assert launch_counts["lookup"] == before + 1
    got, want = _grad_pair(lambda w_, b_, *lv: klf.lookup_fold(lv, coords, 4, w_, b_),
                           lambda w_, b_, *lv: klf.lookup_fold_plain(lv, coords, 4, w_, b_),
                           [w, bias, *levels], cot)
    for a, e in zip(got, want):
        assert a.dtype == e.dtype and torch.isfinite(a).all()
        assert float((a.float() - e.float()).abs().max()) <= _grad_tol(e)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size", sorted(GRAD_SHAPES))
def test_lookup_backward(dev, dtype, size):
    """A's Function: the levels' and (f32) the coordinates' gradients
    against autograd through `lookup_plain`."""
    g = torch.Generator(device=dev).manual_seed(32)
    b, h1, w1 = GRAD_SHAPES[size]
    levels, coords = _grad_levels(g, b, h1, w1, dtype, dev)
    coords = (coords.clamp(-30, 90) + 0.37).contiguous()  # no coordinate on a tent's kink
    cot = torch.randn((b, h1, w1, 324), generator=g, device=dev).to(dtype)
    inputs = [*levels] + ([coords] if dtype == torch.float32 else [])
    split = (lambda a: (a[:4], a[4] if len(a) > 4 else coords))
    got, want = _grad_pair(lambda *a: kl.lookup(split(a)[0], split(a)[1], 4),
                           lambda *a: kl.lookup_plain(split(a)[0], split(a)[1], 4),
                           inputs, cot)
    assert kl.lookup([lv.requires_grad_(True) for lv in levels], coords, 4).grad_fn is not None
    for a, e in zip(got, want):
        assert a.dtype == e.dtype and torch.isfinite(a).all()
        assert float((a.float() - e.float()).abs().max()) <= _grad_tol(e)


def test_fold_backward(dev):
    g = torch.Generator(device=dev).manual_seed(33)
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.randn((7040, 324), generator=g, device=dev).to(dtype)
        w = (torch.randn((256, 324), generator=g, device=dev) / 18).to(dtype)
        bias = torch.randn(256, generator=g, device=dev).to(dtype)
        cot = torch.randn((7040, 256), generator=g, device=dev).to(dtype)
        assert kf.fold(a.requires_grad_(True), w, bias).grad_fn is not None
        got, want = _grad_pair(kf.fold, kf.fold_plain, [a, w, bias], cot)
        for x, e in zip(got, want):
            assert float((x.float() - e.float()).abs().max()) <= _grad_tol(e)


IN_GRAD_SHAPES = {"small": (2, 9, 13, 64), "train": (20, 46, 62, 128)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size", sorted(IN_GRAD_SHAPES))
def test_instance_norm_stats_backward(dev, dtype, size):
    g = torch.Generator(device=dev).manual_seed(34)
    x = (torch.randn(IN_GRAD_SHAPES[size], generator=g, device=dev) * 3 + 1).to(dtype)
    b, c = x.shape[0], x.shape[3]
    cot = (torch.randn((b, c), generator=g, device=dev), torch.randn((b, c), generator=g, device=dev))
    assert kin.instance_norm_stats(x.requires_grad_(True))[0].grad_fn is not None
    (got,), (want,) = _grad_pair(kin.instance_norm_stats, kin.stats_plain, [x], cot)
    assert got.dtype == x.dtype
    assert float((got.float() - want.float()).abs().max()) <= _grad_tol(want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size", sorted(IN_GRAD_SHAPES))
@pytest.mark.parametrize("form", ["plain", "residual"])
def test_instance_norm_backward(dev, dtype, size, form):
    """C1 then C2 with ReLU: x's gradient against autograd through the
    plain version in f32 from the same inputs (the bf16 plain version
    masks its ReLU on the rounded output, which the f32 VJP does not), the
    residual form's ReLU masked where the forward's output is > 0, and the
    residual's gradient that masked cotangent to the bit."""
    g = torch.Generator(device=dev).manual_seed(35)
    shape = IN_GRAD_SHAPES[size]
    x = (torch.randn(shape, generator=g, device=dev) * 3 + 1).to(dtype)
    r = torch.randn(shape, generator=g, device=dev).to(dtype) if form == "residual" else None
    cot = torch.randn(shape, generator=g, device=dev).to(dtype)
    leaves = [x.detach().requires_grad_(True)] + ([] if r is None else [r.detach().requires_grad_(True)])
    y = kin.instance_norm(leaves[0], 1e-5, True, *leaves[1:])
    assert y.grad_fn is not None
    got = torch.autograd.grad(y, leaves, cot)
    g_in = cot if r is None else torch.where(y.detach() > 0, cot, torch.zeros_like(cot))
    if r is not None:
        assert torch.equal(got[1], g_in)
    x32 = x.detach().float().requires_grad_(True)
    (want,) = torch.autograd.grad(kin.apply_plain(x32, *kin.stats_plain(x32), True), x32,
                                  g_in.float())
    assert got[0].dtype == dtype
    assert float((got[0].float() - want).abs().max()) <= _grad_tol(want.to(dtype))


def test_train_step_on_card_matches_cpu(dev):
    """One f32 step of the trained fixture on two 64x96 samples: the loss
    within 1e-4 and the gradient's cosine >= 0.9999 against the CPU; the
    bf16 step's loss within 2% and every gradient finite, in f32."""
    from focusflow_official_tpu_torch.compat.weights import load_npz
    from focusflow_official_tpu_torch.data.synthetic import chairs_layout
    from focusflow_official_tpu_torch.losses import build_sequence_loss
    from focusflow_official_tpu_torch.models import FFRaft, FFRaftConfig
    from focusflow_official_tpu_torch.train.loop import forward_loss

    ds = chairs_layout(0, n=2, h=64, w=96)
    batch = {k: torch.as_tensor(np.stack([ds[i][k] for i in range(2)]))
             for k in ("image1", "image2", "mask1", "mask2", "flow", "valid")}
    fixture = os.path.join(os.path.dirname(__file__), "fixtures", "trained_smoke.npz")

    def step(device, dtype):
        model = FFRaft(FFRaftConfig(fusion="parallel", fuse_cnet=True, iters=4,
                                    compute_dtype=dtype))
        model.load_state_dict(load_npz(fixture), strict=True)
        model.to(device)
        if device != "cpu":
            model.to(memory_format=torch.channels_last)
        model.train()
        loss, _ = forward_loss(model, build_sequence_loss("MixLoss"),
                               {k: v.to(device) for k, v in batch.items()}, iters=4,
                               dtype=getattr(torch, dtype))
        loss.backward()
        grads = [p.grad for p in model.parameters()]
        assert all(gr.dtype == torch.float32 and torch.isfinite(gr).all() for gr in grads)
        return float(loss.detach()), torch.cat([gr.flatten().cpu() for gr in grads])

    cpu_loss, cpu_grad = step("cpu", "float32")
    loss, grad = step(dev, "float32")
    assert abs(loss - cpu_loss) <= 1e-4 * abs(cpu_loss)
    assert float(F.cosine_similarity(grad.double(), cpu_grad.double(), dim=0)) >= 0.9999
    bf_loss, _ = step(dev, "bfloat16")
    assert abs(bf_loss - loss) <= 0.02 * abs(loss)


# ---- training FF-PWCNet and FF-FlowFormer: D's, E's and F's Functions on
# the card against autograd through their plain versions on the card, at a
# small shape and at shapes of the training steps (PWC B=8 at 384x512: its
# finest and coarsest levels; FlowFormer B=6 at 368x496: the Twins stage-1
# attentions over both frames, B=12, and the decoder's cross-attention,
# B x Q = 6 x 2852 entries). Bounds as above.
CORR_GRAD_SHAPES = {"small": (2, 9, 13, 24), "train_level2": (8, 96, 128, 32),
                    "train_level6": (8, 6, 8, 196)}


@pytest.mark.parametrize("slope", [None, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size", sorted(CORR_GRAD_SHAPES))
def test_local_corr_backward(dev, dtype, size, slope):
    g = torch.Generator(device=dev).manual_seed(41)
    shape = CORR_GRAD_SHAPES[size]
    f1, f2 = (torch.randn(shape, generator=g, device=dev).to(dtype) for _ in range(2))
    cot = torch.randn((*shape[:3], 81), generator=g, device=dev).to(dtype)
    out = klc.local_corr(f1.detach().requires_grad_(True), f2, 4, negative_slope=slope)
    assert out.grad_fn is not None
    got, want = _grad_pair(lambda a, b: klc.local_corr(a, b, 4, negative_slope=slope),
                           lambda a, b: klc.local_corr_plain(a, b, 4, slope), [f1, f2], cot)
    for a, e in zip(got, want):
        assert a.dtype == e.dtype == dtype and torch.isfinite(a).all()
        assert float((a.float() - e.float()).abs().max()) <= _grad_tol(e)


# (b, n, m, c, heads)
ATTN_GRAD_SHAPES = {"small": (3, 70, 20, 64, 4), "train_twins1": (12, 11408, 192, 128, 4),
                    "train_decoder": (17112, 1, 8, 64, 8)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size", sorted(ATTN_GRAD_SHAPES))
def test_attention_backward(dev, dtype, size):
    g = torch.Generator(device=dev).manual_seed(42)
    b, n, m, c, heads = ATTN_GRAD_SHAPES[size]
    q = torch.randn((b, n, c), generator=g, device=dev).to(dtype)
    k = torch.randn((b, m, c), generator=g, device=dev).to(dtype)
    v = torch.randn((b, m, c), generator=g, device=dev).to(dtype)
    cot = torch.randn((b, n, c), generator=g, device=dev).to(dtype)
    scale = (c // heads) ** -0.5
    assert ka.small_kv_attention(q.detach().requires_grad_(True), k, v, heads,
                                 scale).grad_fn is not None
    got, want = _grad_pair(lambda *t: ka.small_kv_attention(*t, heads, scale),
                           lambda *t: ka.small_kv_attention_plain(*t, heads, scale),
                           [q, k, v], cot)
    for a, e in zip(got, want):
        assert a.dtype == e.dtype == dtype and torch.isfinite(a).all()
        assert float((a.float() - e.float()).abs().max()) <= _grad_tol(e)


WINDOW_GRAD_SHAPES = {"small": (2, 14, 21, 64, 4), "train_twins1": (12, 98, 126, 128, 4)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size", sorted(WINDOW_GRAD_SHAPES))
def test_window_attention_backward(dev, dtype, size):
    g = torch.Generator(device=dev).manual_seed(43)
    b, hp, wp, c, heads = WINDOW_GRAD_SHAPES[size]
    q, k, v, cot = (torch.randn((b, hp, wp, c), generator=g, device=dev).to(dtype)
                    for _ in range(4))
    scale = (c // heads) ** -0.5
    assert kw.window_attention(q.detach().requires_grad_(True), k, v, 7, heads,
                               scale).grad_fn is not None
    got, want = _grad_pair(lambda *t: kw.window_attention(*t, 7, heads, scale),
                           lambda *t: kw.window_attention_plain(*t, 7, heads, scale),
                           [q, k, v], cot)
    for a, e in zip(got, want):
        assert a.dtype == e.dtype == dtype and torch.isfinite(a).all()
        assert float((a.float() - e.float()).abs().max()) <= _grad_tol(e)


def _family_step(family, device, dtype):
    """One forward and backward (`train/loop.py::forward_backward`) of a
    trained fixture on two samples, no noise -> (loss, the flat gradient
    on the CPU, the TF32 settings inside the forward). FF-RAFT 64x96 with
    4 refinements, FF-PWCNet 64x128, FF-FlowFormer 64x96 with 2."""
    from focusflow_official_tpu_torch.compat.weights import load_npz
    from focusflow_official_tpu_torch.data.synthetic import chairs_layout
    from focusflow_official_tpu_torch.losses import build_multiscale_loss, build_sequence_loss
    from focusflow_official_tpu_torch.models import (FFPWCNet, FFPWCNetConfig, FFRaft,
                                                     FFRaftConfig, FFFlowFormer,
                                                     FlowFormerConfig)
    from focusflow_official_tpu_torch.train.loop import forward_backward

    fixtures = os.path.join(os.path.dirname(__file__), "fixtures")
    if family == "raft":
        model = FFRaft(FFRaftConfig(fusion="parallel", fuse_cnet=True, iters=4,
                                    compute_dtype=dtype))
        fixture, w, iters, loss_fn = "trained_smoke.npz", 96, 4, build_sequence_loss("MixLoss")
    elif family == "pwc":
        model = FFPWCNet(FFPWCNetConfig(compute_dtype=dtype))
        fixture, w, iters = "trained_smoke_pwc.npz", 128, None
        loss_fn = build_multiscale_loss("MixLoss", weights=[0.005, 0.01, 0.02, 0.08, 0.32])
    else:
        model = FFFlowFormer(FlowFormerConfig(encoder_depth=1, decoder_depth=2,
                                              compute_dtype=dtype))
        fixture, w, iters, loss_fn = "trained_smoke_ff.npz", 96, 2, build_sequence_loss("MixLoss")
    model.load_state_dict(load_npz(os.path.join(fixtures, fixture)), strict=True)
    model.to(device)
    if device != "cpu":
        model.to(memory_format=torch.channels_last)
    model.train()
    inside = []
    model.register_forward_hook(lambda *_: inside.append(
        (torch.backends.cuda.matmul.fp32_precision, torch.backends.cudnn.conv.fp32_precision)))
    ds = chairs_layout(0, n=2, h=64, w=w)
    batch = {k: torch.as_tensor(np.stack([ds[i][k] for i in range(2)])).to(device)
             for k in ("image1", "image2", "mask1", "mask2", "flow", "valid")}
    loss, _ = forward_backward(model, loss_fn, batch, iters=iters, dtype=getattr(torch, dtype))
    # GMA's relative position tables take no gradient: zeros, as the step gives them
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in model.parameters()]
    assert all(gr.dtype == torch.float32 and torch.isfinite(gr).all() for gr in grads)
    return float(loss.detach()), torch.cat([gr.flatten().cpu() for gr in grads]), inside


@pytest.mark.parametrize("family", ["pwc", "flowformer"])
def test_family_train_step_on_card_matches_cpu(dev, family):
    """One f32 step of FF-PWCNet (kernel D) and FF-FlowFormer (A, B, E, F,
    each backward through its Function) on the card against the CPU: the
    loss within 1e-4 and the gradient's cosine >= 0.9999; the bf16 step's
    loss within 2% of the f32 step's and every gradient finite, in f32."""
    names = {"pwc": ("local_corr",),
             "flowformer": ("lookup", "fold", "attention", "window_attention")}[family]
    cpu_loss, cpu_grad, _ = _family_step(family, "cpu", "float32")
    before = dict(launch_counts)
    loss, grad, _ = _family_step(family, dev, "float32")
    assert all(launch_counts[n] > before[n] for n in names)
    assert abs(loss - cpu_loss) <= 1e-4 * abs(cpu_loss)
    assert float(F.cosine_similarity(grad.double(), cpu_grad.double(), dim=0)) >= 0.9999
    bf_loss, _, _ = _family_step(family, dev, "bfloat16")
    assert abs(bf_loss - loss) <= 0.02 * abs(loss)


@pytest.mark.parametrize("family", ["raft", "pwc", "flowformer"])
def test_f32_train_step_under_default_tf32_matches_cpu(dev, family):
    """An f32 training step under PyTorch's default flags (cuDNN's TF32 on;
    the fixture `dev` turns it off) runs its forward and backward in full
    f32 (each backend's `fp32_precision` "ieee" inside), puts the flags
    back, and matches the CPU step: the loss within 1e-4, the gradient's
    cosine >= 0.9999."""
    cpu_loss, cpu_grad, _ = _family_step(family, "cpu", "float32")
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        loss, grad, inside = _family_step(family, dev, "float32")
        assert inside == [("ieee", "ieee")]
        assert torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    assert abs(loss - cpu_loss) <= 1e-4 * abs(cpu_loss)
    assert float(F.cosine_similarity(grad.double(), cpu_grad.double(), dim=0)) >= 0.9999


# ---- the baselines and the fusion ablation (plain RAFT, FF-RAFT with
# `fuse_cnet=False`, `abandon_fnet`, the CA, SA and concat units, vanilla
# FlowFormer): the predictor and one training step on the card against the
# CPU. RAFT weights: the trained fixture where names and shapes carry over,
# the rest seeded small (each new unit is q plus a small term); vanilla
# FlowFormer: seeded, its flow head scaled by 0.1 (the FF fixture's image
# half is no model, and seeded weights at full scale make the refinements
# chaotic).
BASELINES = {
    "raft": dict(fusion=None, fuse_cnet=True),
    "fuse_cnet_false": dict(fusion="parallel", fuse_cnet=False),
    "abandon_fnet": dict(fusion=None, abandon_fnet=True),
    "CA": dict(fusion="parallel", fuse_cnet=True, fusion_type="CA"),
    "SA": dict(fusion="parallel", fuse_cnet=True, fusion_type="SA"),
    "concat": dict(fusion="parallel", fuse_cnet=True, fusion_type="concat"),
}


def _baseline_model(variant, dtype="float32", iters=4):
    """The variant's port model on the CPU, with its weights -> (model,
    refinements)."""
    from focusflow_official_tpu_torch.compat.weights import load_npz
    from focusflow_official_tpu_torch.models import (FFRaft, FFRaftConfig, FlowFormer,
                                                     FlowFormerConfig)

    fixtures = os.path.join(os.path.dirname(__file__), "fixtures")
    g = torch.Generator().manual_seed(3)
    if variant == "flowformer":
        model = FlowFormer(FlowFormerConfig(fusion=None, encoder_depth=1, decoder_depth=iters,
                                            compute_dtype=dtype))
        src = {}
    else:
        model = FFRaft(FFRaftConfig(iters=iters, compute_dtype=dtype, **BASELINES[variant]))
        src = load_npz(os.path.join(fixtures, "trained_smoke.npz"))
    sd = {}
    for k, t in model.state_dict().items():
        if k in src and src[k].shape == t.shape:
            sd[k] = src[k]
        elif t.dim() == 1 and k.endswith("weight"):  # FlowFormer's LayerNorm scales
            sd[k] = 1 + 0.1 * torch.randn(t.shape, generator=g)
        else:
            scale = 1 / math.sqrt(t[0].numel()) if t.dim() > 1 else 0.1
            if variant != "flowformer":
                scale *= 0.1
            elif "flow_head" in k:
                scale *= 0.1
            sd[k] = scale * torch.randn(t.shape, generator=g)
    model.load_state_dict(sd, strict=True)
    return model, iters


@pytest.mark.parametrize("variant", sorted(BASELINES) + ["flowformer"])
def test_baseline_predictor_on_card_matches_cpu(dev, variant, tmp_path):
    """The variant's f32 forward on the card (its kernels launched: G, and
    C1 and C2 where an fnet normalises by instance; A, B, E and F for
    FlowFormer) against the same forward on the CPU at 96x128 (FlowFormer
    64x96), 4 refinements: 1e-2 px, the port's parity bound."""
    from focusflow_official_tpu_torch.compat.weights import params_to_jax
    from focusflow_official_tpu_torch.predict import FlowPredictor

    model, _ = _baseline_model(variant)
    path = tmp_path / "weights.npz"
    np.savez(path, **params_to_jax(model.state_dict()))
    h, w = (64, 96) if variant == "flowformer" else (96, 128)
    rng = np.random.RandomState(4)
    i1 = (rng.rand(h, w, 3) * 255).astype(np.float32)
    i2 = np.roll(np.roll(i1, -2, 0), 3, 1)
    m1 = ((rng.rand(h, w, 1) > 0.97) * 255).astype(np.float32)
    m2 = ((rng.rand(h, w, 1) > 0.97) * 255).astype(np.float32)
    names = (("lookup", "fold", "attention", "window_attention") if variant == "flowformer"
             else ("lookup_fold",) if variant == "abandon_fnet"
             else ("lookup_fold", "in_stats", "in_normalize"))
    before = dict(launch_counts)
    on_card = FlowPredictor(model.cfg, str(path), device=dev)(i1, i2, m1, m2)
    assert all(launch_counts[n] > before.get(n, 0) for n in names), names
    on_cpu = FlowPredictor(model.cfg, str(path), device="cpu")(i1, i2, m1, m2)
    assert np.isfinite(on_card).all()
    assert float(np.abs(on_card - on_cpu).max()) <= 1e-2


VARIANTS = {
    "raft_s": dict(fusion=None, small=True),
    "ff_raft_s": dict(fusion="parallel", fuse_cnet=True, small=True),
    "alt_corr": dict(fusion="parallel", fuse_cnet=True, alt_corr=True, alt_corr_chunk=40),
    "attention": dict(fusion="attention", fusion_channel=32),
    "conv": dict(fusion="conv", fusion_channel=32),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_predictor_on_card_matches_cpu(dev, variant, tmp_path):
    """The FF-RAFT variants' f32 forward on the card (G at radius 3 and N =
    96 for the small models, G once a chunk for ALT_CORR: 40 queries, 4
    chunks and a tail of 32; C1 and C2 where an fnet normalises by
    instance) against the same forward on the CPU at 96x128, 4 refinements:
    1e-2 px, the port's parity bound. Weights: the fixture's where the name
    and shape carry over, norms and temperatures at their initialisation,
    the rest seeded small."""
    from focusflow_official_tpu_torch.compat.weights import load_npz, params_to_jax
    from focusflow_official_tpu_torch.models import FFRaft, FFRaftConfig
    from focusflow_official_tpu_torch.predict import FlowPredictor

    model = FFRaft(FFRaftConfig(iters=4, **VARIANTS[variant]))
    src = load_npz(os.path.join(os.path.dirname(__file__), "fixtures", "trained_smoke.npz"))
    g = torch.Generator().manual_seed(5)
    sd = {}
    for k, t in model.state_dict().items():
        if k in src and src[k].shape == t.shape:
            sd[k] = src[k]
        elif k.endswith(("running_mean", "running_var", "temperature")) or (
                t.dim() == 1 and k.endswith("weight")):
            sd[k] = t
        else:
            scale = 0.1 / math.sqrt(t[0].numel()) if t.dim() > 1 else 0.01
            sd[k] = scale * torch.randn(t.shape, generator=g)
    path = tmp_path / "weights.npz"
    np.savez(path, **params_to_jax(sd))
    rng = np.random.RandomState(6)
    i1 = (rng.rand(96, 128, 3) * 255).astype(np.float32)
    i2 = np.roll(np.roll(i1, -2, 0), 3, 1)
    m1 = ((rng.rand(96, 128, 1) > 0.97) * 255).astype(np.float32)
    m2 = ((rng.rand(96, 128, 1) > 0.97) * 255).astype(np.float32)
    before, shapes = launch_counts["lookup_fold"], dict(launch_shapes)
    on_card = FlowPredictor(model.cfg, str(path), device=dev)(i1, i2, m1, m2)
    g_keys = {key: c - shapes.get(key, 0) for key, c in launch_shapes.items()
              if key[0] == "lookup_fold" and c != shapes.get(key, 0)}
    if variant == "alt_corr":
        assert {key[2]: c for key, c in g_keys.items()} == {40: 16, 32: 4}
    else:
        assert launch_counts["lookup_fold"] == before + 4
        assert {(key[-6], key[-5]) for key in g_keys} == (
            {(3, 96)} if model.cfg.small else {(4, 256)})
    on_cpu = FlowPredictor(model.cfg, str(path), device="cpu")(i1, i2, m1, m2)
    assert np.isfinite(on_card).all()
    assert float(np.abs(on_card - on_cpu).max()) <= 1e-2


def _baseline_step(variant, device, dtype):
    """One forward and backward of the variant on two 64x96 samples, 2
    refinements, no noise -> (loss, the flat gradient on the CPU)."""
    from focusflow_official_tpu_torch.data.synthetic import chairs_layout
    from focusflow_official_tpu_torch.losses import build_sequence_loss
    from focusflow_official_tpu_torch.train.loop import forward_backward

    model, iters = _baseline_model(variant, dtype, iters=2)
    model.to(device)
    if device != "cpu":
        model.to(memory_format=torch.channels_last)
    model.train()
    ds = chairs_layout(0, n=2, h=64, w=96)
    batch = {k: torch.as_tensor(np.stack([ds[i][k] for i in range(2)])).to(device)
             for k in ("image1", "image2", "mask1", "mask2", "flow", "valid")}
    loss, _ = forward_backward(model, build_sequence_loss("MixLoss"), batch, iters=iters,
                               dtype=getattr(torch, dtype))
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in model.parameters()]
    assert all(gr.dtype == torch.float32 and torch.isfinite(gr).all() for gr in grads)
    return float(loss.detach()), torch.cat([gr.flatten().cpu() for gr in grads])


@pytest.mark.parametrize("variant", ["raft", "flowformer"])
def test_baseline_train_step_on_card_matches_cpu(dev, variant):
    """One f32 step of plain RAFT (G, A, C1, C2 through their Functions)
    and vanilla FlowFormer (A, B, E, F) on the card against the CPU: the
    loss within 1e-4 and the gradient's cosine >= 0.9999; the bf16 step's
    loss within 2% of the f32 step's and every gradient finite."""
    cpu_loss, cpu_grad = _baseline_step(variant, "cpu", "float32")
    loss, grad = _baseline_step(variant, dev, "float32")
    assert abs(loss - cpu_loss) <= 1e-4 * abs(cpu_loss)
    assert float(F.cosine_similarity(grad.double(), cpu_grad.double(), dim=0)) >= 0.9999
    bf_loss, _ = _baseline_step(variant, dev, "bfloat16")
    assert abs(bf_loss - loss) <= 0.02 * abs(loss)


@pytest.mark.parametrize("b,n,m", [
    (7040, 8, 448),    # patch size 4: the input layer at 1024x436 (14x32 patches)
    (17112, 8, 192),   # and in training, B=6 at 368x496 (12x16 patches)
    (37, 8, 449),      # a ragged last chunk past 448 keys
])
def test_attention_patch4_input_layer(dev, b, n, m):
    """E's staged entry at the patch-4 perceiver's keys, bf16, 8 heads of 16:
    the staged plan fits at least two blocks an SM, the launch counts under
    `staged`, and the output is within the entry's tolerance (f32 weights:
    `_ATTN_TOL`) and within `bf16_bound` of the plain version."""
    g = torch.Generator(device=dev).manual_seed(21)
    q, k, v = (torch.randn((b, nm, 128), generator=g, device=dev).bfloat16()
               for nm in (n, m, m))
    assert ka.design(q, k, v, 8) == "staged"
    assert ka.staged_launch(q, k, v, 8)["blocks_per_sm"] >= 2
    before = dict(launch_shapes)
    got = ka.small_kv_attention(q, k, v, 8, 0.25)
    (key,) = [key for key, c in launch_shapes.items() if c != before.get(key, 0)]
    assert key == ("attention", b, n, m, 128, 128, 8, "torch.bfloat16", "staged")
    want = ka.small_kv_attention_plain(q, k, v, 8, 0.25)
    torch.testing.assert_close(got.float(), want.float(), **_ATTN_TOL[torch.bfloat16])
    bound = ka.bf16_bound(want, q, k, v, 8, 0.25)
    assert bool(((got.float() - want.float()).abs() <= bound).all())


def test_attention_patch4_backward_is_chunked(dev):
    """The training input layer's backward at patch size 4, (17112, 8) x 192
    keys, 8 heads: its f32 softmax weights (841 MB) are taken in chunks of
    `VJP_CHUNK_BYTES`; the gradients against autograd through the plain
    version in f32 within 1e-4 of each one's largest."""
    g = torch.Generator(device=dev).manual_seed(22)
    b, n, m = 17112, 8, 192
    q, k, v = (torch.randn((b, nm, 128), generator=g, device=dev).bfloat16()
               for nm in (n, m, m))
    cot = torch.randn((b, n, 128), generator=g, device=dev).bfloat16()
    assert 8 * n * m * 4 * b > ka.VJP_CHUNK_BYTES
    got = ka.attention_vjp(q, k, v, 8, 0.25, cot)
    qf, kf_, vf = (t.float().requires_grad_(True) for t in (q, k, v))
    want = torch.autograd.grad(ka.small_kv_attention_plain(qf, kf_, vf, 8, 0.25),
                               (qf, kf_, vf), cot.float())
    for a, w_ in zip(got, want):
        top = float(w_.abs().max())
        assert float((a.float() - w_).abs().max()) <= 1e-4 * top + 2.0 ** -8 * top


def test_window_attention_group_shapes(dev):
    """F at group attention's shape, (10, 56, 133, 128), 8 heads of 16, on
    k and v shifted by one window in five batch groups (`_shift_groups`):
    the tensor-core entry within `bf16_bound` of the plain version on the
    same shifted tensors."""
    from focusflow_official_tpu_torch.nn.latent_cost import _shift_groups

    g = torch.Generator(device=dev).manual_seed(23)
    q, k, v = (torch.randn((10, 56, 133, 128), generator=g, device=dev).bfloat16()
               for _ in range(3))
    _check_window(q, _shift_groups(k, 7), _shift_groups(v, 7), 8, 0.25)


FF_VARIANTS = {
    "no_gma": dict(gma=False),
    "mlp": dict(use_mlp=True),
    "convnext": dict(vertical_conv=True),
    "only_global": dict(only_global=True),
    "patch4": dict(patch_size=4),
    "no_res_no_token": dict(cost_encoder_res=False, add_flow_token=False),
}


@pytest.mark.parametrize("variant", sorted(FF_VARIANTS))
def test_ff_variant_predictor_on_card_matches_cpu(dev, variant, tmp_path):
    """FF-FlowFormer's variants, f32, on the card against the same forward
    on the CPU at 64x96, encoder depth 1, 4 refinements: 1e-2 px, the
    port's parity bound, on seeded weights (ConvNext's gamma at 0.1 so the
    layer acts). A, E and F launch; B once a refinement in the only-global
    form (the flow token alone), twice otherwise."""
    from focusflow_official_tpu_torch.compat.weights import params_to_jax
    from focusflow_official_tpu_torch.models import FFFlowFormer, FlowFormerConfig
    from focusflow_official_tpu_torch.predict import FlowPredictor

    cfg = FlowFormerConfig(encoder_depth=1, decoder_depth=4, **FF_VARIANTS[variant])
    g = torch.Generator().manual_seed(8)
    sd = {}
    for k, t in FFFlowFormer(cfg).state_dict().items():
        if t.dim() == 1 and k.endswith("weight"):  # LayerNorm scales
            sd[k] = 1 + 0.1 * torch.randn(t.shape, generator=g)
        else:
            scale = 1 / math.sqrt(t[0].numel()) if t.dim() > 1 else 0.1
            sd[k] = scale * (0.1 if "flow_head" in k else 1.0) * torch.randn(
                t.shape, generator=g)
    path = tmp_path / "weights.npz"
    np.savez(path, **params_to_jax(sd))
    rng = np.random.RandomState(4)
    i1 = (rng.rand(64, 96, 3) * 255).astype(np.float32)
    i2 = np.roll(np.roll(i1, -2, 0), 3, 1)
    m1 = ((rng.rand(64, 96, 1) > 0.97) * 255).astype(np.float32)
    m2 = ((rng.rand(64, 96, 1) > 0.97) * 255).astype(np.float32)
    before = dict(launch_counts)
    on_card = FlowPredictor(cfg, str(path), device=dev)(i1, i2, m1, m2)
    ran = {n: launch_counts[n] - before.get(n, 0) for n in launch_counts}
    assert ran["lookup"] == 4 and ran["fold"] == (4 if cfg.only_global else 8)
    assert ran["attention"] > 0 and ran["window_attention"] > 0
    on_cpu = FlowPredictor(cfg, str(path), device="cpu")(i1, i2, m1, m2)
    assert np.isfinite(on_card).all()
    assert float(np.abs(on_card - on_cpu).max()) <= 1e-2


def test_group_vertical_layer_on_card_matches_cpu(dev):
    """`GroupVerticalSelfAttentionLayer` with the context, f32, on the card
    (F on the shifted windows) against the CPU: within 1e-4 of the
    output's scale."""
    from focusflow_official_tpu_torch.nn.latent_cost import GroupVerticalSelfAttentionLayer

    torch.manual_seed(9)
    layer = GroupVerticalSelfAttentionLayer(128, 64, context_dim=256).eval()
    x = torch.randn(10, 11 * 13, 128)
    ctx = torch.randn(2, 11, 13, 256)
    with torch.no_grad():
        want = layer(x, (11, 13), ctx)
        n = launch_counts["window_attention"]
        got = layer.to(dev)(x.to(dev), (11, 13), ctx.to(dev)).cpu()
    assert launch_counts["window_attention"] == n + 1
    assert float((got - want).abs().max()) <= 1e-4 * max(1.0, float(want.abs().max()))


# FF-FlowFormer's LayerNorm rows in a 4-pair 1024x436 request: the cost
# patch embed's norm (4 x 7040 queries x 112 patches); Twins stage 1 over
# both frames, and the perceiver's latent tokens (28,160 queries x 8);
# Twins stage 2; the decoder's query tokens; then a row count that no
# block's rows divide
LN_SHAPES = [(3153920, 128), (225280, 128), (56320, 256), (28160, 64), (225281, 128)]


def _ln_inputs(rows, c, dtype, dev, wdtype=torch.float32, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn((rows, c), generator=g, device=dev) * 3 + 1).to(dtype)
    w = (1 + 0.1 * torch.randn(c, generator=g, device=dev)).to(wdtype)
    b = (0.1 * torch.randn(c, generator=g, device=dev)).to(wdtype)
    return x, w, b


def _ln_tol(want: torch.Tensor) -> float:
    """One bf16 ulp of the largest output (f32 statistics in another order
    can move a rounding by one); in f32, 1e-6 of it."""
    top = float(want.float().abs().max())
    if want.dtype == torch.bfloat16:
        return 2.0 ** (math.floor(math.log2(top)) - 7)
    return 1e-6 * top


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,c", LN_SHAPES)
def test_layer_norm_kernel(dev, dtype, rows, c):
    """The vector entry at the main path's shapes against the plain version
    (f32 statistics, the result cast to x's type); one launch, counted in
    `launch_counts` and not in `launch_shapes`."""
    x, w, b = _ln_inputs(rows, c, dtype, dev)
    assert kln.design(x) == "vector"
    n, shapes = launch_counts["layer_norm"], dict(launch_shapes)
    got = kln.layer_norm(x, w, b, 1e-5)
    assert launch_counts["layer_norm"] == n + 1 and launch_shapes == shapes
    want = kln.layer_norm_plain(x, w, b, 1e-5)
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=_ln_tol(want))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case,c,entries", [  # the entry in bf16, in f32
    ("vector", 128, ("vector", "vector")),
    ("idle lanes", 96, ("vector", "vector")),  # 12 vectors over 16 lanes; f32 24 over 32
    ("three vectors a lane", 520, ("vector", "scalar")),  # bf16: 65 vectors; f32: 130
    ("odd C", 37, ("scalar", "scalar")),
    ("misaligned x", 64, ("scalar", "scalar")),
    ("wide rows", 2048, ("scalar", "scalar")),  # past 128 vectors
    ("bf16 weights", 256, ("vector", "vector")),
])
def test_layer_norm_each_entry(dev, dtype, case, c, entries):
    rows = 1003
    wdtype = torch.bfloat16 if case == "bf16 weights" else torch.float32
    x, w, b = _ln_inputs(rows, c, dtype, dev, wdtype, seed=3)
    if case == "misaligned x":  # a contiguous view one element past a 16-byte boundary
        flat = torch.empty(rows * c + 8, dtype=dtype, device=dev)
        x = flat[1:1 + rows * c].view(rows, c).copy_(x)
    assert kln.design(x) == entries[dtype == torch.float32]
    got = kln.layer_norm(x, w, b, 1e-6)
    want = kln.layer_norm_plain(x, w, b, 1e-6)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=_ln_tol(want))


def test_layer_norm_strided_input_and_refusals(dev):
    """A strided x is read as its contiguous copy; weight, bias and x of
    another type or device are refused before any launch."""
    x, w, b = _ln_inputs(300, 128, torch.bfloat16, dev)
    xt = x.reshape(150, 2, 128).transpose(0, 1)
    torch.testing.assert_close(kln.layer_norm(xt, w, b, 1e-5).float(),
                               kln.layer_norm_plain(xt, w, b, 1e-5).float(), rtol=0,
                               atol=_ln_tol(kln.layer_norm_plain(xt, w, b, 1e-5)))
    n = launch_counts["layer_norm"]
    for args in ((x.half(), w, b), (x, w.cpu(), b), (x, w, b.bfloat16()), (x, w[:64], b[:64])):
        with pytest.raises(ValueError):
            kln.layer_norm(*args, 1e-5)
    assert launch_counts["layer_norm"] == n


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,c", [(225280, 128), (28160, 64), (1003, 37)])
def test_layer_norm_backward(dev, dtype, rows, c):
    """The Function's gradients for x, weight and bias against autograd
    through the plain version: within one bf16 ulp of the largest plain
    gradient (2^-7 of it), f32 within 1e-5 of it; the saved statistics
    within 1e-6 of the aten op's."""
    x, w, b = _ln_inputs(rows, c, dtype, dev, seed=5)
    g = torch.randn(x.shape, generator=torch.Generator(device=dev).manual_seed(6),
                    device=dev).to(dtype)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    got = torch.autograd.grad(kln.layer_norm(*leaves, 1e-5), leaves, g)
    ref = [t.clone().requires_grad_(True) for t in (x, w, b)]
    want = torch.autograd.grad(kln.layer_norm_plain(*ref, 1e-5), ref, g)
    share = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    for a, e in zip(got, want):
        assert a.dtype == e.dtype and torch.isfinite(a).all()
        tol = share * float(e.float().abs().max())
        torch.testing.assert_close(a.float(), e.float(), rtol=0, atol=tol)
    _, mean, rstd = kln._rows(x, w, b, 1e-5, stats=True)
    _, m_ref, r_ref = torch.ops.aten.native_layer_norm(x.float(), [c], w, b, 1e-5)
    torch.testing.assert_close(mean, m_ref, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(rstd, r_ref, rtol=1e-6, atol=0)


def test_serving_forwards_launch_layer_norm_once_a_call(dev):
    """One FF-FlowFormer serving forward at 4 x 436 x 1024 (the benchmark's
    request, padded to 440; encoder depth 3, 12 refinements) launches the
    LayerNorm kernel 99 times; an FF-RAFT forward, which has no such norm,
    none."""
    from focusflow_official_tpu_torch.config import model_from_config
    from focusflow_official_tpu_torch.models import FFRaftConfig, FlowFormerConfig
    from focusflow_official_tpu_torch.ops.padding import InputPadder
    from focusflow_official_tpu_torch.predict import eval_forward, for_inference

    g = torch.Generator(device=dev).manual_seed(7)
    frames = [torch.rand((4, 436, 1024, 3), generator=g, device=dev) * 255 for _ in range(2)]
    masks = [(torch.rand((4, 436, 1024, 1), generator=g, device=dev) > 0.97).float() * 255
             for _ in range(2)]
    inputs = InputPadder(frames[0].shape).pad(*frames, *masks)
    for cfg, want in ((FlowFormerConfig(compute_dtype="bfloat16"), 99),
                      (FFRaftConfig(fuse_cnet=True, compute_dtype="bfloat16"), 0)):
        torch.manual_seed(0)
        model, iters = model_from_config(cfg)
        model = for_inference(model, torch.bfloat16, dev)
        n, shapes = launch_counts["layer_norm"], dict(launch_shapes)
        flow, _ = eval_forward(model, *inputs, iters=iters)
        assert torch.isfinite(flow).all()
        assert launch_counts["layer_norm"] - n == want
        assert not [k for k in launch_shapes if k[0] == "layer_norm"]
        del model, flow


def _pyramid_rows(seed, shape, dtype, dev):
    """Chunk rows whose values span 2^-20 to 2^20 (so that any other order
    of a cell's four additions rounds otherwise somewhere), with exact
    zeros and a 2x2 cell of -0 in each map."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev)
    x = x * torch.exp2(torch.randint(-20, 21, shape, generator=g, device=dev).float())
    x[torch.rand(shape, generator=g, device=dev) < 0.01] = 0.0
    x[..., :2, :2] = -0.0
    return x.to(dtype)


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _check_pyramid(rows, num_levels, dtype, entry):
    """The kernel's levels against `corr_pyramid` on the same rows, bit for
    bit (the sign of zero too); one launch counted, no shape key."""
    from focusflow_official_tpu_torch.kernels import pyramid as kp

    assert kp.design(rows, num_levels) == entry
    n, shapes = launch_counts["pyramid"], dict(launch_shapes)
    got = kp.pyramid(rows, num_levels, dtype)
    assert launch_counts["pyramid"] == n + 1 and launch_shapes == shapes
    want = corr_pyramid(rows, num_levels, dtype)
    torch.cuda.synchronize()
    assert len(got) == len(want) == num_levels
    for lv, (a, e) in enumerate(zip(got, want)):
        assert a.dtype == e.dtype == dtype and a.shape == e.shape and a.is_contiguous()
        assert torch.equal(_bits(a), _bits(e)), f"level {lv}"


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,num_levels,entry", [
    ((1, 2048, 270, 480), 4, "vector"),  # a 3840x2160 chunk
    ((1, 576, 270, 480), 4, "vector"),   # its tail
    ((1, 2048, 55, 128), 4, "vector"),   # a 1024x436 chunk
    ((2, 804, 46, 62), 4, "scalar"),     # the chairs crop's training tail, B=2
    ((2, 5, 9, 11), 4, "scalar"),        # tiny odd maps
    ((2, 5, 7, 9), 3, "scalar"),
    ((1, 3, 13, 5), 3, "scalar"),
    ((3, 4, 15, 16), 4, "vector"),       # a band of 4 rows and one of 2
    ((3, 4, 15, 17), 3, "scalar"),
    ((1, 7, 6, 11), 2, "scalar"),
])
def test_pyramid_kernel_equals_corr_pyramid(dev, seed, dtype, shape, num_levels, entry):
    _check_pyramid(_pyramid_rows(seed, shape, dtype, dev), num_levels, dtype, entry)


def test_pyramid_misaligned_rows_take_the_scalar_entry(dev):
    src = _pyramid_rows(4, (2, 96, 55, 128), torch.bfloat16, dev)
    flat = torch.empty(src.numel() + 1, dtype=src.dtype, device=dev)
    rows = flat[1:].view(src.shape)  # contiguous, 2 bytes past a 16-byte boundary
    rows.copy_(src)
    _check_pyramid(rows, 4, torch.bfloat16, "scalar")


def test_pyramid_refusals(dev):
    """A strided view, a type other than bf16 or f32, levels in another type
    than the rows', a level of no cell and more levels than G looks up are
    refused before any launch; one level launches nothing."""
    from focusflow_official_tpu_torch.kernels import pyramid as kp

    rows = _pyramid_rows(5, (1, 4, 16, 24), torch.bfloat16, dev)
    n = launch_counts["pyramid"]
    for args in ((rows.transpose(-1, -2), 4, torch.bfloat16), (rows.half(), 4, torch.float16),
                 (rows, 4, torch.float16), (rows, 4, torch.float32),
                 (rows[..., :7, :].contiguous(), 4, torch.bfloat16),
                 (rows, 5, torch.bfloat16)):
        with pytest.raises(ValueError, match="pyramid"):
            kp.pyramid(*args)
    (only,) = kp.pyramid(rows, 1, torch.bfloat16)
    assert only is rows and launch_counts["pyramid"] == n


def _bf16_ulp(x):
    """One bf16 ulp at each value's magnitude (8 significant bits)."""
    return torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 8)


def _check_corr_levels(dev, b, n, h, w, c, num_levels, seed):
    """The chunk-levels kernel on queries s..s+n of random operands (s = 37
    for a tail, whose last tile reads past Q; 0 for a full chunk, with 100
    queries past it that must not be stored) against its plain version on
    the card: `corr_pyramid` of the f32 product (TF32 off). Every level
    within one bf16 ulp of the plain level plus 2^-20 of the level's
    largest: the kernel's f32 sums run in another order than cuBLAS's (a
    few f32 ulps of the terms, which only a near-cancelling cell sees
    beside its own bf16 ulp), and each level is rounded once from them.
    One launch counted, no shape key."""
    from focusflow_official_tpu_torch.kernels import corr_levels as kcl

    tail = n % 2048 != 0
    s = 37 if tail else 0
    q = s + n + (0 if tail else 100)
    g = torch.Generator(device=dev).manual_seed(seed)
    f1 = (torch.randn((b, q, c), generator=g, device=dev) * c ** -0.5).bfloat16()
    f2 = torch.randn((b, h * w, c), generator=g, device=dev).bfloat16()
    before, shapes = launch_counts["corr_levels"], dict(launch_shapes)
    got = kcl.corr_levels(f1, f2, s, n, h, w, num_levels)
    assert launch_counts["corr_levels"] == before + 1 and launch_shapes == shapes
    want = corr_pyramid(torch.matmul(f1[:, s:s + n].float(), f2.float().transpose(1, 2))
                        .reshape(b, n, h, w), num_levels, torch.float32)
    torch.cuda.synchronize()
    assert len(got) == num_levels
    for lv, (a, e) in enumerate(zip(got, want)):
        assert a.dtype == torch.bfloat16 and a.shape == e.shape and a.is_contiguous()
        err = (a.float() - e).abs()
        tol = _bf16_ulp(e) + 2.0 ** -20 * float(e.abs().max())
        worst = float((err - tol).max())
        assert worst <= 0, f"level {lv}: {worst} past the bound"
    del got, want


@pytest.mark.parametrize("c", [256, 128])
@pytest.mark.parametrize("b,n,h,w", [
    (1, 2048, 270, 480),  # a 3840x2160 chunk
    (1, 576, 270, 480),   # its tail
    (1, 2048, 55, 128),   # a 1024x436 chunk
    (1, 896, 55, 128),    # its tail
    (10, 2048, 46, 62),   # the chairs crop at B=10: rows not 16-byte aligned
    (10, 804, 46, 62),
])
def test_corr_levels_kernel_matches_its_plain_version(dev, c, b, n, h, w):
    _check_corr_levels(dev, b, n, h, w, c, 4, seed=n + c)


@pytest.mark.parametrize("b,n,h,w,c,num_levels", [
    (2, 100, 7, 9, 64, 3),    # one patch past both edges
    (3, 65, 13, 5, 72, 3),    # C past the last 64-channel slice
    (1, 64, 6, 11, 8, 2),
    (2, 5, 9, 40, 256, 1),
    (1, 130, 15, 33, 192, 4),
    (2, 2048, 17, 250, 256, 4),
])
def test_corr_levels_kernel_small_maps(dev, b, n, h, w, c, num_levels):
    """The same check on small and odd maps, any C a multiple of 8 up to
    256, one to four levels."""
    _check_corr_levels(dev, b, n, h, w, c, num_levels, seed=h * w)


def test_corr_levels_refusals(dev):
    """f32 operands, a C the kernel does not take, queries past Q and a
    level of no cell are refused before any launch."""
    from focusflow_official_tpu_torch.kernels import corr_levels as kcl

    f1 = torch.zeros((1, 64, 256), device=dev, dtype=torch.bfloat16)
    f2 = torch.zeros((1, 8 * 16, 256), device=dev, dtype=torch.bfloat16)
    n = launch_counts["corr_levels"]
    for args in ((f1.float(), f2.float(), 0, 64, 8, 16, 4), (f1[..., :12], f2[..., :12], 0, 64,
                 8, 16, 4), (f1, f2, 1, 64, 8, 16, 4), (f1, f2[:, :7 * 16], 0, 64, 7, 16, 4)):
        with pytest.raises(ValueError, match="corr_levels"):
            kcl.corr_levels(*args)
    assert launch_counts["corr_levels"] == n



def test_corr_levels_launcher_refuses_a_short_scratch(dev):
    """The launcher checks the levels-2-3 scratch against its own plan: a
    buffer one cell short of batch x patches x n x 24 is refused before
    any launch, one of that size is taken."""
    from focusflow_official_tpu_torch.kernels import corr_levels as kcl

    b, n, h, w, c = 1, 64, 8, 32, 64  # one patch
    f1 = torch.randn((b, n, c), device=dev).bfloat16()
    f2 = torch.randn((b, h * w, c), device=dev).bfloat16()
    levels = [torch.empty((b, n, h >> lv, w >> lv), dtype=torch.bfloat16, device=dev)
              for lv in range(4)]
    p = kcl.plan(b, n, h, w, 132)
    cells = b * p["py"] * p["px"] * n * 24
    coarse = torch.empty(cells, dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for have, ok in ((cells - 1, False), (cells, True)):
        err = kcl._lib().ff_corr_levels_launch(
            f1.data_ptr(), f2.data_ptr(), *[lv.data_ptr() for lv in levels],
            coarse.data_ptr(), have, b, n, 0, n, h, w, c, 4, p["per"], p["grid"], stream)
        assert (err == 0) == ok, (have, err)
    torch.cuda.synchronize()

# the 4K walk's flow against its plain chunks': the largest gap over the
# largest flow (at least 1 px). Three seeds read 0.0014-0.0020 (flow) and
# 0.0030-0.0039 (flow_lr) on an H100: a bf16 ulp at the odd cell (the f32
# sums' order) that the bf16 refinements carry on. 6e-3 is 1.5 x the largest.
ALT_4K_FLOW_TOL = 6e-3
# the share of a level's cells off the plain level rounded to bf16: the
# kernel misses only where the f32 sums' order flips a rounding (about 1e-4
# of the cells); levels pooled from the bf16-rounded product miss on about
# 40% of the cells of levels 1-3
ALT_4K_MISS_SHARE = 1e-2


def test_alt_corr_4k_walk_is_unchanged_and_launches_768(dev):
    """One served FF-RAFT forward with ALT_CORR at 3840x2160 (B=1, bf16, 12
    refinements, chunks of 2048, seeded weights): 768 chunk-levels launches
    (64 chunks x 12, one a chunk walked) and no pyramid kernel; the first
    chunk's levels, as the forward walked them, within one bf16 ulp (plus
    2^-20 of the level's largest) of `corr_pyramid` of the f32 product, and
    off its bf16 rounding on at most ALT_4K_MISS_SHARE of the cells, so
    pooled from the f32 sums; the flow within ALT_4K_FLOW_TOL of the same
    forward with that plain chunk as the walk's levels."""
    from unittest import mock

    from focusflow_official_tpu_torch.config import model_from_config
    from focusflow_official_tpu_torch.kernels import reset_launch_counts
    from focusflow_official_tpu_torch.models import FFRaftConfig
    from focusflow_official_tpu_torch.ops import corr as corr_ops
    from focusflow_official_tpu_torch.predict import eval_forward, for_inference

    g = torch.Generator(device=dev).manual_seed(8)
    frames = [torch.rand((1, 2160, 3840, 3), generator=g, device=dev) * 255 for _ in range(2)]
    masks = [(torch.rand((1, 2160, 3840, 1), generator=g, device=dev) > 0.97).float() * 255
             for _ in range(2)]
    torch.manual_seed(0)
    model, iters = model_from_config(FFRaftConfig(fuse_cnet=True, alt_corr=True,
                                                  compute_dtype="bfloat16"))
    model = for_inference(model, torch.bfloat16, dev)

    def plain(f1, f2t, s, n, h2, w2, num_levels, dtype):
        rows = torch.matmul(f1[:, s:s + n].float(), f2t.float()).reshape(-1, n, h2, w2)
        return corr_pyramid(rows, num_levels, dtype)

    walked = corr_ops.chunk_levels
    first = []

    def record(*args):
        levels = walked(*args)
        if not first:
            first.append((levels, plain(*args[:-1], torch.float32)))
        return levels

    reset_launch_counts()
    with mock.patch.object(corr_ops, "chunk_levels", record):
        flow, flow_lr = eval_forward(model, *frames, *masks, iters=iters)
    assert launch_counts["corr_levels"] == 768 and launch_counts["pyramid"] == 0
    assert torch.isfinite(flow).all()
    for lv, (a, e) in enumerate(zip(*first[0])):
        assert a.dtype == torch.bfloat16 and a.shape == e.shape
        tol = _bf16_ulp(e) + 2.0 ** -20 * float(e.abs().max())
        worst = float(((a.float() - e).abs() - tol).max())
        assert worst <= 0, f"level {lv}: {worst} past the bound"
        miss = float((a != e.bfloat16()).float().mean())
        assert miss <= ALT_4K_MISS_SHARE, f"level {lv}: {miss} of the cells off"
    del first

    with mock.patch.object(corr_ops, "chunk_levels", plain):
        want, want_lr = eval_forward(model, *frames, *masks, iters=iters)
    assert launch_counts["corr_levels"] == 768 and launch_counts["pyramid"] == 0
    for a, e in ((flow, want), (flow_lr, want_lr)):
        gap = float((a - e).abs().max()) / max(1.0, float(e.abs().max()))
        assert gap <= ALT_4K_FLOW_TOL, gap

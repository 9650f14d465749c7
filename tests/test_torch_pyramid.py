"""ALT_CORR's chunk levels (`ops/corr.py::chunk_levels`: the chunk-levels
kernel `kernels/corr_levels.py` in bf16 on the card, the pyramid kernel
`kernels/pyramid.py` after the product in f32 there) on the CPU: the
walk's levels are `corr_pyramid` of the f32 product here, and in f32
today's product-then-pyramid path to the bit; the walk still matches the
materialized lookup; the launch counters; the kernels' plans (the units
of patches and query tiles the chunk-levels kernel walks, the regions the
pyramid kernel cuts a map into, the entry it takes) and what the
launchers refuse. The kernels themselves run on the card only
(`tests/test_torch_cuda.py`)."""

import pytest
import torch

from focusflow_official_tpu_torch import kernels
from focusflow_official_tpu_torch.kernels import corr_levels as kcl
from focusflow_official_tpu_torch.kernels import pyramid as kp
from focusflow_official_tpu_torch.kernels.lookup_fold import lookup_fold
from focusflow_official_tpu_torch.ops import corr as corr_ops
from focusflow_official_tpu_torch.ops.corr import (AltCorr, _chunk_product, all_pairs_corr,
                                                   alternate_corr_fold, chunk_levels,
                                                   corr_pyramid)

DTYPES = [torch.bfloat16, torch.float32]


def _rows(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * 4).to(dtype)


def _operands(b, q, h, w, c, dtype, seed=0):
    """The walk's operands (`_alt_operands`): f1 (B, Q, C) and f2t
    (B, C, H*W), a transposed contiguous (B, H*W, C), in `dtype`."""
    g = torch.Generator().manual_seed(seed)
    f1 = (torch.randn((b, q, c), generator=g) * c ** -0.5).to(dtype)
    f2 = torch.randn((b, h * w, c), generator=g).to(dtype)
    return f1, f2.transpose(1, 2)


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each value's magnitude (8 significant bits)."""
    return torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 8)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,n,h,w", [
    (1, 6, 270, 480),    # 3840x2160's level 0, a few queries
    (2, 3, 270, 480),
    (1, 2048, 55, 128),  # 1024x436: a full chunk
    (2, 896, 55, 128),   # its tail
    (2, 804, 46, 62),    # the chairs crop's training tail
    (2, 5, 7, 9),        # small odd maps: level 3 empty
    (1, 3, 13, 5),
])
def test_chunk_pyramid_on_the_cpu_is_corr_pyramid(dtype, b, n, h, w):
    """`chunk_levels` on the CPU (queries 3..3+n of the operands) is
    `corr_pyramid` of the f32 product: in f32 today's product then pyramid
    to the bit; in bf16 every level within one bf16 ulp of the same
    pyramid taken in f64 (plus 1e-6 of the level's largest, the f32 sums'
    own error), so pooled from the f32 sums and rounded once, not from a
    rounded level 0."""
    f1, f2t = _operands(b, n + 5, h, w, 64, dtype, seed=n)
    got = chunk_levels(f1, f2t, 3, n, h, w, 4, dtype)
    exact = corr_pyramid(torch.matmul(f1[:, 3:3 + n].double(), f2t.double())
                         .reshape(b, n, h, w), 4, torch.float64)
    assert len(got) == len(exact) == 4
    if dtype == torch.float32:
        today = corr_pyramid(_chunk_product(f1, f2t, 3, n, h, w), 4, dtype)
        assert all(torch.equal(a, e) for a, e in zip(got, today))
    for a, e in zip(got, exact):
        assert a.dtype == dtype and a.shape == e.shape and a.is_contiguous()
        if e.numel():
            err = (a.double() - e).abs()
            assert bool((err <= _bf16_ulp(e) + 1e-6 * e.abs().max()).all())


@pytest.mark.parametrize("b,h1,w1,chunk", [
    (1, 12, 16, 64),   # 192 queries: 3 full chunks
    (2, 12, 16, 80),   # 2 chunks and a tail of 32
    (1, 9, 13, 50),    # an odd map: levels 4x6, 2x3, 1x1
])
def test_alternate_corr_fold_matches_the_materialized_lookup(b, h1, w1, chunk, monkeypatch):
    """The walk (`chunk_levels` once a chunk, G's plain
    version) against `lookup_fold(corr_pyramid(all_pairs_corr(...)))` in
    f32: within 1e-5 of the largest output (the products taken a chunk at a
    time)."""
    g = torch.Generator().manual_seed(3)
    f1, f2 = (torch.randn((b, h1, w1, 64), generator=g) for _ in range(2))
    w = torch.randn((96, 4 * 81), generator=g) * 0.05
    bias = torch.randn(96, generator=g)
    coords = (torch.stack(torch.meshgrid(torch.arange(w1), torch.arange(h1), indexing="xy"), -1)
              .float()[None].repeat(b, 1, 1, 1) + torch.randn((b, h1, w1, 2), generator=g) * 3)
    walked = []
    monkeypatch.setattr(corr_ops, "chunk_levels",
                        lambda *a: walked.append(a[3]) or chunk_levels(*a))
    kernels.reset_launch_counts()
    got = alternate_corr_fold(AltCorr(f1, f2, 4, chunk), coords, 4, w, bias)
    want = lookup_fold(corr_pyramid(all_pairs_corr(f1, f2), 4), coords, 4, w, bias)
    assert len(walked) == -(-h1 * w1 // chunk) and sum(walked) == h1 * w1
    assert kernels.launch_counts["pyramid"] == kernels.launch_counts["corr_levels"] == 0
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


def test_launch_counter_has_the_key_and_no_shapes():
    """The pyramid kernel and the chunk-levels kernel count their launches
    in `launch_counts` alone; the CPU walk launches neither."""
    for name in ("pyramid", "corr_levels"):
        assert name in kernels.launch_counts
        kernels.launch_counts[name] = 5
    kernels.reset_launch_counts()
    f1, f2t = _operands(1, 4, 55, 128, 64, torch.bfloat16)
    chunk_levels(f1, f2t, 0, 4, 55, 128, 4, torch.bfloat16)  # no launch
    for name in ("pyramid", "corr_levels"):
        assert kernels.launch_counts[name] == 0
        assert not any(k[0] == name for k in kernels.launch_shapes)


@pytest.mark.parametrize("b,n,h,w,sms", [
    (1, 70, 270, 480, 132),   # 3840x2160: 34 x 15 patches, one group
    (1, 576, 270, 480, 132),  # its tail: 9 tiles
    (1, 2048, 55, 128, 132),  # 1024x436: 28 patches, 4 groups of 8 tiles
    (1, 896, 55, 128, 132),
    (10, 804, 46, 62, 132),   # the chairs crop at B=10: 120 patches
    (2, 804, 46, 62, 8),
    (2, 2048, 46, 62, 132),
    (3, 77, 7, 9, 132),       # one patch a map past both edges
    (1, 1, 7, 9, 132),
])
def test_corr_levels_plan_covers_every_cell_once(b, n, h, w, sms):
    """The units of the chunk-levels kernel's plan (`unit`, as the kernel
    decodes them) cover every cell of levels 0..3 of every query exactly
    once: each unit writes its tiles' queries (64 a tile, those below n)
    and its patch's cells of each level (8 x 32 at level 0, 4 x 16, 2 x 8,
    1 x 4) inside the level's map. At most one block an SM, each with a
    unit."""
    p = kcl.plan(b, n, h, w, sms)
    assert p["grid"] == min(p["units"], sms) and p["units"] == p["groups"] * b * p["py"] * p["px"]
    assert (p["groups"] - 1) * p["per"] < p["tiles"] <= p["groups"] * p["per"]
    seen = [torch.zeros((b, n, h >> lv, w >> lv), dtype=torch.int16) for lv in range(4)]
    for u in range(p["units"]):
        m, py, px, tiles = kcl.unit(p, u, b)
        assert len(tiles) >= 1
        qs = slice(tiles.start * kcl.TILE_Q, min(tiles.stop * kcl.TILE_Q, n))
        for lv, s in enumerate(seen):
            ys = slice(py * kcl.PATCH_Y >> lv, (py + 1) * kcl.PATCH_Y >> lv)
            xs = slice(px * kcl.PATCH_X >> lv, (px + 1) * kcl.PATCH_X >> lv)
            s[m, qs, ys, xs] += 1
    assert all(bool((s == 1).all()) for s in seen)


@pytest.mark.parametrize("case", ["f32 f1", "f16 f2", "strided f1", "misaligned f1", "c 12",
                                  "c 320", "keys", "past q", "no query", "five levels",
                                  "no level", "level 3 of 7 rows", "batches"])
def test_corr_levels_refusals(case):
    """What the chunk-levels launcher refuses, before any launch: operands
    other than bf16, a strided or misaligned operand, C not a multiple of 8
    or past 256, a key map of another size, queries past Q, a level of no
    cell, more levels than G looks up, maps of another batch."""
    f1, f2t = _operands(2, 40, 16, 24, 64, torch.bfloat16)
    f2 = f2t.transpose(1, 2)
    s, n, h, w, levels = 0, 40, 16, 24, 4
    if case == "f32 f1":
        f1 = f1.float()
    elif case == "f16 f2":
        f2 = f2.half()
    elif case == "strided f1":
        f1 = f1.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "misaligned f1":
        f1 = torch.cat([f1.reshape(-1), f1.new_zeros(1)])[1:].view(f1.shape)
    elif case == "c 12":
        f1, f2 = f1[..., :12].contiguous(), f2[..., :12].contiguous()
    elif case == "c 320":
        f1, f2 = f1.repeat(1, 1, 5), f2.repeat(1, 1, 5)
    elif case == "keys":
        h = 15
    elif case == "past q":
        s = 1
    elif case == "no query":
        n = 0
    elif case == "five levels":
        levels = 5
    elif case == "no level":
        levels = 0
    elif case == "level 3 of 7 rows":
        f2, h = f2[:, :7 * 24].contiguous(), 7
    else:
        f2 = f2[:1].contiguous()
    with pytest.raises(ValueError, match="corr_levels"):
        kcl._check(f1, f2, s, n, h, w, levels)


def test_corr_levels_on_other_devices_raises():
    f1, f2t = _operands(1, 8, 8, 8, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported devices"):
        kcl.corr_levels(f1, f2t.transpose(1, 2), 0, 8, 8, 8, 4)
    with pytest.raises(ValueError, match="unsupported devices"):
        kcl.corr_levels(f1.to("meta"), f2t.transpose(1, 2).to("meta"), 0, 8, 8, 8, 4)


@pytest.mark.parametrize("n,k,bands", [
    (270, 3, [(0, 264, 3), (264, 4, 2), (268, 2, 1)]),
    (480, 3, [(0, 480, 3)]),
    (55, 3, [(0, 48, 3), (48, 4, 2), (52, 2, 1)]),  # the 55th row in no cell
    (128, 3, [(0, 128, 3)]),
    (62, 3, [(0, 56, 3), (56, 4, 2), (60, 2, 1)]),
    (9, 3, [(0, 8, 3)]),
    (13, 2, [(0, 12, 2)]),
    (7, 2, [(0, 4, 2), (4, 2, 1)]),
    (5, 1, [(0, 4, 1)]),
])
def test_bands(n, k, bands):
    assert kp._bands(n, k) == bands


MAPS = [(270, 480, 4), (55, 128, 4), (46, 62, 4), (135, 240, 4), (8, 8, 4), (15, 17, 4),
        (9, 23, 4), (31, 30, 4), (7, 9, 3), (13, 5, 3), (6, 11, 2), (2, 3, 2), (12, 16, 4)]


def _patched_levels(x: torch.Tensor, num_levels: int) -> list:
    """The kernel's work on the CPU: each region's patches pooled as one
    thread pools its patch (each column's pair of a cell, then their sum,
    times 1/4, in f32), written where the kernel writes them, into levels
    filled with NaN."""
    h, w = x.shape[-2:]
    out = [torch.full((*x.shape[:-2], h >> lv, w >> lv), float("nan"))
           for lv in range(1, num_levels)]
    for y0, x0, pr, pc, k in kp.regions(h, w, num_levels):
        a = x[..., y0:y0 + (pr << k), x0:x0 + (pc << k)].float()
        for lv in range(1, k + 1):
            a = ((a[..., 0::2, 0::2] + a[..., 1::2, 0::2])
                 + (a[..., 0::2, 1::2] + a[..., 1::2, 1::2])) * 0.25
            dst = out[lv - 1][..., y0 >> lv:(y0 >> lv) + a.shape[-2],
                              x0 >> lv:(x0 >> lv) + a.shape[-1]]
            assert torch.isnan(dst).all(), "a level cell lies in two patches"
            dst.copy_(a)
    return out


@pytest.mark.parametrize("h,w,num_levels", MAPS)
def test_regions_cover_every_level_cell_once(h, w, num_levels):
    """Each cell of levels 1..L-1 lies in exactly one patch of the cut, the
    patches inside the map, the main region first; as the launcher checks,
    the patches' level-1 cells add up to level 1's."""
    cut = kp.regions(h, w, num_levels)
    assert cut[0][:2] == (0, 0) and cut[0][4] == num_levels - 1
    seen = [torch.zeros((h >> lv, w >> lv), dtype=torch.int64) for lv in range(1, num_levels)]
    for y0, x0, pr, pc, k in cut:
        assert 1 <= k <= num_levels - 1 and pr >= 1 and pc >= 1
        assert y0 + (pr << k) <= h and x0 + (pc << k) <= w
        for lv in range(1, k + 1):
            seen[lv - 1][y0 >> lv:(y0 >> lv) + (pr << (k - lv)),
                         x0 >> lv:(x0 >> lv) + (pc << (k - lv))] += 1
    assert all(bool((s == 1).all()) for s in seen)
    assert sum(pr * pc << 2 * (k - 1) for *_, pr, pc, k in cut) == (h >> 1) * (w >> 1)


@pytest.mark.parametrize("h,w,num_levels", [(270, 480, 4), (55, 128, 4), (15, 17, 4),
                                            (7, 9, 3), (13, 5, 3)])
def test_patches_give_the_whole_map_pooling(h, w, num_levels):
    """The levels the patches give, each 2x2 mean in the kernel's order
    from the f32 means one level finer, equal that order's pooling of the
    whole map level by level (floor semantics) to the bit."""
    x = _rows((2, 3, h, w), torch.bfloat16, seed=h * w)
    got = _patched_levels(x, num_levels)
    a = x.float()
    for lv in range(1, num_levels):
        a = a[..., :a.shape[-2] // 2 * 2, :a.shape[-1] // 2 * 2]
        a = ((a[..., 0::2, 0::2] + a[..., 1::2, 0::2])
             + (a[..., 0::2, 1::2] + a[..., 1::2, 1::2])) * 0.25
        assert torch.equal(got[lv - 1], a)


@pytest.mark.parametrize("w,num_levels,dtype,offset,entry", [
    (480, 4, torch.bfloat16, 0, "vector"),   # 3840x2160
    (128, 4, torch.bfloat16, 0, "vector"),   # 1024x436
    (480, 4, torch.float32, 0, "vector"),
    (62, 4, torch.bfloat16, 0, "scalar"),    # the chairs crop: 62 not a multiple of 8
    (12, 3, torch.bfloat16, 0, "vector"),    # a multiple of 4 at three levels
    (12, 4, torch.bfloat16, 0, "scalar"),
    (9, 2, torch.float32, 0, "scalar"),
    (480, 4, torch.bfloat16, 1, "scalar"),   # a view 2 bytes past a 16-byte boundary
    (480, 4, torch.bfloat16, 8, "vector"),   # 16 bytes past
])
def test_design(w, num_levels, dtype, offset, entry):
    flat = torch.empty(4 * w + 16, dtype=dtype)
    base = (-flat.data_ptr() % 16) // flat.element_size()  # the first 16-byte boundary
    x = flat[base + offset:base + offset + 4 * w].view(1, 4, w)
    assert kp.design(x, num_levels) == entry


@pytest.mark.parametrize("case", ["strided", "f16 rows", "f16 levels", "f32 levels",
                                  "f64 rows", "level 3 of 7 rows", "five levels", "no level"])
def test_refusals(case):
    """What the launcher refuses, before any launch: a strided view, a type
    other than bf16 or f32, levels in another type than the rows', a level
    of no cell, more levels than G looks up."""
    rows, levels, dtype = _rows((1, 2, 16, 24), torch.bfloat16), 4, torch.bfloat16
    if case == "strided":
        rows = rows.transpose(-1, -2)
    elif case == "f16 rows":
        rows, dtype = rows.half(), torch.float16
    elif case == "f16 levels":
        dtype = torch.float16
    elif case == "f32 levels":
        dtype = torch.float32
    elif case == "f64 rows":
        rows, dtype = rows.double(), torch.float64
    elif case == "level 3 of 7 rows":
        rows = rows[..., :7, :].contiguous()
    elif case == "five levels":
        levels = 5
    else:
        levels = 0
    with pytest.raises(ValueError, match="pyramid"):
        kp._check(rows, levels, dtype)


def test_other_devices_raise():
    with pytest.raises(ValueError, match="unsupported device"):
        kp.pyramid(torch.empty((1, 2, 16, 16), device="meta"), 4, torch.float32)
    with pytest.raises(ValueError, match="unsupported device"):
        kp.pyramid(_rows((1, 2, 16, 16), torch.float32), 4, torch.float32)

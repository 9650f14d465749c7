"""Kernel D's launch (`kernels/local_corr.py::plan`) walked block by block on
the CPU, as `csrc/local_corr.cu` indexes it: every output is written once,
every channel of each sum is taken once (also where a chunk's k16 steps are
split over warps and the slices summed in shared memory), every staged f2
value a product reads is the one its output needs, and the accumulator
band map of `mma.sync.m16n8k16` gives each (pixel, dx) once. At 132 SMs the
five PWC levels fill the card as the plan promises."""

import math

import numpy as np
import pytest
import torch

from focusflow_official_tpu_torch.kernels import local_corr as klc

# FF-PWCNet's decoder levels 6 to 2 at 1024x448
PWC_LEVELS = [(1, 7, 16, 196), (1, 14, 32, 128), (1, 28, 64, 96), (1, 56, 128, 64),
              (1, 112, 256, 32)]
CASES = ([(s, 4) for s in PWC_LEVELS]
         + [((2, 12, 16, 32), 4), ((1, 9, 13, 24), 3)]   # the parity tests' odd shapes
         + [((1, 20, 27, 40), r) for r in (1, 2, 3)]     # radii 1-3, W not a multiple of 16
         + [((2, 30, 50, 64), 4),                        # B = 2
            ((1, 20, 27, 3), 4),                         # C = 3: one k16 step, 13 pad channels
            ((1, 9, 40, 300), 4)])                       # three channel chunks


def swz(w):
    """Where word w of the band sums lies in shared memory: bit 3 flipped
    where bit 5 is set (`csrc/local_corr.cu::swz`)."""
    return w ^ (((w >> 5) & 1) << 3)


def band_map(radius):
    """The tensor-core entry's accumulators: (lane, n8 tile, register) ->
    (pixel, dx index) of each one that is an output. A register of tile j
    holds S[i][n] with i = lane / 4 + 8 (reg / 2) and n = 8j + 2 (lane % 4)
    + reg % 2 (`csrc/mma.cuh`); halo pixel n lies dx index n - i from pixel
    i, an output where that is in [0, 2r]."""
    out = {}
    for lane in range(32):
        for j in range(3):
            for reg in range(4):
                i = lane // 4 + 8 * (reg // 2)
                d = 8 * j + 2 * (lane % 4) + reg % 2 - i
                if 0 <= d <= 2 * radius:
                    out[(lane, j, reg)] = (i, d)
    return out


def _block(p, idx):
    """blockIdx.x -> (b, y0, x0, dy0): groups fastest, then segments, bands."""
    grp = idx % p["groups"]
    idx //= p["groups"]
    seg = idx % p["segs"]
    idx //= p["segs"]
    band = idx % p["bands"]
    return idx // p["bands"], band * p["rows"], seg * klc.SEG, grp * p["ndy"]


def _staged(p, q, y0, x0, dy0, r):
    """Staged row q of a block -> ("f1" or "f2", y, x), or None past the halo."""
    rows = p["rows"]
    if q < rows * klc.SEG:
        return "f1", y0 + q // klc.SEG, x0 + q % klc.SEG
    h = q - rows * klc.SEG
    hx = h % klc.HALO
    if hx >= klc.SEG + 2 * r:
        return None
    return "f2", y0 + dy0 - r + h // klc.HALO, x0 - r + hx


def _walk(shape, r, sms):
    b, h, w, c = shape
    k = 2 * r + 1
    p = klc.plan(b, h, w, c, r, torch.bfloat16, sms)
    assert p["entry"] == "mma" and k % p["ndy"] == 0 and p["groups"] * p["ndy"] == k
    rows, nd, split, warps, chunk = (p[n] for n in ("rows", "ndy", "split", "warps", "chunk"))
    assert p["grid"] == b * p["bands"] * p["segs"] * p["groups"]
    assert p["bands"] * rows >= h > (p["bands"] - 1) * rows
    assert 1 <= warps <= klc.MAX_WARPS and chunk % 16 == 0 and 16 <= chunk <= klc.MAX_CHUNK
    assert p["smem"] <= klc.MAX_SMEM
    cpad = math.ceil(c / 16) * 16
    nchunks = math.ceil(cpad / chunk)
    assert nchunks == p["nchunks"]

    # the warps' tasks: warp w takes slice w % split of the run of pairs
    # w // split, `per` long; each (pair, slice) once, every warp some
    assert warps % split == 0
    npairs, groups = rows * nd, warps // split
    per = -(-npairs // groups)
    assert per == p["per"]
    tasks = [(pair, wp % split) for wp in range(warps)
             for pair in range(wp // split * per, min(npairs, (wp // split + 1) * per))]
    assert sorted(tasks) == [(pair, s) for pair in range(npairs) for s in range(split)]
    assert all(wp // split * per < npairs for wp in range(warps)), \
        "a warp without a task does no arithmetic"

    # channels of each pair's sum: over slices and chunks, each once, pads past C
    for pair in range(rows * nd):
        taken = np.zeros(cpad, int)
        for s in range(split):
            for ch in range(nchunks):
                kc = min(chunk, cpad - ch * chunk) // 16
                for kk in range(s, kc, split):
                    taken[ch * chunk + kk * 16: ch * chunk + kk * 16 + 16] += 1
        assert (taken == 1).all()

    # the band sums in shared memory: task (s, rr, dyl) writes pixel i's
    # value d at word swz([s][rr][i][dyl][d]), the output's order swizzled
    band = band_map(r)
    run = nd * k
    slice_ = rows * klc.SEG * run
    who = {}
    for s in range(split):
        for rr in range(rows):
            for dyl in range(nd):
                for i, d in band.values():
                    at = swz(((s * rows + rr) * klc.SEG + i) * run + dyl * k + d)
                    assert at not in who
                    who[at] = (rr, i, dyl, d)
    assert sorted(who) == list(range(split * slice_))

    # the epilogue: element e of a block's outputs sums word swz(s slice + e)
    # over s; with all dy rows and one slice, 4-word groups at swz(4q)
    e = np.arange(slice_)
    rr_e, i_e, j_e = e // (klc.SEG * run), (e // run) % klc.SEG, e % run
    for s in range(split):
        for at in range(0, slice_, max(1, slice_ // 97)):  # a sample of each slice
            assert who[swz(s * slice_ + at)] == (rr_e[at], i_e[at], j_e[at] // k,
                                                     j_e[at] % k)
    if nd < k:  # the epilogue walks (pixel, output) by nthreads without a division
        nthreads = 32 * warps
        jump, jrem = divmod(nthreads, run)
        for tid in range(nthreads):
            pix, j = divmod(tid, run)
            for e_ in range(tid, slice_, nthreads):
                assert (pix, j) == divmod(e_, run)
                pix, j = pix + jump, j + jrem
                if j >= run:
                    pix, j = pix + 1, j - run
    for q in range(slice_ // 4):
        assert [swz(4 * q) + u for u in range(4)] == [swz(4 * q + u) for u in range(4)]

    written = np.zeros(b * h * w * k * k, int)
    for idx in range(p["grid"]):
        bb, y0, x0, dy0 = _block(p, idx)
        y, x = y0 + rr_e, x0 + i_e
        ok = (y < h) & (x < w)
        np.add.at(written, (((bb * h + y) * w + x) * k * k + dy0 * k + j_e)[ok], 1)
        if idx % max(1, p["grid"] // 7):
            continue
        # a sample of blocks: every product reads the f1 and f2 pixels its output needs
        for rr in range(rows):
            for dyl in range(nd):
                assert rr + dyl < rows + nd - 1
                for i, d in band.values():
                    f1 = _staged(p, rr * klc.SEG + i, y0, x0, dy0, r)
                    n = i + d  # halo pixel of S's column
                    f2 = _staged(p, rows * klc.SEG + (rr + dyl) * klc.HALO + n, y0, x0, dy0, r)
                    assert f1 == ("f1", y0 + rr, x0 + i)
                    assert f2 == ("f2", y0 + rr + dy0 + dyl - r, x0 + i + d - r)
    assert (written == 1).all()
    return p


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("shape,r", CASES)
def test_plan_writes_each_output_once(shape, r, sms):
    _walk(shape, r, sms)


@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_band_sum_stores_and_loads_meet_few_bank_conflicts(r):
    """A warp stores each accumulator register (j, v) of its lanes that
    holds an output at once: through the swizzle at most two of those lanes
    share a bank (four without it, at radius 4 with all dy rows). The
    epilogue's 16-byte loads of 8 neighbouring groups meet no conflict."""
    k = 2 * r + 1
    band = band_map(r)
    for nd in (1, k):
        worst = {}
        for swizzle in (lambda w: w, swz):
            most = 0
            for rr in range(4):
                for dyl in range(nd):
                    for j in range(3):
                        for reg in range(4):
                            banks = [swizzle((rr * klc.SEG + i) * nd * k + dyl * k + d) % 32
                                     for (lane, j_, reg_), (i, d) in band.items()
                                     if (j_, reg_) == (j, reg)]
                            if banks:
                                most = max(most, max(banks.count(x) for x in banks))
            worst[swizzle] = most
        assert worst[swz] <= 2
        if (r, nd) == (4, 9):
            assert worst[swz] < worst[list(worst)[0]] == 4
    for g0 in range(0, 4 * 1296 // 4, 8):  # 8 lanes of one 16-byte load phase
        quads = [(swz(4 * (g0 + u)) // 4) % 8 for u in range(8)]
        assert len(set(quads)) == 8


@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_band_words_from_lane_offsets(r):
    """The kernel finds a band value's word from per-lane constants: with
    c = 2t - g, the register holds an output where c + 8j + v % 2 - 8 (v / 2)
    lies in [0, 2r], at word g (run - 1) + 2t + 8j + v % 2 + 8 (v / 2)
    (run - 1) of its pair's sums, which is i run + d."""
    k = 2 * r + 1
    band = band_map(r)
    for run in (k, 3 * k, k * k):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for j in range(3):
                for reg in range(4):
                    dk = 8 * j + reg % 2 - 8 * (reg // 2)
                    assert (0 <= 2 * t - g + dk < k) == ((lane, j, reg) in band)
                    if (lane, j, reg) in band:
                        i, d = band[(lane, j, reg)]
                        word = g * (run - 1) + 2 * t + 8 * j + reg % 2 + (reg // 2) * 8 * (run - 1)
                        assert word == i * run + d


@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_band_map_covers_each_pixel_and_dx_once(r):
    band = band_map(r)
    k = 2 * r + 1
    assert sorted(band.values()) == [(i, d) for i in range(16) for d in range(k)]
    for (lane, j, reg), (i, d) in band.items():
        # m16n8k16's C fragment: row g + 8 (reg / 2), column 8j + 2t + reg % 2
        assert i == lane // 4 + 8 * (reg // 2)
        assert i + d == 8 * j + 2 * (lane % 4) + reg % 2 < klc.SEG + 2 * r


def _blocks_per_sm(p):
    """Blocks an SM holds: by threads (2048), shared memory (228 KB, 1 KB
    of it reserved a block) and the block limit (32)."""
    return min(2048 // (32 * p["warps"]), 233472 // (p["smem"] + 1024), 32)


@pytest.mark.parametrize("shape", PWC_LEVELS)
def test_plan_fills_the_card_at_the_pwc_levels(shape):
    sms = 132
    p = klc.plan(*shape, 4, torch.bfloat16, sms)
    slots = sms * _blocks_per_sm(p)
    tail = p["grid"] % slots
    # no second wave that holds under a third of the SMs
    assert p["grid"] <= slots or tail == 0 or tail >= sms / 3
    # levels 4-6: at most two channel chunks, one after another
    if shape[3] >= 96:
        assert p["nchunks"] <= 2
    # every warp of a block has a task: it does arithmetic
    assert p["rows"] * p["ndy"] * p["split"] >= p["warps"]
    # the card is filled where there are pixels enough: 132 blocks or more,
    # else every dy row on its own block
    assert p["grid"] >= sms or p["ndy"] == 1


@pytest.mark.parametrize("shape,r", CASES)
def test_fma_plan_covers_each_dy_once(shape, r):
    """f32: the FMA entry's dy groups (`ndy` a block, the last one short)."""
    b, h, w, c = shape
    k = 2 * r + 1
    p = klc.plan(b, h, w, c, r, torch.float32, 132)
    assert p["entry"] == "fma"
    rows = [min(p["ndy"], k - g * p["ndy"]) for g in range(p["groups"])]
    assert sum(rows) == k and min(rows) >= 1
    tiles = b * math.ceil(h / 8) * math.ceil(w / 8)
    assert p["grid"] == tiles * p["groups"]

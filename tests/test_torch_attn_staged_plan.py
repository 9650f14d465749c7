"""The launch of kernel E's small-N entry (`attn_staged` in
`csrc/attention.cu`), modelled on the CPU: `staged_plan` lays it out, and
this model walks its blocks, steps and threads as the kernel does.

A thread takes two queries of one head (one where N = 1); a unit is one
batch entry's group of heads, all its (query group, head) threads; a
round is `units` units; block x takes rounds x, x + grid, ...; a
round's keys arrive in chunks through a ring of two shared-memory stages,
the chunks of all of a block's rounds one stream. A thread of a unit's
share of the block copies a fixed column of 16-byte pieces of the chunk's
key and value rows, into rows that put a spare piece after every 8.

Held here: every (entry, query, head) is computed exactly once; every key
and value row of an entry is staged exactly once, each piece where the
pair that reads it looks; every read finds the piece the kernel means it to
find in its stage (not a stale one from the slot's last use); the ragged
last chunk is masked (reading past it meets pieces no copy wrote); the
8 lanes of a quarter-warp reading 8 heads of one key meet 8 bank groups;
and the staged walk, in float64 with the online softmax carried from
chunk to chunk, gives `small_kv_attention_plain` (f32) within 1e-5.
"""

import numpy as np
import pytest
import torch

from focusflow_official_tpu_torch.kernels import attention as ka

THREADS = ka.STAGED_THREADS
HEADS, B, SMS = 8, 37, 2  # few SMs: each block takes several rounds


def pad_at(p):
    return p + (p >> 3)


class Layout:
    """The kernel's sizes and thread maps for one call."""

    def __init__(self, b, n, m, heads, d, dv, itemsize, sms):
        self.plan = p = ka.staged_plan(b, n, m, heads, d, dv, itemsize)
        self.b, self.n, self.m, self.heads, self.d, self.dv = b, n, m, heads, d, dv
        self.hg, self.qp, self.units, self.kc = (p["heads_a_group"], p["queries_a_thread"],
                                                 p["units"], p["keys_a_chunk"])
        self.grid = ka.staged_grid(p, sms, 2)
        self.G = heads // self.hg
        self.total = b * self.G
        self.rounds = -(-self.total // self.units)
        self.nch = -(-m // self.kc)
        epg = 16 // itemsize
        self.GK, self.GV = d // epg, dv // epg
        self.gk, self.gv = self.hg * self.GK, self.hg * self.GV
        self.rsk, self.rsv = ka.padded(self.gk), ka.padded(self.gv)
        self.unit_p = self.kc * (self.rsk + self.rsv)
        self.stage_p = self.units * self.unit_p
        t = np.arange(THREADS)
        # staging map
        tpu = THREADS // self.units
        self.s_us, s_t = t // tpu, t % tpu
        self.lanes = min(self.gk + self.gv, tpu)
        self.s_col, self.s_row = s_t % self.lanes, s_t // self.lanes
        self.s_rstep = tpu // self.lanes
        self.stager = (self.s_us < self.units) & (self.s_row < self.s_rstep)
        # compute map
        per_unit = -(-n // self.qp) * self.hg
        self.c_us, self.c_h = t // per_unit, t % self.hg
        self.c_n0 = (t % per_unit) // self.hg * self.qp
        self.worker = self.c_us < self.units

    def steps(self, x):
        """(round, chunk) of block x's steps, in order."""
        mine = (self.rounds - 1 - x) // self.grid + 1 if x < self.rounds else 0
        return [(x + i * self.grid, c) for i in range(mine) for c in range(self.nch)]

    def stage(self, rnd, c, slot):
        """The copies of step (rnd, c) into `slot`, one row each: shared
        piece, tensor (0 k, 1 v), entry, key, piece column of the full row."""
        j0 = c * self.kc
        nk = min(self.kc, self.m - j0)
        u = rnd * self.units + self.s_us
        t = np.flatnonzero(self.stager & (u < self.total))[:, None, None]
        u = u[t]
        b, h0 = u // self.G, (u % self.G) * self.hg
        base = slot * self.stage_p + self.s_us[t] * self.unit_p
        j = self.s_row[t] + self.s_rstep * np.arange(self.kc)[:, None]
        p = self.s_col[t] + self.lanes * np.arange(-(-(self.gk + self.gv) // self.lanes))
        j, p = np.broadcast_arrays(j, p)
        ok = (j < nk) & (p < self.gk + self.gv)
        is_v = p >= self.gk
        pv = p - self.gk
        dst = base + np.where(is_v, self.kc * self.rsk + j * self.rsv + pad_at(pv),
                              j * self.rsk + pad_at(p))
        col = np.where(is_v, h0 * self.GV + pv, h0 * self.GK + p)
        rows = np.broadcast_arrays(dst, is_v.astype(int), b, j0 + j, col)
        return np.stack([r[ok] for r in rows], 1)

    def reads(self, rnd, c, slot, keys):
        """The threads at step (rnd, c) -> (threads, entry, first query and
        head of each, its key pieces (threads, keys, GK) and value pieces in
        `slot`)."""
        u = rnd * self.units + self.c_us
        t = np.flatnonzero(self.worker & (u < self.total))
        u = u[t]
        b, h = u // self.G, (u % self.G) * self.hg + self.c_h[t]
        base = (slot * self.stage_p + self.c_us[t] * self.unit_p)[:, None, None]
        j = np.arange(keys)[:, None]
        kp = base + j * self.rsk + pad_at(self.c_h[t] * self.GK)[:, None, None] \
            + np.arange(self.GK)
        vp = base + self.kc * self.rsk + j * self.rsv \
            + pad_at(self.c_h[t] * self.GV)[:, None, None] + np.arange(self.GV)
        return t, b, self.c_n0[t], h, kp, vp


def walk(lay, q, k, v, scale, masked=True):
    """Run the launch over float64 q (B, N, H*d), k, v: every block's steps
    in order, stage then compute, shared memory NaN until a copy writes it.
    Returns (out, times each (entry, query, head) was computed, times each
    piece of k and v was staged, reads that found a piece other than the
    one meant)."""
    epg = lay.d // lay.GK
    kv = [k.reshape(lay.b, lay.m, -1, epg), v.reshape(lay.b, lay.m, -1, epg)]
    out = np.full((lay.b, lay.n, lay.heads, lay.dv), np.nan)
    pairs = np.zeros((lay.b, lay.n, lay.heads), int)
    staged = np.zeros((2, lay.b, lay.m, lay.heads * max(lay.GK, lay.GV)), int)
    wrong = 0
    for x in range(lay.grid):
        smem = np.full((2 * lay.stage_p, epg), np.nan)
        tag = np.full((2 * lay.stage_p, 4), -1)
        mx = np.full((THREADS, lay.qp), -np.inf)
        l, acc = np.zeros((THREADS, lay.qp)), np.zeros((THREADS, lay.qp, lay.dv))
        for s, (rnd, c) in enumerate(lay.steps(x)):
            cp = lay.stage(rnd, c, s % 2)
            smem[cp[:, 0]] = np.stack(kv)[cp[:, 1], cp[:, 2], cp[:, 3], cp[:, 4]]
            tag[cp[:, 0]] = cp[:, 1:]
            np.add.at(staged, tuple(cp[:, 1:].T), 1)
            nk = min(lay.kc, lay.m - c * lay.kc)
            t, b, n0, h, kp, vp = lay.reads(rnd, c, s % 2, nk if masked else lay.kc)
            keys = c * lay.kc + np.arange(kp.shape[1])[None, :, None]
            for which, pieces, per in ((0, kp, lay.GK), (1, vp, lay.GV)):
                want = np.broadcast_arrays(which, b[:, None, None], keys,
                                           h[:, None, None] * per + np.arange(per))
                wrong += int((tag[pieces] != np.stack(want, -1)).any(-1).sum())
            kr = smem[kp].reshape(len(t), kp.shape[1], -1)
            vr = smem[vp].reshape(len(t), vp.shape[1], -1)
            n = n0[:, None] + np.arange(lay.qp)  # a group past N repeats the last query
            qh = q.reshape(lay.b, lay.n, lay.heads, -1)[b[:, None], np.minimum(n, lay.n - 1),
                                                         h[:, None]]
            if c == 0:
                mx[t], l[t], acc[t] = -np.inf, 0.0, 0.0
            sc = np.einsum("tjd,tqd->tqj", kr, qh) * scale
            mn = np.maximum(mx[t], sc.max(2))
            corr = np.exp(mx[t] - mn)  # exp(-inf) = 0 on a round's first chunk
            p = np.exp(sc - mn[..., None])
            l[t] = l[t] * corr + p.sum(2)
            acc[t] = acc[t] * corr[..., None] + np.einsum("tqj,tjd->tqd", p, vr)
            mx[t] = mn
            if c == lay.nch - 1:
                ok = n < lay.n
                bb, hh = np.broadcast_arrays(b[:, None], h[:, None], n)[:2]
                out[bb[ok], n[ok], hh[ok]] = (acc[t] / l[t][..., None])[ok]
                np.add.at(pairs, (bb[ok], n[ok], hh[ok]), 1)
    return out.reshape(lay.b, lay.n, -1), pairs, staged, wrong


def _qkv(lay, seed):
    rng = np.random.RandomState(seed)
    c, cv = lay.heads * lay.d, lay.heads * lay.dv
    return (rng.randn(lay.b, lay.n, c), rng.randn(lay.b, lay.m, c),
            rng.randn(lay.b, lay.m, cv))


@pytest.mark.parametrize("d", [8, 16, 32])
@pytest.mark.parametrize("n", [1, 8, 63])
@pytest.mark.parametrize("m", [1, 7, 8, 112, 113])
def test_staged_walk_covers_every_pair_and_piece_once(m, n, d):
    itemsize = 2 if d < 32 else 4  # bf16 at 8 and 16, f32 at 32 (8 pieces a head)
    lay = Layout(B, n, m, HEADS, d, d, itemsize, SMS)
    p = lay.plan
    assert p["smem"] == 2 * lay.stage_p * 16 <= 227 * 1024
    assert -(-n // lay.qp) * lay.hg * lay.units <= THREADS and HEADS % lay.hg == 0
    assert lay.qp == (1 if n == 1 else 2)
    assert lay.kc <= ka.STAGED_KEYS and (lay.kc < 8 or lay.kc % 8 == 0)
    q, k, v = _qkv(lay, m * 100 + n * 10 + d)
    scale = -0.7 if n == 8 else d ** -0.5
    out, pairs, staged, wrong = walk(lay, q, k, v, scale)
    assert wrong == 0
    assert (pairs == 1).all()
    assert (staged[0, ..., :HEADS * lay.GK] == 1).all()
    assert (staged[1, ..., :HEADS * lay.GV] == 1).all()
    assert staged.sum() == B * m * HEADS * (lay.GK + lay.GV)
    want = ka.small_kv_attention_plain(*(torch.from_numpy(t) for t in (q, k, v)),
                                       HEADS, scale).numpy()
    # the plain version takes its scores, softmax and sums in f32
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("m", [13, 113])
def test_ragged_last_chunk_is_masked(m):
    """Past the last key of a ragged chunk lie pieces no copy of this step
    wrote (NaN on a slot's first use, a stale chunk's pieces later): the
    walk that stops at M gives the plain result, one that reads the whole
    chunk does not."""
    lay = Layout(B, 8, m, HEADS, 16, 16, 2, SMS)
    assert m % lay.kc
    q, k, v = _qkv(lay, 3)
    out, _, _, wrong = walk(lay, q, k, v, 0.25)
    assert wrong == 0 and np.isfinite(out).all()
    bad, _, _, wrong = walk(lay, q, k, v, 0.25, masked=False)
    assert wrong > 0 and not np.allclose(bad, out, equal_nan=False)


@pytest.mark.parametrize("n,m,c,d,itemsize", [
    (8, 112, 128, 16, 2),  # the perceiver's input layer
    (8, 8, 128, 16, 2),    # its latent self-attention
    (1, 8, 64, 8, 2),      # the decoder's cross-attend
    (8, 112, 128, 16, 4),  # the input layer in f32
    (8, 40, 256, 32, 4),   # 8 pieces a head
])
def test_quarter_warp_reads_meet_no_bank_conflict(n, m, c, d, itemsize):
    """The path's shapes: a warp's lanes reading one key's head slices hit,
    in each quarter-warp (one 16-byte access a lane), distinct pieces in
    distinct groups of four banks, or the same piece (a broadcast)."""
    lay = Layout(7040, n, m, c // d, d, d, itemsize, 132)
    assert lay.hg == 8
    t, _, _, _, kp, vp = lay.reads(0, 0, 0, 1)
    lane = dict(zip(t, range(len(t))))
    for q0 in range(0, THREADS, 8):
        lanes = [lane[i] for i in range(q0, q0 + 8) if i in lane]
        for pieces in (kp, vp):
            for i in range(pieces.shape[2]):
                at = set(pieces[lanes, 0, i].tolist())
                assert len({a % 8 for a in at}) == len(at), (q0, i, sorted(at))

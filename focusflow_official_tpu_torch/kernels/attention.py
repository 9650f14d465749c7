"""Kernel E: multi-head softmax attention with a small key/value side
(`csrc/attention.cu`).

q (B, N, C), k (B, M, C) and v (B, M, Cv) are the pre-head-split
projections; head h is the column slice h*d:(h+1)*d (d = C/heads, and
Cv/heads for v). out (B, N, Cv) = softmax(scale * q_h k_h^T) v_h per head,
scores, softmax and the value sum in f32, emitted in q's type. Every
non-window softmax attention of the FlowFormer path goes through here:
Twins GSA, the vertical global layer, the perceiver's input and latent
self-attention, and the decoder's cross-attend.

`design` names the entry a CUDA call runs. N < 64 (the perceiver and the
decoder: thousands of tiny attentions) runs "staged": a block copies each
batch entry's key and value rows into shared memory once, for all its
queries and heads, as `staged_plan` lays the launch out. On bf16 tensors
with head widths 16 or 32 and N >= 64 the kernel runs on the tensor cores
("mma") and rounds the softmax weights to bf16 before the value sum (the
row sum is of the unrounded weights): against the plain version that is
up to 2^-8 relative on each weight (`bf16_bound` is the bound that follows
for the output). Elsewhere ("staged", "tiled", "direct") the weights stay
f32.

`small_kv_attention` is differentiable in q, k and v (a
`torch.autograd.Function`): its backward is `attention_vjp`, plain PyTorch
on every device, the JAX package's `kernels/attention.py::_attention_bwd`:
the softmax recomputed in f32 from q and k, then dv = Pᵀg, dP = g·vᵀ,
dS = P ⊙ (dP − rowsum(dP ⊙ P)), dq = dS·k·scale, dk = dSᵀ·q·scale, all in
f32, a few batch entries at a time (`VJP_CHUNK_BYTES` of P), each result
cast to its input's type.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, count_launch, sm_count

_c = ctypes.c_void_p
_i = ctypes.c_int
HEAD_DIMS = (8, 16, 32)  # head widths the kernel is built for
ENTRIES = ("direct", "tiled", "mma", "staged")  # by the library's entry number

# the staged entry, as `csrc/attention.cu` is built
STAGED_THREADS = 256  # a block
STAGED_STAGES = 2  # chunks in the ring
STAGED_KEYS = 32  # the most keys a chunk
STAGED_SMEM = 72 * 1024  # what a block's stages aim at (the registers allow two an SM)
VJP_CHUNK_BYTES = 1 << 28  # f32 softmax weights the backward holds at a time, at most


@functools.cache
def _lib():
    lib = _build.load("attention")
    lib.ff_attention.argtypes = [_c, _c, _c, _c] + [_i] * 6 + [
        ctypes.c_float] + [_i] * 6 + [_c]
    lib.ff_attention.restype = _i
    lib.ff_attention_entry.argtypes = [_i] * 6
    lib.ff_attention_entry.restype = _i
    lib.ff_attention_staged_blocks.argtypes = [_i] * 7
    lib.ff_attention_staged_blocks.restype = _i
    return lib


def design(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> str:
    """Which entry of the kernel a call on these CUDA tensors runs, as the
    library itself decides it: "staged" (N < 64), "mma" (tensor cores:
    bf16, head widths 16 or 32, N >= 64), "tiled" (one head's keys staged,
    f32 FMA) or "direct" (N >= 64 beyond what the tiled entries launch)."""
    (b, n, c), m, cv = q.shape, k.shape[1], v.shape[2]
    return ENTRIES[_lib().ff_attention_entry(b, n, m, c // heads, cv // heads,
                                             int(q.dtype == torch.bfloat16))]


def padded(pieces: int) -> int:
    """16-byte pieces a staged row of `pieces` takes: one more after every 8."""
    return pieces + (pieces + 7) // 8


def staged_plan(b: int, n: int, m: int, heads: int, d: int, dv: int,
                itemsize: int) -> dict:
    """The staged entry's launch for q (b, n, heads*d), k (b, m, heads*d)
    and v (b, m, heads*dv) of `itemsize`-byte values, but for its grid
    (`staged_grid`).

    A thread takes `queries_a_thread` queries (2 where n > 1: each key and
    value row it loads serves both) of one head. A unit is one batch
    entry's group of `heads_a_group` heads (the largest divisor of `heads`
    whose ceil(n / queries_a_thread) x group threads fit a block); a round
    is `units` units; a chunk is up to `keys_a_chunk` keys of a round's
    units (a multiple of 8, the softmax loop's step, from 8 up; fewer where
    the two stages would pass STAGED_SMEM), so a round takes `chunks`
    steps; `smem` bytes a block."""
    qp = 1 if n == 1 else 2
    groups = -(-n // qp)
    hg = max(g for g in range(1, heads + 1)
             if heads % g == 0 and groups * g <= STAGED_THREADS)
    units = STAGED_THREADS // (groups * hg)
    per_piece = 16 // itemsize
    row = 16 * (padded(hg * d // per_piece) + padded(hg * dv // per_piece))
    kc = max(1, min(m, STAGED_KEYS, STAGED_SMEM // (STAGED_STAGES * units * row)))
    if kc >= 8:
        kc -= kc % 8
    return dict(queries_a_thread=qp, heads_a_group=hg, units=units, keys_a_chunk=kc,
                chunks=-(-m // kc), rounds=-(-b * (heads // hg) // units),
                smem=STAGED_STAGES * units * kc * row)


def staged_grid(plan: dict, sms: int, blocks_per_sm: int) -> int:
    """The persistent grid of a staged launch: as many blocks as the card's
    SMs hold at once, or one a round where there are fewer rounds; block x
    takes rounds x, x + grid, ..."""
    return max(1, min(plan["rounds"], sms * blocks_per_sm))


def staged_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> dict:
    """The staged launch a call on these CUDA tensors makes: `staged_plan`
    with the grid from the blocks an SM holds (`blocks_per_sm`, the
    library's occupancy query for the plan)."""
    (b, n, c), m, cv = q.shape, k.shape[1], v.shape[2]
    d, dv = c // heads, cv // heads
    plan = staged_plan(b, n, m, heads, d, dv, q.element_size())
    blocks = _staged_blocks(d, dv, q.dtype == torch.bfloat16, plan["heads_a_group"],
                            plan["queries_a_thread"], plan["units"], plan["keys_a_chunk"])
    return dict(plan, blocks_per_sm=blocks, grid=staged_grid(plan, sm_count(q.device), blocks))


@functools.cache
def _staged_blocks(d: int, dv: int, bf16: bool, hg: int, qp: int, units: int, kc: int) -> int:
    blocks = _lib().ff_attention_staged_blocks(d, dv, int(bf16), hg, qp, units, kc)
    if blocks < 1:
        raise RuntimeError(f"attn_staged: no block of its plan fits an SM (d {d}, dv "
                           f"{dv}, {hg} heads a group, {qp} queries a thread, {units} "
                           f"units, {kc} keys a chunk)")
    return blocks


def small_kv_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             heads: int, scale: float) -> torch.Tensor:
    """Plain PyTorch version: einsum, f32 softmax, einsum; q's type out."""
    b, n, c = q.shape
    m = k.shape[1]
    qh = q.reshape(b, n, heads, c // heads).float()
    kh = k.reshape(b, m, heads, c // heads).float()
    vh = v.reshape(b, m, heads, v.shape[-1] // heads).float()
    attn = torch.softmax(torch.einsum("bihd,bjhd->bhij", qh, kh) * scale, dim=-1)
    out = torch.einsum("bhij,bjhd->bihd", attn, vh)
    return out.reshape(b, n, v.shape[-1]).to(q.dtype)


def rounded_p_bound(want: torch.Tensor, on_abs_v: torch.Tensor) -> torch.Tensor:
    """The bound on |tensor-core entry - plain version| at every output of
    an attention whose softmax weights are rounded to bf16 before the value
    sum, from the plain version's output `want` and the plain version's
    output on |v| in f32 (`on_abs_v`) -> f32, want's shape. Rounding a
    weight to bf16 (8 significant bits) moves it by up to 2^-8 of itself,
    so output (n, c) moves by up to 2^-8 sum_j p_nj |v_jc|. Both sides then
    round an f32 result once, half a bf16 ulp each: one ulp at the largest
    size either can have there. 1e-6 stands for the f32 sums' own order.
    Kernel F's tensor-core entry is held to it too
    (`window_attention.bf16_bound`)."""
    moved = 2.0 ** -8 * on_abs_v
    top = want.float().abs() * (1 + 2.0 ** -8) + moved
    ulp = torch.exp2(torch.floor(torch.log2(top.clamp_min(1e-30))) - 7)
    return moved + ulp + 1e-6


def bf16_bound(want: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    """`rounded_p_bound` for bf16 q, k, v of this kernel, `want` being the
    plain version's output."""
    return rounded_p_bound(want, small_kv_attention_plain(
        q.float(), k.float(), v.float().abs(), heads, scale))


def attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                  scale: float, g: torch.Tensor):
    """The VJP of `small_kv_attention`: g (B, N, Cv) -> (dq, dk, dv) in
    q's, k's and v's types, in f32, over chunks of batch entries whose f32
    softmax weights (chunk x heads x N x M) fit `VJP_CHUNK_BYTES`."""
    b, n, c = q.shape
    m, cv = k.shape[1], v.shape[2]
    d, dv_ = c // heads, cv // heads
    chunk = max(1, VJP_CHUNK_BYTES // max(1, heads * n * m * 4))
    dq = torch.empty((b, n, c), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, m, c), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, m, cv), dtype=v.dtype, device=v.device)
    for s in range(0, b, chunk):
        e = min(b, s + chunk)
        heads_of = lambda t, rows, width: t[s:e].float().reshape(
            e - s, rows, heads, width).transpose(1, 2)
        qh, kh, vh = heads_of(q, n, d), heads_of(k, m, d), heads_of(v, m, dv_)
        gh = heads_of(g, n, dv_)
        p = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) * scale, dim=-1)
        dvh = torch.matmul(p.transpose(-1, -2), gh)
        dp = torch.matmul(gh, vh.transpose(-1, -2))
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
        del p, dp
        dq[s:e] = (torch.matmul(ds, kh) * scale).transpose(1, 2).reshape(e - s, n, c)
        dk[s:e] = (torch.matmul(ds.transpose(-1, -2), qh) * scale).transpose(1, 2).reshape(
            e - s, m, c)
        dv[s:e] = dvh.transpose(1, 2).reshape(e - s, m, cv)
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, heads, scale):
        ctx.heads, ctx.scale = heads, scale
        ctx.save_for_backward(q, k, v)
        return _launch(q, k, v, heads, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*attention_vjp(q, k, v, ctx.heads, ctx.scale, g.contiguous()), None, None)


def small_kv_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       heads: int, scale: float) -> torch.Tensor:
    """q (B, N, C), k (B, M, C), v (B, M, Cv) of one type (bf16 or f32)
    -> (B, N, Cv). Differentiable in q, k and v (`attention_vjp`)."""
    return _Attention.apply(q, k, v, heads, scale)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
            scale: float) -> torch.Tensor:
    """The forward: the kernel on CUDA tensors (contiguous, 16-byte
    aligned), `small_kv_attention_plain` on the CPU."""
    if q.device.type == "cpu":
        return small_kv_attention_plain(q, k, v, heads, scale)
    if q.device.type != "cuda":
        raise ValueError(f"small_kv_attention: unsupported device {q.device}")
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("small_kv_attention: q, k, v must be (B, N, C)")
    b, n, c = q.shape
    m, cv = k.shape[1], v.shape[2]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"small_kv_attention: bf16 or f32, got {q.dtype}")
    if c % heads or cv % heads:
        raise ValueError(f"small_kv_attention: {heads} heads do not split "
                         f"C={c} and Cv={cv}")
    d, dv = c // heads, cv // heads
    if d not in HEAD_DIMS or dv not in HEAD_DIMS or m < 1:
        raise ValueError(f"small_kv_attention: head widths {d}, {dv} (built "
                         f"for {HEAD_DIMS}) and M={m} >= 1")
    for t, shape in ((k, (b, m, c)), (v, (b, m, cv))):
        if tuple(t.shape) != shape:
            raise ValueError(f"small_kv_attention: expected {shape}, got "
                             f"{tuple(t.shape)}")
    for t in (q, k, v):
        if (t.device != q.device or t.dtype != q.dtype or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError("small_kv_attention: q, k, v must be contiguous, "
                             f"16-byte aligned {q.dtype} on {q.device}")
    out = torch.empty((b, n, cv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    entry = design(q, k, v, heads)
    p = (staged_launch(q, k, v, heads) if entry == "staged" else
         dict(heads_a_group=0, queries_a_thread=0, units=0, keys_a_chunk=0, grid=0))
    err = _lib().ff_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, m,
        heads, d, dv, float(scale), int(q.dtype == torch.bfloat16),
        p["heads_a_group"], p["queries_a_thread"], p["units"], p["keys_a_chunk"],
        p["grid"], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "ff_attention")
    count_launch("attention", b, n, m, c, cv, heads, str(q.dtype), entry)
    return out

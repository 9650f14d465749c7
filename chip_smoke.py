#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it: FF-RAFT,
FF-FlowFormer and FF-PWCNet inference.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; no result is printed):

1. Print the card's name and power limit (nvidia-smi) and build the CUDA
   kernels from `focusflow_official_tpu_torch/kernels/csrc/` (one nvcc per
   source, in parallel), printing the build time.
2. For each kernel, at the shapes the two paths give it: the largest
   |kernel - plain PyTorch version| against a stated tolerance, the
   kernel's median time over CUDA events, the plain version's time, the
   time of one PyTorch yardstick call, and the least time the card could
   take (bytes over 3.35 TB/s or operations over the type's peak; the
   attentions' products at the bf16 tensor-core peak, and as a third term
   their exponentials, one a score, on 16 special-function lanes a clock an
   SM). One JSON line per kernel and shape: A-C2 and the fused lookup +
   convc1 at the FF-RAFT shapes (A bit-equal to its plain version; the
   fused kernel with the launch plan it ran, beside A then B, and once
   more in f32, where it must equal them to the bit; B once more in f32),
   then A (one level, bit-equal to its plain version), B (K = 81), E
   (small-kv attention) and F
   (7x7 window attention) at every distinct FF-FlowFormer shape (E: the
   Twins GSAs at both stages and batch sizes, the vertical global layer,
   the perceiver's input and self-attention, the decoder, and one shape in
   f32; F: the Twins LSAs at both stages and batch sizes, the vertical
   local layer), then D (local
   correlation) at FF-PWCNet's five decoder levels in bf16 and at one of
   them in f32, and in its fused form (the decoder's leaky ReLU in the
   epilogue, which the path runs) at the five levels, each bit-equal to the
   plain-form kernel then F.leaky_relu and timed beside those two launches
   (`two_step_ms`). D's rows name the launch plan they ran
   (`kernels/local_corr.py::plan`). E's, F's, B's and D's rows say which
   entry of the kernel ran
   (`design`: `mma` on the tensor cores, `fma` on the f32 units, and for
   E `staged` and `tiled`): every bf16 path shape of B, D and F and every
   N >= 64 one of E must say `mma`, E's N < 64 shapes `staged` (with its
   launch plan), and the tensor-core entries of E and F are held at every
   output to their `bf16_bound`. C1's and C2's rows name their entry
   (`vector`: 16-byte accesses); C1's time the whole one-launch call. C2
   runs in its plain form and in its residual form (relu(r + y), the
   ResidualBlock's shortcut) at each shape, each bit-equal to its plain
   version, the residual form also to the plain-form kernel then
   PyTorch's add and ReLU; its yardstick there is three calls
   (F.instance_norm, add, ReLU).
3. FF-RAFT end to end through `FlowPredictor`: a 1024x436 frame pair and
   keypoint masks, B=1, 12 iterations, bf16, the trained fixture weights.
   The flow must be finite, recover the known constant shift (interior
   EPE < 6 px) and track the port's f32 run on the CPU on the same inputs
   (mean |diff| < 0.05 max(mean |flow|, 1), median < 0.1 px). Every
   kernel's launch count over one forward must match the path (the fused
   lookup + convc1 12, instance-norm stats 30, normalize 30 of which 12
   in the residual form, A and B 0), and the profiled forward must show
   30 kernels of C1 and 30 of C2.
   Prints ms per frame pair. The profile lists each port kernel's launches
   and mean time inside the forward; the fused kernel's goes into its
   table entry as `in_forward` (the kernel phase repeats one call's inputs
   on a warm L2, the forward does not).
   Then the same pair through an f32 `FlowPredictor` under PyTorch's
   default TF32 flags (set for the phase, put back after): TF32 must be
   off inside its forward and the flags as they were after it, and the
   flow must pass the same gates against the same f32 CPU run.
4. FF-FlowFormer end to end through `FlowPredictor`, the same way: a
   textured 1024x436 frame and its (3, -2) px shift, B=1, 12 refinements,
   bf16, the trained fixture (`trained_smoke_ff.npz`, encoder_depth 1), the
   same three gates against a full-size f32 CPU run, and the launch counts
   (lookup 12, fold 24, attention 23, window attention 9).
5. FF-FlowFormer at the shipped depth (encoder_depth 3) on weights drawn
   from a seeded `torch.Generator`: finite flow, attention 27 and window
   attention 11 launches, ms per pair and device busy ms. Timing only.
6. FF-PWCNet end to end through `FlowPredictor`: the same textured pair,
   raw 0-255 inputs resized to 1024x448 inside, B=1, bf16, the trained
   fixture (`trained_smoke_pwc.npz`). Finite flow that tracks the f32 CPU
   run within the same bounds (the margin printed: mean |diff| over its
   limit), and exactly 5 launches of D, all in the fused form, 5 in the
   profile too (the kernel count and D's profile time printed). No shift gate:
   this fixture predicts about the zero-flow baseline on any probe, so the
   agreement with the f32 run carries correctness.
7. A `{"kernels": [...]}` line, then the last line
   `{"ok": true, "device": {...}}`. Each wrapper counts a launch under its
   kernel's name and under a key of the call's shape; phase 2 notes the key
   of every shape it holds, and the table reads each shape's launches from
   the counted forwards of phases 3 to 6 by that key, with launches x (ms -
   bound). A path that launched a shape which phase 2 does not hold fails.

Outside the phase under default flags, f32 matmuls and convolutions run
in full f32 here (TF32 off), so the f32 comparisons are not blurred by
TF32's 10-bit mantissa. Needs one card.
"""

from __future__ import annotations

import functools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "trained_smoke.npz")
FIXTURE_FF = os.path.join(ROOT, "tests", "fixtures", "trained_smoke_ff.npz")
FIXTURE_PWC = os.path.join(ROOT, "tests", "fixtures", "trained_smoke_pwc.npz")
OUT_DIR = os.path.join(ROOT, "build")  # gitignored

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32 = 67e12  # f32 outside the tensor cores
PEAK_BF16 = 989e12  # bf16 tensor cores, dense
SFU_LANES = 16  # special-function results (one exponential each) a clock an SM

H, W, ITERS = 436, 1024, 12


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _sms(torch) -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


@functools.cache
def _exp_per_s(torch) -> float:
    """Exponentials a second the card's special-function units can start:
    SMs x 16 a clock x the card's highest SM clock (nvidia-smi)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    mhz = float(out.strip().splitlines()[0])
    return _sms(torch) * SFU_LANES * mhz * 1e6


def _attention_bound(torch, nbytes: float, flops: float, scores: float,
                     peak: float = PEAK_BF16) -> dict:
    """An attention's bound: bytes, its two products at their type's peak
    (bf16: the tensor cores), or one exponential a score, whichever takes
    longest. `bound_by` keeps to bytes or operations; `bound_term` names
    the term."""
    bound, by = _bound_ms(nbytes, flops, peak)
    term = "bytes" if by == "bytes" else "products"
    t_exp = scores / _exp_per_s(torch) * 1e3
    if t_exp > bound:
        bound, by, term = t_exp, "operations", "exponentials"
    return dict(bound_ms=bound, bound_by=by, bound_term=term, exp_bound_ms=t_exp)


def _time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call of `fn`, over CUDA events.

    A ~50 ms device spin goes first, so the host has queued every call
    before the first one starts: each event pair then brackets device work
    only, not the host's launch latency (which, on a busy host, exceeds
    these kernels' run time)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # cycles: ~50 ms at the H100's ~1.98 GHz
    pairs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def _bound_ms(nbytes: float, flops: float, peak: float):
    """The larger of bytes over the memory rate and operations over their
    peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bf16_ulp(x: float) -> float:
    """The spacing of bf16 values (8 significant bits) at magnitude x > 0."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def _check(name: str, err: float, tol: float) -> None:
    if not np.isfinite(err) or err > tol:
        raise AssertionError(f"{name}: max |kernel - plain| = {err} > {tol}")


def _launch_key(fn):
    """Call `fn`, which launches one kernel once -> (its result, the (name,
    *shape) key that the wrapper counted the launch under). The counted
    forwards are split by the same keys, so a row's launches are read from
    the run and not worked out beside it."""
    from focusflow_official_tpu_torch.kernels import launch_shapes, reset_launch_counts

    reset_launch_counts()
    out = fn()
    (key,) = launch_shapes
    return out, key


def _library_ms(torch, fn):
    """The yardstick's time, or None (and why) where the library call
    refuses these inputs; a yardstick is not part of the port."""
    try:
        return _time_ms(torch, fn), None
    except Exception as e:  # noqa: BLE001 - reported, not fatal
        return None, f"{type(e).__name__}: {str(e)[:200]}"


def _grid_sample_yardstick(torch, levels, coords, r: int):
    """A call that looks the windows up with F.grid_sample, one call per
    level over (Q, 1, H_l, W_l) images with a (Q, 9, 9, 2) window grid
    (f32 levels: bf16 grid_sample is not assumed) -> list of (Q, 1, 9, 9)."""
    import torch.nn.functional as F

    dev = coords.device
    q = coords.shape[0] * coords.shape[1] * coords.shape[2]
    d = torch.arange(-r, r + 1, device=dev, dtype=torch.float32)
    win = torch.stack(torch.meshgrid(d, d, indexing="ij"), -1)  # (k, k, 2)
    lv32 = [lv.float().reshape(q, 1, *lv.shape[2:]) for lv in levels]
    grids = []
    for i, lv in enumerate(lv32):
        hl, wl = lv.shape[2:]
        c = coords.reshape(q, 1, 1, 2) / 2 ** i + win
        grids.append(torch.stack([2 * c[..., 0] / (wl - 1) - 1,
                                  2 * c[..., 1] / (hl - 1) - 1], -1))
    return lambda: [F.grid_sample(lv, gr, align_corners=True)
                    for lv, gr in zip(lv32, grids)]


def _tap_count(torch, levels, coords, r: int) -> int:
    """The values of the levels that these coords' windows touch: each
    query's in-bounds (K+1)^2 patch, summed over queries and levels."""
    dev = coords.device
    k = 2 * r + 1
    q = coords.shape[0] * coords.shape[1] * coords.shape[2]
    taps = 0
    for i, lv in enumerate(levels):
        hl, wl = lv.shape[2:]
        c = coords.reshape(q, 2) / 2 ** i
        x0 = torch.floor(c[:, 0]) - r
        y0 = torch.floor(c[:, 1]) - r
        nx = (torch.minimum(x0 + k, torch.tensor(wl - 1.0, device=dev))
              - torch.maximum(x0, torch.tensor(0.0, device=dev)) + 1).clamp(min=0)
        ny = (torch.minimum(y0 + k, torch.tensor(hl - 1.0, device=dev))
              - torch.maximum(y0, torch.tensor(0.0, device=dev)) + 1).clamp(min=0)
        taps += int((nx * ny).sum())
    return taps


def _lookup_row(torch, levels, coords, r: int, label: str) -> dict:
    """Kernel A against its plain version at these levels and coords (in
    the levels' type; bf16 is the plain f32 result's cast: bit-equal
    either way), timed beside F.grid_sample, with its bound and the
    library's block size. `out` is the kernel's."""
    from focusflow_official_tpu_torch.kernels import lookup as kl

    got, key = _launch_key(lambda: kl.lookup(levels, coords, r))
    want = kl.lookup_plain(levels, coords, r)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    # the same f32 products and sums in the same order, rounded once to the
    # output type as the plain version's cast rounds: the same bits
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: not bit-equal to the plain version ({err})")
    ms = _time_ms(torch, lambda: kl.lookup(levels, coords, r))
    plain_ms = _time_ms(torch, lambda: kl.lookup_plain(levels, coords, r), reps=10)
    sample = _grid_sample_yardstick(torch, levels, coords, r)
    lib_ms, lib_err = _library_ms(torch, sample)
    del sample
    nbytes = (got.numel() * got.element_size() + coords.numel() * 4
              + _tap_count(torch, levels, coords, r) * levels[0].element_size())
    flops = got.numel() * 11  # 4 weights, 4 tap products, 3 adds per output
    bound, by = _bound_ms(nbytes, flops, PEAK_F32)
    design = dict(design="patch", units_per_block=kl.units_per_block())
    return dict(key=key, design=design, max_abs_err=err,
                tol=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms, library_error=lib_err, out=got)


def _fold_row(torch, a, w, bias, label: str, design: str) -> dict:
    """Kernel B against its plain version, timed beside F.linear. `design`
    is the entry these inputs must run: `mma` for bf16, `fma` for f32."""
    import torch.nn.functional as F

    from focusflow_official_tpu_torch.kernels import fold as kf

    ran = kf.design(a)
    if ran != design:
        raise AssertionError(f"{label}: ran the {ran} entry, not {design}")
    out, key = _launch_key(lambda: kf.fold(a, w, bias))
    ref = kf.fold_plain(a, w, bias)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    top = max(1.0, float(ref.float().abs().max()))
    # f32 sums of K products in another order (bf16 x bf16 products are
    # exact in f32 on either entry); in bf16 then one rounding: one bf16 ulp
    tol = (1e-4 if a.dtype == torch.float32 else 2.0 ** -7) * top
    _check(label, err, tol)
    ms = _time_ms(torch, lambda: kf.fold(a, w, bias))
    plain_ms = _time_ms(torch, lambda: kf.fold_plain(a, w, bias))
    lib_ms, lib_err = _library_ms(torch, lambda: F.linear(a, w, bias))
    (m_, k_), n_ = a.shape, w.shape[0]
    bound, by = _bound_ms((m_ * k_ + n_ * k_ + n_ + m_ * n_) * a.element_size(),
                          2.0 * m_ * n_ * k_,
                          PEAK_F32 if a.dtype == torch.float32 else PEAK_BF16)
    return dict(key=key, design=ran, max_abs_err=err, tol=tol, ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=lib_ms,
                library_error=lib_err)


def _lookup_fold_row(torch, levels, coords, r: int, w, bias, label: str) -> dict:
    """The fused lookup + convc1 against its plain version (lookup_plain
    then fold_plain) and against kernel A then kernel B, timed beside both
    and beside F.grid_sample per level then F.linear, with the launch plan
    it ran."""
    import torch.nn.functional as F

    from focusflow_official_tpu_torch.kernels import fold as kf
    from focusflow_official_tpu_torch.kernels import lookup as kl
    from focusflow_official_tpu_torch.kernels import lookup_fold as klf

    b, h1, w1, _ = coords.shape
    q = b * h1 * w1
    n_, k_ = w.shape
    sms = torch.cuda.get_device_properties(coords.device).multi_processor_count
    layout = klf.layout()
    plan = klf.plan(q, n_, r, w.dtype, sms, **layout)
    if plan["entry"] == "mma":  # beside the plan, the library's layout
        plan.update(layout, smem=klf.smem(k_, n_))

    def two_step():
        window = kl.lookup(levels, coords, r).reshape(q, k_)
        return kf.fold(window, w, bias)

    got, key = _launch_key(lambda: klf.lookup_fold(levels, coords, r, w, bias))
    want = klf.lookup_fold_plain(levels, coords, r, w, bias)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    # as B: f32 sums in another order, in bf16 then one rounding: one bf16 ulp
    tol = ((1e-4 if w.dtype == torch.float32 else 2.0 ** -7)
           * max(1.0, float(want.float().abs().max())))
    _check(label, err, tol)
    two = two_step().float()
    # f32: the same taps and the same FMA tile in the same k order as A then
    # B: equal to the bit. bf16: the same window and k chain as B's tensor
    # cores, which may sum in another order: one bf16 ulp of the largest output
    tol2 = 0.0 if w.dtype == torch.float32 else _bf16_ulp(float(two.abs().max()))
    err2 = float((got.float().reshape(q, n_) - two).abs().max())
    _check(f"{label} vs lookup then fold", err2, tol2)
    ms = _time_ms(torch, lambda: klf.lookup_fold(levels, coords, r, w, bias))
    two_step_ms = _time_ms(torch, two_step)
    plain_ms = _time_ms(torch, lambda: klf.lookup_fold_plain(levels, coords, r, w, bias),
                        reps=10)
    sample = _grid_sample_yardstick(torch, levels, coords, r)

    def library():
        window = torch.cat([o.reshape(q, -1) for o in sample()], -1)
        return F.linear(window.to(w.dtype), w, bias)

    lib_ms, lib_err = _library_ms(torch, library)
    del sample
    es = w.element_size()
    nbytes = (_tap_count(torch, levels, coords, r) * levels[0].element_size()
              + coords.numel() * 4 + (n_ * k_ + n_ + q * n_) * es)
    # the window's 11 f32 operations a value, then the product at its type's
    # peak as for B: two kinds of operations, one after the other
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    peak = PEAK_F32 if w.dtype == torch.float32 else PEAK_BF16
    t_ops = (q * k_ * 11 / PEAK_F32 + 2.0 * q * n_ * k_ / peak) * 1e3
    bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return dict(key=key, plan=plan, max_abs_err=err, tol=tol,
                vs_lookup_then_fold_max_abs=err2, vs_lookup_then_fold_tol=tol2, ms=ms,
                lookup_then_fold_ms=two_step_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=lib_ms, library_error=lib_err)


# FF-PWCNet's decoder levels 6 to 2 at 1024x448: (B, H, W, C)
PWC_LEVELS = ((1, 7, 16, 196), (1, 14, 32, 128), (1, 28, 64, 96),
              (1, 56, 128, 64), (1, 112, 256, 32))


def _local_corr_row(torch, g, dev, shape, dtype, label: str, slope=None) -> dict:
    """Kernel D on random (B, H, W, C) maps against its plain version, with
    the launch plan it ran. With a slope, the fused form (leaky ReLU in the
    epilogue), which must also equal the plain-form kernel then
    F.leaky_relu (two launches, `two_step_ms`) to the bit. No single PyTorch
    call computes this function, so there is no yardstick."""
    import torch.nn.functional as F

    from focusflow_official_tpu_torch.kernels import local_corr as klc

    r = 4
    f1 = torch.randn(shape, generator=g, device=dev).to(dtype)
    f2 = torch.randn(shape, generator=g, device=dev).to(dtype)
    plan = klc.plan(*shape, r, dtype, _sms(torch))
    if plan["entry"] == "mma":
        plan["smem_built"] = klc.smem_built(shape[3], r, plan)
        if plan["smem_built"] != plan["smem"]:
            raise AssertionError(f"{label}: plan smem {plan['smem']} != the library's "
                                 f"{plan['smem_built']}")
    if plan["entry"] != ("fma" if dtype == torch.float32 else "mma"):
        raise AssertionError(f"{label}: ran the {plan['entry']} entry")
    call = lambda: klc.local_corr(f1, f2, r, negative_slope=slope)
    got, key = _launch_key(call)
    want = klc.local_corr_plain(f1, f2, r, slope)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if dtype == torch.float32:
        # f32 sums of C products in another order
        tol = 1e-5 * max(1.0, float(want.abs().max()))
    else:
        # exact products summed in f32 in another order, rounded once: one
        # bf16 ulp of the largest output
        tol = _bf16_ulp(float(want.float().abs().max()))
    _check(label, err, tol)
    extra = {}
    if slope is not None:
        two_step = lambda: F.leaky_relu(klc.local_corr(f1, f2, r), slope)
        if not torch.equal(got, two_step()):
            raise AssertionError(f"{label}: not bit-equal to the plain-form kernel then "
                                 "F.leaky_relu")
        extra = dict(vs_two_step="bit-equal", two_step_ms=_time_ms(torch, two_step))
    ms = _time_ms(torch, call)
    plain_ms = _time_ms(torch, lambda: klc.local_corr_plain(f1, f2, r, slope), reps=10)
    es = f1.element_size()
    bound, by = _bound_ms((2 * f1.numel() + got.numel()) * es, 2.0 * got.numel() * shape[3],
                          PEAK_F32 if dtype == torch.float32 else PEAK_BF16)
    form = "plain" if slope is None else f"leaky_relu {slope}"
    return dict(shape=f"{tuple(shape)} x2 -> 81, {str(dtype).split('.')[1]}, {form}",
                label=label, key=key, design=plan["entry"], plan=plan, max_abs_err=err,
                tol=tol, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=None, library="none: no single PyTorch call computes it", **extra)


def pwc_kernel_phase(torch, dev) -> list:
    """D at FF-PWCNet's five decoder levels in bf16, at level 4 in f32, then
    the fused form (the decoder's leaky ReLU, which the path runs) at the
    five levels in bf16."""
    g = torch.Generator(device=dev).manual_seed(2)
    rows = []
    levels = list(zip((6, 5, 4, 3, 2), PWC_LEVELS))
    for lvl, shape in levels:
        rows.append(_local_corr_row(torch, g, dev, shape, torch.bfloat16,
                                    f"local_corr level {lvl}"))
        _emit(dict(kernel="local_corr", path="ff_pwcnet", **rows[-1]))
    rows.append(_local_corr_row(torch, g, dev, PWC_LEVELS[2], torch.float32,
                                "local_corr level 4, f32"))
    _emit(dict(kernel="local_corr", path="ff_pwcnet", **rows[-1]))
    for lvl, shape in levels:
        rows.append(_local_corr_row(torch, g, dev, shape, torch.bfloat16,
                                    f"local_corr level {lvl}, leaky_relu", slope=0.1))
        _emit(dict(kernel="local_corr", path="ff_pwcnet", **rows[-1]))
    return rows


def kernel_phase(torch, dev):
    """A, B, the fused lookup + convc1, C1 and C2 at the FF-RAFT shapes ->
    one result per kernel."""
    import torch.nn.functional as F

    from focusflow_official_tpu_torch.kernels import instance_norm as kin
    from focusflow_official_tpu_torch.compat.weights import load_npz
    from focusflow_official_tpu_torch.ops.coords import coords_grid
    from focusflow_official_tpu_torch.ops.corr import corr_pyramid

    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    h1, w1, r = 55, 128, 4
    q = h1 * w1
    results = []

    # ---- A: lookup, pyramid 55x128 / 27x64 / 13x32 / 6x16 in bf16, Q = 7040
    corr0 = torch.randn((1, q, h1, w1), generator=g, device=dev)
    levels = corr_pyramid(corr0, 4, bf16)
    del corr0
    flow = torch.randn((1, h1, w1, 2), generator=g, device=dev) * 8
    coords = (coords_grid(1, h1, w1, device=dev) + flow).contiguous()
    row = _lookup_row(torch, levels, coords, r, "lookup")
    got = row.pop("out")
    results.append(dict(
        name="lookup", route="cuda",
        source="focusflow_official_tpu_torch/kernels/csrc/lookup.cu",
        replaces="focusflow_official_tpu/ops/pallas_lookup.py:70", **row,
        library="F.grid_sample x4 levels (f32)",
        shape=f"levels {[tuple(lv.shape) for lv in levels]} bf16, Q={q}"))
    _emit(results[-1])

    # ---- B: fold, (7040, 324) @ (256, 324).T + bias in bf16, fixture weights
    sd = load_npz(FIXTURE)
    wc = sd["flow_net.update_block.encoder.convc1.weight"].reshape(256, 324)
    wc = wc.to(dev, bf16).contiguous()
    bc = sd["flow_net.update_block.encoder.convc1.bias"].to(dev, bf16)
    a = got.reshape(q, 324).to(bf16)
    row = _fold_row(torch, a, wc, bc, "fold", "mma")
    # the same product in f32: the FMA tiles, which the fused kernel shares
    row32 = _fold_row(torch, a.float(), wc.float(), bc.float(), "fold f32", "fma")
    row32.update(shape="(7040, 324) @ (256, 324).T f32", library="F.linear (f32)")
    results.append(dict(
        name="fold", route="cuda",
        source="focusflow_official_tpu_torch/kernels/csrc/fold.cu",
        replaces="focusflow_official_tpu/kernels/fold.py:51", **row,
        library="F.linear (bf16)", shape="(7040, 324) @ (256, 324).T bf16",
        f32=row32))
    _emit(results[-1])

    # ---- the fused lookup + convc1: the same pyramid, coords and weights
    row = _lookup_fold_row(torch, levels, coords, r, wc, bc, "lookup_fold")
    # in f32 (the same pyramid, weights and coords): equal to A then B to the bit
    levels32 = [lv.float() for lv in levels]
    row32 = _lookup_fold_row(torch, levels32, coords, r, wc.float(), bc.float(),
                             "lookup_fold f32")
    row32.update(shape=f"4 levels f32, Q={q}, (256, 324) weight -> ({q}, 256) f32")
    del levels32
    results.append(dict(
        name="lookup_fold", route="cuda",
        source="focusflow_official_tpu_torch/kernels/csrc/lookup_fold.cu",
        replaces="focusflow_official_tpu/kernels/stage2.py:64", **row,
        library="F.grid_sample x4 levels (f32), cat, F.linear (bf16)",
        shape=f"4 levels bf16, Q={q}, (256, 324) weight -> ({q}, 256) bf16",
        f32=row32))
    _emit(results[-1])
    del levels, got, a

    # ---- C1, C2: instance norm at the fnet's three shapes (both frames); C2
    # in its plain form and in its residual form (ResidualBlock's shortcut)
    shapes = [(2, 220, 512, 64), (2, 110, 256, 96), (2, 55, 128, 128)]
    per_shape = {"in_stats": [], "in_normalize": []}
    for shp in shapes:
        x = (torch.randn(shp, generator=g, device=dev) * 3 + 1).to(bf16)
        res = torch.randn(shp, generator=g, device=dev).to(bf16)
        (mean, inv), key1 = _launch_key(lambda: kin.instance_norm_stats(x))
        if key1[-1] != "vector":
            raise AssertionError(f"in_stats {shp}: ran the {key1[-1]} entry, not vector")
        rmean, rinv = kin.stats_plain(x)
        torch.cuda.synchronize()
        err1 = max(float((mean - rmean).abs().max()), float((inv - rinv).abs().max()))
        # f32 sums of up to 1e5 values in another order
        tol1 = 1e-4 * (1.0 + max(float(rmean.abs().max()), float(rinv.abs().max())))
        _check(f"in_stats {shp}", err1, tol1)
        t1 = _time_ms(torch, lambda: kin.instance_norm_stats(x))
        t1p = _time_ms(torch, lambda: kin.stats_plain(x))
        tv = _time_ms(torch, lambda: torch.var_mean(x, dim=(1, 2), correction=0))
        xs = x.numel() * 2
        b1, by1 = _bound_ms(xs + 2 * shp[0] * shp[3] * 4, 3.0 * x.numel(), PEAK_F32)
        # the launch's key ends with the split and the entry that ran
        per_shape["in_stats"].append(dict(
            shape=list(shp), key=key1, design=key1[-1], splits=key1[-2],
            max_abs_err=err1, tol=tol1, ms=t1, plain_ms=t1p,
            bound_ms=b1, bound_by=by1, library_ms=tv))
        xn, rn = x.permute(0, 3, 1, 2), res.permute(0, 3, 1, 2)  # NCHW views
        plain_y = None
        for r in (None, res):
            form = "plain" if r is None else "residual"
            y, key2 = _launch_key(lambda: kin.instance_norm_apply(x, mean, inv, True, r))
            if key2[-2:] != ("vector", form):  # the key ends with the entry and the form
                raise AssertionError(f"in_normalize {shp}: ran {key2[-2:]}, not vector {form}")
            ry = kin.apply_plain(x, mean, inv, True, r)
            torch.cuda.synchronize()
            err2 = float((y.float() - ry.float()).abs().max())
            # the kernel rounds where PyTorch's bf16 ops round: bit-equal
            if not torch.equal(y, ry):
                raise AssertionError(f"in_normalize {shp} {form}: not bit-equal ({err2})")
            row = dict(shape=list(shp), form=form, key=key2, design=key2[-2],
                       max_abs_err=err2, tol=0.0)
            if r is None:
                plain_y = y
                lib = lambda: F.instance_norm(xn)
                row["library"] = "F.instance_norm (stats and normalize, no ReLU)"
            else:
                # one launch against the plain-form kernel, then PyTorch's add and ReLU
                two = torch.relu(res + plain_y)
                if not torch.equal(y, two):
                    raise AssertionError(f"in_normalize {shp}: the residual form is not the "
                                         "plain-form kernel then add and ReLU")
                row["vs_plain_kernel_add_relu"] = "bit-equal"
                row["plain_kernel_add_relu_ms"] = _time_ms(torch, lambda: torch.relu(
                    res + kin.instance_norm_apply(x, mean, inv, True)))
                lib = lambda: torch.relu(rn + F.instance_norm(xn))
                row["library"] = "three calls: F.instance_norm, add, ReLU"
            row["ms"] = _time_ms(torch, lambda: kin.instance_norm_apply(x, mean, inv, True, r))
            row["plain_ms"] = _time_ms(torch, lambda: kin.apply_plain(x, mean, inv, True, r))
            row["library_ms"] = _time_ms(torch, lib)
            tensors = 2 if r is None else 3  # x (and r) read, y written
            row["bound_ms"], row["bound_by"] = _bound_ms(
                tensors * xs + 2 * shp[0] * shp[3] * 4, (3.0 if r is None else 5.0) * x.numel(),
                PEAK_F32)
            per_shape["in_normalize"].append(row)
            del y, ry
        del x, res, plain_y, xn, rn
    src = "focusflow_official_tpu_torch/kernels/csrc/instance_norm.cu"
    for name, replaces, lib in (
            ("in_stats", "focusflow_official_tpu/kernels/instance_norm.py:51",
             "torch.var_mean over (H, W), correction=0 (the (B, C) rsqrt "
             "not included)"),
            ("in_normalize", "focusflow_official_tpu/kernels/instance_norm.py:66",
             "F.instance_norm (stats and normalize, no ReLU)")):
        rows = per_shape[name]
        top = rows[0]  # the largest shape (plain form) stands for the kernel
        results.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            max_abs_err=max(r_["max_abs_err"] for r_ in rows),
            tol=min(r_["tol"] for r_ in rows),
            ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
            bound_by=top["bound_by"], library_ms=top["library_ms"],
            library=lib, shape=f"{tuple(shapes[0])} bf16", design=top["design"],
            per_shape=rows))
        _emit(results[-1])
    return results


def _attention_row(torch, g, dev, b, n, m, c, heads, label, design: str,
                   dtype=None) -> dict:
    """Kernel E on random q (B, N, C), k, v (B, M, C) (bf16 unless `dtype`)
    against its plain version, timed beside F.scaled_dot_product_attention
    on (B, heads, N, d) views of the same tensors. `design` is the entry
    these inputs must run: `mma` (tensor cores), `staged` (N < 64: each
    entry's keys staged once) or `tiled` (f32 FMA)."""
    import torch.nn.functional as F

    from focusflow_official_tpu_torch.kernels import attention as ka

    dtype = dtype or torch.bfloat16
    q = torch.randn((b, n, c), generator=g, device=dev).to(dtype)
    k = torch.randn((b, m, c), generator=g, device=dev).to(dtype)
    v = torch.randn((b, m, c), generator=g, device=dev).to(dtype)
    d = c // heads
    scale = d ** -0.5
    ran = ka.design(q, k, v, heads)
    got, key = _launch_key(lambda: ka.small_kv_attention(q, k, v, heads, scale))
    if ran != design or key[-1] != design:  # the launch's key ends with the entry
        raise AssertionError(f"{label}: ran the {ran} entry, not {design}")
    plan = ka.staged_launch(q, k, v, heads) if ran == "staged" else None
    want = ka.small_kv_attention_plain(q, k, v, heads, scale)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    top = max(1.0, float(want.float().abs().max()))
    over = None
    if dtype == torch.float32:
        tol = 1e-5 * top  # f32 scores, softmax and sums in another order
    elif ran == "mma":
        # held at every output: one bf16 ulp of that output for the two
        # sides' roundings, and the tensor-core entry's bf16 softmax weights:
        # 2^-8 of its row's sum of p |v|. `tol` is the bound where the error
        # is largest
        bound = ka.bf16_bound(want, q, k, v, heads, scale)
        over = float((diff / bound).max())
        if not over <= 1.0:
            raise AssertionError(f"{label}: |kernel - plain| is {over} of its bound "
                                 "at some output")
        tol = float(bound.flatten()[diff.argmax()])
        del bound
    else:
        # both take f32 scores, softmax and sums from the same bf16 inputs,
        # in other orders, and round once to bf16: one bf16 ulp
        tol = 2.0 ** -7 * top
    del diff
    _check(label, err, tol)
    ms = _time_ms(torch, lambda: ka.small_kv_attention(q, k, v, heads, scale))
    plain_ms = _time_ms(torch, lambda: ka.small_kv_attention_plain(
        q, k, v, heads, scale), reps=10)
    qh, kh, vh = (t.view(b, -1, heads, d).transpose(1, 2) for t in (q, k, v))
    lib_ms, lib_err = _library_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, scale=scale))
    nbytes = (q.numel() + k.numel() + v.numel() + got.numel()) * q.element_size()
    scores = float(b) * heads * n * m
    return dict(shape=f"q ({b}, {n}, {c}) x kv ({b}, {m}, {c}), {heads} heads, "
                      f"{str(dtype).split('.')[1]}", label=label, key=key,
                design=ran, plan=plan, largest_err_over_its_bound=over, max_abs_err=err,
                tol=tol, ms=ms, plain_ms=plain_ms,
                **_attention_bound(torch, nbytes, scores * 2 * 2 * d, scores,
                                   PEAK_F32 if dtype == torch.float32 else PEAK_BF16),
                library_ms=lib_ms, library_error=lib_err)


def _window_row(torch, g, dev, b, hp, wp, c, heads, label) -> dict:
    """Kernel F on random bf16 (B, Hp, Wp, C) q, k, v against its plain
    version, timed beside F.scaled_dot_product_attention on the window-
    partitioned (B*nwin, heads, 49, d) tensors (partitioned before the
    timed window; a second time includes the partition and the merge).
    Every bf16 shape of the path runs the tensor-core entry (`mma`), held
    at every output to `bf16_bound`."""
    import torch.nn.functional as F

    from focusflow_official_tpu_torch.kernels import window_attention as kw

    bf16, ws = torch.bfloat16, 7
    q, k, v = (torch.randn((b, hp, wp, c), generator=g, device=dev).to(bf16)
               for _ in range(3))
    d = c // heads
    scale = d ** -0.5
    got, key = _launch_key(lambda: kw.window_attention(q, k, v, ws, heads, scale))
    if key[-1] != "mma":  # the launch's key ends with the entry that ran
        raise AssertionError(f"{label}: ran the {key[-1]} entry, not mma")
    want = kw.window_attention_plain(q, k, v, ws, heads, scale)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    # held at every output: one bf16 ulp of that output for the two sides'
    # roundings, and 2^-8 of its row's sum of p |v| for the bf16 softmax
    # weights. `tol` is the bound where the error is largest
    bound = kw.bf16_bound(want, q, k, v, heads, scale)
    over = float((diff / bound).max())
    if not over <= 1.0:
        raise AssertionError(f"{label}: |kernel - plain| is {over} of its bound at some output")
    tol = float(bound.flatten()[diff.argmax()])
    del bound, diff
    _check(label, err, tol)
    ms = _time_ms(torch, lambda: kw.window_attention(q, k, v, ws, heads, scale))
    plain_ms = _time_ms(torch, lambda: kw.window_attention_plain(
        q, k, v, ws, heads, scale), reps=10)
    nh, nw = hp // ws, wp // ws

    def part(t):
        t = t.view(b, nh, ws, nw, ws, heads, d).permute(0, 1, 3, 5, 2, 4, 6)
        return t.reshape(b * nh * nw, heads, ws * ws, d)

    def sdpa_merged():
        o = F.scaled_dot_product_attention(part(q), part(k), part(v), scale=scale)
        o = o.view(b, nh, nw, heads, ws, ws, d).permute(0, 1, 4, 2, 5, 3, 6)
        return o.reshape(b, hp, wp, c)

    qw, kw_, vw = part(q), part(k), part(v)
    lib_ms, lib_err = _library_ms(torch, lambda: F.scaled_dot_product_attention(
        qw, kw_, vw, scale=scale))
    lib_full_ms, _ = _library_ms(torch, sdpa_merged)
    scores = float(b * nh * nw) * heads * (ws * ws) ** 2
    return dict(shape=f"({b}, {hp}, {wp}, {c}), {heads} heads, bf16", label=label,
                key=key, design=key[-1], largest_err_over_its_bound=over,
                max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                **_attention_bound(torch, 4 * q.numel() * 2, scores * 2 * 2 * d, scores),
                library_ms=lib_ms, library_error=lib_err,
                library_with_partition_ms=lib_full_ms)


def ff_kernel_phase(torch, dev) -> dict:
    """A (one level), B (K = 81), E and F at the FF-FlowFormer shapes at
    1024x436 (a 55x128 cost grid, Q = 7040) -> {kernel: [rows]}."""
    from focusflow_official_tpu_torch.compat.weights import load_npz
    from focusflow_official_tpu_torch.ops.coords import coords_grid

    g = torch.Generator(device=dev).manual_seed(1)
    bf16 = torch.bfloat16
    h1, w1, r = 55, 128, 4
    q = h1 * w1
    rows = {"lookup": [], "fold": [], "attention": [], "window_attention": []}

    def add(kernel: str, row: dict) -> None:
        rows[kernel].append(row)
        _emit(dict(kernel=kernel, path="ff_flowformer", **row))

    # A: one level, the (1, Q, 55, 128) cost maps in bf16; once a refinement
    level = torch.randn((1, q, h1, w1), generator=g, device=dev).to(bf16)
    flow = torch.randn((1, h1, w1, 2), generator=g, device=dev) * 8
    coords = (coords_grid(1, h1, w1, device=dev) + flow).contiguous()
    row = _lookup_row(torch, [level], coords, r, "lookup (FlowFormer)")
    window = row.pop("out").reshape(q, 81)
    add("lookup", dict(row, shape=f"1 level (1, {q}, {h1}, {w1}) bf16",
                       library="F.grid_sample x1 level (f32)"))
    del level

    # B: the flow-token encoder (81 -> 64) and convc1's window half (81 ->
    # 256), each once a refinement
    sd = load_npz(FIXTURE_FF)
    w0 = sd["memory_decoder.flow_token_encoder_0.weight"].reshape(64, 81)
    b0 = sd["memory_decoder.flow_token_encoder_0.bias"]
    wc = sd["memory_decoder.update_block.encoder.convc1.weight"].reshape(256, 145)[:, 64:]
    bc = sd["memory_decoder.update_block.encoder.convc1.bias"]
    for n_, w_, b_ in ((64, w0, b0), (256, wc, bc)):
        w_ = w_.to(dev, bf16).contiguous()
        b_ = b_.to(dev, bf16)
        row = _fold_row(torch, window, w_, b_, f"fold 81->{n_}", "mma")
        add("fold", dict(row, shape=f"({q}, 81) @ ({n_}, 81).T bf16",
                         library="F.linear (bf16)"))

    # E: the Twins GSAs at both stages (each tower has an image and a mask
    # branch: the feature towers take both frames, the context towers B =
    # 1), the vertical global layer and the latent self-attention (one each
    # an encoder layer), the perceiver's input layer, the decoder's
    # cross-attend (one a refinement); then one tiled shape in f32
    for b, n, m, c, heads, label, design in (
            (2, 28160, 448, 128, 4, "attention twins stage 1", "mma"),
            (1, 28160, 448, 128, 4, "attention twins stage 1, context", "mma"),
            (2, 7040, 448, 256, 8, "attention twins stage 2", "mma"),
            (1, 7040, 448, 256, 8, "attention twins stage 2, context", "mma"),
            (8, 7168, 448, 128, 8, "attention vertical global", "mma"),
            (q, 8, 112, 128, 8, "attention input layer", "staged"),
            (q, 8, 8, 128, 8, "attention latent self", "staged"),
            (q, 1, 8, 64, 8, "attention decoder", "staged")):
        add("attention", _attention_row(torch, g, dev, b, n, m, c, heads, label, design))
    add("attention", _attention_row(torch, g, dev, 1, 7040, 448, 256, 8,
                                    "attention twins stage 2, context, f32", "tiled",
                                    torch.float32))

    # F: the Twins LSAs at both stages and batch sizes, the vertical local layer
    for b, hp, wp, c, heads, label in (
            (2, 112, 259, 128, 4, "window twins stage 1"),
            (1, 112, 259, 128, 4, "window twins stage 1, context"),
            (2, 56, 133, 256, 8, "window twins stage 2"),
            (1, 56, 133, 256, 8, "window twins stage 2, context"),
            (8, 56, 133, 128, 8, "window vertical local")):
        add("window_attention", _window_row(torch, g, dev, b, hp, wp, c, heads, label))
    return rows


def _shift_inputs(h: int, w: int, seed: int = 0):
    """White-noise frame, its copy shifted by (3, -2), sparse masks."""
    rng = np.random.RandomState(seed)
    i1 = (rng.rand(1, h, w, 3) * 255).astype(np.float32)
    dx, dy = 3, -2
    i2 = np.roll(np.roll(i1, dy, 1), dx, 2)
    m1 = ((rng.rand(1, h, w, 1) > 0.97) * 255).astype(np.float32)
    m2 = ((rng.rand(1, h, w, 1) > 0.97) * 255).astype(np.float32)
    return (i1, i2, m1, m2), (dx, dy)


_PORT_KERNELS = ("lookup_kernel", "fold_kernel", "fold_mma", "lookup_fold_mma", "lookup_fold_fma",
                 "in_stats<", "normalize<", "local_corr_kernel", "local_corr_mma",
                 "attn_mma", "attn_tiled", "attn_staged", "attn_direct", "window_mma",
                 "window_attn")


def _category(name: str) -> str:
    if any(k in name for k in _PORT_KERNELS):
        return "port kernels (A-F, lookup_fold)"
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return "host<->device copies"
    if "fprop" in name or "conv" in name.lower():
        return "convolutions (cuDNN)"
    if "gemm" in name or "cutlass" in name or "nvjet" in name:
        return "matmuls (cuBLAS, cuDNN gemm)"
    if "layer_norm" in name:
        return "layer norm"
    if "copy" in name.lower():
        return "copies and casts (contiguous, dtype, cat)"
    return "elementwise, softmax, reductions"


def _device_breakdown(torch, prof, wall_ms: float) -> dict:
    """Device time of one profiled forward by kernel category, the top
    kernels, and the share of the call's wall time the device was idle
    (the union of kernel intervals against the host-clock window)."""
    from torch.autograd import DeviceType

    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.name.startswith("Activity Buffer")]
    by_cat, by_name, port = {}, {}, {}
    spans = []
    for e in kern:
        us = e.time_range.end - e.time_range.start
        by_cat[_category(e.name)] = by_cat.get(_category(e.name), 0.0) + us
        by_name[e.name[:90]] = by_name.get(e.name[:90], 0.0) + us
        spans.append((e.time_range.start, e.time_range.end))
        for k in sorted(_PORT_KERNELS, key=len, reverse=True):  # the longest that matches
            if k in e.name:
                n, t = port.get(k, (0, 0.0))
                port[k] = (n + 1, t + us)
                break
    busy, end = 0.0, -float("inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return dict(
        kernel_count=len(kern),
        device_busy_ms=busy / 1e3, wall_ms=wall_ms,
        idle_share=max(0.0, 1.0 - busy / 1e3 / wall_ms),
        ms_by_category={k: v / 1e3 for k, v in
                        sorted(by_cat.items(), key=lambda kv: -kv[1])},
        top_kernels_ms=[[k, v / 1e3] for k, v in
                        sorted(by_name.items(), key=lambda kv: -kv[1])[:12]],
        # the port's kernels in this forward: launches, total and mean ms
        port_kernels=[[k, n, t / 1e3, t / 1e3 / n] for k, (n, t) in
                      sorted(port.items(), key=lambda kv: -kv[1][1])])


def _drive(torch, p, inputs, want: dict, profile_name: str):
    """Warm up, then one forward of the path with every launch count set
    to 0 just before and read just after (it must equal `want`), then ten
    timed calls and one profiled call. Returns (flow (H, W, 2) of the
    counted forward, (counts, the same launches split by shape key), median
    ms, all ms, device breakdown)."""
    from torch.profiler import ProfilerActivity, profile

    from focusflow_official_tpu_torch.kernels import (
        launch_counts, launch_shapes, reset_launch_counts)

    p(*inputs)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    reset_launch_counts()
    flow = p(*inputs)[0]  # one forward of the path
    counts, shapes = dict(launch_counts), dict(launch_shapes)
    want = {name: want.get(name, 0) for name in counts}
    if counts != want:
        raise AssertionError(f"{profile_name}: launches per forward {counts} != {want}")

    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p(*inputs)  # returns numpy: ends in a device sync
        times.append((time.perf_counter() - t0) * 1e3)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p(*inputs)
        profiled_ms = (time.perf_counter() - t0) * 1e3
    breakdown = _device_breakdown(torch, prof, profiled_ms)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"{profile_name}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=60))
    return flow, (counts, shapes), float(np.median(times)), times, breakdown


def _cpu_flow(cfg, fixture: str, inputs):
    """The port's f32 run on the CPU on the same inputs -> (flow (H, W, 2),
    seconds)."""
    import torch

    from focusflow_official_tpu_torch.predict import FlowPredictor

    p = FlowPredictor(cfg, fixture, device="cpu", dtype=torch.float32)
    t0 = time.perf_counter()
    flow = p(*inputs)[0]
    return flow, time.perf_counter() - t0


def _gates(flow, shift, cpu) -> dict:
    """Finite flow of the input's size, interior EPE < 6 px on the known
    shift (skipped where `shift` is None: a fixture that does not solve
    the probe), and agreement with the f32 CPU run `cpu` (`_cpu_flow`) on
    the same inputs."""
    if flow.shape != (H, W, 2) or not np.isfinite(flow).all():
        raise AssertionError(f"flow {flow.shape} not finite or not ({H}, {W}, 2)")
    epe = None
    if shift is not None:
        epe = float(np.sqrt(((flow[8:-8, 8:-8] - np.array(shift)) ** 2)
                            .sum(-1)).mean())
        if not epe < 6.0:
            raise AssertionError(f"interior EPE {epe} >= 6 px")
    flow_cpu, cpu_s = cpu
    diff = np.abs(flow - flow_cpu)
    mag = float(np.abs(flow_cpu).mean())
    if not (float(diff.mean()) < 0.05 * max(mag, 1.0)
            and float(np.median(diff)) < 0.1):
        raise AssertionError(f"card vs f32 CPU: mean {diff.mean()}, "
                             f"median {np.median(diff)}, |flow| {mag}")
    return dict(epe_interior=epe, mean_abs_flow=float(np.abs(flow).mean()),
                vs_cpu_f32_mean_abs=float(diff.mean()),
                vs_cpu_f32_median_abs=float(np.median(diff)),
                vs_cpu_f32_max_abs=float(diff.max()), cpu_f32_mean_abs_flow=mag,
                cpu_f32_seconds=cpu_s)


def _raft_cfg():
    from focusflow_official_tpu_torch.models import FFRaftConfig

    return FFRaftConfig(fusion="parallel", fusion_type="1x1conv", fuse_cnet=True, iters=ITERS)


def end_to_end_phase(torch, card: str):
    """-> (launch counts of the counted forward, its profile, the f32 CPU
    run on the phase's inputs)."""
    from focusflow_official_tpu_torch.predict import FlowPredictor

    cfg = _raft_cfg()
    inputs, shift = _shift_inputs(H, W)
    p = FlowPredictor(cfg, FIXTURE, device="cuda", dtype=torch.bfloat16)
    want = {"lookup_fold": ITERS, "in_stats": 30, "in_normalize": 30}
    flow, counts, ms, times, breakdown = _drive(torch, p, inputs, want,
                                                "chip_smoke_profile")
    # C1 and C2 are one kernel a call: 30 each in the profiled forward
    for name in ("in_stats<", "normalize<"):
        got = [r_[1] for r_ in breakdown["port_kernels"] if r_[0] == name]
        if got != [30]:
            raise AssertionError(f"profiled forward: {name} launches {got} != [30]")
    # the 12 ResidualBlocks of the fnet (image and mask branch, both frames
    # batched) take their shortcut add and ReLU in C2's residual form
    forms = {}
    for key, n in counts[1].items():
        if key[0] == "in_normalize":
            forms[key[-1]] = forms.get(key[-1], 0) + n
    if forms != {"plain": 18, "residual": 12}:
        raise AssertionError(f"in_normalize forms {forms} != 18 plain, 12 residual")
    cpu = _cpu_flow(cfg, FIXTURE, inputs)
    gates = _gates(flow, shift, cpu)
    _emit(dict(phase="end_to_end", model="ff_raft", card=card, shape=[1, H, W],
               iters=ITERS, dtype="bfloat16", ms_per_pair=ms, pairs_per_s=1e3 / ms,
               ms_all=times, profile=breakdown, launches=counts[0], **gates,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30))
    return counts, breakdown, cpu


def f32_default_flags_phase(torch, card: str, defaults: tuple, cpu) -> None:
    """FF-RAFT in f32 on the card under PyTorch's default TF32 flags
    (`defaults`: matmul, cuDNN, as the process found them), set here and
    put back after: the predictor must run its forward with both off (each
    backend's `fp32_precision` "ieee"), leave them as they were, and track
    the f32 CPU run `cpu` on the same inputs within the agreement bounds."""
    from focusflow_official_tpu_torch.kernels import launch_counts, reset_launch_counts
    from focusflow_official_tpu_torch.predict import FlowPredictor

    flags = lambda: (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    saved = flags()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = defaults
    try:
        inputs, shift = _shift_inputs(H, W)
        p = FlowPredictor(_raft_cfg(), FIXTURE, device="cuda", dtype=torch.float32)
        inside = []
        hook = p.model.register_forward_hook(lambda *_: inside.append(tuple(
            b.fp32_precision for b in (torch.backends.cuda.matmul, torch.backends.cudnn.conv))))
        p(*inputs)  # warm-up
        reset_launch_counts()
        flow = p(*inputs)[0]
        counts = {k: v for k, v in launch_counts.items() if v}
        hook.remove()
        after = flags()
        if inside != [("ieee", "ieee")] * 2 or after != defaults:
            raise AssertionError(f"TF32 flags inside the forward {inside}, after it "
                                 f"{after}, caller's {defaults}")
        want = {"lookup_fold": ITERS, "in_stats": 30, "in_normalize": 30}
        if counts != want:
            raise AssertionError(f"f32 forward: launches {counts} != {want}")
        gates = _gates(flow, shift, cpu)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    _emit(dict(phase="f32_default_flags", model="ff_raft", card=card, shape=[1, H, W],
               iters=ITERS, dtype="float32", caller_flags=dict(zip(("matmul", "cudnn"), defaults)),
               flags_inside_forward=dict(zip(("matmul", "cudnn"), inside[-1])),
               launches=counts, **gates))


def _textured_inputs(h: int, w: int, seed: int = 0):
    """Band-limited noise (three Gaussian blurs of white noise), its copy
    shifted by (3, -2), 3% keypoint masks: the trained FlowFormer gates'
    probe, at this size."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.RandomState(seed)
    base = rng.rand(h, w, 3).astype(np.float32)
    img1 = np.zeros_like(base)
    for sigma, gain in ((1.5, 1.0), (5.0, 2.0), (12.0, 4.0)):
        img1 += gain * gaussian_filter(base, (sigma, sigma, 0), mode="mirror")
    img1 -= img1.min()
    img1 *= 255.0 / max(img1.max(), 1e-6)
    dx, dy = 3, -2
    img2 = np.roll(np.roll(img1, dy, 0), dx, 1)
    m1 = ((rng.rand(h, w, 1) > 0.97) * 255).astype(np.float32)
    m2 = ((rng.rand(h, w, 1) > 0.97) * 255).astype(np.float32)
    return (img1[None], img2[None], m1[None], m2[None]), (dx, dy)


def _ff_launches(encoder_depth: int, iters: int) -> dict:
    """Launches of one FF-FlowFormer forward: E in the 8 Twins GSAs (two
    stages of the context's and the features' image and mask towers), the
    perceiver's input layer, each latent self-attention and vertical global
    layer and each decoder step; F in the 8 Twins LSAs and each vertical
    local layer; A once and B twice a decoder step."""
    return {"attention": 8 + 1 + 2 * encoder_depth + iters,
            "window_attention": 8 + encoder_depth,
            "lookup": iters, "fold": 2 * iters}


def ff_end_to_end_phase(torch, card: str):
    from focusflow_official_tpu_torch.models import FlowFormerConfig
    from focusflow_official_tpu_torch.predict import FlowPredictor

    cfg = FlowFormerConfig(encoder_depth=1, decoder_depth=ITERS)
    inputs, shift = _textured_inputs(H, W)
    p = FlowPredictor(cfg, FIXTURE_FF, device="cuda", dtype=torch.bfloat16)
    flow, counts, ms, times, breakdown = _drive(
        torch, p, inputs, _ff_launches(1, ITERS), "chip_smoke_profile_ff")
    gates = _gates(flow, shift, _cpu_flow(cfg, FIXTURE_FF, inputs))
    _emit(dict(phase="end_to_end", model="ff_flowformer", card=card,
               shape=[1, H, W], encoder_depth=1, iters=ITERS, dtype="bfloat16",
               ms_per_pair=ms, pairs_per_s=1e3 / ms, ms_all=times,
               profile=breakdown, launches=counts[0], **gates,
               cpu_f32_size="full frame",
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30))
    return counts


def pwc_end_to_end_phase(torch, card: str):
    """FF-PWCNet: 1024x436 padded to 1024x440, resized to 1024x448 inside,
    raw 0-255 inputs, one launch of D at each of the five decoder levels."""
    from focusflow_official_tpu_torch.models import FFPWCNetConfig
    from focusflow_official_tpu_torch.predict import FlowPredictor

    cfg = FFPWCNetConfig(fusion="parallel", fusion_type="1x1conv")
    inputs, _ = _textured_inputs(H, W)
    p = FlowPredictor(cfg, FIXTURE_PWC, device="cuda", dtype=torch.bfloat16)
    flow, counts, ms, times, breakdown = _drive(
        torch, p, inputs, {"local_corr": 5}, "chip_smoke_profile_pwc")
    gates = _gates(flow, None, _cpu_flow(cfg, FIXTURE_PWC, inputs))
    # every launch of D is the fused form: no leaky ReLU runs on the volume
    forms = {}
    for key, n in counts[1].items():
        if key[0] == "local_corr":
            forms[key[-1]] = forms.get(key[-1], 0) + n
    if forms != {"leaky_relu": 5}:
        raise AssertionError(f"local_corr forms {forms} != 5 leaky_relu")
    d_prof = [r_ for r_ in breakdown["port_kernels"] if r_[0].startswith("local_corr")]
    if sum(r_[1] for r_ in d_prof) != 5:
        raise AssertionError(f"profiled forward: local_corr launches {d_prof} != 5")
    limit = 0.05 * max(gates["cpu_f32_mean_abs_flow"], 1.0)
    _emit(dict(phase="end_to_end", model="ff_pwcnet", card=card, shape=[1, H, W],
               dtype="bfloat16", ms_per_pair=ms, pairs_per_s=1e3 / ms,
               kernel_count=breakdown["kernel_count"],
               local_corr_in_profile=dict(launches=sum(r_[1] for r_ in d_prof),
                                          total_ms=sum(r_[2] for r_ in d_prof)),
               agreement_margin=dict(mean_abs=gates["vs_cpu_f32_mean_abs"], limit=limit,
                                     share=gates["vs_cpu_f32_mean_abs"] / limit),
               ms_all=times, profile=breakdown, launches=counts[0], **gates,
               cpu_f32_size="full frame",
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30))
    return counts


def _random_ff_weights(torch, path: str, encoder_depth: int, seed: int = 0) -> None:
    """Flat flax-named weights of the fixture's shapes, with the latent
    layers repeated to `encoder_depth`, drawn from a seeded
    torch.Generator: kernels ~ N(0, 1/fan_in), LayerNorm scales
    ~ 1 + N(0, 0.1), every other leaf ~ N(0, 0.1). Saved as .npz."""
    g = torch.Generator().manual_seed(seed)
    shapes = {}
    with np.load(FIXTURE_FF) as raw:
        for k in raw.files:
            if "encoder_layers_0/" in k:  # latent and vertical layers
                for i in range(encoder_depth):
                    shapes[k.replace("encoder_layers_0/", f"encoder_layers_{i}/")] = (
                        raw[k].shape)
            else:
                shapes[k] = raw[k].shape
    flat = {}
    for k in sorted(shapes):
        shape, leaf = shapes[k], k.rsplit("/", 1)[1]
        t = torch.randn(shape, generator=g)
        if leaf == "kernel":
            t = t / float(np.sqrt(np.prod(shape[:-1])))
        elif leaf == "scale":
            t = 1 + 0.1 * t
        else:
            t = 0.1 * t
        flat[k] = t.numpy()
    np.savez(path, **flat)


def ff_shipped_depth_phase(torch, card: str):
    """The shipped encoder_depth 3 on seeded random weights: timing only."""
    from focusflow_official_tpu_torch.models import FlowFormerConfig
    from focusflow_official_tpu_torch.predict import FlowPredictor

    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "ff_random_depth3.npz")
    _random_ff_weights(torch, path, 3)
    inputs, _ = _textured_inputs(H, W)
    p = FlowPredictor(FlowFormerConfig(encoder_depth=3, decoder_depth=ITERS), path,
                      device="cuda", dtype=torch.bfloat16)
    flow, counts, ms, times, breakdown = _drive(
        torch, p, inputs, _ff_launches(3, ITERS), "chip_smoke_profile_ff_depth3")
    if flow.shape != (H, W, 2) or not np.isfinite(flow).all():
        raise AssertionError(f"depth-3 flow {flow.shape} not finite")
    _emit(dict(phase="shipped_depth", model="ff_flowformer", card=card,
               shape=[1, H, W], encoder_depth=3, iters=ITERS, dtype="bfloat16",
               weights="seeded torch.Generator", ms_per_pair=ms,
               pairs_per_s=1e3 / ms, ms_all=times, profile=breakdown,
               launches=counts[0], mean_abs_flow=float(np.abs(flow).mean())))
    return counts


def _worst(rows: list) -> dict:
    """The max_abs_err and tol of the shape whose error is the largest
    share of its own tolerance (a tolerance of 0: bit-equal, share 0)."""
    r = max(rows, key=lambda r_: r_["max_abs_err"] / r_["tol"] if r_["tol"] else 0.0)
    return dict(max_abs_err=r["max_abs_err"], tol=r["tol"])


def _kernel_table(raft: list, ff_rows: dict, pwc_rows: list, drives: dict,
                  card: str) -> list:
    """One entry per kernel: the headline shape's times (the FF-RAFT shape
    for A-C2 and the fused lookup + convc1, the first FlowFormer shape for
    E and F, PWC level 2 for D), for E and B the entry that shape ran
    (`design`), the error and tolerance of its worst shape, and every shape
    held under `per_shape` with its own tolerance. `drives` is path ->
    (launch counts, launches by shape key) of that path's counted forward.
    A kernel's `launches` are summed over the three paths
    (`launches_by_path`); a shape's are read from the same forwards by the
    key its wrapper counted it under in the kernel phase, with launches x
    (ms - bound_ms). Every shape a path launched must be held here."""
    table = []
    for kr in raft:
        if "per_shape" not in kr:
            head = {k: kr[k] for k in ("shape", "key", "design", "plan", "max_abs_err", "tol", "ms",
                                       "plain_ms", "bound_ms", "bound_by", "library_ms")
                    if k in kr}
            kr["per_shape"] = [dict(head, path="ff_raft")]
            if "f32" in kr:
                kr["per_shape"].append(dict(kr.pop("f32"), path="ff_raft"))
            kr["per_shape"] += [dict(r, path="ff_flowformer")
                                for r in ff_rows.get(kr["name"], [])]
            kr.update(_worst(kr["per_shape"]))
        kr.pop("key", None)
        table.append(kr)
    for name, src, replaces, lib in (
            ("attention", "attention.cu", "focusflow_official_tpu/kernels/attention.py:51",
             "F.scaled_dot_product_attention on (B, heads, N, d) views"),
            ("window_attention", "window_attention.cu",
             "focusflow_official_tpu/kernels/window_attention.py:56",
             "F.scaled_dot_product_attention on (B*nwin, heads, 49, d), "
             "partition outside the timed window")):
        rows = ff_rows[name]
        top = rows[0]
        table.append(dict(
            name=name, route="cuda", source=f"focusflow_official_tpu_torch/kernels/csrc/{src}",
            replaces=replaces, **_worst(rows), ms=top["ms"], plain_ms=top["plain_ms"],
            bound_ms=top["bound_ms"], bound_by=top["bound_by"],
            bound_term=top["bound_term"], library_ms=top["library_ms"], library=lib,
            shape=top["shape"], per_shape=[dict(r, path="ff_flowformer") for r in rows]))
        if "design" in top:
            table[-1]["design"] = top["design"]
    top = pwc_rows[-1]  # level 2, the largest, in the fused form the path runs
    table.append(dict(
        name="local_corr", route="cuda",
        source="focusflow_official_tpu_torch/kernels/csrc/local_corr.cu",
        replaces="focusflow_official_tpu/ops/pallas_local_corr.py:46", **_worst(pwc_rows),
        ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
        bound_by=top["bound_by"], library_ms=None, library=top["library"],
        design=top["design"], two_step_ms=top["two_step_ms"],
        shape=top["shape"], per_shape=[dict(r, path="ff_pwcnet") for r in pwc_rows]))
    paths = ("ff_raft", "ff_flowformer", "ff_pwcnet")  # `launches` sums these
    held = set()
    for kr in table:
        by_path = {path: drives[path][0].get(kr["name"], 0) for path in paths}
        kr["launches"] = sum(by_path.values())
        kr["launches_by_path"] = by_path
        kr["card"] = card
        for row in kr["per_shape"]:
            held.add(row["key"])
            by_path = {path: shapes.get(row["key"], 0)
                       for path, (_, shapes) in drives.items()}
            row["launches_by_path"] = by_path
            row["launches"] = sum(by_path[path] for path in paths)
            row["launches_x_ms_over_bound"] = row["launches"] * (row["ms"] - row["bound_ms"])
        if sum(row["launches"] for row in kr["per_shape"]) != kr["launches"]:
            raise AssertionError(f"{kr['name']}: launches by shape do not add up to "
                                 f"{kr['launches']}")
    for path, (_, shapes) in drives.items():
        if set(shapes) - held:
            raise AssertionError(f"{path} launched shapes that no kernel row holds: "
                                 f"{sorted(set(shapes) - held)}")
    return table


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from focusflow_official_tpu_torch.kernels import _build

    # PyTorch's defaults, for the f32 phase under them; then full f32 for
    # the f32 comparisons: no TF32 in matmuls or convolutions
    defaults = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = _card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    _emit(dict(torch=torch.__version__, cuda=torch.version.cuda, kind=kind,
               count=torch.cuda.device_count()))

    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    # each kernel's registers and shared memory, and any spill that is not zero
    regs = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln
                or ("spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln)]
            for n, log in logs.items()}
    _emit(dict(phase="build", seconds=build_s, ptxas=regs))

    dev = torch.device("cuda", 0)
    raft_kernels = kernel_phase(torch, dev)
    ff_rows = ff_kernel_phase(torch, dev)
    pwc_rows = pwc_kernel_phase(torch, dev)
    torch.cuda.empty_cache()
    raft_counts, raft_profile, raft_cpu = end_to_end_phase(torch, card)
    f32_default_flags_phase(torch, card, defaults, raft_cpu)
    drives = {"ff_raft": raft_counts,
              "ff_flowformer": ff_end_to_end_phase(torch, card),
              "ff_flowformer_depth3": ff_shipped_depth_phase(torch, card),
              "ff_pwcnet": pwc_end_to_end_phase(torch, card)}
    kernels = _kernel_table(raft_kernels, ff_rows, pwc_rows, drives, card)
    # the fused kernel inside the profiled FF-RAFT forward, where its inputs
    # are not the same on every call as in the kernel phase
    (g,) = [kr for kr in kernels if kr["name"] == "lookup_fold"]
    (row,) = [r_ for r_ in raft_profile["port_kernels"] if r_[0] == "lookup_fold_mma"]
    g["in_forward"] = dict(launches=row[1], total_ms=row[2], mean_ms=row[3])
    for kr in kernels:
        if kr["launches"] == 0:
            raise AssertionError(f"{kr['name']}: no launch on any path")

    _emit(dict(phase="total", seconds=time.perf_counter() - t_start))
    _emit({"kernels": kernels})
    _emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Check the PyTorch/CUDA port on one NVIDIA card and time its kernels alone.

    python3 chip_smoke.py

The script does two jobs. It holds each hand-written kernel at the shapes
the port's paths give it against its plain PyTorch version and times it
alone (the rows of `PERF.md` §6's kernel table). And it runs every path of
the port on the card through its gates: the launches a forward or step
makes, agreement with the port's f32 run on the CPU, descent, memory.
Whole-path rates, latencies, busy time and idle shares are the
benchmark's (`BENCHMARK.json`, `benchmark/`); this script measures none.
Any failed check raises and exits non-zero. Needs one card.

The build. Phase 1 prints the card's name and power limit (nvidia-smi)
and builds the CUDA kernels from `focusflow_official_tpu_torch/kernels/csrc/`
(one nvcc per source, in parallel), each kernel's registers and spills.

The kernel rows. Each row holds one kernel at one shape: the largest
|kernel - plain version| against a stated tolerance (bit-equal where the
kernel rounds as the plain version does, one bf16 ulp of the largest
output where it sums in another order, each output under `bf16_bound` for
the attentions' tensor-core entries), the entry and launch plan that ran,
the kernel's median device time over CUDA events (`_time_ms`), the plain
version's, one library yardstick call's (F.grid_sample, F.linear,
torch.var_mean, F.instance_norm, SDPA, F.layer_norm) and the least time
the card could take (bytes over 3.35 TB/s, or operations over the type's
peak; the attentions' exponentials on 16 special-function lanes a clock an
SM). A training row adds its Function's gradients against autograd through
the plain version and the backward's time beside autograd's. Rows come
from phase 2 (A, B, G, C1, C2 at FF-RAFT's shapes; A, B, E, F at
FF-FlowFormer's; D at FF-PWCNet's five levels, both forms; the LayerNorm
kernel, whose row also counts the 99 launches of one served 4-pair
FF-FlowFormer forward; the chunk pyramid kernel P at ALT_CORR's f32
chairs walk; the chunk-levels kernel at its bf16 4K walk) and from the `*_rows` of phases 9
to 17 at their paths' own shapes. Each wrapper counts a launch under its
kernel's name and under a key of the call's shape; a row notes the key it
held (`_launch_key`), and a path that launches a shape no row holds has it
held once, untimed (`_hold_shape`), or fails where it feeds the table.

The last lines are a `{"kernels": [...]}` line (phase 7: each kernel's
rows with their launches read from the counted forwards and steps of the
paths by that key, and launches x (ms - bound)), `{"phase": "total"}` and
`{"ok": true, "device": {...}}`.

Gates by phase (1024x436 frames, B=1, bf16, 12 refinements unless said;
"the f32 CPU run" is the port's own f32 forward on the same inputs and
weights, held to mean |diff| < 0.05 max(mean |flow|, 1) px and median <
0.1 px; "the shift" is interior EPE < 6 px on a known (3, -2) px shift):

3. FF-RAFT through `FlowPredictor` on the trained fixture: finite flow,
   the shift, the f32 CPU run; launches G 12, C1 30, C2 30 (18 plain, 12
   residual), A and B 0. Then an f32 predictor under PyTorch's default
   TF32 flags: TF32 off inside its forward, the flags as they were after
   it, the same launches and gates.
4. FF-FlowFormer on `trained_smoke_ff.npz` (encoder depth 1): finite, the
   shift, the f32 CPU run; A 12, B 24, E 23, F 9, LayerNorm 83.
5. FF-FlowFormer at the shipped encoder depth 3 on seeded weights, one
   counted forward at the end of phase 4: finite flow, E 27, F 11.
6. FF-PWCNet on `trained_smoke_pwc.npz` (1024x448 inside): finite, the f32
   CPU run; D 5, all in the leaky-ReLU form.
8. The evaluation protocol (`train/evaluate.py`) on in-memory chairs,
   Sintel (clean and final) and KITTI layouts: finite metrics beside the
   zero-flow baseline's, each family's kernels launched; each FF-RAFT
   layout's first pair and the warm-started second Sintel pair against the
   f32 CPU run (and AEPE, keypoint EPE within 0.05 max(AEPE, 1) px); the
   warm and cold sequences finite; the KITTI submission read back within
   1/64 px (or the codec's ImportError without cv2).
9. FF-RAFT training through `cli/train.py::train` on
   `ffraft_chairs_orb.yaml` (B=10, 368x496, noise, AdamW + OneCycle, bf16)
   from the fixture, 16 steps on one fixed batch: finite loss and gradient
   norm every step; every step G 12, A 12, C1 30, C2 30 (12 residual);
   descent: the fixed batch's f32 loss after the last step under
   DESCENT_BOUND x the loss before the first (`_fixed_batch_loss`); the
   final validation finite; on two samples without noise the f32 step
   (TF32 off) within 1e-4 of the CPU's in loss and >= 0.9999 in gradient
   cosine, the bf16 step within 2% and >= 0.99 of the f32 step.
10. FF-PWCNet training (`ffpwc_chairs.yaml`, B=8): phase 9's gates, D 5 a
    step in the leaky form, the f32 step under PyTorch's default flags.
11. FF-FlowFormer training (`ff_chairs.yaml`, B=6, depth 3): A 12, B 24,
    E 27, F 11 a step; agreement at the fixture's depth (1, 2
    refinements), descent on JAX's fresh-weight recipe (`_descent_recipe`).
12. The baselines and the fusion ablation: plain RAFT, FF-RAFT with CA, SA
    and concat units and vanilla FlowFormer served (finite, the f32 CPU
    run, the launches and forms a forward), then plain RAFT and vanilla
    FlowFormer trained (B=6) with phase 11's gates.
13. Training at scale. 13a: the on-card augmentation's draws within their
    recipes' ranges and its `apply` against the CPU's on the same draws
    (chairs and a mixed kitti-stage batch), then 16 trainer steps with
    `device_aug` (phase 9's launches, finite losses). 13b: two gloo ranks
    on card 0 (`--ddp-rank`) against one process on the global batch
    (loss 1e-5, gradient cosine 0.99999, each gradient within 1e-4 of its
    largest plus 1e-4 of the model's, the state after AdamW within 1e-4 of
    its largest), then 6 trainer steps over a world-size-1 NCCL group from
    torchrun's variables (phase 9's launches, finite losses).
14. The FF-RAFT variants served: ALT_CORR at 1024x436 (the shift, the f32
    CPU run, the materialized bf16 flow; G and the chunk-levels kernel 12 a
    chunk), at 1920x1080
    against the materialized flow and at 3840x2160 (the shift, peak
    allocated memory under ALT_PEAK_GIB); RAFT-S, FF-RAFT-S and the
    attention and conv front ends against their f32 CPU runs with their
    launches and forms.
15. FF-FlowFormer's variants: MLP-Mixer without GMA, ConvNext with
    only-global and patch size 4 served (the f32 CPU run, launches, B's
    widths); MLP-Mixer with ConvNext and patch size 4 trained 6 steps
    (launches, the f32 step against the CPU's); group attention and the
    position encodings against the f32 CPU run.
16. Every FF-RAFT variant trained: ALT_CORR 16 steps (phase 9's descent
    gate, the chunk-levels kernel 4 x 12 a bf16 step, its f32 step against
    the materialized one with P alone on its chunks, its step's peak
    memory no higher than the materialized one's at B=10 and lower by the
    f32 level-0 volume at 1920x1080), RAFT-S, FF-RAFT-S, the front ends
    (the attention front end at ATTENTION_BATCH under FIT_SHARE of the
    card, the conv front end also under FREEZE_BN) and dropout (the kept
    share within 4 sigma of 1 - p), each with its launches and agreement
    steps.
17. FF-RAFT served with the volume's queries sharded over two gloo ranks
    on card 0 (`--shard-rank`): each rank against the f32 CPU run and the
    one process's flow, G at its 3520 queries, its one volume product; at
    1920x1080 each rank's peak allocated memory under the one process's by
    half the f32 level-0 volume.

Outside the phase under default flags, f32 matmuls and convolutions run in
full f32 here (TF32 off), so the f32 comparisons are not blurred by TF32.
"""

from __future__ import annotations

import dataclasses
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


def _local_corr_row(torch, g, dev, shape, dtype, label: str, slope=None,
                    backward: bool = False) -> dict:
    """Kernel D on random (B, H, W, C) maps against its plain version, with
    the launch plan it ran. With a slope, the fused form (leaky ReLU in the
    epilogue), which must also equal the plain-form kernel then
    F.leaky_relu (two launches, `two_step_ms`) to the bit. No single PyTorch
    call computes this function, so there is no yardstick. With `backward`,
    the Function's gradients against autograd through the plain version
    (`_backward_check`), timed, with the backward's bound: the maps, the
    cotangent (and the fused form's output) read once, both gradients
    written once, two products a shift and channel."""
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
    es = f1.element_size()
    extra = {}
    if slope is not None:
        two_step = lambda: F.leaky_relu(klc.local_corr(f1, f2, r), slope)
        if not torch.equal(got, two_step()):
            raise AssertionError(f"{label}: not bit-equal to the plain-form kernel then "
                                 "F.leaky_relu")
        extra = dict(vs_two_step="bit-equal", two_step_ms=_time_ms(torch, two_step))
    ms = _time_ms(torch, call)
    plain_ms = _time_ms(torch, lambda: klc.local_corr_plain(f1, f2, r, slope), reps=10)
    bound, by = _bound_ms((2 * f1.numel() + got.numel()) * es, 2.0 * got.numel() * shape[3],
                          PEAK_F32 if dtype == torch.float32 else PEAK_BF16)
    if backward:
        cot = torch.randn(got.shape, generator=g, device=dev).to(dtype)
        saved = None if slope is None else got
        extra.update(_backward_check(
            torch, lambda a, b: klc.local_corr(a, b, r, negative_slope=slope),
            lambda a, b: klc.local_corr_plain(a, b, r, slope), [f1, f2], cot,
            lambda: klc.local_corr_vjp(f1, f2, r, cot, saved, slope), label))
        extra.update(_backward_bound(
            (4 * f1.numel() + (2 if slope is not None else 1) * got.numel()) * es,
            4.0 * got.numel() * shape[3], dtype),
            library_backward_ms=None, library_backward="none: no PyTorch call computes it")
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


def _grad_tol(want) -> float:
    """One bf16 ulp of the largest |value| (2^-7 of it) for a bf16 gradient,
    1e-5 of it in f32."""
    return (2.0 ** -7 if str(want.dtype) == "torch.bfloat16" else 1e-5) * float(
        want.float().abs().max())


def _backward_check(torch, fn, plain, inputs, g, vjp, label: str) -> dict:
    """The Function `fn(*inputs)`'s gradients for the cotangent `g` against
    autograd through `plain(*inputs)` on the same inputs, each within
    `_grad_tol` of the plain gradient, and the device time of the backward
    alone (`vjp()`, what the Function's backward runs) beside autograd's
    through the plain version."""
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    got = torch.autograd.grad(fn(*leaves), leaves, g)
    ref = [t.detach().requires_grad_(True) for t in inputs]
    out = plain(*ref)
    want = torch.autograd.grad(out, ref, g, retain_graph=True)
    errs, tols = [], []
    for a, b in zip(got, want):
        if a.dtype != b.dtype or a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"{label}: gradient {a.dtype} {tuple(a.shape)} against "
                                 f"{b.dtype} {tuple(b.shape)}, or not finite")
        errs.append(float((a.float() - b.float()).abs().max()))
        tols.append(_grad_tol(b))
        _check(f"{label} gradient", errs[-1], tols[-1])
    return dict(grad_max_abs_err=errs, grad_tol=tols, backward_ms=_time_ms(torch, vjp, reps=10),
                plain_backward_ms=_time_ms(
                    torch, lambda: torch.autograd.grad(out, ref, g, retain_graph=True), reps=10))


def _backward_bound(nbytes: float, flops: float, dtype) -> dict:
    """A backward's bound: its inputs read once and its gradients written
    once, over the memory rate, or its operations over the inputs' type's
    peak (bf16: the tensor cores), whichever is longer."""
    bound, by = _bound_ms(nbytes, flops, PEAK_F32 if str(dtype) == "torch.float32"
                          else PEAK_BF16)
    return dict(backward_bound_ms=bound, backward_bound_by=by)


def _instance_norm_backward(torch, g, dev, x, r, label: str) -> dict:
    """The instance norm Function's gradients (C1 then C2 with ReLU, and
    `r` the residual or None) against autograd through the plain version in
    f32 from the same bf16 inputs, within `_grad_tol`; the ReLU of the
    residual form masks where the forward's own output is > 0 (the plain
    form's bf16 output, to which the kernel is bit-equal), and the
    residual's gradient must be that masked cotangent to the bit. The
    plain version in bf16 is not the yardstick: its ReLU masks where the
    rounded (x - mean) * inv > 0, which drops gradients the f32 VJP keeps.
    Times the backward alone (`instance_norm_vjp`) and autograd's through
    the bf16 plain version."""
    from focusflow_official_tpu_torch.kernels import instance_norm as kin

    cot = torch.randn(x.shape, generator=g, device=dev).to(x.dtype)
    leaves = [x.detach().requires_grad_(True)] + ([] if r is None else [r.detach().requires_grad_(True)])
    y = kin.instance_norm(*leaves[:1], 1e-5, True, *leaves[1:])
    got = torch.autograd.grad(y, leaves, cot)
    g_in = cot if r is None else torch.where(y.detach() > 0, cot, torch.zeros_like(cot))
    if r is not None and not torch.equal(got[1], g_in):
        raise AssertionError(f"{label}: the residual's gradient is not the masked cotangent")
    x32 = x.detach().float().requires_grad_(True)
    (want,) = torch.autograd.grad(kin.apply_plain(x32, *kin.stats_plain(x32), True), x32,
                                  g_in.float())
    err, tol = float((got[0].float() - want).abs().max()), _grad_tol(want.to(x.dtype))
    _check(f"{label} gradient", err, tol)
    ref = [t.detach().requires_grad_(True) for t in leaves]
    out = kin.apply_plain(ref[0], *kin.stats_plain(ref[0]), True, *ref[1:])
    return dict(grad_max_abs_err=err, grad_tol=tol,
                backward_ms=_time_ms(torch, lambda: kin.instance_norm_vjp(
                    x, torch.where(y > 0, cot, 0.0) if r is not None else cot, 1e-5, True),
                    reps=10),
                plain_backward_ms=_time_ms(
                    torch, lambda: torch.autograd.grad(out, ref, cot, retain_graph=True),
                    reps=10))


def _instance_norm_rows(torch, g, dev, shapes, backward: bool = False) -> dict:
    """C1 and C2 (both forms, ReLU) at NHWC `shapes` in bf16, each against
    its plain version and timed -> {"in_stats": rows, "in_normalize": rows}.
    With `backward`, each row also holds its Function's gradients against
    autograd through the plain version (`_backward_check`) and times the
    backward."""
    import torch.nn.functional as F

    from focusflow_official_tpu_torch.kernels import instance_norm as kin

    bf16 = torch.bfloat16
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
        if backward:
            gm = torch.randn(rmean.shape, generator=g, device=dev)
            gi = torch.randn(rinv.shape, generator=g, device=dev)
            per_shape["in_stats"][-1].update(_backward_check(
                torch, kin.instance_norm_stats, kin.stats_plain, [x], (gm, gi),
                lambda: kin.stats_vjp(x, mean, inv, gm, gi), f"in_stats {shp}"))
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
            if backward:
                row.update(_instance_norm_backward(torch, g, dev, x, r, f"in_normalize {shp} {form}"))
            per_shape["in_normalize"].append(row)
            del y, ry
        del x, res, plain_y, xn, rn
    return per_shape


def kernel_phase(torch, dev):
    """A, B, the fused lookup + convc1, C1 and C2 at the FF-RAFT shapes ->
    one result per kernel."""
    import torch.nn.functional as F

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
    per_shape = _instance_norm_rows(torch, g, dev, shapes)
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
                   dtype=None, backward: bool = False) -> dict:
    """Kernel E on random q (B, N, C), k, v (B, M, C) (bf16 unless `dtype`)
    against its plain version, timed beside F.scaled_dot_product_attention
    on (B, heads, N, d) views of the same tensors. `design` is the entry
    these inputs must run: `mma` (tensor cores), `staged` (N < 64: each
    entry's keys staged once) or `tiled` (f32 FMA). With `backward`, the
    Function's gradients against autograd through the plain version
    (`_backward_check`), timed beside autograd through
    F.scaled_dot_product_attention, with the backward's bound: q, k, v and
    the cotangent read once, three gradients written once, five products
    and one exponential a score. A bf16 row of any entry is held at every
    output to `bf16_bound` too."""
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
        if dtype == torch.bfloat16:
            over = float((diff / ka.bf16_bound(want, q, k, v, heads, scale)).max())
            if not over <= 1.0:
                raise AssertionError(f"{label}: |kernel - plain| is {over} of bf16_bound "
                                     "at some output")
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
    peak = PEAK_F32 if dtype == torch.float32 else PEAK_BF16
    extra = {}
    if backward:
        cot = torch.randn(got.shape, generator=g, device=dev).to(dtype)
        extra = _backward_check(
            torch, lambda *t: ka.small_kv_attention(*t, heads, scale),
            lambda *t: ka.small_kv_attention_plain(*t, heads, scale), [q, k, v], cot,
            lambda: ka.attention_vjp(q, k, v, heads, scale, cot), label)
        bound = _attention_bound(torch, 2 * nbytes, scores * 5 * 2 * d, scores, peak)
        extra.update(backward_bound_ms=bound["bound_ms"], backward_bound_by=bound["bound_by"],
                     backward_bound_term=bound["bound_term"])
        lq, lk, lv = (t.detach().clone().requires_grad_(True) for t in (qh, kh, vh))
        lo = F.scaled_dot_product_attention(lq, lk, lv, scale=scale)
        go = cot.view(b, n, heads, d).transpose(1, 2)
        extra["library_backward_ms"], extra["library_backward_error"] = _library_ms(
            torch, lambda: torch.autograd.grad(lo, (lq, lk, lv), go, retain_graph=True))
        extra["library_backward"] = "autograd through F.scaled_dot_product_attention"
        del lq, lk, lv, lo
    return dict(shape=f"q ({b}, {n}, {c}) x kv ({b}, {m}, {c}), {heads} heads, "
                      f"{str(dtype).split('.')[1]}", label=label, key=key,
                design=ran, plan=plan, largest_err_over_its_bound=over, max_abs_err=err,
                tol=tol, ms=ms, plain_ms=plain_ms,
                **_attention_bound(torch, nbytes, scores * 2 * 2 * d, scores, peak),
                library_ms=lib_ms, library_error=lib_err, **extra)


def _window_row(torch, g, dev, b, hp, wp, c, heads, label, backward: bool = False) -> dict:
    """Kernel F on random bf16 (B, Hp, Wp, C) q, k, v against its plain
    version, timed beside F.scaled_dot_product_attention on the window-
    partitioned (B*nwin, heads, 49, d) tensors (partitioned before the
    timed window; a second time includes the partition and the merge).
    Every bf16 shape of the path runs the tensor-core entry (`mma`), held
    at every output to `bf16_bound`. With `backward`, the Function's
    gradients against autograd through the plain version
    (`_backward_check`), timed beside autograd through the partition,
    F.scaled_dot_product_attention and the merge, with the backward's
    bound (as E's)."""
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

    def sdpa_merged(q, k, v):
        o = F.scaled_dot_product_attention(part(q), part(k), part(v), scale=scale)
        o = o.view(b, nh, nw, heads, ws, ws, d).permute(0, 1, 4, 2, 5, 3, 6)
        return o.reshape(b, hp, wp, c)

    qw, kw_, vw = part(q), part(k), part(v)
    lib_ms, lib_err = _library_ms(torch, lambda: F.scaled_dot_product_attention(
        qw, kw_, vw, scale=scale))
    lib_full_ms, _ = _library_ms(torch, lambda: sdpa_merged(q, k, v))
    scores = float(b * nh * nw) * heads * (ws * ws) ** 2
    extra = {}
    if backward:
        cot = torch.randn(q.shape, generator=g, device=dev).to(bf16)
        extra = _backward_check(
            torch, lambda *t: kw.window_attention(*t, ws, heads, scale),
            lambda *t: kw.window_attention_plain(*t, ws, heads, scale), [q, k, v], cot,
            lambda: kw.window_attention_vjp(q, k, v, ws, heads, scale, cot), label)
        bound = _attention_bound(torch, 2 * 4 * q.numel() * 2, scores * 5 * 2 * d, scores)
        extra.update(backward_bound_ms=bound["bound_ms"], backward_bound_by=bound["bound_by"],
                     backward_bound_term=bound["bound_term"])
        lq, lk, lv = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        lo = sdpa_merged(lq, lk, lv)
        extra["library_backward_ms"], extra["library_backward_error"] = _library_ms(
            torch, lambda: torch.autograd.grad(lo, (lq, lk, lv), cot, retain_graph=True))
        extra["library_backward"] = ("autograd through the partition, "
                                     "F.scaled_dot_product_attention and the merge")
        del lq, lk, lv, lo
    return dict(shape=f"({b}, {hp}, {wp}, {c}), {heads} heads, bf16", label=label,
                key=key, design=key[-1], largest_err_over_its_bound=over,
                max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                **_attention_bound(torch, 4 * q.numel() * 2, scores * 2 * 2 * d, scores),
                library_ms=lib_ms, library_error=lib_err,
                library_with_partition_ms=lib_full_ms, **extra)


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


# FF-FlowFormer's LayerNorm rows of a 4-pair 1024x436 request: the cost
# patch embed's norm (4 x 7040 queries x 112 patches); Twins stage 1 over
# both frames and the perceiver's latent tokens (28,160 queries x 8); Twins
# stage 2 over both frames; the decoder's query tokens
LN_SHAPES = ((3153920, 128), (225280, 128), (56320, 256), (28160, 64))
LN_BATCH = 4


def layer_norm_phase(torch, dev) -> dict:
    """The LayerNorm kernel (`kernels/layer_norm.py`, which replaces no TPU
    kernel) at `LN_SHAPES` in bf16, with the module's f32 weight and bias:
    against the plain version (one bf16 ulp of the largest output), timed
    beside it and beside `F.layer_norm` on the bf16 rows (the library's
    yardstick, bf16 weight and bias), its bound the bytes (x read, y
    written); the form that also writes the statistics, and the Function's
    backward against autograd through the plain version. Then one served
    forward of a `LN_BATCH`-pair 1024x436 request (the shipped depth 3, 12
    refinements, fresh weights), each LayerNorm call's rows and width
    noted by a forward hook: `_ff_launches`' 99 calls and launches; every distinct
    (rows, C) timed, kernel and plain version, summed over the request's
    calls -> the kernel's entry of the kernel table."""
    import torch.nn.functional as F

    from focusflow_official_tpu_torch.config import model_from_config
    from focusflow_official_tpu_torch.kernels import launch_counts
    from focusflow_official_tpu_torch.kernels import layer_norm as kln
    from focusflow_official_tpu_torch.models import FlowFormerConfig
    from focusflow_official_tpu_torch.nn.twins import LayerNorm
    from focusflow_official_tpu_torch.ops.padding import InputPadder
    from focusflow_official_tpu_torch.predict import eval_forward, for_inference

    bf16, eps = torch.bfloat16, 1e-5
    g = torch.Generator(device=dev).manual_seed(4)

    def inputs(n, c):
        x = (torch.randn((n, c), generator=g, device=dev) * 3 + 1).to(bf16)
        return x, 1 + 0.1 * torch.randn(c, generator=g, device=dev), 0.1 * torch.randn(
            c, generator=g, device=dev)

    def bound(n, c):
        return _bound_ms(2 * n * c * 2 + 2 * c * 4, 8.0 * n * c, PEAK_F32)

    rows = []
    for n, c in LN_SHAPES:
        x, w, b = inputs(n, c)
        y = kln.layer_norm(x, w, b, eps)
        want = kln.layer_norm_plain(x, w, b, eps)
        torch.cuda.synchronize()
        err = float((y.float() - want.float()).abs().max())
        tol = _bf16_ulp(float(want.float().abs().max()))
        _check(f"layer_norm {n}x{c}", err, tol)
        wb, bb = w.to(bf16), b.to(bf16)
        row = dict(shape=[n, c], dtype="bfloat16", design=kln.design(x), max_abs_err=err,
                   tol=tol, ms=_time_ms(torch, lambda: kln.layer_norm(x, w, b, eps)),
                   stats_ms=_time_ms(torch, lambda: kln._rows(x, w, b, eps, stats=True)),
                   plain_ms=_time_ms(torch, lambda: kln.layer_norm_plain(x, w, b, eps)),
                   library_ms=_time_ms(torch, lambda: F.layer_norm(x, (c,), wb, bb, eps)),
                   library="F.layer_norm on the bf16 rows, bf16 weight and bias")
        row["bound_ms"], row["bound_by"] = bound(n, c)
        gy = torch.randn((n, c), generator=g, device=dev).to(bf16)
        _, mean, rstd = kln._rows(x, w, b, eps, stats=True)
        row.update(_backward_check(
            torch, lambda *t: kln.layer_norm(*t, eps), lambda *t: kln.layer_norm_plain(*t, eps),
            [x, w, b], gy, lambda: kln.layer_norm_vjp(gy, x, mean, rstd, w, b),
            f"layer_norm {n}x{c}"))
        rows.append(row)
        _emit(dict(kernel="layer_norm", path="ff_flowformer", **row))
        del x, y, want, gy, mean, rstd
    torch.cuda.empty_cache()

    # one served request: every call's rows and width, and the launches
    torch.manual_seed(0)
    model, iters = model_from_config(FlowFormerConfig(compute_dtype="bfloat16"))
    model = for_inference(model, bf16, dev)
    calls = {}

    def note(_m, args, _out):
        key = (args[0].numel() // args[0].shape[-1], args[0].shape[-1])
        calls[key] = calls.get(key, 0) + 1

    hooks = [m.register_forward_hook(note) for m in model.modules() if isinstance(m, LayerNorm)]
    frames = [torch.rand((LN_BATCH, H, W, 3), generator=g, device=dev) * 255 for _ in range(2)]
    masks = [(torch.rand((LN_BATCH, H, W, 1), generator=g, device=dev) > 0.97).float() * 255
             for _ in range(2)]
    before = launch_counts["layer_norm"]
    eval_forward(model, *InputPadder(frames[0].shape).pad(*frames, *masks), iters=iters)
    launches = launch_counts["layer_norm"] - before
    for h in hooks:
        h.remove()
    del model, frames, masks
    torch.cuda.empty_cache()
    want = _ff_launches(3, ITERS)["layer_norm"]
    if launches != want or sum(calls.values()) != want:
        raise AssertionError(f"layer_norm: {launches} launches, {sum(calls.values())} calls "
                             f"in a served FF-FlowFormer forward, not {want}")
    request = []
    for (n, c), k in sorted(calls.items(), key=lambda kv: -kv[0][0] * kv[0][1]):
        x, w, b = inputs(n, c)
        request.append(dict(shape=[n, c], calls=k, ms=_time_ms(
            torch, lambda: kln.layer_norm(x, w, b, eps)), plain_ms=_time_ms(
            torch, lambda: kln.layer_norm_plain(x, w, b, eps)), bound_ms=bound(n, c)[0]))
        del x
    for row in rows:
        row["launches"] = calls.get(tuple(row["shape"]), 0)
    total = lambda key: sum(r_["calls"] * r_[key] for r_ in request)
    out = dict(
        name="layer_norm", route="cuda",
        source="focusflow_official_tpu_torch/kernels/csrc/layer_norm.cu",
        replaces="no TPU kernel: the port's cast, F.layer_norm in f32 and cast back",
        **_worst(rows), ms=rows[0]["ms"], plain_ms=rows[0]["plain_ms"],
        bound_ms=rows[0]["bound_ms"], bound_by=rows[0]["bound_by"],
        library_ms=rows[0]["library_ms"], library=rows[0]["library"],
        shape=f"{tuple(LN_SHAPES[0])} bf16", design=rows[0]["design"],
        backward_ms=rows[0]["backward_ms"], plain_backward_ms=rows[0]["plain_backward_ms"],
        per_shape=rows, served_request=dict(
            pairs=LN_BATCH, launches=launches, calls_by_shape=request,
            ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms")))
    _emit(dict(phase="layer_norm", **{k: v for k, v in out.items() if k != "per_shape"}))
    return out


def pyramid_phase(torch, dev) -> dict:
    """The chunk pyramid kernel (`kernels/pyramid.py`, which replaces no TPU
    kernel) where the port launches it: ALT_CORR's f32 walk (the bf16 walk
    takes the chunk-levels kernel), at the chairs step's B=TB, TH x TW (a
    46x62 key map) and its chunks of 2048 queries and the tail. The rows
    are the f32 product of the walk's operands (C = 256, TF32 off), four
    levels, every level equal to `corr_pyramid`'s on the same rows to the
    bit (the plain version, timed beside it as `plain_ms`); its bound the
    bytes (the rows read once, levels 1-3 written once). Its launches are
    counted in `_alt_corr_gates`' f32 step."""
    from focusflow_official_tpu_torch.kernels import pyramid as kp
    from focusflow_official_tpu_torch.ops.corr import corr_pyramid

    f32, levels, c = torch.float32, 4, 256
    gh, gw = _grid(TH, TW)
    q = gh * gw
    g = torch.Generator(device=dev).manual_seed(6)
    f1 = torch.randn((TB, q, c), generator=g, device=dev) * c ** -0.5
    f2t = torch.randn((TB, c, q), generator=g, device=dev)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    try:
        for n in _alt_chunks(q):
            x = torch.matmul(f1[:, :n], f2t).reshape(TB, n, gh, gw)
            got, want = kp.pyramid(x, levels, f32), corr_pyramid(x, levels, f32)
            torch.cuda.synchronize()
            if not all(torch.equal(a.view(torch.int32), e.view(torch.int32))
                       for a, e in zip(got, want)):
                raise AssertionError(f"pyramid ({TB}, {n}, {gh}, {gw}) f32: not corr_pyramid's "
                                     "bits")
            del got, want
            cells = sum((gh >> lv) * (gw >> lv) for lv in range(1, levels))
            row = dict(shape=[TB, n, gh, gw], dtype="float32", levels=levels,
                       design=kp.design(x, levels), bit_equal=True,
                       ms=_time_ms(torch, lambda: kp.pyramid(x, levels, f32)),
                       plain_ms=_time_ms(torch, lambda: corr_pyramid(x, levels, f32), reps=5))
            row["bound_ms"], row["bound_by"] = _bound_ms(TB * n * (gh * gw + cells) * 4,
                                                         4.0 * TB * n * cells, PEAK_F32)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            rows.append(row)
            _emit(dict(kernel="pyramid", path="alt_corr_train_f32", **row))
            del x
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    del f1, f2t
    torch.cuda.empty_cache()
    out = dict(
        name="pyramid", route="cuda",
        source="focusflow_official_tpu_torch/kernels/csrc/pyramid.cu",
        replaces="no TPU kernel: corr_pyramid's f32 copy, three avg_pool2x2 and casts",
        max_abs_err=0.0, tol=0.0, ms=rows[0]["ms"], plain_ms=rows[0]["plain_ms"],
        bound_ms=rows[0]["bound_ms"], bound_by=rows[0]["bound_by"],
        shape=f"{tuple(rows[0]['shape'])} f32", design=rows[0]["design"], per_shape=rows)
    _emit(dict(phase="pyramid", **{k: v for k, v in out.items() if k != "per_shape"}))
    return out


def corr_levels_phase(torch, dev) -> dict:
    """The chunk-levels kernel (`kernels/corr_levels.py`, which replaces no
    TPU kernel) at ALT_CORR's 3840x2160 chunk and tail: the walk's bf16
    operands, f1 (1, Q, 256) scaled by 1/16 and the key map (1, 270 x 480,
    256), four levels, each within one bf16 ulp (plus 2^-20 of the level's
    largest: the f32 sums' order) of its plain version, `corr_pyramid` of
    the f32 product (TF32 off), timed beside it as `plain_ms`. The library
    yardstick is the path it replaces: cuBLAS's bf16 product, then the
    pyramid kernel P. The bound: the levels written once, the key map and
    the chunk's queries read once, at 3.35 TB/s (the products at the bf16
    peak take less). The request's sum: 63 chunks and the tail, 12
    refinements each."""
    from focusflow_official_tpu_torch.kernels import corr_levels as kcl
    from focusflow_official_tpu_torch.kernels import pyramid as kp
    from focusflow_official_tpu_torch.ops.corr import corr_pyramid

    bf16, levels, c = torch.bfloat16, 4, 256
    gh, gw = _grid(*FOUR_K)
    q = gh * gw
    g = torch.Generator(device=dev).manual_seed(7)
    f1 = (torch.randn((1, q, c), generator=g, device=dev) * c ** -0.5).to(bf16)
    f2 = torch.randn((1, q, c), generator=g, device=dev).to(bf16)
    f2t = f2.transpose(1, 2)
    cells = sum((gh >> lv) * (gw >> lv) for lv in range(levels))
    rows = []
    for n in _alt_chunks(q):
        s = 0 if n == ALT_CHUNK else q - n  # the tail ends the map's queries

        def plain(s=s, n=n):
            prod = torch.matmul(f1[:, s:s + n].float(), f2t.float())
            return corr_pyramid(prod.reshape(1, n, gh, gw), levels, torch.float32)

        got, want = kcl.corr_levels(f1, f2, s, n, gh, gw, levels), plain()
        torch.cuda.synchronize()
        worst = 0.0  # the largest |kernel - plain| over its bound, any level
        for a, e in zip(got, want):
            ulp = torch.ldexp(torch.ones_like(e), torch.frexp(e)[1] - 8)
            bound = ulp + 2.0 ** -20 * float(e.abs().max())
            worst = max(worst, float(((a.float() - e).abs() / bound).max()))
        del got, want
        _check(f"corr_levels (1, {n}, {gh}, {gw})", worst, 1.0)
        row = dict(shape=[1, n, gh, gw], channels=c, dtype="bfloat16", levels=levels,
                   plan=kcl.plan(1, n, gh, gw, _sms(torch)), worst_over_bound=worst,
                   chunks_a_request=ITERS * (q // n if n == ALT_CHUNK else 1),
                   ms=_time_ms(torch, lambda: kcl.corr_levels(f1, f2, s, n, gh, gw, levels)),
                   plain_ms=_time_ms(torch, plain, reps=5),
                   library_ms=_time_ms(torch, lambda: kp.pyramid(
                       torch.matmul(f1[:, s:s + n], f2t).reshape(1, n, gh, gw), levels, bf16)),
                   library="torch.matmul (cuBLAS, bf16) then the pyramid kernel P")
        row["bound_ms"], row["bound_by"] = _bound_ms(n * cells * 2 + (q + n) * c * 2,
                                                     2.0 * n * q * c, PEAK_BF16)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        _emit(dict(kernel="corr_levels", path="ff_raft_alt_corr_4k", **row))
        torch.cuda.empty_cache()
    del f1, f2, f2t
    total = lambda key: sum(r_["chunks_a_request"] * r_[key] for r_ in rows)
    out = dict(
        name="corr_levels", route="cuda",
        source="focusflow_official_tpu_torch/kernels/csrc/corr_levels.cu",
        replaces="no TPU kernel: cuBLAS's chunk product, then the pyramid kernel P on its "
                 "bf16 rows",
        max_abs_err=max(r_["worst_over_bound"] for r_ in rows), tol=1.0,
        ms=rows[0]["ms"], plain_ms=rows[0]["plain_ms"], library_ms=rows[0]["library_ms"],
        library=rows[0]["library"], bound_ms=rows[0]["bound_ms"],
        bound_by=rows[0]["bound_by"], shape=f"{tuple(rows[0]['shape'])} x {c} bf16",
        per_shape=rows,
        request=dict(launches=sum(r_["chunks_a_request"] for r_ in rows), ms=total("ms"),
                     plain_ms=total("plain_ms"), library_ms=total("library_ms"),
                     bound_ms=total("bound_ms")))
    _emit(dict(phase="corr_levels", **{k: v for k, v in out.items() if k != "per_shape"}))
    return out


def _shift_inputs(h: int, w: int, seed: int = 0):
    """White-noise frame, its copy shifted by (3, -2), sparse masks."""
    rng = np.random.RandomState(seed)
    i1 = (rng.rand(1, h, w, 3) * 255).astype(np.float32)
    dx, dy = 3, -2
    i2 = np.roll(np.roll(i1, dy, 1), dx, 2)
    m1 = ((rng.rand(1, h, w, 1) > 0.97) * 255).astype(np.float32)
    m2 = ((rng.rand(1, h, w, 1) > 0.97) * 255).astype(np.float32)
    return (i1, i2, m1, m2), (dx, dy)


def _drive(torch, p, inputs, want: dict, label: str):
    """Warm up, then one forward of the path with every launch count set
    to 0 just before and read just after (it must equal `want`). Returns
    (flow (H, W, 2), (counts, the same launches split by shape key))."""
    from focusflow_official_tpu_torch.kernels import (
        launch_counts, launch_shapes, reset_launch_counts)

    p(*inputs)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    reset_launch_counts()
    flow = p(*inputs)[0]  # one forward of the path
    counts, shapes = dict(launch_counts), dict(launch_shapes)
    want = {name: want.get(name, 0) for name in counts}
    if counts != want:
        raise AssertionError(f"{label}: launches per forward {counts} != {want}")
    return flow, (counts, shapes)


def _count_forms(shapes: dict, kernel: str) -> dict:
    """Launches of `kernel` by form: the last item of its shape keys."""
    forms = {}
    for key, n in shapes.items():
        if key[0] == kernel:
            forms[key[-1]] = forms.get(key[-1], 0) + n
    return forms


def _cpu_flow(cfg, fixture: str, inputs):
    """The port's f32 run on the CPU on the same inputs -> flow (H, W, 2)."""
    import torch

    from focusflow_official_tpu_torch.predict import FlowPredictor

    return FlowPredictor(cfg, fixture, device="cpu", dtype=torch.float32)(*inputs)[0]


def _gates(flow, shift, cpu, shape=(H, W, 2)) -> dict:
    """Finite flow of the input's size (`shape`), interior EPE < 6 px on the
    known shift (skipped where `shift` is None: a fixture that does not
    solve the probe), and agreement with the f32 CPU run `cpu` (`_cpu_flow`)
    on the same inputs."""
    if flow.shape != tuple(shape) or not np.isfinite(flow).all():
        raise AssertionError(f"flow {flow.shape} not finite or not {tuple(shape)}")
    epe = None
    if shift is not None:
        epe = float(np.sqrt(((flow[8:-8, 8:-8] - np.array(shift)) ** 2)
                            .sum(-1)).mean())
        if not epe < 6.0:
            raise AssertionError(f"interior EPE {epe} >= 6 px")
    agree = _agreement(flow, cpu, "card vs f32 CPU")
    return dict(epe_interior=epe, mean_abs_flow=float(np.abs(flow).mean()),
                **{f"vs_cpu_f32_{k}": v for k, v in agree.items() if k != "ref_mean_abs_flow"},
                cpu_f32_mean_abs_flow=agree["ref_mean_abs_flow"])


def _agreement(flow, ref, label: str) -> dict:
    """Phase 3's agreement bounds of `flow` with `ref`: the mean |diff| under
    0.05 max(mean |ref|, 1) px and the median under 0.1 px; `margin` is the
    mean over its limit."""
    diff = np.abs(flow - ref)
    mag = float(np.abs(ref).mean())
    limit = 0.05 * max(mag, 1.0)
    if not (float(diff.mean()) < limit and float(np.median(diff)) < 0.1):
        raise AssertionError(f"{label}: mean {diff.mean()}, median {np.median(diff)}, "
                             f"|flow| {mag}")
    return dict(mean_abs=float(diff.mean()), median_abs=float(np.median(diff)),
                max_abs=float(diff.max()), margin=float(diff.mean()) / limit,
                ref_mean_abs_flow=mag)


def _raft_cfg():
    from focusflow_official_tpu_torch.models import FFRaftConfig

    return FFRaftConfig(fusion="parallel", fusion_type="1x1conv", fuse_cnet=True, iters=ITERS)


def end_to_end_phase(torch, card: str):
    """-> (launch counts of the counted forward, the f32 CPU run on the
    phase's inputs)."""
    from focusflow_official_tpu_torch.predict import FlowPredictor

    cfg = _raft_cfg()
    inputs, shift = _shift_inputs(H, W)
    p = FlowPredictor(cfg, FIXTURE, device="cuda", dtype=torch.bfloat16)
    want = {"lookup_fold": ITERS, "in_stats": 30, "in_normalize": 30}
    flow, counts = _drive(torch, p, inputs, want, "ff_raft")
    # the 12 ResidualBlocks of the fnet (image and mask branch, both frames
    # batched) take their shortcut add and ReLU in C2's residual form
    forms = _count_forms(counts[1], "in_normalize")
    if forms != {"plain": 18, "residual": 12}:
        raise AssertionError(f"in_normalize forms {forms} != 18 plain, 12 residual")
    cpu = _cpu_flow(cfg, FIXTURE, inputs)
    gates = _gates(flow, shift, cpu)
    _emit(dict(phase="end_to_end", model="ff_raft", card=card, shape=[1, H, W],
               iters=ITERS, dtype="bfloat16", launches=counts[0], **gates))
    return counts, cpu


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


def _ff_launches(encoder_depth: int, iters: int, fused: bool = True) -> dict:
    """Launches of one FF-FlowFormer forward: E in the 8 Twins GSAs (two
    stages of the context's and the features' image and mask towers), the
    perceiver's input layer, each latent self-attention and vertical global
    layer and each decoder step; F in the 8 Twins LSAs and each vertical
    local layer; A once and B twice a decoder step; the LayerNorm kernel
    once a `nn/twins.py::LayerNorm` call: 6 a Twins stage (its patch
    embed, two blocks of two, the GSA's keys), 3 around the perceiver's
    input (the cost patch embed, the cross-attention's two), 8 an encoder
    layer (two in the latent layer, four in the vertical blocks, the GSA's
    keys and values) and 2 a decoder step. Vanilla FlowFormer
    (`fused=False`) has no mask towers: 4 GSAs and 4 LSAs."""
    towers = 8 if fused else 4
    return {"attention": towers + 1 + 2 * encoder_depth + iters,
            "window_attention": towers + encoder_depth,
            "lookup": iters, "fold": 2 * iters,
            "layer_norm": 6 * towers + 3 + 8 * encoder_depth + 2 * iters}


def ff_end_to_end_phase(torch, card: str) -> dict:
    """FF-FlowFormer on the fixture (encoder depth 1) against its f32 CPU
    run, then one counted forward at the shipped encoder depth 3 on seeded
    weights (`_random_ff_weights`): finite flow and its launches (E 27, F
    11) -> path -> (launch counts, launches by shape key)."""
    from focusflow_official_tpu_torch.models import FlowFormerConfig
    from focusflow_official_tpu_torch.predict import FlowPredictor

    cfg = FlowFormerConfig(encoder_depth=1, decoder_depth=ITERS)
    inputs, shift = _textured_inputs(H, W)
    p = FlowPredictor(cfg, FIXTURE_FF, device="cuda", dtype=torch.bfloat16)
    flow, counts = _drive(torch, p, inputs, _ff_launches(1, ITERS), "ff_flowformer")
    gates = _gates(flow, shift, _cpu_flow(cfg, FIXTURE_FF, inputs))
    _emit(dict(phase="end_to_end", model="ff_flowformer", card=card,
               shape=[1, H, W], encoder_depth=1, iters=ITERS, dtype="bfloat16",
               launches=counts[0], **gates, cpu_f32_size="full frame"))
    del p
    path = os.path.join(OUT_DIR, "ff_random_depth3.npz")
    os.makedirs(OUT_DIR, exist_ok=True)
    _random_ff_weights(torch, path, 3)
    p = FlowPredictor(FlowFormerConfig(encoder_depth=3, decoder_depth=ITERS), path,
                      device="cuda", dtype=torch.bfloat16)
    flow3, counts3 = _drive(torch, p, inputs, _ff_launches(3, ITERS), "ff_flowformer depth 3")
    if flow3.shape != (H, W, 2) or not np.isfinite(flow3).all():
        raise AssertionError(f"depth-3 flow {flow3.shape} not finite")
    _emit(dict(phase="end_to_end", model="ff_flowformer", card=card, shape=[1, H, W],
               encoder_depth=3, iters=ITERS, dtype="bfloat16",
               weights="seeded torch.Generator", launches=counts3[0],
               mean_abs_flow=float(np.abs(flow3).mean())))
    return {"ff_flowformer": counts, "ff_flowformer_depth3": counts3}


def pwc_end_to_end_phase(torch, card: str):
    """FF-PWCNet: 1024x436 padded to 1024x440, resized to 1024x448 inside,
    raw 0-255 inputs, one launch of D at each of the five decoder levels."""
    from focusflow_official_tpu_torch.models import FFPWCNetConfig
    from focusflow_official_tpu_torch.predict import FlowPredictor

    cfg = FFPWCNetConfig(fusion="parallel", fusion_type="1x1conv")
    inputs, _ = _textured_inputs(H, W)
    p = FlowPredictor(cfg, FIXTURE_PWC, device="cuda", dtype=torch.bfloat16)
    flow, counts = _drive(torch, p, inputs, {"local_corr": 5}, "ff_pwcnet")
    gates = _gates(flow, None, _cpu_flow(cfg, FIXTURE_PWC, inputs))
    # every launch of D is the fused form: no leaky ReLU runs on the volume
    forms = _count_forms(counts[1], "local_corr")
    if forms != {"leaky_relu": 5}:
        raise AssertionError(f"local_corr forms {forms} != 5 leaky_relu")
    limit = 0.05 * max(gates["cpu_f32_mean_abs_flow"], 1.0)
    _emit(dict(phase="end_to_end", model="ff_pwcnet", card=card, shape=[1, H, W],
               dtype="bfloat16",
               agreement_margin=dict(mean_abs=gates["vs_cpu_f32_mean_abs"], limit=limit,
                                     share=gates["vs_cpu_f32_mean_abs"] / limit),
               launches=counts[0], **gates, cpu_f32_size="full frame"))
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


RAFT_CTK_YAML = os.path.join(ROOT, "configs", "ff-raft", "experiment", "raft_CTK.yaml")
ABLATION_YAMLS = {t: os.path.join(ROOT, "configs", "ff-raft", "ablation", "fusion", f)
                  for t, f in (("CA", "CA.yaml"), ("SA", "SA.yaml"), ("concat", "conv.yaml"))}
VANILLA_FF_YAML = os.path.join(ROOT, "configs", "ff-flowformer", "chairs.yaml")


def _raft_variant_weights(torch, cfg, path: str) -> dict:
    """Weights for a RAFT variant (plain RAFT, or FF-RAFT with another
    fusion unit) from `trained_smoke.npz`: every tensor whose name and
    shape carry over (plain RAFT's encoders carry the CCE image branch's
    names), and for the rest: a `concat` unit's weight derived from the
    fixture's 1x1conv unit at the same place ([identity | its weight], its
    bias as it is, so the unit computes q + W v + b, what the 1x1conv unit
    computed), the norms' scales and running statistics and the channel
    attention's temperatures as the model initialises them (the front
    ends'), every other tensor (the CA and SA units', the small model's and
    the front ends') drawn from a seeded torch.Generator, weights 0.1 x
    N(0, 1/fan_in) (a front end's N(0, 1/fan_in)), biases 0.01 x N(0, 1),
    so a unit is q plus a small term. Saved as the .npz of flat flax variables -> {"seeded": names,
    "derived": names, "initial": names}."""
    from focusflow_official_tpu_torch.compat.weights import load_npz, params_to_jax
    from focusflow_official_tpu_torch.config import model_from_config

    model, _ = model_from_config(cfg)
    src = load_npz(FIXTURE)
    g = torch.Generator().manual_seed(12)
    sd, seeded, derived, initial = {}, [], [], []
    for k, t in model.state_dict().items():
        if k in src and src[k].shape == t.shape:
            sd[k] = src[k]
        elif (k.endswith(("running_mean", "running_var", "temperature"))
              or (t.dim() == 1 and k.endswith("weight"))):
            sd[k] = t
            initial.append(k)
        elif cfg.fusion_type == "concat" and k.endswith(".conv.weight"):
            w = src[k]  # the 1x1conv unit's (C, C, 1, 1) under the same name
            sd[k] = torch.cat([torch.eye(w.shape[0])[:, :, None, None], w], 1)
            derived.append(k)
        else:
            # a front end stands in for the image as a whole: N(0, 1/fan_in)
            # keeps its features at the image's scale, where 0.1 x that
            # shrinks them layer by layer under the RAFT's biases, whose bf16
            # sum then loses them
            scale = 1.0 if k.startswith("fusion_layer.") else 0.1
            scale = scale / float(np.sqrt(t[0].numel())) if t.dim() > 1 else 0.01
            sd[k] = scale * torch.randn(t.shape, generator=g)
            seeded.append(k)
    os.makedirs(OUT_DIR, exist_ok=True)
    np.savez(path, **params_to_jax(sd))
    return dict(seeded=seeded, derived=derived, initial=initial)


def _vanilla_ff_weights(torch, path: str) -> dict:
    """Vanilla FlowFormer at encoder depth 3: phase 5's seeded draw
    (`_random_ff_weights`) without the mask towers and fusion units, the
    GMA flow head's weights and biases scaled by 0.1. (The FF fixture's
    image half is no model: on its own it predicts flows of about 80 px on
    this input, and its bf16 and f32 runs part by more than the agreement
    bound. A flow head at full scale makes the 12 refinements of seeded
    weights chaotic the same way.) -> {"seeded": names}."""
    _random_ff_weights(torch, path, 3)
    with np.load(path) as raw:
        flat = {k: raw[k] * (0.1 if "/flow_head/" in k else 1.0) for k in raw.files
                if "_svt/mask_" not in k and "/fusion_blks_" not in k}
    np.savez(path, **flat)
    return dict(seeded=sorted(flat), flow_head_scale=0.1)


def baseline_phase(torch, card: str) -> dict:
    """Phase 12, serving: plain RAFT (`raft_CTK.yaml`'s model), FF-RAFT with
    the CA, SA and concat units (the fusion ablation's YAMLs) and vanilla
    FlowFormer (`configs/ff-flowformer/chairs.yaml`: encoder depth 3, 12
    refinements), each through `FlowPredictor` at 1024x436, B=1, bf16
    (`_raft_variant_weights`, `_vanilla_ff_weights`). Gates: finite flow;
    the bf16 card run against the f32 CPU run on the same weights within
    phase 3's bounds; the counted forward's launches equal the model's
    (RAFT: G 12; C1 and C2 30 a CCE fnet, 18 plain and 12 residual, or 15
    a plain fnet, 9 and 6; FlowFormer: `_ff_launches(3, 12, fused=False)`).
    -> path -> (launch counts, launches by shape key) of the counted
    forward."""
    from focusflow_official_tpu_torch.config import config_from_yaml, load_yaml_config
    from focusflow_official_tpu_torch.predict import FlowPredictor

    models = [("raft", RAFT_CTK_YAML)] + [(f"raft_{t.lower()}", y)
                                          for t, y in ABLATION_YAMLS.items()]
    models.append(("flowformer", VANILLA_FF_YAML))
    drives = {}
    for path, yaml in models:
        cfg = config_from_yaml(load_yaml_config(yaml), compute_dtype="bfloat16")
        weights = os.path.join(OUT_DIR, f"{path}_weights.npz")
        if path == "flowformer":
            made = _vanilla_ff_weights(torch, weights)
            want = _ff_launches(cfg.encoder_depth, cfg.decoder_depth, fused=False)
            inputs, _ = _textured_inputs(H, W)
            forms = None
        else:
            made = _raft_variant_weights(torch, cfg, weights)
            plain = cfg.fusion is None
            n_in = 15 if plain else 30
            want = {"lookup_fold": cfg.iters, "in_stats": n_in, "in_normalize": n_in}
            forms = {"plain": 9, "residual": 6} if plain else {"plain": 18, "residual": 12}
            inputs, _ = _shift_inputs(H, W)
        p = FlowPredictor(cfg, weights, device="cuda", dtype=torch.bfloat16)
        flow, counts = _drive(torch, p, inputs, want, path)
        if forms is not None and _count_forms(counts[1], "in_normalize") != forms:
            raise AssertionError(f"{path}: in_normalize forms "
                                 f"{_count_forms(counts[1], 'in_normalize')} != {forms}")
        gates = _gates(flow, None, _cpu_flow(cfg, weights, inputs))
        del p
        _emit(dict(phase="baselines", model=path, yaml=os.path.relpath(yaml, ROOT), card=card,
                   shape=[1, H, W], iters=getattr(cfg, "iters", getattr(cfg, "decoder_depth", None)),
                   dtype="bfloat16", launches=counts[0],
                   weights={k: (dict(count=len(v), first=v[:2]) if isinstance(v, list) else v)
                            for k, v in made.items()},
                   **gates, cpu_f32_size="full frame"))
        drives[path] = counts
        torch.cuda.empty_cache()
    return drives


# ------------------------------------------------ phase 14: the FF-RAFT variants
ALT_CHUNK = 2048
FULL_HD, FOUR_K = (1080, 1920), (2160, 3840)
ALT_PEAK_GIB = 24.0  # the 4K ALT_CORR run's bound on allocated device memory
SMALL_FNET_SHAPES = [(2, 220, 512, 32), (2, 220, 512, 8), (2, 220, 512, 16),
                     (2, 110, 256, 16), (2, 110, 256, 64), (2, 110, 256, 24),
                     (2, 55, 128, 24), (2, 55, 128, 96)]  # RAFT-S's fnet at 1024x436


def _grid(h: int, w: int) -> tuple:
    """The /8 grid of an (h, w) frame padded to a multiple of 8."""
    return -(-h // 8), -(-w // 8)


def _cce_fnet_shapes(h: int, w: int) -> list:
    """The CCE fnet's instance-norm shapes (both frames) at an (h, w) frame."""
    hh, wh = -(-h // 8) * 4, -(-w // 8) * 4
    return [(2, hh, wh, 64), (2, (hh + 1) // 2, (wh + 1) // 2, 96),
            (2, (hh + 3) // 4, (wh + 3) // 4, 128)]


def _alt_chunks(q: int) -> list:
    """ALT_CORR's chunk sizes over q queries: the full chunks and the tail."""
    return sorted({min(ALT_CHUNK, q - s) for s in range(0, q, ALT_CHUNK)}, reverse=True)


def variant_kernel_rows(torch, dev) -> dict:
    """Phase 14's new (kernel, shape) keys, each held against its plain
    version and timed beside its bound and yardstick, as the kernel phase
    holds its rows: G at radius 3 with N = 96 (RAFT-S's and FF-RAFT-S's
    motion encoder, Q = 7040), G at ALT_CORR's full chunk and tail at
    1024x436 and at 3840x2160 (the chunk's 4 levels over the whole frame,
    the fixture's convc1), and C1 and C2 (both forms) at RAFT-S's
    SmallEncoder fnet shapes and at the CCE fnet's 4K shapes ->
    {kernel: rows}."""
    from focusflow_official_tpu_torch.compat.weights import load_npz
    from focusflow_official_tpu_torch.ops.coords import coords_grid
    from focusflow_official_tpu_torch.ops.corr import corr_pyramid

    g = torch.Generator(device=dev).manual_seed(14)
    bf16 = torch.bfloat16
    sd = load_npz(FIXTURE)
    wc = sd["flow_net.update_block.encoder.convc1.weight"].reshape(256, 324).to(dev, bf16)
    bc = sd["flow_net.update_block.encoder.convc1.bias"].to(dev, bf16)
    w96 = (torch.randn((96, 196), generator=g, device=dev) / 14).to(bf16)
    b96 = (torch.randn((96,), generator=g, device=dev) * 0.1).to(bf16)
    h0, w0 = _grid(H, W)
    specs = [("RAFT-S motion encoder, radius 3", (h0, w0), h0 * w0, 3, w96, b96)]
    for size, label in (((H, W), "1024x436"), (FOUR_K, "3840x2160")):
        gh, gw = _grid(*size)
        specs += [(f"ALT_CORR {label}, {q} of {gh * gw} queries", (gh, gw), q, 4, wc, bc)
                  for q in _alt_chunks(gh * gw)]
    rows = {"lookup_fold": [], "in_stats": [], "in_normalize": []}
    for label, (gh, gw), q, r, w, bias in specs:
        levels = corr_pyramid(torch.randn((1, q, gh, gw), generator=g, device=dev), 4, bf16)
        coords = (coords_grid(1, gh, gw, device=dev).reshape(1, 1, -1, 2)[:, :, :q]
                  + torch.randn((1, 1, q, 2), generator=g, device=dev) * 8).contiguous()
        row = _lookup_fold_row(torch, levels, coords, r, w, bias, label)
        row.update(shape=f"{label}: levels {[tuple(lv.shape) for lv in levels]} bf16, "
                         f"({w.shape[0]}, {w.shape[1]}) weight")
        rows["lookup_fold"].append(row)
        _emit(dict(phase="variant_kernels", name="lookup_fold", **row))
        del levels, coords
        torch.cuda.empty_cache()
    per_shape = _instance_norm_rows(torch, g, dev, SMALL_FNET_SHAPES + _cce_fnet_shapes(*FOUR_K))
    for name in ("in_stats", "in_normalize"):
        rows[name] = per_shape[name]
        for row in per_shape[name]:
            _emit(dict(phase="variant_kernels", name=name, **row))
    return rows


def _variant_cfg(yaml: str, **model):
    """The YAML's port config (bf16) with MODEL keys set."""
    from focusflow_official_tpu_torch.config import config_from_yaml, load_yaml_config

    cfg = load_yaml_config(yaml)
    for k, v in model.items():
        setattr(cfg.MODEL, k, v)
    return config_from_yaml(cfg, compute_dtype="bfloat16")


def _materialized_bytes(h: int, w: int) -> dict:
    """The all-pairs path's volume at an (h, w) frame, in bytes: the f32
    product, its three pooled levels in f32, level 0 stored in bf16."""
    gh, gw = _grid(h, w)
    q = gh * gw
    pooled = sum((gh >> lv) * (gw >> lv) for lv in (1, 2, 3))
    return dict(f32_product=q * q * 4, f32_pooled=q * pooled * 4, bf16_level0=q * q * 2,
                total=q * q * 6 + q * pooled * 4)


def _chunk_launches(shapes: dict) -> dict:
    """G's launches by the chunk's queries (the key's q)."""
    out = {}
    for key, n in shapes.items():
        if key[0] == "lookup_fold":
            out[key[2]] = out.get(key[2], 0) + n
    return out


def variants_phase(torch, card: str, held: set) -> dict:
    """Phase 14, the FF-RAFT variants, through `FlowPredictor`, B=1, bf16, 12
    refinements (see the module docstring) -> path -> (launch counts,
    launches by shape key) of each counted forward. Runs that are checks
    and no path (the 1080p pair, the attention front end's cut pair) have
    each (kernel, shape) they launch that no row holds (`held`) held once
    against its plain version."""
    from focusflow_official_tpu_torch.kernels import launch_shapes, reset_launch_counts
    from focusflow_official_tpu_torch.predict import FlowPredictor

    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    drives, checked = {}, {}

    def checks(fn):
        """Run `fn` with its launches kept apart from the paths' counts."""
        reset_launch_counts()
        out = fn()
        for key, n in launch_shapes.items():
            checked[key] = checked.get(key, 0) + n
        return out

    # ---- 14.1 ALT_CORR at 1024x436, beside the materialized path
    alt = dataclasses.replace(_raft_cfg(), alt_corr=True, alt_corr_chunk=ALT_CHUNK)
    inputs, shift = _shift_inputs(H, W)
    mat_flow = checks(lambda: FlowPredictor(_raft_cfg(), FIXTURE, device="cuda", dtype=bf16)(
        *inputs)[0])
    q = int(np.prod(_grid(H, W)))
    want = {"lookup_fold": ITERS * -(-q // ALT_CHUNK),
            "corr_levels": ITERS * -(-q // ALT_CHUNK),
            "in_stats": 30, "in_normalize": 30}
    p = FlowPredictor(alt, FIXTURE, device="cuda", dtype=bf16)
    flow, counts = _drive(torch, p, inputs, want, "ff_raft_alt_corr")
    chunks = _chunk_launches(counts[1])
    if chunks != {c: ITERS * (q // c if c == ALT_CHUNK else 1) for c in _alt_chunks(q)}:
        raise AssertionError(f"ALT_CORR 1024x436: G launches by chunk {chunks}")
    gates = _gates(flow, shift, _cpu_flow(alt, FIXTURE, inputs))
    _emit(dict(phase="variants", model="ff_raft_alt_corr", card=card, shape=[1, H, W],
               iters=ITERS, dtype="bfloat16", chunk=ALT_CHUNK, launches=counts[0],
               g_launches_by_chunk=chunks, **gates,
               vs_materialized_bf16=_agreement(flow, mat_flow, "ALT_CORR vs materialized")))
    drives["ff_raft_alt_corr"] = counts
    del p

    # ---- 14.2 ALT_CORR at 1920x1080 against the materialized path, then 4K
    inputs, shift = _shift_inputs(*FULL_HD)
    hd = {}
    for name, cfg in (("materialized", _raft_cfg()), ("alt_corr", alt)):
        torch.cuda.empty_cache()
        hd[name] = checks(lambda: FlowPredictor(cfg, FIXTURE, device="cuda", dtype=bf16)(
            *inputs)[0])
    hd_gates = _agreement(hd["alt_corr"], hd["materialized"], "ALT_CORR vs materialized, 1080p")
    inputs, shift = _shift_inputs(*FOUR_K)
    q4 = int(np.prod(_grid(*FOUR_K)))
    want = {"lookup_fold": ITERS * -(-q4 // ALT_CHUNK),
            "corr_levels": ITERS * -(-q4 // ALT_CHUNK),
            "in_stats": 30, "in_normalize": 30}
    p = FlowPredictor(alt, FIXTURE, device="cuda", dtype=bf16)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    flow, counts = _drive(torch, p, inputs, want, "ff_raft_alt_corr_4k")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    shape4 = (*FOUR_K, 2)
    if flow.shape != shape4 or not np.isfinite(flow).all():
        raise AssertionError(f"ALT_CORR 4K: flow {flow.shape} not finite or not {shape4}")
    epe = float(np.sqrt(((flow[8:-8, 8:-8] - np.array(shift)) ** 2).sum(-1)).mean())
    if not (epe < 6.0 and peak < ALT_PEAK_GIB):
        raise AssertionError(f"ALT_CORR 4K: interior EPE {epe}, peak {peak} GiB")
    _emit(dict(phase="variants", model="ff_raft_alt_corr_4k", card=card, shape=[1, *FOUR_K],
               iters=ITERS, dtype="bfloat16", chunk=ALT_CHUNK, launches=counts[0],
               g_launches_by_chunk=_chunk_launches(counts[1]), epe_interior=epe,
               mean_abs_flow=float(np.abs(flow).mean()), peak_mem_gib=peak,
               peak_bound_gib=ALT_PEAK_GIB,
               materialized_bytes_reckoned=_materialized_bytes(*FOUR_K),
               full_hd=dict(shape=[1, *FULL_HD], vs_materialized_bf16=hd_gates,
                            materialized_bytes_reckoned=_materialized_bytes(*FULL_HD))))
    drives["ff_raft_alt_corr_4k"] = counts
    del p, hd
    torch.cuda.empty_cache()

    # ---- 14.3 RAFT-S and FF-RAFT-S; 14.4 the attention and conv front ends
    cases = (("raft_s", RAFT_CTK_YAML, dict(SMALL=True), 21, (15, 6)),
             ("ff_raft_s", TRAIN_YAML, dict(SMALL=True), 30, (18, 12)),
             ("raft_attention", TRAIN_YAML, dict(FUSION="attention", FUSION_CHANNEL=256),
              15, (9, 6)),
             ("raft_conv", TRAIN_YAML, dict(FUSION="conv", FUSION_CHANNEL=256), 15, (9, 6)))
    inputs, _ = _shift_inputs(H, W)
    for path, yaml, model, n_in, (n_plain, n_res) in cases:
        cfg = _variant_cfg(yaml, **model)
        weights = os.path.join(OUT_DIR, f"{path}_weights.npz")
        made = _raft_variant_weights(torch, cfg, weights)
        want = {"lookup_fold": cfg.iters, "in_stats": n_in, "in_normalize": n_in}
        p = FlowPredictor(cfg, weights, device="cuda", dtype=bf16)
        flow, counts = _drive(torch, p, inputs, want, path)
        forms = _count_forms(counts[1], "in_normalize")
        g_keys = {key for key in counts[1] if key[0] == "lookup_fold"}
        radius, n_out = (3, 96) if cfg.small else (4, 256)
        if forms != {"plain": n_plain, "residual": n_res} or any(
                (key[-6], key[-5]) != (radius, n_out) for key in g_keys):
            raise AssertionError(f"{path}: in_normalize forms {forms}, G keys {g_keys}")
        cpu_inputs, cpu_note = inputs, "full frame"
        if cfg.fusion == "attention":
            # its 256-channel UNet is about 30 TFLOP a pair in f32, minutes on
            # the card machine's CPU: the agreement runs on the pair's top
            # left 224x512 (the card's bf16 run of the same crop beside it)
            cpu_inputs = tuple(a[:, :224, :512] for a in inputs)
            cpu_note = "top left 224x512, the card's run of the same crop"
            flow = checks(lambda: p(*cpu_inputs)[0])
        gates = _gates(flow, None, _cpu_flow(cfg, weights, cpu_inputs),
                       shape=(*cpu_inputs[0].shape[1:3], 2))
        del p
        _emit(dict(phase="variants", model=path, yaml=os.path.relpath(yaml, ROOT),
                   set=model, card=card, shape=[1, H, W], iters=cfg.iters, dtype="bfloat16",
                   launches=counts[0], in_normalize_forms=forms,
                   g_keys=sorted(map(list, g_keys)),
                   weights={k: dict(count=len(v), first=v[:2]) for k, v in made.items()},
                   **gates, cpu_f32_size=cpu_note))
        drives[path] = counts
        torch.cuda.empty_cache()

    g = torch.Generator(device="cuda").manual_seed(15)
    new = sorted((k for k in checked if k not in held), key=str)
    new_rows = [dict(_hold_shape(torch, g, torch.device("cuda", 0), k), launches=checked[k])
                for k in new]
    _emit(dict(phase="variants", part="check runs' new shapes held", held=new_rows,
               phase_seconds=time.perf_counter() - t_phase))
    return drives


# ------------------------------------------------ phase 15: the FF-FlowFormer variants
# path -> MODEL keys set over `ff_chairs.yaml` (encoder depth 3, 12 refinements)
FF_VARIANT_PATHS = {
    "ff_mlp_nogma": dict(use_mlp=True, gma=False, cost_encoder_res=False, add_flow_token=False),
    "ff_convnext_global": dict(vertical_conv=True, only_global=True),
    "ff_patch4": dict(patch_size=4),
}
FF_VARIANT_TRAIN = dict(use_mlp=True, vertical_conv=True, gma=False)
FF_PATCH4_TRAIN = dict(patch_size=4)  # phase 11's step but for the patch size
# patch 4's agreement steps at phase 11's agreement depth (encoder depth 1, 2
# refinements), on weights drawn for it: at depth 3 and 12 refinements
# (GMA on) the f32 gradient of these weights is chaotic, the CPU's f32
# against its f64 at cosine 0.9899, and 1e-6 relative noise on the weights
# moves it to 0.916 (184x248, two samples); at depth 1 and 2 refinements
# 0.99999999 and 0.9999995
FF_PATCH4_AGREE = dict(encoder_depth=1, decoder_depth=2)
VARIANT_TRAIN_STEPS = 6  # step 4 counted
GROUP_SHAPE = (10, 56, 133, 128)  # group attention's F: B*K = 10 at the 55x128 grid, padded
# bf16 against f32 through LayerNorm, four products, GELU and F's bf16 softmax
# weights, the residual's input rounded to 8 significant bits: of the output's scale
GROUP_LAYER_TOL = 2.0 ** -5


def _ff_variant_launches(cfg) -> dict:
    """`_ff_launches` for a variant: E loses the latent self-attention with
    `use_mlp` and the vertical global layer with `vertical_conv`, which
    also takes F's vertical local layer; B runs once a refinement (the
    flow token alone) with `only_global`. LayerNorm: the four ConvNext
    blocks of a `vertical_conv` layer take two fewer than the vertical
    blocks, a decoder step without `add_flow_token` one fewer."""
    d = cfg.encoder_depth
    want = _ff_launches(d, cfg.decoder_depth, fused=cfg.fusion is not None)
    want["attention"] -= d * (int(cfg.use_mlp) + int(cfg.vertical_conv))
    want["window_attention"] -= d * int(cfg.vertical_conv)
    want["fold"] -= cfg.decoder_depth * int(cfg.only_global)
    want["layer_norm"] -= 2 * d * int(cfg.vertical_conv) + cfg.decoder_depth * int(
        not cfg.add_flow_token)
    return want


def _ff_variant_weights(torch, cfg, path: str) -> dict:
    """Weights for a FlowFormer variant from the fixture at encoder depth 3
    (`_ff_depth3_weights`: layer 0 copied into layers 1 and 2): every
    tensor whose name and shape carry over; derived from the fixture, the
    basic update block's GRU (the GMA GRU reads [net, context, motion,
    the aggregate]: the aggregate's columns are added to the motion's, so
    it computes what the GMA GRU computes where the aggregator's gamma is
    0; the fixture's is 0.0055) and the only-global convc1 (the fixture's
    without its window columns); seeded from a torch.Generator, the rest
    (MLP-Mixer and ConvNext layers, the patch-4 convs): weights
    N(0, 1/fan_in), LayerNorm scales 1 + N(0, 0.1^2), ConvNext's gamma and
    every bias N(0, 0.1^2). Saved as .npz -> {"seeded", "derived": names}."""
    from focusflow_official_tpu_torch.compat.weights import load_npz, params_to_jax
    from focusflow_official_tpu_torch.config import model_from_config

    src = load_npz(_ff_depth3_weights())
    model, _ = model_from_config(cfg)
    norms = {n for n, m in model.named_modules() if type(m).__name__ == "LayerNorm"}
    g = torch.Generator().manual_seed(15)
    sd, seeded, derived = {}, [], []
    for k, t in model.state_dict().items():
        owner, leaf = k.rpartition(".")[::2]
        if k in src and src[k].shape == t.shape:
            sd[k] = src[k]
        elif k in src and ".update_block.gru." in k and leaf == "weight":
            w = src[k]  # (128, 128 + 384, kh, kw): [net, context, motion, aggregate]
            sd[k] = torch.cat([w[:, :256], w[:, 256:384] + w[:, 384:]], dim=1)
            derived.append(k)
        elif k in src and k.endswith("encoder.convc1.weight"):
            sd[k] = src[k][:, :t.shape[1]].contiguous()  # the global cost's columns
            derived.append(k)
        else:
            r = torch.randn(t.shape, generator=g)
            if owner in norms and leaf == "weight":
                sd[k] = 1 + 0.1 * r
            elif leaf == "weight" and t.dim() > 1:
                sd[k] = r / float(np.sqrt(t[0].numel()))
            else:
                sd[k] = 0.1 * r
            seeded.append(k)
    model.load_state_dict(sd, strict=True)
    np.savez(path, **params_to_jax(sd))
    return dict(seeded=seeded, derived=derived)


def ff_variant_kernel_rows(torch, dev) -> dict:
    """Phase 15's new (kernel, shape) keys, held and timed as the kernel
    phase holds its rows: E's staged entry at the patch-4 perceiver's input
    layer, (7040, 8) x 448 keys at 1024x436 and (17112, 8) x 192 in
    training at B=6, 368x496 (with its Function's backward); F at group
    attention's shape
    (`GROUP_SHAPE`, 8 heads of 16) -> {kernel: rows}."""
    g = torch.Generator(device=dev).manual_seed(15)
    q, tq = 55 * 128, 6 * 46 * 62
    rows = {"attention": [
        _attention_row(torch, g, dev, q, 8, 448, 128, 8, "attention input layer, patch 4",
                       "staged"),
        _attention_row(torch, g, dev, tq, 8, 192, 128, 8,
                       "attention train input layer, patch 4", "staged", backward=True)],
        "window_attention": [_window_row(torch, g, dev, *GROUP_SHAPE, 8,
                                         "window group attention")]}
    for name, rs in rows.items():
        for row in rs:
            _emit(dict(phase="ff_variant_kernels", name=name, **row))
    torch.cuda.empty_cache()
    return rows


def _dwconv_row(torch, dev, b: int, h: int, w: int, c: int) -> dict:
    """ConvNext's depthwise 7x7 (cuDNN) on the vertical layer's bf16
    (b, h, w, c) channels-last grid: median ms beside its bound (input and
    output once; 2 x 49 operations an output on the f32 units)."""
    from focusflow_official_tpu_torch.nn.twins import conv_nhwc

    conv = torch.nn.Conv2d(c, c, 7, 1, 3, groups=c).to(dev, torch.bfloat16,
                                                       memory_format=torch.channels_last)
    x = torch.randn((b, h, w, c), device=dev).to(torch.bfloat16)
    with torch.no_grad():
        ms = _time_ms(torch, lambda: conv_nhwc(conv, x))
    bound, by = _bound_ms(2 * x.numel() * 2, 2 * 49 * x.numel(), PEAK_F32)
    return dict(shape=f"({b}, {h}, {w}, {c}) bf16, channels last", ms=ms, bound_ms=bound,
                bound_by=by)


def ff_variants_phase(torch, card: str) -> dict:
    """Phase 15, serving: the three variant configurations of
    `FF_VARIANT_PATHS` through `FlowPredictor` at 1024x436, B=1, bf16, 12
    refinements, encoder depth 3, on `_ff_variant_weights`. Gates: finite
    flow; agreement with the f32 CPU run on the same weights (phase 3's
    bounds, the margin printed); the launches a forward
    (`_ff_variant_launches`; B only in its 81 -> 64 form where only-global).
    -> path -> (launch counts, launches by shape key) of each counted
    forward."""
    from focusflow_official_tpu_torch.predict import FlowPredictor

    t_phase = time.perf_counter()
    inputs, _ = _textured_inputs(H, W)
    drives = {}
    for path, model in FF_VARIANT_PATHS.items():
        cfg = _variant_cfg(FF_TRAIN_YAML, **model)
        weights = os.path.join(OUT_DIR, f"{path}_weights.npz")
        made = _ff_variant_weights(torch, cfg, weights)
        want = _ff_variant_launches(cfg)
        p = FlowPredictor(cfg, weights, device="cuda", dtype=torch.bfloat16)
        flow, counts = _drive(torch, p, inputs, want, path)
        folds = sorted({key[3] for key in counts[1] if key[0] == "fold"})
        if folds != ([64] if cfg.only_global else [64, 256]):
            raise AssertionError(f"{path}: fold widths {folds}")
        extra = {}
        if cfg.vertical_conv:  # 4 blocks a vertical layer, over B*K = 8 grids
            extra["convnext_dwconv"] = dict(
                _dwconv_row(torch, torch.device("cuda", 0), 8, 55, 128, cfg.cost_latent_dim),
                launches=4 * cfg.encoder_depth)
        gates = _gates(flow, None, _cpu_flow(cfg, weights, inputs))
        limit = 0.05 * max(gates["cpu_f32_mean_abs_flow"], 1.0)
        del p
        _emit(dict(phase="ff_variants", model=path, yaml=os.path.relpath(FF_TRAIN_YAML, ROOT),
                   set=model, card=card, shape=[1, H, W], encoder_depth=cfg.encoder_depth,
                   iters=cfg.decoder_depth, dtype="bfloat16", launches=counts[0], want=want,
                   fold_widths=folds,
                   agreement_margin=dict(mean_abs=gates["vs_cpu_f32_mean_abs"], limit=limit,
                                         share=gates["vs_cpu_f32_mean_abs"] / limit),
                   weights={k: dict(count=len(v), first=v[:2]) for k, v in made.items()},
                   **extra, **gates, cpu_f32_size="full frame"))
        drives[path] = counts
        torch.cuda.empty_cache()
    _emit(dict(phase="ff_variants", part="serving", seconds=time.perf_counter() - t_phase))
    return drives


def ff_variant_train_phase(torch, card: str, held: set, path: str = "ff_variant_train",
                           form: dict = FF_VARIANT_TRAIN, agree_model=None) -> tuple:
    """Phase 15, training: the trainer's body (`cli/train.py::train`) on
    `ff_chairs.yaml` with the MODEL fields of `form` set (FF_VARIANT_TRAIN:
    MLP-Mixer, ConvNext, no GMA; FF_PATCH4_TRAIN: patch size 4 alone) at
    full width and depth (B=6, 368x496, encoder depth 3, 12 refinements,
    MixLoss, noise, AdamW + OneCycle, bf16) from `_ff_variant_weights`,
    NUM_STEPS cut to VARIANT_TRAIN_STEPS, on phase 11's fixed batch. Gates:
    finite loss and gradient norm at every step; every step's launches
    (`_ff_variant_launches`); on two samples at 184x248 without noise, the
    f32 step (TF32 off) within 1e-4 of the port's f32 CPU step in loss and
    >= 0.9999 in gradient cosine (phase 11's bounds; with `agree_model`,
    on the model with those MODEL fields set, from `_ff_variant_weights`
    drawn for it, as phase 11 agrees at the fixture's depth). No descent
    gate. Every (kernel, shape) launched that no row holds (`held`) is
    held once against its plain version. -> ((counts, launches by shape
    key) of step 4, the phase's line)."""
    import copy

    from focusflow_official_tpu_torch.cli.train import train as run_trainer
    from focusflow_official_tpu_torch.config import config_from_yaml, load_yaml_config
    from focusflow_official_tpu_torch.data import synthetic as sy
    from focusflow_official_tpu_torch.kernels import (
        launch_counts, launch_shapes, reset_launch_counts)

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    cfg = load_yaml_config(FF_TRAIN_YAML)
    for k, v in form.items():
        setattr(cfg.MODEL, k, v)
    weights = os.path.join(OUT_DIR, f"{path}_weights.npz")
    made = _ff_variant_weights(torch, config_from_yaml(cfg), weights)
    cfg.TRAIN.NUM_STEPS = VARIANT_TRAIN_STEPS
    cfg.MODEL.PRETRAIN = weights
    cfg.MODEL.LOAD_MODULE = None
    cfg.MODEL.load_former = None
    cfg.GLOBAL.NUM_WORKERS = 2
    b, (th, tw) = int(cfg.TRAIN.BATCH_SIZE), tuple(cfg.TRAIN.IMAGE_SIZE)
    want = _ff_variant_launches(config_from_yaml(cfg))
    data = sy.chairs_layout(5, n=b, h=th, w=tw)
    st = dict(per_step=[], metrics=[], seen={})

    def on_step(step, metrics):
        st["per_step"].append({k: v for k, v in launch_counts.items() if v})
        st["metrics"].append(metrics)
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"{path} step {step}: metrics {metrics} not finite")
        if step == 4:
            st["counted"] = (dict(launch_counts), dict(launch_shapes))
        for key, n in launch_shapes.items():
            st["seen"][key] = st["seen"].get(key, 0) + n
        reset_launch_counts()

    torch.cuda.empty_cache()
    reset_launch_counts()
    run_trainer(cfg, data, validate=lambda model: {},
                log_dir=os.path.join(OUT_DIR, "train_runs"), device="cuda",
                compute_dtype="bfloat16", val_freq=10 ** 9, on_step=on_step)
    want_step = {k: v for k, v in want.items() if v}
    for i, c in enumerate(st["per_step"], start=1):
        if c != want_step:
            raise AssertionError(f"{path} step {i}: launches {c} != {want_step}")

    ch, cw = th // 2, tw // 2
    two = {k: torch.as_tensor(np.stack([data[i][k][:ch, :cw] for i in range(2)]))
           for k in ("image1", "image2", "mask1", "mask2", "flow", "valid")}
    acfg, aweights = cfg, weights
    if agree_model:
        acfg = copy.deepcopy(cfg)
        for k, v in agree_model.items():
            setattr(acfg.MODEL, k, v)
        aweights = os.path.join(OUT_DIR, f"{path}_agree_weights.npz")
        _ff_variant_weights(torch, config_from_yaml(acfg), aweights)
        acfg.MODEL.PRETRAIN = aweights
    cpu_loss, cpu_grad = _two_sample_grads(torch, acfg, aweights, two, "cpu", torch.float32)
    reset_launch_counts()
    f32_loss, f32_grad = _two_sample_grads(torch, acfg, aweights, two, dev, torch.float32)
    for key, n in launch_shapes.items():
        st["seen"][key] = st["seen"].get(key, 0) + n
    agree = dict(cpu_f32_loss=cpu_loss, card_f32_loss=f32_loss,
                 f32_loss_rel=abs(f32_loss - cpu_loss) / abs(cpu_loss),
                 f32_grad_cosine=_cosine(torch, f32_grad, cpu_grad), crop=[ch, cw],
                 model=agree_model or "the phase's", f32_card_flags="TF32 off for the script")
    if not (agree["f32_loss_rel"] <= 1e-4 and agree["f32_grad_cosine"] >= 0.9999):
        raise AssertionError(f"{path} training agreement: {agree}")
    del cpu_grad, f32_grad
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(16)
    new = sorted((k for k in st["seen"] if k not in held), key=str)
    new_rows = [dict(_hold_shape(torch, g, dev, k), launches=st["seen"][k]) for k in new]
    out = dict(phase="ff_variant_train", path=path, card=card,
               yaml=os.path.relpath(FF_TRAIN_YAML, ROOT), set=form, batch=b,
               crop=[th, tw], iters=int(cfg.MODEL.decoder_depth), dtype="bfloat16",
               steps=VARIANT_TRAIN_STEPS, losses=[m["loss"] for m in st["metrics"]],
               grad_norms=[m["grad_norm"] for m in st["metrics"]],
               launches_per_step=want_step, agreement=agree,
               weights={k: dict(count=len(v), first=v[:2]) for k, v in made.items()},
               new_shapes_held=new_rows, phase_seconds=time.perf_counter() - t_phase)
    _emit(out)
    torch.cuda.empty_cache()
    return st["counted"], out


def ff_variant_modules_phase(torch, card: str) -> dict:
    """Phase 15, the modules no model path runs, once each on the card in
    bf16 against the f32 CPU run on the same weights and inputs:
    `GroupVerticalSelfAttentionLayer` (dim 128, 8 heads) on B*K = 10 tokens
    of the 55x128 grid with the context (vert_c_dim 64, 256 channels,
    batch 2 tiled to 10) and without it (F at `GROUP_SHAPE`: the launch's
    key is the kernel phase's row's), within GROUP_LAYER_TOL of the output's
    scale; the three position encodings on a (2, 55, 128, 256) map, each
    output within a bf16 ulp of each of its two roundings, the encoding's
    (|encoding| <= 1) and the sum's: 2^-7 x (1 + |output|) of the CPU's.
    Checks, not paths: their launches count in no drive."""
    from focusflow_official_tpu_torch.kernels import launch_shapes, reset_launch_counts
    from focusflow_official_tpu_torch.nn import position_encoding as tpe
    from focusflow_official_tpu_torch.nn.latent_cost import GroupVerticalSelfAttentionLayer
    from focusflow_official_tpu_torch.predict import for_inference

    dev, bf16 = torch.device("cuda", 0), torch.bfloat16
    g = torch.Generator().manual_seed(17)
    out = {}

    def both(module, *args):
        """module on the CPU in f32, then on the card in bf16 -> (card, CPU)."""
        module.eval()
        with torch.no_grad():
            want = module(*args)
            card = for_inference(module, bf16, dev)(
                *(a.to(dev, bf16) if torch.is_tensor(a) and a.is_floating_point() else a
                  for a in args))
        return card.float().cpu(), want

    h1, w1 = 55, 128
    for vc in (64, 0):
        torch.manual_seed(17 + vc)
        layer = GroupVerticalSelfAttentionLayer(128, vc, context_dim=256)
        x = torch.randn((10, h1 * w1, 128), generator=g)
        args = (x, (h1, w1)) + ((torch.randn((2, h1, w1, 256), generator=g),) if vc else ())
        reset_launch_counts()
        got, want = both(layer, *args)
        keys = dict(launch_shapes)
        key = ("window_attention", *GROUP_SHAPE, 8, "torch.bfloat16", "mma")
        if keys != {key: 1}:
            raise AssertionError(f"group layer (vert_c_dim {vc}): launches {keys}")
        scale = max(1.0, float(want.abs().max()))
        err = float((got - want).abs().max())
        if not err <= GROUP_LAYER_TOL * scale:
            raise AssertionError(f"group layer (vert_c_dim {vc}): {err} > "
                                 f"{GROUP_LAYER_TOL} x {scale}")
        out[f"group_vertical_layer_vert_c_{vc}"] = dict(
            max_abs_err=err, tol=GROUP_LAYER_TOL * scale, mean_abs_err=float(
                (got - want).abs().mean()), moved_input_by=float((want - x).abs().max()))
    x = torch.randn((2, h1, w1, 256), generator=g) * 4
    for name, module in (("sine", tpe.PositionEncodingSine(256)),
                         ("linear", tpe.LinearPositionEncoding()),
                         ("learned", tpe.LearnedPositionEncoding(256))):
        got, want = both(module, x.to(bf16).float())  # the card's input, exactly
        over = float(((got - want).abs() / (2.0 ** -7 * (1 + want.abs()))).max())
        if not over <= 1.0:
            raise AssertionError(f"position encoding {name}: {over} of its bound")
        out[f"position_{name}"] = dict(largest_err_over_its_bound=over,
                                       max_abs_err=float((got - want).abs().max()))
    _emit(dict(phase="ff_variant_modules", card=card, **out))
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------ phase 16: training the FF-RAFT variants
VARIANT_STEPS = 6  # step 4 counted
# the attention front end's batch: 3, the largest whose step fits under
# FIT_SHARE of the card's memory (one step's peak at B=1 and 2, about 17 GiB
# a sample, reckoned B=4 at 68.6 of 79.18 GiB: PERF.md); its step's
# peak is held under that share
ATTENTION_BATCH = 3
FIT_SHARE = 0.85
DROPOUT_P = 0.2
AGREE_CROP = (184, 248)
ATTENTION_AGREE_CROP = (96, 128)  # its UNet: about 30 TFLOP a pair at 1024x436 in f32


def _small_fnet_train_shapes(b: int) -> list:
    """RAFT-S's SmallEncoder fnet over both frames of a B-sample chairs batch:
    its instance-norm shapes (NHWC), the stem's, layer 1's and the
    bottlenecks' inner widths."""
    n, (h2, w2), (h4, w4), (h8, w8) = 2 * b, (TH // 2, TW // 2), (TH // 4, TW // 4), (TH // 8,
                                                                                      TW // 8)
    return [(n, h2, w2, 32), (n, h2, w2, 8), (n, h2, w2, 16), (n, h4, w4, 16), (n, h4, w4, 64),
            (n, h4, w4, 24), (n, h8, w8, 24), (n, h8, w8, 96)]


def raft_variant_train_rows(torch, dev) -> dict:
    """Phase 16's new (kernel, shape) keys, held and timed as phase 9 holds
    its rows, each with its Function's backward: G at radius 3 with N = 96
    at B=10 (RAFT-S's and FF-RAFT-S's motion encoder, Q = 28,520); G at
    ALT_CORR's training chunks at the chairs crop (2048 queries and the
    tail of 804 a sample row, coordinates (10, 1, n, 2), the fixture's
    convc1) with A at the same chunks (their backward launches it); C1
    and C2 (both forms) at RAFT-S's SmallEncoder training shapes (B=20,
    both frames) -> kernel name -> rows."""
    from focusflow_official_tpu_torch.compat.weights import load_npz
    from focusflow_official_tpu_torch.kernels import lookup as kl
    from focusflow_official_tpu_torch.kernels import lookup_fold as klf
    from focusflow_official_tpu_torch.ops.coords import coords_grid
    from focusflow_official_tpu_torch.ops.corr import corr_pyramid

    g = torch.Generator(device=dev).manual_seed(16)
    bf16 = torch.bfloat16
    h1, w1 = TH // 8, TW // 8
    q = h1 * w1
    sd = load_npz(FIXTURE)
    wc = sd["flow_net.update_block.encoder.convc1.weight"].reshape(256, 324).to(dev, bf16)
    bc = sd["flow_net.update_block.encoder.convc1.bias"].to(dev, bf16)
    w96 = (torch.randn((96, 196), generator=g, device=dev) / 14).to(bf16)
    b96 = (torch.randn((96,), generator=g, device=dev) * 0.1).to(bf16)
    grid = coords_grid(TB, h1, w1, device=dev)
    specs = [("RAFT-S motion encoder train, radius 3", q, 3, w96, b96,
              grid + torch.randn(grid.shape, generator=g, device=dev) * 8)]
    starts = dict(zip(_alt_chunks(q), range(0, q, ALT_CHUNK)))
    for n in _alt_chunks(q):
        c = grid.reshape(TB, 1, q, 2)[:, :, starts[n]:starts[n] + n]
        specs.append((f"ALT_CORR train, {n} of {q} queries", n, 4, wc, bc,
                      c + torch.randn(c.shape, generator=g, device=dev) * 8))
    rows = {"lookup": [], "lookup_fold": []}
    for label, n, r, w, bias, coords in specs:
        coords = coords.contiguous()
        levels = corr_pyramid(torch.randn((TB, n, h1, w1), generator=g, device=dev), 4, bf16)
        shape = f"{label}: levels {[tuple(lv.shape) for lv in levels]} bf16"
        if label.startswith("ALT_CORR"):  # A: launched in the chunk's backward
            row = _lookup_row(torch, levels, coords, r, f"lookup {label}")
            win = row.pop("out")
            cot = torch.randn(win.shape, generator=g, device=dev).to(bf16)
            row.update(shape=shape, **_backward_check(
                torch, lambda *lv: kl.lookup(lv, coords, r),
                lambda *lv: kl.lookup_plain(lv, coords, r), levels, cot,
                lambda: kl.lookup_vjp(levels, coords, r, cot), f"lookup {label}"))
            rows["lookup"].append(row)
            del win, cot
        row = _lookup_fold_row(torch, levels, coords, r, w.contiguous(), bias, label)
        cot = torch.randn((*coords.shape[:3], w.shape[0]), generator=g, device=dev).to(bf16)
        row.update(shape=f"{shape}, {tuple(w.shape)} weight", **_backward_check(
            torch, lambda w_, b_, *lv: klf.lookup_fold(lv, coords, r, w_, b_),
            lambda w_, b_, *lv: klf.lookup_fold_plain(lv, coords, r, w_, b_),
            [w, bias, *levels], cot, lambda: klf.lookup_fold_vjp(levels, coords, r, w, cot),
            label))
        rows["lookup_fold"].append(row)
        del levels, cot
        torch.cuda.empty_cache()
    rows.update(_instance_norm_rows(torch, g, dev, _small_fnet_train_shapes(TB), backward=True))
    _emit_train_rows("raft_variant_train", rows)
    torch.cuda.empty_cache()
    return rows


def _variant_train_cfg(yaml: str, model: dict, train: dict, steps: int, weights):
    """The YAML with MODEL and TRAIN keys set, cut to `steps` steps at B=10
    and the chairs crop, from `weights` (a callable of the model's config
    -> (the .npz path, what `_raft_variant_weights` made)) -> (the YAML's
    node, the weights' path, what was made)."""
    from focusflow_official_tpu_torch.config import config_from_yaml, load_yaml_config

    cfg = load_yaml_config(yaml)
    for k, v in model.items():
        setattr(cfg.MODEL, k, v)
    for k, v in train.items():
        setattr(cfg.TRAIN, k, v)
    cfg.TRAIN.NUM_STEPS, cfg.TRAIN.BATCH_SIZE, cfg.TRAIN.IMAGE_SIZE = steps, TB, [TH, TW]
    cfg.MODEL.LOAD_MODULE = None
    cfg.GLOBAL.NUM_WORKERS = 2
    path, made = weights(config_from_yaml(cfg))
    cfg.MODEL.PRETRAIN = path
    return cfg, path, made


def _fixed_batch(torch, data, device, rows=None) -> dict:
    """The first `rows` samples of `data` (all by default) as one batch on
    `device`."""
    n = len(data) if rows is None else rows
    return {k: torch.as_tensor(np.stack([data[i][k] for i in range(n)])).to(device)
            for k in ("image1", "image2", "mask1", "mask2", "flow", "valid")}


def _one_step_peak(torch, cfg, weights: str, batch: dict, seen: dict) -> dict:
    """One bf16 `train_step` of the YAML's model from `weights` on `batch`
    (noise on, as the trainer) with the peak allocated memory reset just
    before -> its loss and peak GiB; the launches go into `seen`."""
    from focusflow_official_tpu_torch.kernels import launch_shapes, reset_launch_counts
    from focusflow_official_tpu_torch.train.loop import build_optimizer, train_step

    dev = torch.device("cuda", 0)
    model, loss_fn, iters = _trained_model(torch, cfg, weights, dev, "bfloat16", True)
    opt = build_optimizer(model, 1e-5)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda _: 1.0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    m = train_step(model, opt, sched, loss_fn, batch, iters=iters, dtype=torch.bfloat16,
                   noise=torch.Generator(device=dev).manual_seed(0))
    loss = float(m["loss"])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for key, n in launch_shapes.items():
        seen[key] = seen.get(key, 0) + n
    del model, opt, m
    torch.cuda.empty_cache()
    if not np.isfinite(loss):
        raise AssertionError(f"one-step peak: loss {loss}")
    return dict(loss=loss, peak_gib=peak)


def _param_grads(torch, cfg, weights: str, batch: dict, dtype) -> tuple:
    """One forward and backward of the YAML's model from `weights` on the
    card on `batch`, no noise (`forward_backward`; f32 with TF32 off) ->
    (loss, {name: gradient on the CPU})."""
    from focusflow_official_tpu_torch.train.loop import forward_backward

    model, loss_fn, iters = _trained_model(
        torch, cfg, weights, torch.device("cuda", 0),
        {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype], True)
    loss, _ = forward_backward(model, loss_fn, batch, iters=iters, dtype=dtype)
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().float().cpu()
             for n, p in model.named_parameters()}
    out = float(loss.detach())
    del model, loss
    torch.cuda.empty_cache()
    return out, grads


def _alt_corr_gates(torch, path: str, cfg, weights: str, data, seen: dict) -> dict:
    """ALT_CORR's own gates: its f32 step (TF32 off) on the fixed batch
    against the materialized f32 step on the same weights (loss within
    1e-5, gradient cosine >= 0.99999, each tensor within 1e-4 of its
    largest; a gradient of rounding alone, at most 1e-7 of the model's
    largest, within 1e-7 of that); one bf16 step's peak memory beside the
    materialized step's at B=10 (ALT_CORR's no higher) and at 1920x1080,
    B=1 (ALT_CORR's lower by at least the f32 level-0 volume, Q^2 x 4
    bytes, Q = 135 x 240)."""
    import copy

    from focusflow_official_tpu_torch.data import synthetic as sy

    from focusflow_official_tpu_torch.kernels import launch_counts, reset_launch_counts

    mat = copy.deepcopy(cfg)
    mat.MODEL.ALT_CORR = False
    dev = torch.device("cuda", 0)
    batch = _fixed_batch(torch, data, dev)
    reset_launch_counts()
    alt_loss, alt_g = _param_grads(torch, cfg, weights, batch, torch.float32)
    f32_walk = {k: launch_counts[k] for k in ("pyramid", "corr_levels")}
    if not (f32_walk["pyramid"] > 0 and f32_walk["corr_levels"] == 0):
        raise AssertionError(f"{path}: the f32 walk's chunks launched {f32_walk}, not P alone")
    mat_loss, mat_g = _param_grads(torch, mat, weights, batch, torch.float32)
    names = sorted(mat_g)
    flat_a = torch.cat([alt_g[n].flatten() for n in names])
    flat_m = torch.cat([mat_g[n].flatten() for n in names])
    top = float(flat_m.abs().max())
    worst = 0.0
    for n in names:
        own = float(mat_g[n].abs().max())
        bound = 1e-7 * top if own <= 1e-7 * top else 1e-4 * own
        worst = max(worst, float((alt_g[n] - mat_g[n]).abs().max()) / bound)
    gates = dict(f32_loss=alt_loss, materialized_f32_loss=mat_loss, f32_walk_launches=f32_walk,
                 f32_loss_rel=abs(alt_loss - mat_loss) / abs(mat_loss),
                 f32_grad_cosine=_cosine(torch, flat_a, flat_m),
                 worst_tensor_over_its_bound=worst)
    if not (gates["f32_loss_rel"] <= 1e-5 and gates["f32_grad_cosine"] >= 0.99999
            and worst <= 1.0):
        raise AssertionError(f"{path}: f32 step against the materialized step: {gates}")
    del alt_g, mat_g, flat_a, flat_m
    batch = _fixed_batch(torch, data, dev)
    gates["chairs_b10"] = dict(alt_corr=_one_step_peak(torch, cfg, weights, batch, seen),
                               materialized=_one_step_peak(torch, mat, weights, batch, seen))
    peaks = gates["chairs_b10"]
    if peaks["alt_corr"]["peak_gib"] > peaks["materialized"]["peak_gib"]:
        raise AssertionError(f"{path}: ALT_CORR's step peak above the materialized one's: "
                             f"{gates['chairs_b10']}")
    del batch
    hd = sy.chairs_layout(6, n=1, h=FULL_HD[0], w=FULL_HD[1])
    batch = _fixed_batch(torch, hd, dev)
    q = _grid(*FULL_HD)[0] * _grid(*FULL_HD)[1]
    volume = q * q * 4 / 2 ** 30
    runs = dict(alt_corr=_one_step_peak(torch, cfg, weights, batch, seen),
                materialized=_one_step_peak(torch, mat, weights, batch, seen))
    runs["saved_gib"] = runs["materialized"]["peak_gib"] - runs["alt_corr"]["peak_gib"]
    runs["f32_level0_gib"] = volume
    gates["full_hd_b1"] = runs
    if not runs["saved_gib"] >= volume:
        raise AssertionError(f"{path}: at 1920x1080 ALT_CORR saves {runs['saved_gib']} GiB, "
                             f"less than the f32 level 0's {volume}")
    del batch
    torch.cuda.empty_cache()
    return gates


def _variant_train_specs() -> dict:
    """path -> what phase 16 drives: the YAML and the MODEL and TRAIN keys
    it sets, the steps, the launches every step must make, the agreement
    crop (None: no agreement gates) and the path's own gates."""
    cce = {"lookup_fold": ITERS, "lookup": ITERS, "in_stats": 30, "in_normalize": 30}
    plain = {"lookup_fold": ITERS, "lookup": ITERS, "in_stats": 15, "in_normalize": 15}
    front = dict(FUSION_CHANNEL=256)
    return {
        "alt_corr_train": dict(
            yaml=TRAIN_YAML, model=dict(ALT_CORR=True), train={}, steps=TRAIN_STEPS,
            want={"lookup_fold": 2 * ITERS, "lookup": 2 * ITERS, "corr_levels": 4 * ITERS,
                  "in_stats": 30, "in_normalize": 30}, agree=AGREE_CROP, gates="alt_corr"),
        "raft_s_train": dict(
            yaml=RAFT_CTK_YAML, model=dict(SMALL=True), train={}, steps=VARIANT_STEPS,
            want={"lookup_fold": ITERS, "lookup": ITERS, "in_stats": 21, "in_normalize": 21},
            agree=AGREE_CROP, gates=None),
        "ff_raft_s_train": dict(
            yaml=TRAIN_YAML, model=dict(SMALL=True), train={}, steps=VARIANT_STEPS, want=cce,
            agree=AGREE_CROP, gates=None),
        # the front ends' agreement steps run on fresh weights, as phase 12's
        # plain RAFT: behind a front end the fixture's RAFT saturates, and
        # the bf16 gradient sat 0.81 (attention), 0.82 (conv) and 0.84 (conv
        # under FREEZE_BN) from the f32 one in cosine on the phase's
        # weights (f32 card against the CPU: 0.99990, 0.999992, 0.99997).
        # The attention front end's bf16 gradient is held to a cosine of
        # 0.9, not 0.99: on fresh weights it sat 0.953 from the f32 one,
        # and the JAX package's own bf16 step sits 0.960 from its f32 step
        # on the same weights (CPU, 96x128, B=2, 12 refinements), the cnet
        # stem's gradient 60% off in both: the front end's output carries
        # its variation under a per-channel offset that bf16 activations
        # round away (batch norms normalising in f32 leave it at 0.968)
        "raft_attention_train": dict(
            yaml=TRAIN_YAML, model=dict(front, FUSION="attention"),
            train=dict(SEPARATE_LR=True), steps=VARIANT_STEPS, want=plain,
            agree=ATTENTION_AGREE_CROP, agree_fresh=True, bf16_cosine=0.9, gates="fit"),
        "raft_conv_train": dict(
            yaml=TRAIN_YAML, model=dict(front, FUSION="conv"), train=dict(SEPARATE_LR=True),
            steps=VARIANT_STEPS, want=plain, agree=AGREE_CROP, agree_fresh=True, gates=None),
        # the same past the chairs stage: FREEZE_BN on the RAFT core only
        "raft_conv_freeze_train": dict(
            yaml=TRAIN_YAML, model=dict(front, FUSION="conv"),
            train=dict(SEPARATE_LR=True, STAGE="things"), steps=VARIANT_STEPS, want=plain,
            agree=AGREE_CROP, agree_fresh=True, gates="freeze_bn"),
        "ff_raft_dropout_train": dict(
            yaml=TRAIN_YAML, model=dict(DROPOUT=DROPOUT_P), train={}, steps=3, want=cce,
            agree=None, gates="dropout"),
    }


def variant_train_phase(torch, card: str, held: set, path: str, phase9: dict) -> tuple:
    """Phase 16, one path: the trainer's body (`cli/train.py::train`) on the
    path's YAML and keys (`_variant_train_specs`) at full width, B=10 (the
    attention front end: ATTENTION_BATCH, its step's peak memory held
    under FIT_SHARE of the card), 368x496, 12 refinements, noise, AdamW + OneCycle,
    bf16, on phase 9's fixed batch, from `_raft_variant_weights` (the main
    path's config: the fixture itself). Gates: finite loss and gradient
    norm at every step; every step's launches; but for dropout, on two
    samples without noise, the f32 step (TF32 off) against the port's f32
    CPU step (1e-4, cosine 0.9999) and the bf16 step against the f32 step
    (2%, cosine 0.99 or the path's `bf16_cosine`; the front ends' on fresh
    weights, `agree_fresh`); the path's own (ALT_CORR: `_alt_corr_gates` and
    phase 9's descent gate; FREEZE_BN: the front end's running statistics
    moved, `flow_net`'s did not; dropout: the kept share of the drawn
    channels within 4 sigma of 1 - p). The variants have no trained
    weights, so they have no descent gate; ALT_CORR starts from the
    fixture and has phase 9's. Every (kernel, shape) launched that no row holds (`held`) is held once
    against its plain version. -> ((counts, launches by shape key) of the
    counted step, the path's line, kernel rows of its own: phase 9's at
    the attention front end's batch, else none)."""
    import copy

    from focusflow_official_tpu_torch.cli.train import train as run_trainer
    from focusflow_official_tpu_torch.data import synthetic as sy
    from focusflow_official_tpu_torch.kernels import (
        launch_counts, launch_shapes, reset_launch_counts)
    from focusflow_official_tpu_torch.train import loop

    t_phase = time.perf_counter()
    spec = _variant_train_specs()[path]
    dev = torch.device("cuda", 0)
    steps = spec["steps"]
    counted = {TRAIN_STEPS: COUNTED_STEP, VARIANT_STEPS: 4, 3: 2}[steps]
    npz = os.path.join(OUT_DIR, f"{path}_weights.npz")
    cfg, weights, made = _variant_train_cfg(
        spec["yaml"], spec["model"], spec["train"], steps,
        lambda model_cfg: (npz, _raft_variant_weights(torch, model_cfg, npz)))
    seen = {}
    data = sy.chairs_layout(5, n=TB, h=TH, w=TW)
    rows = {}
    if spec["gates"] == "fit":
        cfg.TRAIN.BATCH_SIZE = ATTENTION_BATCH
        data = sy.InMemoryDataset(data.samples[:ATTENTION_BATCH])
        # phase 9's rows at this batch
        rows = train_kernel_rows(torch, dev, ATTENTION_BATCH, path)
        held = held | {r["key"] for rs in rows.values() for r in rs}
    batch = int(cfg.TRAIN.BATCH_SIZE)
    freeze = spec["gates"] == "freeze_bn"
    if spec["gates"] == "alt_corr":
        before = _fixed_batch_loss(torch, _trained_model(torch, cfg, weights, dev, "float32")[0],
                                   cfg, data)
    st = dict(per_step=[], metrics=[])
    drawn = []
    draw = loop.draw_dropout

    def record(model, gen, n, **shard):
        masks = draw(model, gen, n, **shard)
        drawn.extend(m.detach().flatten().cpu() for m in masks.values())
        return masks

    def on_step(step, metrics):
        st["per_step"].append({k: v for k, v in launch_counts.items() if v})
        st["metrics"].append(metrics)
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"{path} step {step}: metrics {metrics} not finite")
        if step == counted:
            st["counted"] = (dict(launch_counts), dict(launch_shapes))
            st["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        for key, n in launch_shapes.items():
            seen[key] = seen.get(key, 0) + n
        reset_launch_counts()

    def validate(model):  # once, after the last step
        if spec["gates"] == "alt_corr":
            st["after"] = _fixed_batch_loss(torch, model, cfg, data)
        return {}

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    loop.draw_dropout = record
    try:
        result = run_trainer(cfg, data, validate=validate,
                             log_dir=os.path.join(OUT_DIR, "train_runs"), device="cuda",
                             compute_dtype="bfloat16", val_freq=10 ** 9, on_step=on_step)
    finally:
        loop.draw_dropout = draw
    want = {k: v for k, v in spec["want"].items() if v}
    for i, c in enumerate(st["per_step"], start=1):
        if c != want:
            raise AssertionError(f"{path} step {i}: launches {c} != {want}")
    out = dict(phase="raft_variant_train", path=path, card=card,
               yaml=os.path.relpath(spec["yaml"], ROOT), model=spec["model"], train=spec["train"],
               batch=batch, crop=[TH, TW], iters=ITERS, dtype="bfloat16", steps=steps,
               losses=[m["loss"] for m in st["metrics"]],
               grad_norms=[m["grad_norm"] for m in st["metrics"]], launches_per_step=want,
               weights={k: dict(count=len(v), first=v[:2]) for k, v in made.items()})

    if spec["gates"] == "fit":
        card_gib = torch.cuda.get_device_properties(dev).total_memory / 2 ** 30
        out["batch_fit"] = dict(batch=batch, peak_gib=st["peak_gib"], card_gib=card_gib,
                                share=FIT_SHARE)
        if not st["peak_gib"] <= FIT_SHARE * card_gib:
            raise AssertionError(f"{path}: B={batch} peaks at {st['peak_gib']} GiB, over "
                                 f"{FIT_SHARE} of {card_gib}")
    if spec["gates"] == "alt_corr":
        out["descent"] = dict(_descent_gate(path, before, st["after"]),
                              phase9_ratio=phase9["descent"]["ratio"])
        out["alt_corr"] = _alt_corr_gates(torch, path, cfg, weights, data, seen)
    if freeze:
        with np.load(weights) as a, np.load(result["export"]) as b_:
            stats = [k for k in a.files if k.startswith("batch_stats/")]
            moved = {k: not np.array_equal(a[k], b_[k]) for k in stats}
        front = [k for k in stats if k.startswith("batch_stats/fusion_layer/")]
        out["freeze_bn"] = dict(front_end_stats=len(front), front_end_moved=sum(
            moved[k] for k in front), flow_net_stats=len(stats) - len(front),
            flow_net_moved=sum(moved[k] for k in stats if k not in front))
        if not (front and all(moved[k] for k in front)
                and not any(moved[k] for k in stats if k not in front)):
            raise AssertionError(f"{path}: FREEZE_BN moved {out['freeze_bn']}")
    if spec["gates"] == "dropout":
        keep = torch.cat(drawn).float()
        share, sigma = float(keep.mean()), (DROPOUT_P * (1 - DROPOUT_P) / keep.numel()) ** 0.5
        out["dropout"] = dict(p=DROPOUT_P, channels=keep.numel(), kept_share=share, sigma=sigma,
                              off_by_sigmas=abs(share - (1 - DROPOUT_P)) / sigma)
        if not abs(share - (1 - DROPOUT_P)) <= 4 * sigma:
            raise AssertionError(f"{path}: kept share {out['dropout']}")
    if spec["agree"]:
        ch, cw = spec["agree"]
        two = {k: torch.as_tensor(np.stack([data[i][k][:ch, :cw] for i in range(2)]))
               for k in ("image1", "image2", "mask1", "mask2", "flow", "valid")}
        acfg = copy.deepcopy(cfg)
        if spec.get("agree_fresh"):  # PyTorch's initialisation under seed 0
            from focusflow_official_tpu_torch.cli.train import build_model
            from focusflow_official_tpu_torch.compat.weights import params_to_jax

            torch.manual_seed(0)
            weights = os.path.join(OUT_DIR, f"{path}_fresh.npz")
            np.savez(weights, **params_to_jax(build_model(acfg, "float32")[1].state_dict()))
        cpu_loss, cpu_grad = _two_sample_grads(torch, acfg, weights, two, "cpu", torch.float32,
                                               freeze_bn=True)
        reset_launch_counts()
        f32_loss, f32_grad = _two_sample_grads(torch, acfg, weights, two, dev, torch.float32,
                                               freeze_bn=True)
        bf_loss, bf_grad = _two_sample_grads(torch, acfg, weights, two, dev, torch.bfloat16,
                                             freeze_bn=True)
        for key, n in launch_shapes.items():
            seen[key] = seen.get(key, 0) + n
        agree = dict(cpu_f32_loss=cpu_loss, card_f32_loss=f32_loss, card_bf16_loss=bf_loss,
                     f32_loss_rel=abs(f32_loss - cpu_loss) / abs(cpu_loss),
                     f32_grad_cosine=_cosine(torch, f32_grad, cpu_grad),
                     bf16_loss_rel=abs(bf_loss - f32_loss) / abs(f32_loss),
                     bf16_grad_cosine=_cosine(torch, bf_grad, f32_grad),
                     f32_card_flags="TF32 off for the script",
                     crop=[ch, cw], weights=os.path.relpath(weights, ROOT))
        agree["bf16_grad_cosine_bound"] = spec.get("bf16_cosine", 0.99)
        out["agreement"] = agree
        if not (agree["f32_loss_rel"] <= 1e-4 and agree["f32_grad_cosine"] >= 0.9999
                and agree["bf16_loss_rel"] <= 0.02
                and agree["bf16_grad_cosine"] >= agree["bf16_grad_cosine_bound"]
                and torch.isfinite(bf_grad).all()):
            raise AssertionError(f"{path} training agreement: {agree}")
        del cpu_grad, f32_grad, bf_grad
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(17)
    new = sorted((k for k in seen if k not in held), key=str)
    out["new_shapes_held"] = [dict(_hold_shape(torch, g, dev, k), launches=seen[k]) for k in new]
    out["phase_seconds"] = time.perf_counter() - t_phase
    _emit(out)
    torch.cuda.empty_cache()
    return st["counted"], out, rows


def _hold_shape(torch, g, dev, key: tuple) -> dict:
    """One untimed launch of a kernel at the shape of a launch key, on
    seeded inputs, against its plain version, with the tolerance of the
    kernel phase's row for that kernel. The launch must count under the
    same key (the same shape, type, entry and plan)."""
    from focusflow_official_tpu_torch.kernels import attention as ka
    from focusflow_official_tpu_torch.kernels import fold as kf
    from focusflow_official_tpu_torch.kernels import instance_norm as kin
    from focusflow_official_tpu_torch.kernels import local_corr as klc
    from focusflow_official_tpu_torch.kernels import lookup as kl
    from focusflow_official_tpu_torch.kernels import lookup_fold as klf
    from focusflow_official_tpu_torch.kernels import window_attention as kw
    from focusflow_official_tpu_torch.ops.coords import coords_grid

    name = key[0]
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)
    dtype_of = lambda text: getattr(torch, text.split(".")[1])  # "torch.bfloat16"
    over = None

    def rel_tol(want, f32_rel, bf16_rel):
        return (f32_rel if want.dtype == torch.float32 else bf16_rel) * max(
            1.0, float(want.float().abs().max()))

    if name in ("lookup", "lookup_fold"):
        b, q = key[1], key[2]
        if name == "lookup":
            dims, r, dt = key[3:-1], 4, dtype_of(key[-1])
        else:
            dims, r, n, dt = key[3:-6], key[-6], key[-5], dtype_of(key[-4])
        levels = [rnd(b, q, hl, wl).to(dt) for hl, wl in zip(dims[::2], dims[1::2])]
        # q queries over level 0 (an ALT_CORR chunk: fewer than its cells)
        coords = (coords_grid(b, dims[0], dims[1], device=dev).reshape(b, 1, -1, 2)[:, :, :q]
                  + rnd(b, 1, q, 2) * 8).contiguous()
        if name == "lookup":  # bit-equal in the levels' type, as its row
            call = lambda: kl.lookup(levels, coords, r)
            want, tol = kl.lookup_plain(levels, coords, r), 0.0
        else:
            k = (2 * r + 1) ** 2 * len(levels)
            w = (rnd(n, k) / k ** 0.5).to(dt).contiguous()
            bias = (rnd(n) * 0.1).to(dt)
            call = lambda: klf.lookup_fold(levels, coords, r, w, bias)
            want = klf.lookup_fold_plain(levels, coords, r, w, bias)
            tol = rel_tol(want, 1e-4, 2.0 ** -7)
    elif name == "fold":
        m, k, n, dt = key[1], key[2], key[3], dtype_of(key[4])
        a, w, bias = rnd(m, k).to(dt), (rnd(n, k) / k ** 0.5).to(dt), (rnd(n) * 0.1).to(dt)
        call = lambda: kf.fold(a, w, bias)
        want = kf.fold_plain(a, w, bias)
        tol = rel_tol(want, 1e-4, 2.0 ** -7)
    elif name == "in_stats":
        x = (rnd(*key[1:5]) * 3 + 1).to(dtype_of(key[5]))
        call = lambda: torch.cat(kin.instance_norm_stats(x))
        want = torch.cat(kin.stats_plain(x))
        tol = 1e-4 * (1.0 + float(want.abs().max()))
    elif name == "in_normalize":
        x = (rnd(*key[1:5]) * 3 + 1).to(dtype_of(key[5]))
        mean, inv = kin.stats_plain(x)
        res = rnd(*key[1:5]).to(x.dtype) if key[-1] == "residual" else None
        call = lambda: kin.instance_norm_apply(x, mean, inv, True, res)
        want, tol = kin.apply_plain(x, mean, inv, True, res), 0.0  # bit-equal, as its row
    elif name == "local_corr":
        b, h, w, c, r, dt = key[1], key[2], key[3], key[4], key[5], dtype_of(key[6])
        f1, f2 = rnd(b, h, w, c).to(dt), rnd(b, h, w, c).to(dt)
        slope = 0.1 if key[-1] == "leaky_relu" else None
        call = lambda: klc.local_corr(f1, f2, r, negative_slope=slope)
        want = klc.local_corr_plain(f1, f2, r, slope)
        tol = (1e-5 * max(1.0, float(want.abs().max())) if dt == torch.float32
               else _bf16_ulp(float(want.float().abs().max())))
    elif name in ("attention", "window_attention"):
        if name == "attention":
            b, n, m, c, cv, heads, dt = key[1:8]
            dt = dtype_of(dt)
            q, k, v = rnd(b, n, c).to(dt), rnd(b, m, c).to(dt), rnd(b, m, cv).to(dt)
            scale = (c // heads) ** -0.5
            call = lambda: ka.small_kv_attention(q, k, v, heads, scale)
            want = ka.small_kv_attention_plain(q, k, v, heads, scale)
            bound_of = ka.bf16_bound
        else:
            b, hp, wp, c, heads, dt = key[1:7]
            dt = dtype_of(dt)
            q, k, v = (rnd(b, hp, wp, c).to(dt) for _ in range(3))
            scale = (c // heads) ** -0.5
            call = lambda: kw.window_attention(q, k, v, 7, heads, scale)
            want = kw.window_attention_plain(q, k, v, 7, heads, scale)
            bound_of = kw.bf16_bound
        if key[-1] == "mma":  # held at every output to the entry's bound
            got = call()
            diff = (got.float() - want.float()).abs()
            bound = bound_of(want, q, k, v, heads, scale)
            over = float((diff / bound).max())
            if not over <= 1.0:
                raise AssertionError(f"{key}: |kernel - plain| is {over} of its bound")
            tol = float(bound.flatten()[diff.argmax()])
            del diff, bound, got
        else:  # f32 sums in another order; the staged bf16 entry: one bf16 ulp
            tol = rel_tol(want, 1e-5, 2.0 ** -7)
    else:
        raise AssertionError(f"no check for kernel {name!r} at {key}")
    got, got_key = _launch_key(call)
    if got_key != key:
        raise AssertionError(f"held {key} but the launch counted {got_key}")
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if tol == 0.0 and not torch.equal(got, want):
        raise AssertionError(f"{key}: not bit-equal to the plain version ({err})")
    _check(f"{key}", err, tol)
    return dict(key=list(key), max_abs_err=err, tol=tol, largest_err_over_its_bound=over)


def _protocol_flow(torch, model, sample: dict, iters: int, pad_mode, device):
    """The protocol's forward of one sample (`train/evaluate.py`): padded as
    the dataset's validation pads (not at all for chairs), unpadded ->
    (flow (H, W, 2) numpy, its frame metrics: AEPE, keypoint EPE)."""
    from focusflow_official_tpu_torch.ops.padding import InputPadder
    from focusflow_official_tpu_torch.predict import eval_forward
    from focusflow_official_tpu_torch.train.evaluate import frame_metrics

    ims = [torch.as_tensor(sample[k], device=device)[None]
           for k in ("image1", "image2", "mask1", "mask2")]
    padder = InputPadder(ims[0].shape, mode=pad_mode or "sintel")
    flow = eval_forward(model, *(padder.pad(*ims) if pad_mode else ims), iters=iters)[0]
    flow = (padder.unpad(flow) if pad_mode else flow)[0].float()
    m = frame_metrics(flow, torch.as_tensor(sample["flow"], device=device),
                      torch.as_tensor(sample["valid"], device=device), ims[2][0],
                      sparse=pad_mode == "kitti").cpu().numpy()
    return flow.cpu().numpy(), dict(aepe=float(m[3]), keypoint_epe=float(m[2]))


def _epe_gate(card: dict, cpu: dict) -> dict:
    """The card's AEPE and keypoint EPE of one pair within 0.05 max(AEPE of
    the f32 CPU run, 1) px of the CPU run's."""
    limit = 0.05 * max(cpu["aepe"], 1.0)
    deltas = {k: abs(card[k] - cpu[k]) for k in ("aepe", "keypoint_epe")}
    if not all(d < limit for d in deltas.values()):
        raise AssertionError(f"card {card} vs f32 CPU {cpu}: limit {limit} px")
    return dict(card=card, cpu_f32=cpu, limit_px=limit, delta=deltas)


def eval_phase(torch, card: str, held: set) -> dict:
    """The evaluation entry point on the card: the validation protocol
    (`train/evaluate.py`) on in-memory chairs, Sintel and KITTI layouts of
    the multi-pixel affine input (`data/synthetic.py`), bf16.

    - FF-RAFT (the trained fixture, full width): chairs at 12 refinements,
      Sintel clean and final and KITTI (mixed sizes, per-shape padding) at
      32; `FlowPredictor.sequence` over the Sintel scene with and without
      warm start; `create_kitti_submission` (the KITTI PNG codec needs cv2:
      without it, a clear ImportError is the expected outcome).
    - FF-FlowFormer (encoder_depth 1) and FF-PWCNet: chairs.

    Gates: every metric finite; the first pair of each FF-RAFT layout, and
    the second Sintel pair from the same `flow_init`, track the port's f32
    CPU run (`_gates`' bounds, and AEPE and keypoint EPE within 0.05
    max(AEPE, 1) px); each family launches its kernels. Every (kernel,
    shape) the phase launched that the kernel phase did not hold (`held`)
    is held here against its plain version (`_hold_shape`), untimed. The
    phase is not one of the kernels line's drives."""
    from focusflow_official_tpu_torch.data import synthetic as sy
    from focusflow_official_tpu_torch.data.io import read_flow_kitti
    from focusflow_official_tpu_torch.kernels import (
        launch_counts, launch_shapes, reset_launch_counts)
    from focusflow_official_tpu_torch.models import FFPWCNetConfig, FlowFormerConfig
    from focusflow_official_tpu_torch.ops.coords import forward_interpolate
    from focusflow_official_tpu_torch.predict import FlowPredictor
    from focusflow_official_tpu_torch.train import evaluate as tev
    from focusflow_official_tpu_torch.train.submission import create_kitti_submission

    dev = torch.device("cuda", 0)
    chairs = sy.chairs_layout(0)
    sintel, scene = sy.sintel_layout(1)
    kitti = sy.kitti_layout(2)
    bf16 = torch.bfloat16
    raft = FlowPredictor(_raft_cfg(), FIXTURE, device="cuda", dtype=bf16)
    raft_cpu = FlowPredictor(_raft_cfg(), FIXTURE, device="cpu", dtype=torch.float32)
    shapes, out = {}, {}

    class ZeroFlow(torch.nn.Module):
        def forward(self, image1, image2, mask1, mask2):
            return torch.zeros(image1.shape[:3] + (2,), device=image1.device)

    def note_shapes():
        for key, n in launch_shapes.items():
            shapes[key] = shapes.get(key, 0) + n

    def drive(label, validate, model, kernels, **kw):
        reset_launch_counts()
        metrics = validate(model, **kw)
        counts = {k: v for k, v in launch_counts.items() if v}
        note_shapes()
        if not all(counts.get(k, 0) > 0 for k in kernels):
            raise AssertionError(f"{label}: launches {counts}, expected each of {kernels}")
        data = {k: v for k, v in kw.items() if k in ("dataset", "datasets")}
        zero = validate(ZeroFlow(), device=dev, **data)
        if not np.isfinite(list(metrics.values())).all():
            raise AssertionError(f"{label}: metrics {metrics} not finite")
        out[label] = dict(metrics=metrics, zero_flow=zero, iters=kw.get("iters"),
                          launches=counts)
        _emit(dict(phase="eval", dataset=label, card=card, dtype="bfloat16", **out[label]))

    raft_kernels = ("lookup_fold", "in_stats", "in_normalize")
    drive("ff_raft chairs", tev.validate_chairs, raft.model, raft_kernels, dataset=chairs,
          iters=12)
    drive("ff_raft sintel", tev.validate_sintel, raft.model, raft_kernels, datasets=sintel,
          iters=32)
    drive("ff_raft kitti", tev.validate_kitti, raft.model, raft_kernels, dataset=kitti, iters=32)

    # the first pair of each layout against the f32 CPU run on the same inputs
    agree = {}
    for label, sample, iters, pad in (("chairs", chairs[0], 12, None),
                                      ("sintel", sintel["clean"][0], 32, "sintel"),
                                      ("kitti", kitti[0], 32, "kitti")):
        flow_cpu, m_cpu = _protocol_flow(torch, raft_cpu.model, sample, iters, pad, "cpu")
        flow, m_card = _protocol_flow(torch, raft.model, sample, iters, pad, dev)
        agree[label] = dict(_gates(flow, None, flow_cpu, shape=flow_cpu.shape),
                            epe=_epe_gate(m_card, m_cpu), iters=iters,
                            shape=list(sample["image1"].shape[:2]),
                            gt_mean_abs_flow=float(np.abs(sample["flow"]).mean()))

    # the Sintel scene as a warm-started sequence, and its second pair from
    # the same flow_init on the card and on the CPU
    seq = FlowPredictor(_raft_cfg(), FIXTURE, device="cuda", dtype=bf16, iters=32)
    seq_cpu = FlowPredictor(_raft_cfg(), FIXTURE, device="cpu", dtype=torch.float32, iters=32)
    frames, masks = scene["frames"]["clean"], scene["masks"]
    runs = {}
    reset_launch_counts()
    for warm in (True, False):
        flows = seq.sequence(frames, masks, warm_start=warm)
        if flows.shape != (len(frames) - 1, *frames[0].shape[:2], 2) or not np.isfinite(
                flows).all():
            raise AssertionError(f"sequence flows {flows.shape} not finite")
        epe = [float(np.sqrt(((f - g_) ** 2).sum(-1)).mean())
               for f, g_ in zip(flows, scene["flows"])]
        runs["warm" if warm else "cold"] = dict(epe_per_pair=epe, flows=flows)
    note_shapes()
    _, flow_lr = seq.forward(*seq.prepare(frames[0], frames[1], masks[0], masks[1]))
    init = forward_interpolate(flow_lr[0].cpu().numpy())
    pair2 = (frames[1], frames[2], masks[1], masks[2])
    flow2 = seq.forward(*seq.prepare(*pair2), flow_init=torch.from_numpy(init[None]).to(dev))[0]
    flow2_cpu = seq_cpu.forward(*seq_cpu.prepare(*pair2), flow_init=torch.from_numpy(init[None]))[0]
    flow2 = flow2[0].cpu().numpy()
    warm2 = _gates(flow2, None, flow2_cpu[0].numpy(), shape=flow2.shape)
    warm2["init_mean_abs"] = float(np.abs(init).mean())
    warm2["vs_sequence_max_abs"] = float(np.abs(flow2 - runs["warm"]["flows"][1]).max())
    agree["sintel pair 2, warm start"] = warm2
    for run in runs.values():
        del run["flows"]
    out["sequence"], out["agreement"] = runs, agree
    _emit(dict(phase="eval", part="agreement and sequence", card=card, agreement=agree,
               sequence=runs))

    ff = FlowPredictor(FlowFormerConfig(encoder_depth=1, decoder_depth=ITERS), FIXTURE_FF,
                       device="cuda", dtype=bf16)
    drive("ff_flowformer chairs", tev.validate_chairs, ff.model,
          ("attention", "window_attention", "lookup", "fold"), dataset=chairs, iters=ITERS)
    del ff
    pwc = FlowPredictor(FFPWCNetConfig(fusion="parallel", fusion_type="1x1conv"), FIXTURE_PWC,
                        device="cuda", dtype=bf16)
    drive("ff_pwcnet chairs", tev.validate_chairs, pwc.model, ("local_corr",), dataset=chairs)
    del pwc

    # the KITTI submission writer: PNGs where cv2 is installed, else the
    # codec's ImportError after the first pair's forward
    test_split = sy.InMemoryDataset([dict(kitti[i], extra_info=[f"{i:06d}_10.png"])
                                     for i in range(len(kitti))])
    sub_dir = os.path.join(OUT_DIR, "kitti_submission")
    reset_launch_counts()
    try:
        create_kitti_submission(raft.model, test_split, sub_dir)
        png_flow, png_valid = read_flow_kitti(os.path.join(sub_dir, "000000_10.png"))
        flow0, _ = _protocol_flow(torch, raft.model, kitti[0], 24, "kitti", dev)
        err = float(np.abs(png_flow - flow0).max())
        if not (err <= 1 / 64 + 1e-3 and (png_valid == 1).all()):
            raise AssertionError(f"KITTI PNG read back: max |diff| {err} px")
        out["kitti_submission"] = dict(pngs=len(os.listdir(sub_dir)), read_back_max_abs=err)
    except ImportError as e:
        if "OpenCV" not in str(e):
            raise
        out["kitti_submission"] = dict(import_error=str(e))
    note_shapes()
    if launch_counts["lookup_fold"] == 0:
        raise AssertionError("the KITTI submission ran no forward")
    _emit(dict(phase="eval", part="kitti_submission", card=card, **out["kitti_submission"]))

    g = torch.Generator(device=dev).manual_seed(3)
    new = sorted((k for k in shapes if k not in held), key=str)
    out["new_shapes"] = [dict(_hold_shape(torch, g, dev, k), launches=shapes[k]) for k in new]
    torch.cuda.empty_cache()
    _emit(dict(phase="eval", part="new shapes, each held against its plain version",
               count=len(new), rows=out["new_shapes"]))
    return out


# ------------------------------------------------------------- training
TRAIN_YAML = os.path.join(ROOT, "configs", "ff-raft", "experiment", "ffraft_chairs_orb.yaml")
TB, TH, TW = 10, 368, 496  # the chairs stage's batch and crop
TRAIN_STEPS = 16
COUNTED_STEP = 4  # steps 1-3 warm up
# the descent gate: the fixed batch's f32 loss after the last step over the
# loss before the first (`_descent_gate`)
DESCENT_BOUND = 0.98
# each training step: G 12 (forward), A 12 (G's backward), C1 30, C2 30
TRAIN_WANT = {"lookup_fold": ITERS, "lookup": ITERS, "in_stats": 30, "in_normalize": 30}


def train_kernel_rows(torch, dev, batch: int = TB, path: str = "ff_raft_train") -> dict:
    """G, A, C1 and C2 at a RAFT training step's shapes (FF-RAFT: B=10 at
    368x496, bf16: the pyramid of a 46x62 grid; the fnet's three shapes over
    both frames, B=20; plain RAFT's step: B=6 and 12), held and timed as the
    kernel phase holds them, each row with its Function's backward: the
    gradients against autograd through the plain version
    (`_backward_check`, `_instance_norm_backward`) and the backward's time
    -> kernel name -> rows."""
    from focusflow_official_tpu_torch.compat.weights import load_npz
    from focusflow_official_tpu_torch.kernels import lookup as kl
    from focusflow_official_tpu_torch.kernels import lookup_fold as klf
    from focusflow_official_tpu_torch.ops.coords import coords_grid
    from focusflow_official_tpu_torch.ops.corr import corr_pyramid

    g = torch.Generator(device=dev).manual_seed(9)
    bf16 = torch.bfloat16
    h1, w1, r = TH // 8, TW // 8, 4
    q = h1 * w1
    corr0 = torch.randn((batch, q, h1, w1), generator=g, device=dev)
    levels = corr_pyramid(corr0, 4, bf16)
    del corr0
    coords = (coords_grid(batch, h1, w1, device=dev)
              + torch.randn((batch, h1, w1, 2), generator=g, device=dev) * 8).contiguous()
    shape = f"levels {[tuple(lv.shape) for lv in levels]} bf16, Q={batch * q}"

    row = _lookup_row(torch, levels, coords, r, "lookup train")
    win = row.pop("out")
    cot = torch.randn(win.shape, generator=g, device=dev).to(bf16)
    row.update(shape=shape, **_backward_check(
        torch, lambda *lv: kl.lookup(lv, coords, r), lambda *lv: kl.lookup_plain(lv, coords, r),
        levels, cot, lambda: kl.lookup_vjp(levels, coords, r, cot), "lookup train"))
    rows = {"lookup": [row]}
    del win, cot

    sd = load_npz(FIXTURE)
    wc = sd["flow_net.update_block.encoder.convc1.weight"].reshape(256, 324).to(dev, bf16)
    bc = sd["flow_net.update_block.encoder.convc1.bias"].to(dev, bf16)
    row = _lookup_fold_row(torch, levels, coords, r, wc.contiguous(), bc, "lookup_fold train")
    cot = torch.randn((batch, h1, w1, 256), generator=g, device=dev).to(bf16)
    row.update(shape=f"{shape}, (256, 324) weight -> ({batch * q}, 256) bf16", **_backward_check(
        torch, lambda w_, b_, *lv: klf.lookup_fold(lv, coords, r, w_, b_),
        lambda w_, b_, *lv: klf.lookup_fold_plain(lv, coords, r, w_, b_),
        [wc, bc, *levels], cot, lambda: klf.lookup_fold_vjp(levels, coords, r, wc, cot),
        "lookup_fold train"))
    rows["lookup_fold"] = [row]
    del levels, coords, cot
    torch.cuda.empty_cache()

    shapes = [(2 * batch, TH // 2, TW // 2, 64), (2 * batch, TH // 4, TW // 4, 96),
              (2 * batch, TH // 8, TW // 8, 128)]
    rows.update(_instance_norm_rows(torch, g, dev, shapes, backward=True))
    _emit_train_rows(path, rows)
    torch.cuda.empty_cache()
    return rows


def _emit_train_rows(path: str, rows: dict) -> None:
    for name in rows:
        for row in rows[name]:
            _emit(dict(phase="train_kernels", path=path, name=name,
                       **{k: v for k, v in row.items() if k not in ("key", "out")},
                       key=list(row["key"])))


def pwc_train_rows(torch, dev, step_shapes: dict) -> dict:
    """D at the shapes of the FF-PWCNet training step's own launch keys
    (the five decoder levels of B=8 at 384x512, bf16), in both forms (the
    step runs the leaky-ReLU form), each held and timed as the kernel
    phase holds it, with its Function's backward (`_local_corr_row`)."""
    g = torch.Generator(device=dev).manual_seed(10)
    rows = []
    keys = sorted((k for k in step_shapes if k[0] == "local_corr"), key=lambda k: -k[4])
    for key in keys:
        b, h, w, c, r = key[1:6]
        dtype = getattr(torch, key[6].split(".")[1])
        for slope in (None, 0.1):
            form = "plain" if slope is None else "leaky_relu"
            rows.append(_local_corr_row(torch, g, dev, (b, h, w, c), dtype,
                                        f"local_corr train {h}x{w}, {form}", slope,
                                        backward=True))
            torch.cuda.empty_cache()
    out = {"local_corr": rows}
    _emit_train_rows("ff_pwcnet_train", out)
    return out


def ff_train_rows(torch, dev, step_shapes: dict) -> dict:
    """A, B, E and F at the shapes of the FF-FlowFormer training step's own
    launch keys (B=6 at 368x496: the Twins towers over 6 and 12 frames,
    the perceiver and the decoder over 6 x 2852 queries, the 46x62 cost
    maps), each held and timed as the kernel phase holds it, with its
    Function's backward against autograd through the plain version
    (`_backward_check`) and the backward's time, bound and library time."""
    import torch.nn.functional as F

    from focusflow_official_tpu_torch.kernels import fold as kf
    from focusflow_official_tpu_torch.kernels import lookup as kl
    from focusflow_official_tpu_torch.ops.coords import coords_grid

    g = torch.Generator(device=dev).manual_seed(11)
    dtype_of = lambda text: getattr(torch, text.split(".")[1])
    rows = {"lookup": [], "fold": [], "attention": [], "window_attention": []}
    for key in sorted(step_shapes, key=str):
        name = key[0]
        if name == "attention":
            _, b, n, m, c, cv, heads, dt, entry = key
            if cv != c:
                raise AssertionError(f"{key}: the row takes v as wide as k")
            row = _attention_row(torch, g, dev, b, n, m, c, heads, f"attention train {key[1:4]}",
                                 entry, dtype_of(dt), backward=True)
        elif name == "window_attention":
            _, b, hp, wp, c, heads, dt, entry = key
            if dt != "torch.bfloat16":
                raise AssertionError(f"{key}: the row runs bf16")
            row = _window_row(torch, g, dev, b, hp, wp, c, heads,
                              f"window train {key[1:4]}", backward=True)
        elif name == "lookup":
            _, b, q, h1, w1, dt = key
            level = torch.randn((b, q, h1, w1), generator=g, device=dev).to(dtype_of(dt))
            coords = (coords_grid(b, h1, w1, device=dev)
                      + torch.randn((b, h1, w1, 2), generator=g, device=dev) * 8).contiguous()
            label = f"lookup train (1 level {tuple(level.shape)})"
            row = _lookup_row(torch, [level], coords, 4, label)
            out = row.pop("out")
            cot = torch.randn(out.shape, generator=g, device=dev).to(level.dtype)
            row.update(shape=f"1 level {tuple(level.shape)} {dt}, Q={b * q}",
                       library="F.grid_sample x1 level (f32)", **_backward_check(
                           torch, lambda lv: kl.lookup([lv], coords, 4),
                           lambda lv: kl.lookup_plain([lv], coords, 4), [level], cot,
                           lambda: kl.lookup_vjp([level], coords, 4, cot), label),
                       **_backward_bound((out.numel() + level.numel()) * level.element_size()
                                         + coords.numel() * 4, 8.0 * out.numel(), level.dtype),
                       library_backward_ms=None,
                       library_backward="none: grid_sample's backward takes other inputs")
            del level, coords, out, cot
        elif name == "fold":
            _, m, k, n, dt = key
            dt = dtype_of(dt)
            a = torch.randn((m, k), generator=g, device=dev).to(dt)
            w = (torch.randn((n, k), generator=g, device=dev) / k ** 0.5).to(dt)
            bias = (torch.randn(n, generator=g, device=dev) * 0.1).to(dt)
            label = f"fold train ({m}, {k}) -> {n}"
            row = _fold_row(torch, a, w, bias, label, "mma" if dt == torch.bfloat16 else "fma")
            cot = torch.randn((m, n), generator=g, device=dev).to(dt)
            la, lw = (t.detach().clone().requires_grad_(True) for t in (a, w))
            lo = F.linear(la, lw, bias)
            lib_ms, lib_err = _library_ms(torch, lambda: torch.autograd.grad(
                lo, (la, lw), cot, retain_graph=True))
            row.update(shape=f"({m}, {k}) @ ({n}, {k}).T {dt}", library="F.linear",
                       **_backward_check(
                           torch, lambda a_, w_: kf.fold(a_, w_, bias),
                           lambda a_, w_: kf.fold_plain(a_, w_, bias), [a, w], cot,
                           lambda: kf.fold_vjp(a, w, cot), label),
                       **_backward_bound((2 * (m * k + n * k) + m * n) * a.element_size(),
                                         4.0 * m * n * k, dt),
                       library_backward_ms=lib_ms, library_backward_error=lib_err,
                       library_backward="autograd through F.linear")
            del a, w, la, lw, lo, cot
        else:
            continue
        rows[name].append(row)
        torch.cuda.empty_cache()
    out = {k: v for k, v in rows.items() if v}
    _emit_train_rows("ff_flowformer_train", out)
    return out


def _flat_grad(torch, model) -> "torch.Tensor":
    # a parameter the loss does not reach (GMA's position tables) counts as 0
    return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                      .detach().float().flatten().cpu() for p in model.parameters()])


def _trained_model(torch, cfg, weights: str, device, dtype: str, freeze_bn: bool = False):
    """The YAML's model from `weights` (f32 parameters, train mode, on
    `device`; `channels_last` on the card; with `freeze_bn`, an FF-RAFT
    config's FREEZE_BN as the trainer applies it) -> (model, loss, iters)."""
    from focusflow_official_tpu_torch.cli.train import build_model
    from focusflow_official_tpu_torch.predict import load_weights

    model_cfg, model, loss_fn, iters = build_model(cfg, dtype)
    model.load_state_dict(load_weights(weights, model), strict=True)
    model.to(device)
    if torch.device(device).type == "cuda":
        model.to(memory_format=torch.channels_last)
    model.train()
    if freeze_bn and getattr(model_cfg, "freeze_bn", False):
        model.freeze_bn()
    return model, loss_fn, iters


def _two_sample_grads(torch, cfg, weights: str, batch: dict, device, dtype, flags=None,
                      freeze_bn: bool = False):
    """The model from `weights` on `batch`, no noise: one forward in `dtype`
    and the loss's backward (`train/loop.py::forward_backward`) -> (loss,
    flat gradient on the CPU). `flags`: (matmul, cuDNN) TF32 flags set
    around the step and put back after, None to leave them. `freeze_bn`:
    as `_trained_model`."""
    from focusflow_official_tpu_torch.train.loop import forward_backward

    model, loss_fn, iters = _trained_model(
        torch, cfg, weights, device, {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype],
        freeze_bn)
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    if flags is not None:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    try:
        loss, _ = forward_backward(model, loss_fn, {k: v.to(device) for k, v in batch.items()},
                                   iters=iters, dtype=dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return float(loss.detach()), _flat_grad(torch, model)


def _cosine(torch, a, b) -> float:
    return float(torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=0))


PWC_TRAIN_YAML = os.path.join(ROOT, "configs", "ff-pwcnet", "ffpwc_chairs.yaml")
FF_TRAIN_YAML = os.path.join(ROOT, "configs", "ff-flowformer", "ff_chairs.yaml")
FF_TRAIN_WEIGHTS = os.path.join(OUT_DIR, "trained_smoke_ff_depth3.npz")


def _ff_depth3_weights() -> str:
    """The FlowFormer fixture (encoder_depth 1) with its latent and
    vertical layer 0 copied into layers 1 and 2, for the shipped depth 3
    -> the `.npz` path."""
    with np.load(FIXTURE_FF) as raw:
        flat = {k: raw[k] for k in raw.files}
    for k in [k for k in flat if "encoder_layers_0/" in k]:
        for i in (1, 2):
            flat[k.replace("encoder_layers_0/", f"encoder_layers_{i}/")] = flat[k]
    os.makedirs(OUT_DIR, exist_ok=True)
    np.savez(FF_TRAIN_WEIGHTS, **flat)
    return FF_TRAIN_WEIGHTS


def _train_specs() -> dict:
    """path -> what its training phase drives: the YAML, the weights it
    starts from (the YAMLs' LOAD_MODULE and load_former files are not in
    the repository), the stage's batch and crop, the refinements, the
    launches every step must make and, where a kernel has forms, the count
    of each a step."""
    return {
        "ff_raft_train": dict(
            yaml=TRAIN_YAML, weights=FIXTURE, batch=TB, crop=(TH, TW),
            iters=ITERS, want=TRAIN_WANT, forms=("in_normalize", {"plain": 18, "residual": 12}),
            flags=None, agree=None,
            descent="trainer"),
        "ff_pwcnet_train": dict(
            yaml=PWC_TRAIN_YAML, weights=FIXTURE_PWC, batch=8,
            crop=(368, 496), iters=None, want={"local_corr": 5},
            forms=("local_corr", {"leaky_relu": 5}),
            flags="defaults", agree=None,
            descent="trainer"),
        "ff_flowformer_train": dict(
            yaml=FF_TRAIN_YAML, weights=None, batch=6,
            crop=(368, 496), iters=12, want=_ff_launches(3, 12), forms=None, flags="defaults",
            # the agreement gates at the fixture's own depth: past the 2
            # refinements it was trained at, its f32 gradient depends on
            # the order of f32 sums (JAX's and the port's f32 steps:
            # cosine 0.9974 at 12 refinements, 64x96)
            agree=dict(MODEL=dict(encoder_depth=1, decoder_depth=2), weights=FIXTURE_FF),
            # descent held on JAX's own descent test (fresh weights): the
            # fixture predicts about zero flow on this input (each
            # refinement's EPE within 0.7 px of |flow|) and its batch loss
            # moves by 0.02% in 5 steps (the port's trainer takes JAX's
            # steps, loss for loss, on the CPU)
            descent="recipe"),
        # phase 12: the baselines, each trained from phase 12's serving
        # weights (`_raft_variant_weights`, `_vanilla_ff_weights`), their
        # descent on JAX's fresh-weight recipe, their agreement steps at
        # 184x248 (the f32 CPU step at full depth and 12 refinements).
        # Plain RAFT's agreement runs on the recipe's fresh weights: on the
        # fixture's image half its GRU saturates, and its bf16 gradient is
        # 0.985 from the f32 one in cosine at 368x496 (f32 card against the
        # CPU: 0.99999994), as FF-RAFT's fixture shows on the CPU (0.9964);
        # fresh, 0.9997 on the CPU
        "raft_train": dict(
            yaml=RAFT_CTK_YAML, batch=6, crop=(368, 496), iters=ITERS,
            weights=lambda torch: _baseline_weights(torch, "raft"),
            want={"lookup_fold": ITERS, "lookup": ITERS, "in_stats": 15, "in_normalize": 15},
            forms=("in_normalize", {"plain": 9, "residual": 6}), flags="defaults",
            agree=dict(MODEL={}, crop=(184, 248),
                       weights=lambda torch: _fresh_weights(torch, RAFT_CTK_YAML, "raft")),
            descent="recipe"),
        "flowformer_train": dict(
            yaml=VANILLA_FF_YAML, batch=6, crop=(368, 496), iters=12,
            weights=lambda torch: _baseline_weights(torch, "flowformer"),
            want=_ff_launches(3, 12, fused=False), forms=None, flags="defaults",
            agree=dict(MODEL={}, crop=(184, 248)), descent="recipe"),
    }


def _fresh_weights(torch, yaml: str, path: str) -> str:
    """The YAML's model at PyTorch's default initialisation under seed 0
    (`_descent_recipe`'s start) -> the .npz path."""
    from focusflow_official_tpu_torch.cli.train import build_model
    from focusflow_official_tpu_torch.compat.weights import params_to_jax
    from focusflow_official_tpu_torch.config import load_yaml_config

    torch.manual_seed(0)
    _, model, _, _ = build_model(load_yaml_config(yaml), "float32")
    out = os.path.join(OUT_DIR, f"{path}_fresh.npz")
    np.savez(out, **params_to_jax(model.state_dict()))
    return out


def _baseline_weights(torch, path: str) -> str:
    """Phase 12's serving weights of `path` ("raft" or "flowformer") -> the
    .npz path."""
    from focusflow_official_tpu_torch.config import config_from_yaml, load_yaml_config

    out = os.path.join(OUT_DIR, f"{path}_weights.npz")
    if path == "flowformer":
        _vanilla_ff_weights(torch, out)
    else:
        _raft_variant_weights(torch, config_from_yaml(load_yaml_config(RAFT_CTK_YAML)), out)
    return out


def train_phase(torch, card: str, held: set, path: str = "ff_raft_train", defaults=None,
                rows_for=None) -> tuple:
    """Training on the card through the trainer's body
    (`cli/train.py::train`) at the YAML's full width and its stage's batch
    and crop (`_train_specs`): FF-RAFT's `ffraft_chairs_orb.yaml` (B=10,
    368x496 crops, 12 refinements, the cnet's batch norm in train mode),
    FF-PWCNet's `ffpwc_chairs.yaml` (B=8, 368x496 resized to 384x512
    inside, the multiscale MixLoss in 'pretrain' mode) or FF-FlowFormer's
    `ff_chairs.yaml` (B=6, 368x496, encoder_depth 3, decoder_depth 12,
    the sequence MixLoss); noise, AdamW + OneCycle, bf16, from the trained
    fixture (PRETRAIN; the YAMLs' LOAD_MODULE and load_former files are
    not in the repository; FF-FlowFormer's fixture has encoder_depth 1,
    its layer 0 copied into layers 1 and 2), NUM_STEPS cut to 16, on one
    fixed batch of in-memory multi-pixel affine pairs with 3% keypoint
    masks (`data/synthetic.py`; no host augmentation).

    Gates: every step's loss and gradient norm finite; every step makes
    the path's launches (FF-RAFT: G 12, A 12, C1 30, C2 30 of which 12 in
    the residual form; FF-PWCNet: D 5, all in the leaky-ReLU form;
    FF-FlowFormer: A 12, B 24, E 27, F 11); the fixed batch's f32 loss
    after the last step under DESCENT_BOUND x its loss before the first
    (`_descent_gate`; FF-FlowFormer's on 16 more steps of JAX's own
    descent test: fresh weights, a constant lr of 1e-4, no noise,
    `_descent_recipe`; its fixture predicts about zero flow on this input
    and its batch loss does not move in 16 steps); the final
    validation (`validate_chairs` on phase 8's chairs layout) finite. Then,
    on two of the samples with no noise: the f32 step's loss within 1e-4 of
    the port's f32 step on the CPU and the cosine of their flat gradients
    >= 0.9999 (FF-RAFT with TF32 off for the script; the other two under
    PyTorch's default flags `defaults`, which the f32 step must turn off
    itself); the bf16 step's loss within 2% of the f32 step's and the
    gradient cosine >= 0.99. FF-FlowFormer's agreement runs at the
    fixture's own depth (encoder_depth 1, 2 refinements, its weights as
    they are) at the full crop: past the 2 refinements it was trained at,
    its f32 gradient depends on the order of f32 sums (on the CPU at 64x96
    and 12 refinements, JAX's f32 step against the port's: cosine 0.9974;
    the port's bf16 step against its f32 step: 0.16-0.45). `rows_for(launches
    by shape key of the counted step)` -> {kernel: rows} builds the path's kernel rows from
    the step's own launch keys; every other (kernel, shape) launched that
    no row holds (`held`) is held once against its plain version.
    -> ((counts, launches by shape key) of step 4, the counted step; the
    rows of `rows_for`)."""
    import copy

    from focusflow_official_tpu_torch.cli.train import train as run_trainer
    from focusflow_official_tpu_torch.data import synthetic as sy
    from focusflow_official_tpu_torch.kernels import (
        launch_counts, launch_shapes, reset_launch_counts)
    from focusflow_official_tpu_torch.predict import for_inference
    from focusflow_official_tpu_torch.train import evaluate as tev

    t_phase = time.perf_counter()
    spec, cfg, weights, data = _train_setup(torch, path)
    batch, (th, tw), want = spec["batch"], spec["crop"], spec["want"]
    dev = torch.device("cuda", 0)
    bf16 = torch.bfloat16
    chairs = sy.chairs_layout(0)
    before = (_fixed_batch_loss(torch, _trained_model(torch, cfg, weights, dev, "float32")[0],
                                cfg, data) if spec["descent"] == "trainer" else None)
    shapes_seen: dict = {}
    st = dict(metrics=[], per_step=[], counted=None)

    def on_step(step, metrics):
        """After each step: its launches (every count set to 0 after the
        step before) and its metrics."""
        counts = dict(launch_counts)
        st["per_step"].append({k: v for k, v in counts.items() if v})
        st["metrics"].append(metrics)
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"{path} step {step}: metrics {metrics} not finite")
        if step == COUNTED_STEP:
            st["counted"] = (counts, dict(launch_shapes))
        for key, n in launch_shapes.items():
            shapes_seen[key] = shapes_seen.get(key, 0) + n
        reset_launch_counts()  # each step counted from 0

    def validate(model):  # once, after the last step
        if spec["descent"] == "trainer":
            st["after"] = _fixed_batch_loss(torch, model, cfg, data)
        return tev.validate_chairs(for_inference(copy.deepcopy(model), bf16, dev), chairs)

    torch.cuda.empty_cache()
    reset_launch_counts()
    result = run_trainer(cfg, data, validate=validate,
                         log_dir=os.path.join(OUT_DIR, "train_runs"), device="cuda",
                         compute_dtype="bfloat16", val_freq=10 ** 9, on_step=on_step)
    for key, n in launch_shapes.items():  # the final validation's launches
        shapes_seen[key] = shapes_seen.get(key, 0) + n
    for i, c in enumerate(st["per_step"], start=1):
        if c != want:
            raise AssertionError(f"{path} step {i}: launches {c} != {want}")
    counts, step_shapes = st["counted"]
    forms = {}
    if spec["forms"]:
        kernel, want_forms = spec["forms"]
        forms = _count_forms(step_shapes, kernel)
        if forms != want_forms:
            raise AssertionError(f"{path} step: {kernel} forms {forms}, not {want_forms}")
    losses = [m["loss"] for m in st["metrics"]]
    descent = (_descent_gate(path, before, st["after"]) if spec["descent"] == "trainer"
               else _descent_recipe(torch, path, cfg, data))
    final = result["final"]
    if not np.isfinite(list(final.values())).all():
        raise AssertionError(f"{path}: validation on the trained weights: {final}")

    # f32 on the card against the CPU, then bf16 against f32
    ch, cw = (spec["agree"] or {}).get("crop", (th, tw))
    two = {k: torch.as_tensor(np.stack([data[i][k][:ch, :cw] for i in range(2)]))
           for k in ("image1", "image2", "mask1", "mask2", "flow", "valid")}
    flags = defaults if spec["flags"] == "defaults" else None
    acfg, aweights = cfg, weights
    if spec["agree"]:
        acfg, aweights = copy.deepcopy(cfg), spec["agree"].get("weights", weights)
        aweights = aweights(torch) if callable(aweights) else aweights
        for k, v in spec["agree"]["MODEL"].items():
            setattr(acfg.MODEL, k, v)
    cpu_loss, cpu_grad = _two_sample_grads(torch, acfg, aweights, two, "cpu", torch.float32)
    reset_launch_counts()
    f32_loss, f32_grad = _two_sample_grads(torch, acfg, aweights, two, dev, torch.float32, flags)
    bf_loss, bf_grad = _two_sample_grads(torch, acfg, aweights, two, dev, bf16)
    for key, n in launch_shapes.items():
        shapes_seen[key] = shapes_seen.get(key, 0) + n
    agree = dict(cpu_f32_loss=cpu_loss, card_f32_loss=f32_loss, card_bf16_loss=bf_loss,
                 f32_loss_rel=abs(f32_loss - cpu_loss) / abs(cpu_loss),
                 f32_grad_cosine=_cosine(torch, f32_grad, cpu_grad),
                 bf16_loss_rel=abs(bf_loss - f32_loss) / abs(f32_loss),
                 bf16_grad_cosine=_cosine(torch, bf_grad, f32_grad),
                 f32_card_flags="PyTorch's defaults (matmul TF32 {}, cuDNN TF32 {})".format(
                     *flags) if flags else "TF32 off for the script",
                 model=spec["agree"]["MODEL"] if spec["agree"] else "the phase's",
                 weights=os.path.relpath(aweights, ROOT), crop=[ch, cw])
    if not (agree["f32_loss_rel"] <= 1e-4 and agree["f32_grad_cosine"] >= 0.9999
            and agree["bf16_loss_rel"] <= 0.02 and agree["bf16_grad_cosine"] >= 0.99
            and torch.isfinite(bf_grad).all()):
        raise AssertionError(f"{path} training agreement: {agree}")
    del cpu_grad, f32_grad, bf_grad
    torch.cuda.empty_cache()

    rows = rows_for(step_shapes) if rows_for is not None else {}
    held = held | {r["key"] for rs in rows.values() for r in rs}
    g = torch.Generator(device=dev).manual_seed(4)
    new = sorted((k for k in shapes_seen if k not in held), key=str)
    new_rows = [dict(_hold_shape(torch, g, dev, k), launches=shapes_seen[k]) for k in new]
    out = dict(phase=path.replace("ff_raft_train", "train"), path=path, card=card,
               yaml=os.path.relpath(spec["yaml"], ROOT), batch=batch, crop=[th, tw],
               iters=spec["iters"], dtype="bfloat16", steps=TRAIN_STEPS, losses=losses,
               descent=descent, grad_norms=[m["grad_norm"] for m in st["metrics"]],
               final_validation=final, launches_per_step=want,
               **({f"{spec['forms'][0]}_forms": forms} if forms else {}),
               agreement=agree, new_shapes_held=new_rows,
               phase_seconds=time.perf_counter() - t_phase)
    _emit(out)
    torch.cuda.empty_cache()
    return (counts, step_shapes), rows, out


def _train_setup(torch, path: str) -> tuple:
    """A training path's spec (`_train_specs`), its YAML cut to
    TRAIN_STEPS steps from its weights, and its fixed batch -> (spec, cfg,
    weights, data)."""
    from focusflow_official_tpu_torch.config import load_yaml_config
    from focusflow_official_tpu_torch.data import synthetic as sy

    spec = _train_specs()[path]
    weights = spec["weights"]
    weights = (_ff_depth3_weights() if weights is None
               else weights(torch) if callable(weights) else weights)
    batch, (th, tw) = spec["batch"], spec["crop"]
    cfg = load_yaml_config(spec["yaml"])
    cfg.TRAIN.NUM_STEPS = TRAIN_STEPS
    cfg.MODEL.PRETRAIN = weights
    cfg.MODEL.LOAD_MODULE = None
    cfg.MODEL.load_former = None
    cfg.GLOBAL.NUM_WORKERS = 2
    if (int(cfg.TRAIN.BATCH_SIZE), tuple(cfg.TRAIN.IMAGE_SIZE)) != (batch, (th, tw)):
        raise AssertionError(f"{spec['yaml']}: batch {cfg.TRAIN.BATCH_SIZE}, crop "
                             f"{cfg.TRAIN.IMAGE_SIZE}, not {batch} at {th}x{tw}")
    return spec, cfg, weights, sy.chairs_layout(5, n=batch, h=th, w=tw)


def _fixed_batch_loss(torch, model, cfg, data) -> float:
    """The loss of `model` on the fixed batch `data`, the descent gate's
    measure: in f32 with TF32 off, no noise, on an f32 copy of the model
    in train mode (the batch norms on the batch's statistics as in a step;
    frozen ones on their running statistics), so that its statistics stay
    as they were."""
    from focusflow_official_tpu_torch.cli.train import build_model
    from focusflow_official_tpu_torch.predict import _no_tf32
    from focusflow_official_tpu_torch.train.loop import forward_loss

    model_cfg, m, loss_fn, iters = build_model(cfg, "float32")  # its forward in f32
    m.load_state_dict(model.state_dict(), strict=True)
    dev = next(model.parameters()).device
    m.to(dev).train()
    if dev.type == "cuda":
        m.to(memory_format=torch.channels_last)
    if getattr(model_cfg, "freeze_bn", False):
        m.freeze_bn()
    batch = {k: torch.as_tensor(np.stack([data[i][k] for i in range(len(data))]), device=dev)
             for k in ("image1", "image2", "mask1", "mask2", "flow", "valid")}
    with torch.no_grad(), _no_tf32():
        loss, _ = forward_loss(m, loss_fn, batch, iters=iters, dtype=torch.float32)
    del m, batch
    torch.cuda.empty_cache()
    return float(loss)


def _descent_gate(path: str, before: float, after: float) -> dict:
    """The fixed batch's f32 loss after the last step over the loss before
    the first must be under DESCENT_BOUND."""
    out = dict(loss_before=before, loss_after=after, ratio=after / before,
               bound=DESCENT_BOUND)
    print(f"{path}: descent ratio {out['ratio']:.6f} (bound {DESCENT_BOUND})", flush=True)
    if not out["ratio"] < DESCENT_BOUND:
        raise AssertionError(f"{path}: no descent over {TRAIN_STEPS} steps: {out}")
    return out


def _descent_recipe(torch, path: str, cfg, data, device="cuda") -> dict:
    """JAX's own descent test (`tests/test_train.py`,
    `test_loss_decreases_and_multichip`) at the phase's shape: 16 steps of
    `train/loop.py::train_step` on the fixed batch from fresh weights
    (PyTorch's default initialisation under seed 0), bf16, at a constant
    lr of 1e-4, global clip 1.0, no noise; gated on the fixed batch's f32
    loss before the first step and after the last (`_descent_gate`) ->
    the gate's numbers and the steps' losses. `device`: the card, or the
    CPU for the CPU test at a reduced size."""
    from focusflow_official_tpu_torch.cli.train import build_model
    from focusflow_official_tpu_torch.train.loop import build_optimizer, train_step

    dev = torch.device(device)
    torch.manual_seed(0)
    _, model, loss_fn, iters = build_model(cfg, "bfloat16")
    model.to(dev).train()
    if dev.type == "cuda":
        model.to(memory_format=torch.channels_last)
    before = _fixed_batch_loss(torch, model, cfg, data)
    opt = build_optimizer(model, 1e-4, weight_decay=0.0)
    constant = torch.optim.lr_scheduler.LambdaLR(opt, lambda _: 1.0)
    batch = {k: torch.as_tensor(np.stack([data[i][k] for i in range(len(data))]), device=dev)
             for k in ("image1", "image2", "mask1", "mask2", "flow", "valid")}
    losses = [float(train_step(model, opt, constant, loss_fn, batch, iters=iters,
                               dtype=torch.bfloat16, clip=1.0)["loss"])
              for _ in range(TRAIN_STEPS)]
    del opt, batch
    out = dict(_descent_gate(path, before, _fixed_batch_loss(torch, model, cfg, data)),
               recipe_losses=losses)
    del model
    torch.cuda.empty_cache()
    return out


def descent_run(torch, path: str) -> dict:
    """A training path's descent alone: the trainer's 16 steps from the
    path's weights (`descent="trainer"`) or the recipe (`"recipe"`), and
    the gate's numbers (`scripts/descent_forms.py` takes them under two
    summation forms)."""
    from focusflow_official_tpu_torch.cli.train import train as run_trainer

    spec, cfg, weights, data = _train_setup(torch, path)
    if spec["descent"] == "recipe":
        return _descent_recipe(torch, path, cfg, data)
    dev = torch.device("cuda", 0)
    before = _fixed_batch_loss(torch, _trained_model(torch, cfg, weights, dev, "float32")[0],
                               cfg, data)
    got = {}

    def validate(model):  # once, after the last step
        got["after"] = _fixed_batch_loss(torch, model, cfg, data)
        return {}

    run_trainer(cfg, data, validate=validate, log_dir=os.path.join(OUT_DIR, "train_runs"),
                device="cuda", compute_dtype="bfloat16", val_freq=10 ** 9)
    return _descent_gate(path, before, got["after"])


# ------------------------------------------------ phase 13: training at scale
CTK_YAML = os.path.join(ROOT, "configs", "ff-raft", "experiment", "ffraft_CTK.yaml")
AUG_STEPS = 16
DDP_WORLD, DDP_B, DDP_CROP = 2, 4, (184, 248)
DDP_DEADLINE_S = 300
NCCL_STEPS = 6  # step 2 counted


def _tagged(samples, recipe: int) -> list:
    return [dict(s, recipe=np.int32(recipe)) for s in samples]


def _raw_chairs(n: int, seed: int):
    """`n` raw chairs-size pairs (384x512, keypoint masks), tagged for the
    chairs recipe, as `fetch_dataset(stage="chairs", no_aug=True)` gives
    them -> the dataset (with `device_recipes`)."""
    from focusflow_official_tpu_torch.data import synthetic as sy
    from focusflow_official_tpu_torch.data.datasets import RecipeTagged
    from focusflow_official_tpu_torch.data.device_aug import dense_recipe

    ds = RecipeTagged(sy.chairs_layout(seed, n=n, h=384, w=512), 0)
    ds.device_recipes = [dense_recipe(-0.1, 1.0)]
    return ds


def _check_draws(torch, aug, draws: dict, sizes, recipe, label: str) -> dict:
    """Every draw within its recipe's range -> the shares drawn."""
    rp = {k: v.cpu().double() for k, v in aug._recipe(recipe.cpu()).items()}
    d = {k: v.cpu() for k, v in draws.items()}
    sizes = sizes.cpu()
    lo = lambda x: torch.clamp(1 - x, min=0.0)
    jit = d["jitter"].double()
    ok = []
    for k, name in enumerate(("brightness", "contrast", "saturation")):
        ok.append(bool((jit[..., k] >= lo(rp[name])[:, None] - 1e-6).all()
                       and (jit[..., k] <= 1 + rp[name][:, None] + 1e-6).all()))
    ok.append(bool((jit[..., 3].abs() <= rp["hue"][:, None] + 1e-6).all()))
    ok.append(bool((d["order"].sort(dim=-1).values == torch.arange(4)).all()))
    sc = d["scale"].double()
    ok.append(bool((sc >= 2 ** rp["min_scale"] * (1 - 1e-6)).all()
                   and (sc <= 2 ** rp["max_scale"] * (1 + 1e-6)).all()))
    st = d["stretch"].double()
    ok.append(bool((st >= 2 ** -0.2 * (1 - 1e-6)).all() and (st <= 2 ** 0.2 * (1 + 1e-6)).all()))
    ok.append(bool((d["n_rect"] >= 1).all() and (d["n_rect"] <= 2).all()))
    r = d["rects"]
    ok.append(bool((r[..., 0] >= 0).all() and (r[..., 0] < sizes[:, 1:2]).all()
                   and (r[..., 1] >= 0).all() and (r[..., 1] < sizes[:, 0:1]).all()
                   and (r[..., 2:] >= 50).all() and (r[..., 2:] < 100).all()))
    for key, prob in ((d["flip"][:, 0], "h_flip_prob"), (d["flip"][:, 1], "v_flip_prob"),
                      (d["do_stretch"], "stretch_prob"), (d["asym"], "asym_prob")):
        ok.append(bool((~key | (rp[prob] > 0)).all()))  # no event where its probability is 0
    _, _, resized = aug._resize(d, sizes, {k: v.float() for k, v in rp.items()})
    span = torch.clamp(resized - torch.tensor(aug.crop_size), min=1)
    ok.append(bool((d["offset"] >= 0).all() and (d["offset"] < span).all()))
    if not all(ok):
        raise AssertionError(f"{label}: draws outside their recipes' ranges: {ok}")
    return {k: float(d[k].float().mean()) for k in ("asym", "erase", "do_stretch", "do_spatial")}


def _aug_agreement(torch, aug, batch: dict, draws: dict, label: str, dev) -> dict:
    """`apply` on `dev` (the card) against `apply` on the CPU on the same
    draws: images and masks within 1e-3 (0-255 scale), flow within 1e-4 of
    max(1, |flow|), valid and the valid counts exact."""
    card = aug.apply({k: torch.as_tensor(v, device=dev) for k, v in batch.items()}, draws)
    cpu = aug.apply({k: torch.as_tensor(v) for k, v in batch.items()},
                    {k: v.cpu() for k, v in draws.items()})
    err = {k: float((card[k].cpu() - cpu[k]).abs().max())
           for k in ("image1", "image2", "mask1", "mask2", "flow", "valid")}
    flow_tol = 1e-4 * max(1.0, float(cpu["flow"].abs().max()))
    counts = (card["valid"].sum(dim=(1, 2)).cpu().tolist(), cpu["valid"].sum(dim=(1, 2)).tolist())
    out = dict(max_abs_err=err, flow_tol=flow_tol, valid_counts=counts[0],
               shape=list(card["image1"].shape))
    if not (max(err[k] for k in ("image1", "image2", "mask1", "mask2")) <= 1e-3
            and err["flow"] <= flow_tol and err["valid"] == 0 and counts[0] == counts[1]
            and all(bool(torch.isfinite(card[k]).all()) for k in card)):
        raise AssertionError(f"{label}: card apply against the CPU's: {out}")
    return out


def _mixed_kitti_batch() -> dict:
    """One raw batch of the kitti stage (`ffraft_CTK.yaml`): two dense
    Sintel-size pairs (436x1024) beside two sparse KITTI-size ones
    (375x1242), zero-padded to 436x1242 by the loader, with `sizes` and
    `recipe`."""
    from focusflow_official_tpu_torch.data import synthetic as sy
    from focusflow_official_tpu_torch.data.loader import Loader

    sintel = sy.sintel_layout(21, n_frames=3)[0]["clean"]
    kitti = sy.kitti_layout(22, shapes=((375, 1242),) * 2)
    samples = (_tagged([sintel[i] for i in range(2)], 0)
               + _tagged([kitti[i] for i in range(2)], 1))
    return Loader(samples, len(samples))._collate(samples)


def device_aug_phase(torch, card: str) -> tuple:
    """13a: the on-card augmentation. The augmentor alone on a raw chairs
    batch (B=10, 384x512 -> 368x496) and on a mixed kitti-stage batch
    (`_mixed_kitti_batch`, ffraft_CTK.yaml's recipes and crop): draws in
    their recipes' ranges and the card's `apply` against the CPU's on the
    same draws. Then the trainer (`cli/train.py::train`, `device_aug=True`)
    on `ffraft_chairs_orb.yaml` at B=10, bf16, from the fixture, over 20
    raw pairs: 16 steps, each with phase 9's launches (G 12, A 12, C1 30,
    C2 30), finite losses. -> (counts, launches by shape key) of step 4."""
    from focusflow_official_tpu_torch.cli.train import train as run_trainer
    from focusflow_official_tpu_torch.config import load_yaml_config
    from focusflow_official_tpu_torch.data.device_aug import (
        DeviceFlowAugmentor, dense_recipe, sparse_recipe)
    from focusflow_official_tpu_torch.data.loader import Loader
    from focusflow_official_tpu_torch.kernels import (
        launch_counts, launch_shapes, reset_launch_counts)

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(13)
    out = dict(phase="device_aug", card=card)
    raw = _raw_chairs(20, 31)
    chairs = DeviceFlowAugmentor((TH, TW), recipes=raw.device_recipes)
    ctk = load_yaml_config(CTK_YAML)
    kitti = DeviceFlowAugmentor(tuple(ctk.TRAIN.IMAGE_SIZE),
                                recipes=[dense_recipe(-0.2, 0.6), sparse_recipe(-0.3, 0.5)])
    for label, aug, batch in (
            ("chairs", chairs, Loader(raw, TB)._collate([raw[i] for i in range(TB)])),
            ("kitti_mixed", kitti, _mixed_kitti_batch())):
        on_card = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        b = on_card["image1"].shape[0]
        draws = aug.draw(gen, b, on_card["sizes"].long(), on_card["recipe"].long())
        out[label] = dict(raw_shape=list(batch["image1"].shape),
                          shares=_check_draws(torch, aug, draws, on_card["sizes"],
                                              on_card["recipe"], label),
                          agreement=_aug_agreement(torch, aug, batch, draws, label, dev))
        del on_card, draws
    torch.cuda.empty_cache()

    cfg = load_yaml_config(TRAIN_YAML)
    cfg.TRAIN.NUM_STEPS = AUG_STEPS
    cfg.MODEL.PRETRAIN = FIXTURE
    cfg.MODEL.LOAD_MODULE = None
    cfg.GLOBAL.NUM_WORKERS = 2
    st = dict(losses=[], per_step=[], counted=None)

    def on_step(step, metrics):
        st["per_step"].append({k: v for k, v in launch_counts.items() if v})
        st["losses"].append(metrics["loss"])
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"device_aug step {step}: metrics {metrics} not finite")
        if step == COUNTED_STEP:
            st["counted"] = (dict(launch_counts), dict(launch_shapes))
        reset_launch_counts()

    reset_launch_counts()
    run_trainer(cfg, raw, validate=lambda model: {}, log_dir=os.path.join(OUT_DIR, "train_runs"),
                device="cuda", compute_dtype="bfloat16", val_freq=10 ** 9, on_step=on_step,
                device_aug=True)
    for i, c in enumerate(st["per_step"], start=1):
        if c != TRAIN_WANT:
            raise AssertionError(f"device_aug step {i}: launches {c} != {TRAIN_WANT}")
    out["train"] = dict(
        yaml=os.path.relpath(TRAIN_YAML, ROOT), batch=TB, raw=[384, 512], crop=[TH, TW],
        dtype="bfloat16", steps=AUG_STEPS, losses=st["losses"], launches_per_step=TRAIN_WANT)
    out["phase_seconds"] = time.perf_counter() - t_phase
    _emit(out)
    torch.cuda.empty_cache()
    return st["counted"]


def _ddp_global_batch() -> dict:
    """FF-RAFT chairs pairs at 184x248, B=4; rank 1's rows (1 and 3) keep
    a tenth of their keypoints, so the ranks' mask sums differ."""
    from focusflow_official_tpu_torch.data import synthetic as sy

    ds = sy.chairs_layout(41, n=DDP_B, h=DDP_CROP[0], w=DDP_CROP[1])
    keys = ("image1", "image2", "mask1", "mask2", "flow", "valid")
    batch = {k: np.stack([ds[i][k] for i in range(DDP_B)]).astype(np.float32) for k in keys}
    rng = np.random.RandomState(42)
    for k in ("mask1", "mask2"):
        batch[k][1::2] *= rng.rand(*batch[k][1::2].shape) < 0.1
    return batch


def _ddp_step(torch, mesh, dev) -> dict:
    """One f32 step of `ffraft_chairs_orb.yaml`'s FF-RAFT on the card
    (fresh weights under seed 0, the cnet's batch norm in train mode,
    MixLoss, noise, AdamW at lr 4e-4, clip 1.0; TF32 off) on the global
    batch, or on `mesh`'s rows of it, on `dev` -> metrics, gradients,
    state and the launches by shape key, on the CPU. One process takes the
    batch statistics as the ranks do, as sums over a count (through the
    identity)."""
    from focusflow_official_tpu_torch.cli.train import build_model
    from focusflow_official_tpu_torch.config import load_yaml_config
    from focusflow_official_tpu_torch.kernels import launch_shapes, reset_launch_counts
    from focusflow_official_tpu_torch.train.loop import build_optimizer, train_step

    torch.manual_seed(0)
    _, model, loss_fn, iters = build_model(load_yaml_config(TRAIN_YAML), "float32", mesh)
    model.to(dev).to(memory_format=torch.channels_last).train()
    opt = build_optimizer(model, 4e-4)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda _: 1.0)
    rows = slice(None) if mesh is None else slice(mesh.rank, None, mesh.world)
    batch = {k: torch.as_tensor(v[rows], device=dev) for k, v in _ddp_global_batch().items()}
    reset_launch_counts()
    m = train_step(model, opt, sched, loss_fn, batch, iters=iters, clip=1.0,
                   noise=torch.Generator(device=dev).manual_seed(7), mesh=mesh)
    return dict(metrics={k: float(v) for k, v in m.items()},
                grads={n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                state={k: v.detach().cpu() for k, v in model.state_dict().items()},
                shapes=dict(launch_shapes))


def ddp_rank_main(rank: int, store: str, out_path: str) -> int:
    """One rank of 13b (`chip_smoke.py --ddp-rank R STORE OUT`): gloo on
    card 0 through a file store, `_ddp_step` on its rows, its result
    saved to OUT."""
    import datetime

    import torch
    import torch.distributed as dist

    from focusflow_official_tpu_torch.train.mesh import Mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=DDP_WORLD, timeout=datetime.timedelta(seconds=120))
    dev = torch.device("cuda", 0)
    try:
        torch.save(_ddp_step(torch, Mesh(rank, DDP_WORLD, dev), dev), out_path)
    finally:
        dist.destroy_process_group()
    return 0


def _ddp_gates(torch, got: dict, want: dict) -> dict:
    """Two ranks against one process: the loss within 1e-5 relative; the
    flat gradient's cosine >= 0.99999 and each tensor within 1e-4 of its
    largest magnitude plus 1e-4 of the model's largest gradient (f32
    rounding of sums taken in another order, amplified by the norms'
    backward: `tests/test_torch_distributed.py`); parameters after the
    step and running statistics within 1e-4 of each tensor's largest
    (2 x lr more where the gradient lies within its bound of 0: Adam's
    first step is about lr x sign(g))."""
    names = sorted(want["grads"])
    fg = torch.cat([got["grads"][n].flatten() for n in names]).double()
    fw = torch.cat([want["grads"][n].flatten() for n in names]).double()
    top = float(fw.abs().max())
    err = {n: float((got["grads"][n] - want["grads"][n]).abs().max()) for n in names}
    own = {n: float(want["grads"][n].abs().max()) for n in names}
    grad_ratio = max(err[n] / (1e-4 * (own[n] + top)) for n in names)
    # printed, not gated: the worst against 1e-4 of its own largest alone,
    # over the tensors whose gradient is more than rounding
    own_ratio = max(err[n] / (1e-4 * own[n]) for n in names if own[n] > 1e-7 * top)
    state_ratio = 0.0
    for k, t in want["state"].items():
        diff = (got["state"][k] - t).abs()
        if k in want["grads"]:
            g = want["grads"][k].abs()
            diff = torch.where(g <= 1e-4 * (float(g.max()) + top),
                               torch.clamp(diff - 2 * 4e-4, min=0.0), diff)
        state_ratio = max(state_ratio, float(diff.max()) / (1e-4 * max(float(t.abs().max()),
                                                                       1e-30)))
    lw, lg = want["metrics"]["loss"], got["metrics"]["loss"]
    out = dict(loss_one_process=lw, loss_two_ranks=lg, loss_rel=abs(lg - lw) / abs(lw),
               grad_cosine=float(torch.nn.functional.cosine_similarity(fg, fw, dim=0)),
               grad_err_over_bound=grad_ratio, grad_err_over_own_bound=own_ratio,
               state_err_over_bound=state_ratio,
               metrics_rel={k: abs(got["metrics"][k] - v) / max(abs(v), 1e-6)
                            for k, v in want["metrics"].items()})
    if not (out["loss_rel"] <= 1e-5 and out["grad_cosine"] >= 0.99999 and grad_ratio <= 1
            and state_ratio <= 1):
        raise AssertionError(f"13b: two ranks against one process: {out}")
    return out


def ddp_phase(torch, card: str, held: set) -> tuple:
    """13b: data parallelism on one card. Two ranks over gloo on card 0
    (NCCL refuses two ranks on one device; the same `train/mesh.py` code
    runs under both), spawned as `--ddp-rank` processes with a file store
    and a 120 s timeout, against one process on the global batch
    (`_ddp_step`, `_ddp_gates`); every (kernel, shape) the three runs
    launched that no row holds is held once against its plain version.
    Then a world-size-1 NCCL group from torchrun's variables
    (`train/mesh.py::init_from_env`, as `cli/train.py --multihost` starts
    it) under the trainer on `ffraft_chairs_orb.yaml` at B=10, 368x496,
    bf16 on phase 9's fixed batch: 6 steps with phase 9's launches and
    finite losses. -> (counts, launches by shape key) of its step 2."""
    import shutil
    import socket

    import torch.distributed as dist

    from focusflow_official_tpu_torch.cli.train import train as run_trainer
    from focusflow_official_tpu_torch.config import load_yaml_config
    from focusflow_official_tpu_torch.data import synthetic as sy
    from focusflow_official_tpu_torch.kernels import (
        launch_counts, launch_shapes, reset_launch_counts)
    from focusflow_official_tpu_torch.train.mesh import init_from_env

    t_phase = time.perf_counter()
    work = os.path.join(OUT_DIR, "ddp")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    procs = []
    for r in range(DDP_WORLD):
        with open(os.path.join(work, f"rank{r}.log"), "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--ddp-rank", str(r),
                 os.path.join(work, "store"), os.path.join(work, f"rank{r}.pt")],
                cwd=ROOT, stdout=log, stderr=subprocess.STDOUT))
    try:
        want = _ddp_step(torch, None, torch.device("cuda", 0))  # one process, meanwhile
        t_end = time.monotonic() + DDP_DEADLINE_S
        for p in procs:
            p.wait(timeout=max(1.0, t_end - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(work, f"rank{r}.log")) as f:
                raise AssertionError(f"13b rank {r} exited {p.returncode}: {f.read()[-3000:]}")
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=True)
             for r in range(DDP_WORLD)]
    gates = _ddp_gates(torch, ranks[0], want)
    for k, t in ranks[0]["state"].items():
        if not torch.equal(ranks[1]["state"][k], t):
            raise AssertionError(f"13b: the ranks' {k} differ after the step")
    seen = {}
    for run in (want, *ranks):
        for key, n in run["shapes"].items():
            seen[key] = seen.get(key, 0) + n
    g = torch.Generator(device="cuda").manual_seed(5)
    new = [dict(_hold_shape(torch, g, torch.device("cuda", 0), key), launches=seen[key])
           for key in sorted(seen, key=str) if key not in held]

    # world size 1 over NCCL, as `cli/train.py --multihost` joins it
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
               MASTER_PORT=str(port))
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    cfg = load_yaml_config(TRAIN_YAML)
    cfg.TRAIN.NUM_STEPS = NCCL_STEPS
    cfg.MODEL.PRETRAIN = FIXTURE
    cfg.MODEL.LOAD_MODULE = None
    cfg.GLOBAL.NUM_WORKERS = 2
    st = dict(per_step=[], losses=[])

    def on_step(step, metrics):
        st["per_step"].append({k: v for k, v in launch_counts.items() if v})
        st["losses"].append(metrics["loss"])
        if step == 2:
            st["counted"] = (dict(launch_counts), dict(launch_shapes))
        reset_launch_counts()

    mesh = init_from_env("cuda")
    try:
        if (dist.get_backend(), mesh.world) != ("nccl", 1):
            raise AssertionError(f"13b: {dist.get_backend()} at world size {mesh.world}")
        reset_launch_counts()
        run_trainer(cfg, sy.chairs_layout(5, n=TB, h=TH, w=TW), validate=lambda model: {},
                    log_dir=os.path.join(OUT_DIR, "train_runs"), compute_dtype="bfloat16",
                    val_freq=10 ** 9, on_step=on_step, mesh=mesh)
    finally:
        dist.destroy_process_group()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    for i, c in enumerate(st["per_step"], start=1):
        if c != TRAIN_WANT:
            raise AssertionError(f"13b NCCL step {i}: launches {c} != {TRAIN_WANT}")
    if not np.isfinite(st["losses"]).all():
        raise AssertionError(f"13b NCCL losses {st['losses']}")
    _emit(dict(phase="ddp", card=card, gloo_two_ranks=dict(
        backend="gloo", world=DDP_WORLD, device="cuda:0", batch=DDP_B, crop=list(DDP_CROP),
        dtype="float32", tf32="off", weights="fresh (seed 0)", gates=gates,
        new_shapes_held=new),
        nccl_world1=dict(yaml=os.path.relpath(TRAIN_YAML, ROOT), batch=TB, crop=[TH, TW],
                         dtype="bfloat16", steps=NCCL_STEPS, losses=st["losses"]),
        phase_seconds=time.perf_counter() - t_phase))
    torch.cuda.empty_cache()
    return st["counted"]


# ------------------------------------------------ phase 17: the query-sharded volume
SHARD_WORLD = 2  # two gloo ranks on card 0, model extent 2
SHARD_DEADLINE_S = 300


def sharded_kernel_row(torch, dev) -> dict:
    """Phase 17's new (kernel, shape) key, held and timed as the kernel
    phase holds its rows: G on a rank's block of the 1024x436 queries
    (Q = 3520 of 7040: rank 0's rows of the 55x128 grid, coordinates
    (1, 1, 3520, 2), levels (1, 3520, 55, 128) ... in bf16, the fixture's
    convc1) -> {kernel: rows}."""
    from focusflow_official_tpu_torch.compat.weights import load_npz
    from focusflow_official_tpu_torch.ops.coords import coords_grid
    from focusflow_official_tpu_torch.ops.corr import corr_pyramid

    g = torch.Generator(device=dev).manual_seed(17)
    bf16 = torch.bfloat16
    h1, w1 = _grid(H, W)
    q = h1 * w1 // SHARD_WORLD
    sd = load_npz(FIXTURE)
    wc = sd["flow_net.update_block.encoder.convc1.weight"].reshape(256, 324).to(dev, bf16)
    bc = sd["flow_net.update_block.encoder.convc1.bias"].to(dev, bf16)
    c = coords_grid(1, h1, w1, device=dev).reshape(1, 1, -1, 2)[:, :, :q]
    coords = (c + torch.randn(c.shape, generator=g, device=dev) * 8).contiguous()
    levels = corr_pyramid(torch.randn((1, q, h1, w1), generator=g, device=dev), 4, bf16)
    label = f"a rank's block of the queries, {q} of {h1 * w1}"
    row = _lookup_fold_row(torch, levels, coords, 4, wc.contiguous(), bc, label)
    row["shape"] = (f"{label}: levels {[tuple(lv.shape) for lv in levels]} bf16, "
                    f"(256, 324) weight")
    _emit(dict(phase="sharded_kernels", name="lookup_fold", **row))
    del levels
    torch.cuda.empty_cache()
    return {"lookup_fold": [row]}


def shard_rank_main(rank: int, store: str, out_path: str) -> int:
    """One rank of phase 17 (`chip_smoke.py --shard-rank R STORE OUT`): gloo
    on card 0 through a file store, a mesh of model extent SHARD_WORLD
    (`train/mesh.py::make_mesh`), FF-RAFT's bf16 `FlowPredictor` on it
    (the volume's queries sharded). The 1024x436 pair: a warm-up and one
    counted forward; then one 1920x1080 forward with the peak allocated
    memory reset just before. Each forward notes the
    shape of every volume product the rank computed. Saved to OUT."""
    import datetime

    import torch
    import torch.distributed as dist

    import focusflow_official_tpu_torch.models.ff_raft as ff_raft
    from focusflow_official_tpu_torch.kernels import (
        launch_counts, launch_shapes, reset_launch_counts)
    from focusflow_official_tpu_torch.predict import FlowPredictor
    from focusflow_official_tpu_torch.train.mesh import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=SHARD_WORLD, timeout=datetime.timedelta(seconds=120))
    dev = torch.device("cuda", 0)
    products = []
    corr_rows = ff_raft.corr_rows

    def rows(f1, f2):
        out = corr_rows(f1, f2)
        products.append(list(out.shape))
        return out

    ff_raft.corr_rows = rows
    try:
        mesh = make_mesh(dev, model_axis=SHARD_WORLD)
        p = FlowPredictor(_raft_cfg(), FIXTURE, dtype=torch.bfloat16, mesh=mesh)
        inputs, _ = _shift_inputs(H, W)
        p(*inputs)  # warm-up
        torch.cuda.synchronize()
        products.clear()
        reset_launch_counts()
        flow = p(*inputs)[0]
        out = dict(rank=rank, axes=[mesh.data, mesh.data_rank, mesh.model, mesh.model_rank],
                   flow=flow, counts=dict(launch_counts), shapes=dict(launch_shapes),
                   products=list(products))
        hd, _ = _shift_inputs(*FULL_HD)
        products.clear()
        reset_launch_counts()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        flow_hd = p(*hd)[0]
        out["full_hd"] = dict(flow=flow_hd, peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                              products=list(products), shapes=dict(launch_shapes))
        torch.save(out, out_path)
    finally:
        ff_raft.corr_rows = corr_rows
        dist.destroy_process_group()
    return 0


def sharded_phase(torch, card: str, held: set, cpu) -> tuple:
    """Phase 17: FF-RAFT serving with the volume's queries sharded over a
    model axis of extent 2 (`train/mesh.py::spatial_sharding`, through
    `FlowPredictor(..., mesh=...)`): two ranks over gloo on card 0 (NCCL
    refuses two ranks on one device), spawned as `--shard-rank` processes
    with a file store and a 120 s timeout (`shard_rank_main`), beside one
    process that runs the same predictor without a mesh meanwhile. Phase
    3's pair (1024x436 padded to 1024x440, bf16, 12 refinements,
    `trained_smoke.npz`, white noise and its (3, -2) px shift). Gates, on
    each rank: phase 3's gates against the f32 CPU run `cpu` and the shift,
    and phase 3's agreement bounds against the one-process bf16 flow; the
    launches of the counted forward (G 12, at Q = 3520; C1 30, C2 30);
    its one volume product 3520 rows of (55, 128), the two blocks together
    the 7040 queries. At 1920x1080, B=1: each rank's flow against the
    one process's (the agreement bounds), each rank's volume 16200 of the
    32400 rows, and each rank's peak allocated memory under the one
    process's by at least half the f32 level-0 volume (32400^2 x 4 B / 2).
    Every (kernel, shape) the ranks launched that no row holds (`held`)
    is held once against its plain version. -> (counts, launches by shape
    key) of the two ranks' counted forwards, summed."""
    import shutil

    from focusflow_official_tpu_torch.predict import FlowPredictor

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    work = os.path.join(OUT_DIR, "sharded")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    procs = []
    for r in range(SHARD_WORLD):
        with open(os.path.join(work, f"rank{r}.log"), "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--shard-rank", str(r),
                 os.path.join(work, "store"), os.path.join(work, f"rank{r}.pt")],
                cwd=ROOT, stdout=log, stderr=subprocess.STDOUT))
    try:  # one process, meanwhile
        p = FlowPredictor(_raft_cfg(), FIXTURE, dtype=torch.bfloat16)
        inputs, shift = _shift_inputs(H, W)
        one = p(*inputs)[0]
        hd, _ = _shift_inputs(*FULL_HD)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        one_hd = p(*hd)[0]
        one_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del p
        torch.cuda.empty_cache()
        t_end = time.monotonic() + SHARD_DEADLINE_S
        for proc in procs:
            proc.wait(timeout=max(1.0, t_end - time.monotonic()))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for r, proc in enumerate(procs):
        if proc.returncode != 0:
            with open(os.path.join(work, f"rank{r}.log")) as f:
                raise AssertionError(f"17 rank {r} exited {proc.returncode}: {f.read()[-3000:]}")
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(SHARD_WORLD)]
    h1, w1 = _grid(H, W)
    q = h1 * w1
    hq = _grid(*FULL_HD)[0] * _grid(*FULL_HD)[1]
    level0_gib = hq * hq * 4 / 2 ** 30
    want = {"lookup_fold": ITERS, "in_stats": 30, "in_normalize": 30}
    counts, shapes, seen, per_rank = {}, {}, {}, []
    for r, out in enumerate(ranks):
        got = {k: v for k, v in out["counts"].items() if v}
        g_keys = {k: n for k, n in out["shapes"].items() if k[0] == "lookup_fold"}
        block = len(torch.tensor_split(torch.arange(q), SHARD_WORLD)[r])
        if got != want or [(k[2], n) for k, n in g_keys.items()] != [(block, ITERS)]:
            raise AssertionError(f"17 rank {r}: launches {got}, G {g_keys}")
        if out["products"] != [[1, block, h1, w1]]:
            raise AssertionError(f"17 rank {r}: volume products {out['products']}")
        hd_block = len(torch.tensor_split(torch.arange(hq), SHARD_WORLD)[r])
        if out["full_hd"]["products"] != [[1, hd_block, *_grid(*FULL_HD)]]:
            raise AssertionError(f"17 rank {r}: 1080p products {out['full_hd']['products']}")
        gates = _gates(out["flow"], shift, cpu)
        gates["vs_one_process"] = _agreement(out["flow"], one, f"17 rank {r} vs one process")
        hd_gate = _agreement(out["full_hd"]["flow"], one_hd, f"17 rank {r} 1080p vs one process")
        saved = one_peak - out["full_hd"]["peak_gib"]
        if not saved >= level0_gib / 2:
            raise AssertionError(f"17 rank {r}: 1080p peak {out['full_hd']['peak_gib']} GiB, "
                                 f"one process {one_peak}: saved {saved} < {level0_gib / 2}")
        per_rank.append(dict(rank=r, axes=out["axes"], launches=out["counts"], g_shape=list(g_keys)[0][:3],
                             volume_rows=out["products"][0], **gates,
                             full_hd=dict(peak_gib=out["full_hd"]["peak_gib"],
                                          one_process_peak_gib=one_peak, saved_gib=saved,
                                          volume_rows=out["full_hd"]["products"][0],
                                          vs_one_process=hd_gate)))
        for k, v in out["counts"].items():
            counts[k] = counts.get(k, 0) + v
        for key, n in out["shapes"].items():
            shapes[key] = shapes.get(key, 0) + n
        for run in (out["shapes"], out["full_hd"]["shapes"]):
            for key, n in run.items():
                seen[key] = seen.get(key, 0) + n
    g = torch.Generator(device=dev).manual_seed(17)
    new = [dict(_hold_shape(torch, g, dev, key), launches=seen[key])
           for key in sorted(seen, key=str) if key not in held]
    _emit(dict(phase="sharded", card=card, backend="gloo", world=SHARD_WORLD,
               model_extent=SHARD_WORLD, device="cuda:0", shape=[1, H, W], iters=ITERS,
               dtype="bfloat16", queries=q, ranks=per_rank,
               full_hd=dict(shape=list(FULL_HD), f32_level0_gib=level0_gib,
                            one_process_peak_gib=one_peak),
               new_shapes_held=new, phase_seconds=time.perf_counter() - t_phase))
    torch.cuda.empty_cache()
    return counts, shapes


def _worst(rows: list) -> dict:
    """The max_abs_err and tol of the shape whose error is the largest
    share of its own tolerance (a tolerance of 0: bit-equal, share 0)."""
    r = max(rows, key=lambda r_: r_["max_abs_err"] / r_["tol"] if r_["tol"] else 0.0)
    return dict(max_abs_err=r["max_abs_err"], tol=r["tol"])


def _row_keys(raft: list, ff_rows: dict, pwc_rows: list, train_rows: dict,
              variant_rows: dict) -> set:
    """The launch key of every row the kernel phases hold (`train_rows` and
    `variant_rows`: path -> {kernel: rows})."""
    keys = set()
    for kr in raft:
        keys.update(r["key"] for r in kr.get("per_shape", ()))
        keys.update(k for k in (kr.get("key"), kr.get("f32", {}).get("key")) if k)
    for rows in (*ff_rows.values(), pwc_rows,
                 *(rs for by_kernel in (*train_rows.values(), *variant_rows.values())
                   for rs in by_kernel.values())):
        keys.update(r["key"] for r in rows)
    return keys


def _kernel_table(raft: list, ff_rows: dict, pwc_rows: list, train_rows: dict,
                  variant_rows: dict, drives: dict, card: str) -> list:
    """One entry per kernel: the headline shape's times (the FF-RAFT shape
    for A-C2 and the fused lookup + convc1, the first FlowFormer shape for
    E and F, PWC level 2 for D), for E and B the entry that shape ran
    (`design`), the error and tolerance of its worst shape, and every shape
    held under `per_shape` with its own tolerance. `drives` is path ->
    (launch counts, launches by shape key) of that path's counted forward.
    A kernel's `launches` are summed over the serving paths (phase 12's
    baselines among them) and the training paths (`launches_by_path`); a
    shape's are read from the same forwards by the key its wrapper counted
    it under in the kernel phase, with launches x (ms - bound_ms). Every
    shape a path launched must be held here. The training steps' rows
    (`train_rows`: path -> {kernel: rows}, for the paths "ff_raft_train",
    "ff_pwcnet_train", "ff_flowformer_train" and "raft_train";
    "flowformer_train" launches shapes that "ff_flowformer_train"'s rows
    hold) carry their backward's time and gradient check beside the
    forward's; a kernel's `train` entry gives each training path's first
    row. The variant phases' rows (`variant_rows`: path -> {kernel: rows},
    phase 14's "ff_raft_variants", phase 15's "ff_flowformer_variants")
    join their kernel's `per_shape` under that path."""
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
    for kr in table:
        for path, by_kernel in variant_rows.items():
            kr["per_shape"] += [dict(r, path=path) for r in by_kernel.get(kr["name"], ())]
        kr.update(_worst(kr["per_shape"]))
        for path, by_kernel in train_rows.items():
            rows = [dict(r, path=path) for r in by_kernel.get(kr["name"], ())]
            if not rows:
                continue
            kr["per_shape"] += rows
            head = rows[0]  # the training rows of each path: its first shape's backward
            kr.setdefault("train", {})[path] = {
                k: head[k] for k in ("shape", "ms", "backward_ms", "plain_backward_ms",
                                     "backward_bound_ms", "library_backward_ms")
                if k in head}
            kr.setdefault("backward_ms", head["backward_ms"])
            kr.setdefault("plain_backward_ms", head["plain_backward_ms"])
            kr.setdefault("train_shape", head["shape"])
            worst = _worst(kr["per_shape"])
            kr["max_abs_err"], kr["tol"] = worst["max_abs_err"], worst["tol"]
    # `launches` sums these
    paths = ("ff_raft", "ff_flowformer", "ff_pwcnet", "raft", "raft_ca", "raft_sa",
             "raft_concat", "flowformer", "ff_raft_alt_corr", "ff_raft_alt_corr_4k", "raft_s",
             "ff_raft_s", "raft_attention", "raft_conv", "ff_raft_train", "ff_pwcnet_train",
             "ff_flowformer_train", "raft_train", "flowformer_train", "ff_raft_train_aug",
             "ff_raft_train_nccl1", *FF_VARIANT_PATHS, "ff_variant_train", "ff_patch4_train",
             *_variant_train_specs(), "ff_raft_sharded")
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
    ln_kernel = layer_norm_phase(torch, dev)
    pyramid_kernel = pyramid_phase(torch, dev)
    levels_kernel = corr_levels_phase(torch, dev)
    pwc_rows = pwc_kernel_phase(torch, dev)
    torch.cuda.empty_cache()
    raft_counts, raft_cpu = end_to_end_phase(torch, card)
    f32_default_flags_phase(torch, card, defaults, raft_cpu)
    drives = {"ff_raft": raft_counts, **ff_end_to_end_phase(torch, card),
              "ff_pwcnet": pwc_end_to_end_phase(torch, card)}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    drives.update(baseline_phase(torch, card))
    _emit(dict(phase="baselines", part="serving", seconds=time.perf_counter() - t0))
    torch.cuda.empty_cache()
    # phase 14: the FF-RAFT variants (ALT_CORR, the small model, the front ends)
    t0 = time.perf_counter()
    variant_rows = {"ff_raft_variants": variant_kernel_rows(torch, dev)}
    held = lambda: _row_keys(raft_kernels, ff_rows, pwc_rows, train_rows, variant_rows)
    train_rows = {}
    drives.update(variants_phase(torch, card, held()))
    _emit(dict(phase="variants", seconds=time.perf_counter() - t0))
    torch.cuda.empty_cache()
    train_rows["ff_raft_train"] = train_kernel_rows(torch, dev)
    drives["ff_raft_train"], _, phase9 = train_phase(torch, card, held())
    for path, rows_for in (
            ("ff_pwcnet_train", pwc_train_rows), ("ff_flowformer_train", ff_train_rows),
            # phase 12: plain RAFT's step runs G, A, C1 and C2 at B=6 (rows of
            # its own); vanilla FlowFormer's launches shapes phase 11 holds
            ("raft_train", lambda t, d, _: train_kernel_rows(t, d, 6, "raft_train")),
            ("flowformer_train", None)):
        drives[path], train_rows[path], _ = train_phase(
            torch, card, held(), path,
            defaults, rows_for and (lambda shapes, fn=rows_for: fn(torch, dev, shapes)))
    # phase 13: the on-card augmentation, then data parallelism on one card
    t0 = time.perf_counter()
    drives["ff_raft_train_aug"] = device_aug_phase(torch, card)
    drives["ff_raft_train_nccl1"] = ddp_phase(torch, card, held())
    _emit(dict(phase="training_at_scale", seconds=time.perf_counter() - t0))
    torch.cuda.empty_cache()
    # phase 15: the FF-FlowFormer variants (served, trained) and the modules
    # no path runs
    t0 = time.perf_counter()
    variant_rows["ff_flowformer_variants"] = ff_variant_kernel_rows(torch, dev)
    drives.update(ff_variants_phase(torch, card))
    drives["ff_variant_train"], _ = ff_variant_train_phase(torch, card, held())
    drives["ff_patch4_train"], _ = ff_variant_train_phase(torch, card, held(), "ff_patch4_train",
                                                          FF_PATCH4_TRAIN, FF_PATCH4_AGREE)
    ff_variant_modules_phase(torch, card)
    _emit(dict(phase="ff_flowformer_variants", seconds=time.perf_counter() - t0))
    torch.cuda.empty_cache()
    # phase 16: training the FF-RAFT variants
    t0 = time.perf_counter()
    train_rows["raft_variant_train"] = raft_variant_train_rows(torch, dev)
    checked = set()  # shapes a path held once, untimed: not held again
    f32_walks = {}  # P's launches in ALT_CORR's f32 steps, the one path left to it
    for path in _variant_train_specs():
        drives[path], out, rows = variant_train_phase(torch, card, held() | checked, path,
                                                      phase9)
        checked |= {tuple(r["key"]) for r in out["new_shapes_held"]}
        if "alt_corr" in out:
            f32_walks[f"{path}_f32_step"] = out["alt_corr"]["f32_walk_launches"]["pyramid"]
        if rows:
            train_rows[path] = rows
    _emit(dict(phase="raft_variant_train", part="total", card=card,
               seconds=time.perf_counter() - t0))
    torch.cuda.empty_cache()
    # phase 17: serving with the volume's queries sharded, two ranks on card 0
    t0 = time.perf_counter()
    variant_rows["ff_raft_sharded"] = sharded_kernel_row(torch, dev)
    drives["ff_raft_sharded"] = sharded_phase(torch, card, held(), raft_cpu)
    _emit(dict(phase="sharded", part="total", card=card, seconds=time.perf_counter() - t0))
    kernels = _kernel_table(raft_kernels, ff_rows, pwc_rows, train_rows, variant_rows, drives,
                            card)
    for kr in kernels:
        if kr["launches"] == 0:
            raise AssertionError(f"{kr['name']}: no launch on any path")
    torch.cuda.empty_cache()
    eval_phase(torch, card, {row["key"] for kr in kernels for row in kr["per_shape"]})
    # LayerNorm's launches have no shape key: its entry counts them by path
    by_path = {path: counts.get("layer_norm", 0) for path, (counts, _) in drives.items()}
    if not sum(by_path.values()):
        raise AssertionError("layer_norm: no launch on any path")
    kernels.append(dict(ln_kernel, card=card, launches=sum(by_path.values()),
                        launches_by_path=by_path))
    # so do the chunk kernels': ALT_CORR's paths alone launch them, the
    # chunk-levels kernel in bf16, P in f32
    for name, entry, extra in (("corr_levels", levels_kernel, {}),
                               ("pyramid", pyramid_kernel, f32_walks)):
        by_path = {path: counts.get(name, 0) for path, (counts, _) in drives.items()}
        by_path.update(extra)
        if not sum(by_path.values()):
            raise AssertionError(f"{name}: no launch on any path")
        kernels.append(dict(entry, card=card, launches=sum(by_path.values()),
                            launches_by_path=by_path))

    _emit(dict(phase="total", seconds=time.perf_counter() - t_start))
    _emit({"kernels": kernels})
    _emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-rank"]:  # one rank of phase 13b
        sys.exit(ddp_rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    if sys.argv[1:2] == ["--shard-rank"]:  # one rank of phase 17
        sys.exit(shard_rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    sys.exit(main())

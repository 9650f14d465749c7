"""The readings that set a cell's limits, on the card, in one process:

    python3 benchmark/readings.py --workload <cell> --seeds 11 12 ... \
        [--control 21 22 23] [--faults half_batch] [--out readings.json] \
        [--aug-only] [--compute-dtype float32]

For each of `--seeds`, the program's numbers as a run compares them (the
same set-up, the same timed path and sizes, the same sample of answers;
no measured window, since the check does not read one). For each of
`--control`, the control's: the plain reference computed in fp8
(`reference/lowp.py`) put in the program's place. For each fault in
`--faults` (training: 'half_batch'; serving: 'answer'), the program with
that fault planted, on the first three of `--seeds`. A state left
unchanged ('unchanged') reads 1 by the training numbers' measure and needs
no run. `--aug-only` (training): `aug_gap` alone, with no model step of
the reference. `--compute-dtype` runs the program in another compute type
than its configuration states, with TF32 off: a witness for a number that
the stated type moves, never a reading for a limit. Each reading is
printed as a JSON line (without the per-parameter gaps) and written to
`--out` (with them). The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
for path in (str(ROOT), str(BENCH_DIR)):
    if path not in sys.path:
        sys.path.insert(0, path)

from harness.common import NoDevice, require_cards, set_environment  # noqa: E402


def serve_reading(cell, seed: int, device, *, control: bool = False, fault=None) -> dict:
    import torch

    from harness import serve

    tr, config = cell.traffic, cell.config
    p, state = serve.build_predictor(config, seed, device)
    if fault is not None:
        serve._plant(p, fault)
    pool = serve.make_pool(tr, seed, device)
    sample = serve.Sample(seed, tr["check_requests"])
    for i in range(max(tr["check_requests"], len(pool))):
        sample.offer(p(*pool[i % len(pool)]))
    del p
    torch.cuda.empty_cache()
    flows = sample.kept
    picked = list(flows)
    requests = [pool[i % len(pool)] for i in picked]
    ref = serve.reference_flows(config, state, requests, device)
    if control:
        flows = dict(zip(picked, serve.reference_flows(config, state, requests, device,
                                                       lower=True)))
    import numpy as np

    return {"flow_gap": max(serve.flow_gap(flows[i], r) for i, r in zip(picked, ref)),
            "gaps": [serve.flow_gap(flows[i], r) for i, r in zip(picked, ref)],
            "reference_mean_px": [float(np.linalg.norm(r, axis=-1).mean()) for r in ref]}


def _worst(program, reference, kept, n=3):
    from harness.train import norm_gaps

    gaps = norm_gaps(program, reference, kept)
    return [[k, gaps[k], program.get(k), reference[k]]
            for k in sorted(gaps, key=gaps.get, reverse=True)[:n]]


def train_reading(cell, seed: int, device, *, control: bool = False, fault=None,
                  aug_only: bool = False, compute_dtype=None) -> dict:
    import torch

    from harness import train
    from reference.frozen.precision import no_tf32

    tr, config = cell.traffic, cell.config
    tr = dict(tr, warmup_steps=tr["checked_steps"])
    witness = contextlib.nullcontext()
    if compute_dtype is not None:
        config, witness = dict(config, compute_dtype=compute_dtype), no_tf32()
    with witness:
        p, rec = train.setup(config, tr, seed, device, fault)
    p.loader = p.batches = None
    del p
    torch.cuda.empty_cache()
    if aug_only:
        exact = train.reference_steps(config, tr, rec, device, steps=False)[4]
        if control:
            low = train.reference_steps(config, tr, rec, device, lower=True)[0]
            rec = dict(rec, augmented=low)
        return {"aug_gap": train.compare_augmented(rec["augmented"], exact)}
    ref = train.reference_steps(config, tr, rec, device)
    if control:
        batches, losses, grads, changes, _ = train.reference_steps(config, tr, rec, device,
                                                                   lower=True)
        rec = dict(rec, augmented=batches, losses=losses, grads=grads, changes=changes)
    kept = train.kept_leaves(ref[2])
    return {**train.compare(rec, ref), "losses": rec["losses"], "reference_losses": ref[1],
            "kept": len(kept), "leaves": len(ref[2]),
            "worst_grad": _worst(rec["grads"], ref[2], kept),
            "worst_update": _worst(rec["changes"], ref[3], kept),
            "leaf_grad_gaps": train.norm_gaps(rec["grads"], ref[2], kept),
            "leaf_update_gaps": train.norm_gaps(rec["changes"], ref[3], kept),
            "leaf_reference_grads": {n: ref[2][n] for n in kept}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--out", default=None)
    ap.add_argument("--aug-only", action="store_true")
    ap.add_argument("--compute-dtype", default=None, choices=("float32", "bfloat16"))
    args = ap.parse_args(argv)
    set_environment(ROOT)
    from harness.cells import load_bench, resolve

    cell = resolve(load_bench(ROOT), args.workload)
    try:
        require_cards(cell.chips)
    except NoDevice as e:
        print(f"error: {e}", file=sys.stderr)
        return 3
    import torch

    device = torch.device("cuda:0")
    reading = {"train": train_reading, "serve": serve_reading}[cell.traffic["mode"]]
    extra = {}
    if args.aug_only or args.compute_dtype:
        extra = dict(aug_only=args.aug_only, compute_dtype=args.compute_dtype)
    runs = ([("program", s, None) for s in args.seeds]
            + [("control", s, None) for s in args.control]
            + [(f"fault:{f}", s, f) for f in args.faults for s in args.seeds[:3]])
    rows = []
    for kind, seed, fault in runs:
        t = time.perf_counter()
        row = {"workload": args.workload, "kind": kind, "seed": seed, **extra,
               **reading(cell, seed, device, control=kind == "control", fault=fault, **extra),
               "seconds": time.perf_counter() - t}
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items() if not k.startswith("leaf_")}),
              flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

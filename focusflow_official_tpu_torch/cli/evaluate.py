"""Evaluation CLI: `python -m focusflow_official_tpu_torch.cli.evaluate`.

    python -m focusflow_official_tpu_torch.cli.evaluate --yaml <config> \\
        --checkpoint <weights .npz or reference .pth> [--datasets chairs sintel kitti] \\
        [--data-root chairs=<dir> ...] [--compute-dtype float32|bfloat16] \\
        [--iters N] [--device cuda|cpu]

Runs the validation protocol (`train/evaluate.py`) on the datasets that
the YAML's CRITERION.VAL_DATASET names (or `--datasets`), with the masks of
TRAIN.MASK_TYPE from the mask tree beside each data root, and prints one
JSON line of metrics. Any YAML under `configs/` runs, the baselines and
the fusion ablation among them (a baseline ignores the masks). Refinements:
the protocol's (chairs 12, Sintel and KITTI 32) for FF-RAFT and plain
RAFT, the config's `decoder_depth` for FF-FlowFormer and vanilla
FlowFormer, `--iters` for every dataset where given. File datasets need cv2 and PIL,
and the YAML needs PyYAML.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence

import torch

from ..config import load_yaml_config
from ..data.datasets import KITTI, FlyingChairs, MpiSintel
from ..models import FlowFormerConfig
from ..predict import FlowPredictor
from ..train import evaluate as eval_mod

DEFAULT_DATA_ROOT = {
    "chairs": "data/FlyingChairs_release",
    "things": "data/FlyingThings3D",
    "sintel": "data/Sintel-custom",
    "kitti": "data/KITTI-custom",
}


def mask_roots(data_root: Dict[str, str]) -> Dict[str, str]:
    """`<parent>/mask/<name>` beside each data root `<parent>/<name>`."""
    return {k: os.path.join(os.path.dirname(v) or ".", "mask", os.path.basename(v))
            for k, v in data_root.items()}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--yaml", required=True)
    parser.add_argument("--checkpoint", required=True,
                        help="an .npz of flat flax variables or a reference .pth")
    parser.add_argument("--datasets", nargs="+", default=None,
                        help="override CRITERION.VAL_DATASET")
    parser.add_argument("--data-root", nargs="*", default=None, metavar="NAME=DIR")
    parser.add_argument("--compute-dtype", default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--iters", type=int, default=None,
                        help="refinements for every dataset")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    cfg = load_yaml_config(args.yaml)
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[args.compute_dtype]
    predictor = FlowPredictor(args.yaml, args.checkpoint, device=args.device, dtype=dtype)
    iters = args.iters
    if iters is None and isinstance(predictor.cfg, FlowFormerConfig):
        iters = predictor.iters  # FlowFormer evaluates at its decoder_depth
    its = {} if iters is None else {"iters": iters}

    data_root = dict(DEFAULT_DATA_ROOT)
    for kv in args.data_root or ():
        k, v = kv.split("=", 1)
        data_root[k] = v
    mask_root = mask_roots(data_root)
    mask_type = cfg.TRAIN.MASK_TYPE

    model = predictor.model
    results = {}
    for val_dataset in args.datasets or cfg.CRITERION.VAL_DATASET:
        if val_dataset == "chairs":
            ds = FlyingChairs(data_root["chairs"], mask_root["chairs"],
                              split="validation", mask_type=mask_type)
            results.update(eval_mod.validate_chairs(model, ds, mask_type, **its))
        elif val_dataset == "sintel":
            dss = {t: MpiSintel(data_root["sintel"], mask_root["sintel"], split="val",
                                dstype=t, mask_type=mask_type)
                   for t in ("clean", "final")}
            results.update(eval_mod.validate_sintel(model, dss, mask_type, **its))
        elif val_dataset == "kitti":
            ds = KITTI(data_root["kitti"], mask_root["kitti"], split="val",
                       mask_type=mask_type)
            results.update(eval_mod.validate_kitti(model, ds, mask_type, **its))
        else:
            raise ValueError(f"unknown validation dataset {val_dataset!r}")
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()

"""A cell cut to a size a CPU test run can hold: the configuration's
widths as they are, f32, 2 refinements, a batch of 2, 64x96 crops of
80x112 pairs (serving: 60x90 pairs), one-request pools. `control_cell`
keeps the configuration's 12 refinements at 160x320 (serving) or 128x192
crops of 160x224 pairs (training), where the fp8 control parts from f32
as it does at the cells' own sizes."""

from __future__ import annotations

import copy

from harness.cells import load_bench, resolve


def tiny_cell(name: str):
    cell = copy.deepcopy(resolve(load_bench(), name))
    y = cell.config["yaml"]
    cell.config["compute_dtype"] = "float32"
    y["MODEL"]["ITERS" if cell.config["family"] == "ff_raft" else "decoder_depth"] = 2
    y["TRAIN"]["BATCH_SIZE"] = 2
    y["TRAIN"]["IMAGE_SIZE"] = [64, 96]
    y["GLOBAL"]["NUM_WORKERS"] = 2
    if cell.traffic["mode"] == "train":
        cell.traffic.update(height=80, width=112, pool_pairs=8, warmup_steps=3, trace_steps=1)
    else:
        cell.traffic.update(batch=2, height=60, width=90, pool_requests=3, warmup_requests=1,
                            trace_requests=1, check_requests=2)
    return cell


def control_cell(name: str):
    cell = tiny_cell(name)
    full = resolve(load_bench(), name).config["yaml"]["MODEL"]
    key = "ITERS" if cell.config["family"] == "ff_raft" else "decoder_depth"
    cell.config["yaml"]["MODEL"][key] = full[key]
    if cell.traffic["mode"] == "train":
        cell.config["yaml"]["TRAIN"]["IMAGE_SIZE"] = [128, 192]
        cell.traffic.update(height=160, width=224)
    else:
        cell.traffic.update(batch=1, height=160, width=320)
    return cell

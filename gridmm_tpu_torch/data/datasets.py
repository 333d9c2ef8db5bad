"""Dataset annotation loading, R2R/REVERIE/SOON/RxR instruction files (a copy
of the JAX-free gridmm_tpu/data/datasets.py, so the port needs nothing of the
JAX package).

Honors the reference's annotation contracts:
  * `{DATASET}_{split}_enc.json` (bert) / `_enc_xlmr.json` (xlm) with
    `instructions` + `instr_encodings` per path item
    (map_nav_src/r2r/data_utils.py:5-27).
  * items are exploded one-instruction-per-entry with instr_id
    "{path_id}_{j}" (data_utils.py:29-45).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional


def load_instr_datasets(anno_dir: str, dataset: str, splits, tokenizer: str = "bert"):
    data = []
    for split in splits:
        if "/" not in split:
            suffix = "_enc.json" if tokenizer == "bert" else "_enc_xlmr.json"
            path = os.path.join(anno_dir, f"{dataset.upper()}_{split}{suffix}")
            with open(path) as f:
                new_data = json.load(f)
            if split == "val_train_seen":
                new_data = new_data[:50]
        else:  # augmented file given by path
            with open(split) as f:
                new_data = json.load(f)
        data += new_data
    return data


def construct_instrs(anno_dir: str, dataset: str, splits,
                     tokenizer: str = "bert",
                     max_instr_len: int = 512) -> List[dict]:
    """One entry per instruction, instr_id = '{path_id}_{j}'."""
    out = []
    for item in load_instr_datasets(anno_dir, dataset, splits, tokenizer):
        if "instr_encoding" in item:  # RxR-style pre-exploded entries
            new_item = dict(item)
            new_item["instr_encoding"] = item["instr_encoding"][:max_instr_len]
            out.append(new_item)
            continue
        for j, instr in enumerate(item["instructions"]):
            new_item = dict(item)
            new_item["instr_id"] = f"{item['path_id']}_{j}"
            new_item["instruction"] = instr
            new_item["instr_encoding"] = item["instr_encodings"][j][:max_instr_len]
            del new_item["instructions"]
            del new_item["instr_encodings"]
            out.append(new_item)
    return out


def load_obj2vps(bbox_file: str) -> Dict[str, list]:
    """REVERIE object->viewpoints map (reverie/data_utils.py:95-115 contract:
    BBoxes.json keyed by scan_vp with per-object visible_pos lists)."""
    obj2vps: Dict[str, list] = {}
    with open(bbox_file) as f:
        bbox_data = json.load(f)
    for scanvp, value in bbox_data.items():
        scan = scanvp.split("_")[0]
        for objid, objinfo in value.items():
            if objinfo["visible_pos"]:
                obj2vps.setdefault(f"{scan}_{objid}", [])
                obj2vps[f"{scan}_{objid}"].extend(objinfo["visible_pos"])
    return obj2vps


def soon_pseudo_obj_labels(data: List[dict], world) -> List[dict]:
    """SOON object pseudo-labels from GT bbox polygons.

    SOON annotations carry only bbox polygons at goal viewpoints, not object
    ids; the reference derives object supervision by matching detector objects
    to the bbox (soon/env.py:331-424 polygon scoring; SoonTextPathData obj
    targets). Here: for each episode, the first object at the goal viewpoint
    whose (heading, elevation) direction falls inside the GT polygon becomes
    the pseudo GT object (sets `objId` for pretraining OG and `gt_obj_id` for
    the fine-tune og teacher). Mutates and returns `data`.
    """
    from gridmm_tpu_torch.env.discrete import (soon_convert_elevation,
                                               soon_convert_heading)
    from gridmm_tpu_torch.env.metrics import point_in_polygon

    for item in data:
        goal = item["path"][-1]
        bb = (item.get("bboxes") or {}).get(goal)
        if not bb:
            continue
        # bbox polygons live in the SOON annotations' converted [0,1)
        # direction units (soon/data_utils.py:21-25); detector objects carry
        # raw radians — convert before the containment test
        corners = [(bb["target"][c]["heading"], bb["target"][c]["elevation"])
                   for c in ("left_top", "right_top", "right_bottom",
                             "left_bottom")]
        for obj in world.objects(item["scan"], goal):
            if point_in_polygon(
                    soon_convert_heading(float(obj.get("heading", 0.0))),
                    soon_convert_elevation(float(obj.get("elevation", 0.0))),
                    corners):
                item["objId"] = obj["obj_id"]
                item["gt_obj_id"] = obj["obj_id"]
                break
    return data

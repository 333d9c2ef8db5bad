"""VLN evaluation metrics (a copy of the JAX-free
gridmm_tpu/env/metrics.py, so the port needs nothing of the JAX package).

Semantics follow the reference exactly:
SR/OSR/SPL/TL/NE (map_nav_src/r2r/env.py:652-679), nDTW/SDTW
(r2r/eval_utils.py:6-26), CLS (r2r/eval_utils.py:28-42), aggregated as
percentages (env.py:696-708). Distances are graph shortest-path metres.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

ERROR_MARGIN = 3.0


def dtw_scores(shortest: Dict[str, Dict[str, float]],
               prediction: Sequence[str], reference: Sequence[str],
               success: float | None = None,
               threshold: float = ERROR_MARGIN) -> Dict[str, float]:
    """Dynamic-time-warping alignment cost between trajectories, normalized
    per Ilharco et al.; vectorized over the reference axis."""
    n, m = len(prediction), len(reference)
    cost = np.asarray([[shortest[p][r] for r in reference] for p in prediction])
    dtw = np.full((n + 1, m + 1), np.inf)
    dtw[0, 0] = 0.0
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            dtw[i, j] = cost[i - 1, j - 1] + min(
                dtw[i - 1, j], dtw[i, j - 1], dtw[i - 1, j - 1])
    d = dtw[n, m]
    ndtw = float(np.exp(-d / (threshold * m)))
    if success is None:
        success = float(shortest[prediction[-1]][reference[-1]] < threshold)
    return {"DTW": float(d), "nDTW": ndtw, "SDTW": success * ndtw}


def cls_score(shortest: Dict[str, Dict[str, float]],
              prediction: Sequence[str], reference: Sequence[str],
              threshold: float = ERROR_MARGIN) -> float:
    """Coverage-weighted by length score (Jain et al.)."""

    def path_len(nodes):
        return float(np.sum([shortest[a][b]
                             for a, b in zip(nodes[:-1], nodes[1:])]))

    coverage = float(np.mean([
        np.exp(-min(shortest[u][v] for v in prediction) / threshold)
        for u in reference]))
    expected = coverage * path_len(reference)
    denom = expected + abs(expected - path_len(prediction))
    score = expected / denom if denom > 0 else 0.0
    return coverage * score


def evaluate_trajectory(
    shortest: Dict[str, Dict[str, float]],
    pred_path: Sequence[Sequence[str]],   # list of per-action sub-paths
    gt_path: Sequence[str],
    error_margin: float = ERROR_MARGIN,
) -> Dict[str, float]:
    """Single-trajectory scores (env.py:652-679)."""
    path: List[str] = [vp for seg in pred_path for vp in seg]
    assert gt_path[0] == path[0], "trajectory must start at the GT start"

    goal = gt_path[-1]
    nearest = min(path, key=lambda vp: shortest[vp][goal])

    scores: Dict[str, float] = {}
    scores["nav_error"] = shortest[path[-1]][goal]
    scores["oracle_error"] = shortest[nearest][goal]
    scores["action_steps"] = len(pred_path) - 1
    scores["trajectory_steps"] = len(path) - 1
    scores["trajectory_lengths"] = float(np.sum(
        [shortest[a][b] for a, b in zip(path[:-1], path[1:])]))
    gt_lengths = float(np.sum(
        [shortest[a][b] for a, b in zip(gt_path[:-1], gt_path[1:])]))
    scores["success"] = float(scores["nav_error"] < error_margin)
    scores["spl"] = scores["success"] * gt_lengths / max(
        scores["trajectory_lengths"], gt_lengths, 0.01)
    scores["oracle_success"] = float(scores["oracle_error"] < error_margin)
    scores.update(dtw_scores(shortest, path, gt_path, scores["success"],
                             error_margin))
    scores["CLS"] = cls_score(shortest, path, gt_path, error_margin)
    return scores


def point_in_polygon(x: float, y: float, polygon) -> bool:
    """Ray-casting point-in-polygon (SOON bbox det metrics,
    map_nav_src/soon/env.py:331-424 use shapely polygons; dependency-free
    equivalent)."""
    inside = False
    n = len(polygon)
    for i in range(n):
        x1, y1 = polygon[i]
        x2, y2 = polygon[(i + 1) % n]
        if (y1 > y) != (y2 > y):
            xin = (x2 - x1) * (y - y1) / (y2 - y1 + 1e-12) + x1
            if x < xin:
                inside = not inside
    return inside


def evaluate_reverie_trajectory(
    shortest: Dict[str, Dict[str, float]],
    pred_path, gt_path, gt_end_vps, pred_obj_id, gt_obj_id,
    error_margin: float = ERROR_MARGIN,
) -> Dict[str, float]:
    """REVERIE scores (reverie/env.py:685-709): navigation success is
    stopping AT any viewpoint where the GT object is visible (obj2vps /
    gt_end_vps), oracle success is PASSING THROUGH one (membership, not a
    distance margin), and RGS is the unconditional object-id match — the
    reference compares str(pred) == str(gt) without requiring success (a
    correct grounding is only offered at goal viewpoints in real data, so
    rgs <= sr there without being enforced by the formula).
    nav_error/nDTW/CLS are framework extras graded against the GT path end;
    the reference does not report them for REVERIE."""
    scores = evaluate_trajectory(shortest, pred_path, gt_path, error_margin)
    path = [vp for seg in pred_path for vp in seg]
    goal_vps = set(gt_end_vps)
    scores["success"] = float(path[-1] in goal_vps)
    scores["oracle_success"] = float(any(vp in goal_vps for vp in path))
    gt_lengths = float(np.sum(
        [shortest[a][b] for a, b in zip(gt_path[:-1], gt_path[1:])]))
    denom = max(scores["trajectory_lengths"], gt_lengths, 0.01)
    scores["spl"] = scores["success"] * gt_lengths / denom
    rgs = float(str(pred_obj_id) == str(gt_obj_id))
    scores["rgs"] = rgs
    scores["rgspl"] = rgs * gt_lengths / denom
    # aliases kept for this framework's earlier score dicts
    scores["det_success"] = rgs
    scores["det_spl"] = scores["rgspl"]
    return scores


def evaluate_soon_trajectory(
    shortest: Dict[str, Dict[str, float]],
    pred_path, gt_path, gt_bboxes: Dict[str, dict],
    obj_heading: float, obj_elevation: float,
    error_margin: float = ERROR_MARGIN,
) -> Dict[str, float]:
    """SOON scores (map_nav_src/soon/env.py:331-424): navigation success is
    measured against the GT goal — unless the agent stopped at ANY viewpoint
    carrying a GT bbox, which then becomes the goal ("follow the original
    evaluation", :345-349); detection success requires the predicted object
    direction to fall inside that bbox polygon in (heading, elevation) space.

    gt_bboxes: {vp: {heading, elevation, target: {left_top: {heading,
    elevation}, right_top, right_bottom, left_bottom}}}."""
    path: List[str] = [vp for seg in pred_path for vp in seg]
    assert gt_path[0] == path[0], "trajectory must start at the GT start"
    start_vp, goal_vp = gt_path[0], gt_path[-1]

    # oracle uses the ORIGINAL goal (computed before the goal update)
    nearest = min(path, key=lambda vp: shortest[vp][goal_vp])

    scores: Dict[str, float] = {}
    det = False
    if path[-1] in gt_bboxes:
        goal_vp = path[-1]
        bb = gt_bboxes[path[-1]]
        scores["heading_error"] = abs(bb["heading"] - obj_heading)
        scores["elevation_error"] = abs(bb["elevation"] - obj_elevation)
        scores["point_det_error"] = float(np.hypot(
            bb["heading"] - obj_heading, bb["elevation"] - obj_elevation))
        corners = [(bb["target"][c]["heading"], bb["target"][c]["elevation"])
                   for c in ("left_top", "right_top", "right_bottom",
                             "left_bottom")]
        det = point_in_polygon(obj_heading, obj_elevation, corners)

    scores["action_steps"] = len(pred_path) - 1
    scores["trajectory_steps"] = len(path) - 1
    scores["trajectory_lengths"] = float(np.sum(
        [shortest[a][b] for a, b in zip(path[:-1], path[1:])]))
    scores["nav_error"] = shortest[path[-1]][goal_vp]
    scores["oracle_error"] = shortest[nearest][goal_vp]
    scores["success"] = float(scores["nav_error"] < error_margin)
    scores["oracle_success"] = float(scores["oracle_error"] < error_margin)
    scores["goal_progress"] = (shortest[start_vp][goal_vp]
                               - shortest[path[-1]][goal_vp])
    # SOON uses the shortest-dist gt length, not the gt-path length (:389-390)
    gt_lengths = shortest[gt_path[0]][goal_vp]
    denom = max(scores["trajectory_lengths"], gt_lengths, 0.01)
    scores["spl"] = scores["success"] * gt_lengths / denom
    scores["det_success"] = float(det)
    scores["det_spl"] = float(det) * gt_lengths / denom
    # dtw/cls extras (our framework reports them uniformly across datasets)
    scores.update(dtw_scores(shortest, path, gt_path, scores["success"],
                             error_margin))
    scores["CLS"] = cls_score(shortest, path, gt_path, error_margin)
    return scores


def aggregate_metrics(per_traj: List[Dict[str, float]]) -> Dict[str, float]:
    """Mean metrics as percentages (env.py:696-708)."""
    acc = defaultdict(list)
    for scores in per_traj:
        for k, v in scores.items():
            acc[k].append(v)
    out = {
        "action_steps": float(np.mean(acc["action_steps"])),
        "steps": float(np.mean(acc["trajectory_steps"])),
        "lengths": float(np.mean(acc["trajectory_lengths"])),
        "nav_error": float(np.mean(acc["nav_error"])),
        "oracle_error": float(np.mean(acc["oracle_error"])),
        "sr": float(np.mean(acc["success"])) * 100,
        "oracle_sr": float(np.mean(acc["oracle_success"])) * 100,
        "spl": float(np.mean(acc["spl"])) * 100,
        "nDTW": float(np.mean(acc["nDTW"])) * 100,
        "SDTW": float(np.mean(acc["SDTW"])) * 100,
        "CLS": float(np.mean(acc["CLS"])) * 100,
    }
    if "det_success" in acc:
        out["det_sr"] = float(np.mean(acc["det_success"])) * 100
        out["det_spl"] = float(np.mean(acc["det_spl"])) * 100
    if "rgs" in acc:  # REVERIE aggregate names (reverie/env.py:727-736)
        out["rgs"] = float(np.mean(acc["rgs"])) * 100
        out["rgspl"] = float(np.mean(acc["rgspl"])) * 100
    if "goal_progress" in acc:
        out["goal_progress"] = float(np.mean(acc["goal_progress"]))
    return out

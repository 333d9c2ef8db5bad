"""Discrete (panoramic-graph) navigation environment (a copy of the JAX-free
gridmm_tpu/env/discrete.py, so the port needs nothing of the JAX package).

Host-side twin of the reference's EnvBatch + R2RNavBatch
(map_nav_src/r2r/env.py:125-709) with one architectural difference: the grid
memory map is NOT built here. The env ships raw ingredients (depth patches,
CLIP grid features, pose) and the device pipeline builds the grid inside the
device step (ops/geometry.py) — the reference instead rebuilds it
in numpy on host every step (env.py:267-374).

Simulator note: the reference drives MatterSim only as a graph-teleport +
candidate oracle (agent.py:239-255 moves via newEpisode; rendering is disabled,
env.py:158). This environment implements that contract directly from the nav
graph; a MatterSim-backed provider can be swapped in for pixel-exact parity.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from gridmm_tpu_torch.env.graph import angle_features, rel_pos_features
from gridmm_tpu_torch.env.metrics import aggregate_metrics, evaluate_trajectory
from gridmm_tpu_torch.env.nav_graph import NavGraph
from gridmm_tpu_torch.env.world import WorldProvider

DEG30 = math.radians(30)


def soon_convert_heading(x: float) -> float:
    """radians -> [0,1) turn units (soon/data_utils.py:21-22)."""
    return (x % (2 * math.pi)) / (2 * math.pi)


def soon_convert_elevation(x: float) -> float:
    """radians -> [0,1), 0.5 at level (soon/data_utils.py:13-25:
    normalize_angle to (-pi,pi] then shift)."""
    pi2 = 2 * math.pi
    x = x % pi2
    if x > math.pi:
        x -= pi2
    return (x + math.pi) / pi2


def view_index_heading(view_index: int) -> float:
    return (view_index % 12) * DEG30


def view_index_elevation(view_index: int) -> float:
    return (view_index // 12 - 1) * DEG30


def nearest_view_index(heading: float, elevation: float) -> int:
    h_idx = int(round(heading / DEG30)) % 12
    e_idx = min(max(int(round(elevation / DEG30)) + 1, 0), 2)
    return e_idx * 12 + h_idx


def all_point_angle_features(angle_feat_size: int = 4) -> np.ndarray:
    """(36, 36, A): angle features of every view relative to every base view
    (utils/data.py:131-154, computed geometrically instead of by stepping a
    headless simulator)."""
    out = np.zeros((36, 36, angle_feat_size), np.float32)
    for base in range(36):
        bh, be = view_index_heading(base), view_index_elevation(base)
        for ix in range(36):
            out[base, ix] = angle_features(
                view_index_heading(ix) - bh, view_index_elevation(ix) - be,
                angle_feat_size)
    return out


class EpisodeState:
    """Per-slot simulator state (scan, node, orientation)."""

    __slots__ = ("scan", "viewpoint", "heading", "elevation")

    def __init__(self, scan: str, viewpoint: str, heading: float,
                 elevation: float = 0.0):
        self.scan = scan
        self.viewpoint = viewpoint
        self.heading = heading
        self.elevation = elevation

    @property
    def view_index(self) -> int:
        return nearest_view_index(self.heading, self.elevation)


class DiscreteNavEnv:
    """Minibatched episodic environment over panorama graphs."""

    def __init__(
        self,
        world: WorldProvider,
        graphs: Dict[str, NavGraph],
        data: List[dict],
        batch_size: int = 8,
        angle_feat_size: int = 4,
        seed: int = 0,
        name: str = "train",
        sel_data_idxs: Optional[Tuple[int, int]] = None,
    ):
        self.world = world
        self.graphs = graphs
        self.data = list(data)
        self.batch_size = batch_size
        self.angle_feat_size = angle_feat_size
        self.name = name

        self.gt_trajs = {
            x["instr_id"]: (x["scan"], x["path"]) for x in self.data
            if len(x["path"]) > 1
        }
        self._items_by_id = {x["instr_id"]: x for x in self.data}
        # eval-split sharding (main_nav.py:79, r2r/env.py:427-435)
        if sel_data_idxs is not None:
            t_split, n_splits = sel_data_idxs
            per = len(self.data) // n_splits
            start = per * t_split
            end = None if t_split == n_splits - 1 else start + per
            self.data = self.data[start:end]

        self._rng = random.Random(seed)
        self._rng.shuffle(self.data)
        self.ix = 0
        self.batch: List[dict] = []
        self.states: List[EpisodeState] = []

        tables = {s: g.all_pairs_tables() for s, g in graphs.items()}
        self.shortest_distances = {s: t[0] for s, t in tables.items()}
        self.shortest_paths = {s: t[1] for s, t in tables.items()}
        self.angle_table = all_point_angle_features(angle_feat_size)
        self._cand_cache: Dict[str, list] = {}

    def size(self) -> int:
        return len(self.data)

    # ------------------------------------------------------------- iteration
    def _next_minibatch(self, batch_size: Optional[int] = None) -> None:
        bs = batch_size or self.batch_size
        batch = self.data[self.ix: self.ix + bs]
        if len(batch) < bs:
            self._rng.shuffle(self.data)
            self.ix = bs - len(batch)
            batch += self.data[: self.ix]
        else:
            self.ix += bs
        self.batch = batch

    def reset_epoch(self, shuffle: bool = False) -> None:
        if shuffle:
            self._rng.shuffle(self.data)
        self.ix = 0

    # ------------------------------------------------------------ candidates
    def candidates(self, scan: str, viewpoint: str, view_index: int,
                   view_fts: np.ndarray) -> List[dict]:
        """Adjacent-node candidates with their best view and features
        (make_candidate, env.py:506-581, computed from graph geometry).
        Geometry is cached per (scan, viewpoint) like the reference's
        buffered_state_dict; features are re-attached per call (they may be
        augmented per epoch)."""
        key = f"{scan}_{viewpoint}"
        cached = self._cand_cache.get(key)
        if cached is None:
            cur_pos = self.graphs[scan].positions[viewpoint]
            cached = []
            for nb, _w in self.graphs[scan].neighbors(viewpoint).items():
                nb_pos = self.graphs[scan].positions[nb]
                h, e, _d = rel_pos_features(cur_pos, nb_pos)
                cached.append((nb, nearest_view_index(h, e), h, e,
                               tuple(nb_pos)))
            self._cand_cache[key] = cached

        base_h = view_index_heading(view_index)
        base_e = view_index_elevation(view_index)
        out = []
        for nb, point_id, h, e, nb_pos in cached:
            heading = h - base_h
            elevation = e - base_e
            ang = angle_features(heading, elevation, self.angle_feat_size)
            out.append({
                "viewpointId": nb,
                "pointId": point_id,
                "heading": heading,
                "elevation": elevation,
                "position": nb_pos,
                "feature": np.concatenate(
                    [view_fts[point_id], ang]).astype(np.float32),
            })
        return out

    # ------------------------------------------------------------------- obs
    def _get_obs(self) -> List[dict]:
        obs = []
        for i, state in enumerate(self.states):
            item = self.batch[i]
            scan, vp = state.scan, state.viewpoint
            view_fts = self.world.view_features(scan, vp)
            cand = self.candidates(scan, vp, state.view_index, view_fts)
            feature = np.concatenate(
                [view_fts, self.angle_table[state.view_index]], axis=-1)
            pos = self.world.position(scan, vp)
            ob = {
                "instr_id": item["instr_id"],
                "scan": scan,
                "viewpoint": vp,
                "viewIndex": state.view_index,
                "position": pos,
                "heading": state.heading,
                "elevation": state.elevation,
                "feature": feature.astype(np.float32),
                "candidate": cand,
                "instruction": item.get("instruction", ""),
                "instr_encoding": np.asarray(item["instr_encoding"], np.int32),
                "gt_path": item["path"],
                "path_id": item.get("path_id", item["instr_id"]),
                # grid-memory ingredients (device builds the map)
                "depth_patches": self.world.depth_patches(scan, vp),
                "grid_fts": self.world.grid_features(scan, vp),
            }
            if ob["instr_id"] in self.gt_trajs:
                ob["distance"] = self.shortest_distances[scan][vp][
                    item["path"][-1]]
            else:
                ob["distance"] = 0.0
            # object grounding (REVERIE/SOON): world may expose per-vp objects
            if hasattr(self.world, "objects"):
                af = self.angle_feat_size
                objs = []
                for o in self.world.objects(scan, vp):
                    if "heading" in o:
                        o = dict(o)
                        lf = np.array(o["loc_fts"], np.float32, copy=True)
                        # fine-tune obs recompute object angle features
                        # RELATIVE to the agent's current orientation
                        # (reverie/data_utils.py:44-47, soon:108-111); the
                        # PRETRAIN data code keeps them ABSOLUTE
                        # (pretrain_src/data/dataset.py:533-540) — the
                        # reference trains through that inconsistency, so
                        # data/pretrain_data.py deliberately does NOT share
                        # this recompute
                        lf[:af] = angle_features(
                            float(o["heading"]) - state.heading,
                            float(o["elevation"]) - state.elevation, af)
                        o["loc_fts"] = lf
                        # SOON exports predicted directions in converted
                        # [0,1) units (soon/data_utils.py:117, env.py:279)
                        o["direction"] = (
                            soon_convert_heading(float(o["heading"])),
                            soon_convert_elevation(float(o["elevation"])))
                    objs.append(o)
                ob["objects"] = objs
                ob["gt_obj_id"] = item.get("gt_obj_id")
                ob["gt_end_vps"] = item.get("gt_end_vps", [item["path"][-1]])
            obs.append(ob)
        return obs

    def reset(self) -> List[dict]:
        self._next_minibatch()
        self.states = [
            EpisodeState(item["scan"], item["path"][0],
                         float(item.get("heading", 0.0)))
            for item in self.batch
        ]
        return self._get_obs()

    def teleport(self, i: int, viewpoint: str, heading: float,
                 elevation: float) -> None:
        """Move slot i (agent.py:239-255 does this via sim.newEpisode)."""
        st = self.states[i]
        self.states[i] = EpisodeState(st.scan, viewpoint, heading, elevation)

    # ------------------------------------------------------------------ eval
    def eval_metrics(self, preds: List[dict]) -> Tuple[dict, dict]:
        from gridmm_tpu_torch.env.metrics import (evaluate_reverie_trajectory,
                                            evaluate_soon_trajectory)

        per_traj = []
        instr_ids = []
        for item in preds:
            instr_id = item["instr_id"]
            scan, gt = self.gt_trajs[instr_id]
            data_item = self._items_by_id.get(instr_id, {})
            if data_item.get("bboxes"):
                # SOON: bbox-polygon detection metrics (soon/env.py:331-424)
                per_traj.append(evaluate_soon_trajectory(
                    self.shortest_distances[scan], item["trajectory"], gt,
                    data_item["bboxes"],
                    float(item.get("pred_obj_heading") or 0.0),
                    float(item.get("pred_obj_elevation") or 0.0)))
            elif data_item.get("gt_obj_id") is not None:
                per_traj.append(evaluate_reverie_trajectory(
                    self.shortest_distances[scan], item["trajectory"], gt,
                    data_item.get("gt_end_vps", [gt[-1]]),
                    item.get("pred_obj_id"), data_item["gt_obj_id"]))
            else:
                per_traj.append(evaluate_trajectory(
                    self.shortest_distances[scan], item["trajectory"], gt))
            instr_ids.append(instr_id)
        avg = aggregate_metrics(per_traj)
        detail = {"instr_id": instr_ids, "scores": per_traj}
        return avg, detail


def synthetic_episodes(world, num: int, seed: int = 0,
                       max_len: int = 6,
                       with_objects: bool = False,
                       soon_bboxes: bool = False) -> List[dict]:
    """Generate GT trajectories as graph shortest paths on a SyntheticWorld.

    with_objects=True labels each episode with a goal object visible at the
    trajectory end (REVERIE-style `objId`, reverie/data_utils.py episodes);
    episodes whose goal node has no objects are resampled.
    soon_bboxes=True additionally attaches a SOON-style GT bbox polygon
    around the goal object's direction (soon/env.py bboxes contract)."""
    rng = random.Random(seed)
    scans = world.scans()
    paths_cache = {s: world.graphs[s].all_pairs_paths() for s in scans}
    out = []
    for k in range(num):
        scan = rng.choice(scans)
        vps = list(world.graphs[scan].positions)
        for _attempt in range(200):
            a, b = rng.sample(vps, 2)
            path = paths_cache[scan][a].get(b)
            if not (path and 2 <= len(path) <= max_len):
                continue
            if with_objects and not world.objects(scan, path[-1]):
                continue
            break
        else:
            raise ValueError(
                f"could not sample a valid episode for scan {scan} in 200 "
                f"attempts (max_len={max_len}, with_objects={with_objects}) "
                "— the synthetic world is too constrained")
        item = {
            "instr_id": f"syn_{k}",
            "path_id": f"syn_{k}",
            "scan": scan,
            "path": path,
            "heading": rng.uniform(0, 2 * math.pi),
            "instruction": "walk to the goal",
            "instr_encoding": [101] + [rng.randrange(1000, 29000)
                                       for _ in range(rng.randrange(6, 16))] + [102],
        }
        if with_objects:
            objs = world.objects(scan, path[-1])
            if objs:
                obj = rng.choice(objs)
                item["objId"] = obj["obj_id"]
                # eval-side keys (env/discrete.py _eval_item reads gt_obj_id/
                # gt_end_vps; objId is the pretrain-trajectory spelling) —
                # the same object, so det metrics grade against the label
                # the episode actually carries
                item["gt_obj_id"] = obj["obj_id"]
                item["gt_end_vps"] = [path[-1]]
                if soon_bboxes:
                    # GT bboxes live in the SOON annotations' converted [0,1)
                    # direction units (soon/data_utils.py:21-25; the agent's
                    # predicted direction arrives in the same units)
                    h = soon_convert_heading(float(obj.get("heading", 0.0)))
                    e = soon_convert_elevation(
                        float(obj.get("elevation", 0.0)))
                    dh, de = 0.05, 0.04
                    item["bboxes"] = {path[-1]: {
                        "heading": h, "elevation": e,
                        "target": {
                            "left_top": {"heading": h - dh,
                                         "elevation": e + de},
                            "right_top": {"heading": h + dh,
                                          "elevation": e + de},
                            "right_bottom": {"heading": h + dh,
                                             "elevation": e - de},
                            "left_bottom": {"heading": h - dh,
                                            "elevation": e - de},
                        }}}
        out.append(item)
    return out

"""Trajectory datasets for pretraining (MLM/MRC/SAP/OG) from annotation files
(twin of gridmm_tpu/data/pretrain_data.py).

Host-side twin of pretrain_src/data/{dataset,tasks}.py: jsonl trajectory items
(scan, path, instr_encoding — R2R_*_enc.jsonl contract, dataset.py:101-108) are
expanded into fixed-shape PretrainBatch tensors:

  * end-viewpoint sampling pos/neg_in_gt_path/neg_others (dataset.py:234-246),
    trajectories truncated to TRAIN_MAX_STEP (dataset.py:28)
  * per-step panorama tokens: candidate views first (nav_type 1) then the
    remaining views (nav_type 0) (dataset.py get_traj_pano_fts)
  * gmap in our STABLE discovery-slot space with visited/candidate scatter
    index maps (replaces the per-item python aggregation loops)
  * the grid point cloud is built with the same geometry the device path
    runs (ops/geometry), on CPU tensors
  * task labels: BERT-style MLM masking (tasks.py random_word), MRC view
    masking with soft labels (tasks.py:164-227), SAP teacher actions
    (dataset.py global/local act labels)
"""

from __future__ import annotations

import json
import random
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from gridmm_tpu_torch.config import GridMMConfig
from gridmm_tpu_torch.env.discrete import (all_point_angle_features,
                                           nearest_view_index,
                                           view_index_elevation,
                                           view_index_heading)
from gridmm_tpu_torch.env.graph import (MAX_DIST, MAX_STEP, angle_features,
                                        rel_pos_features)
from gridmm_tpu_torch.ops import geometry as G
from gridmm_tpu_torch.train.pretrain import (PretrainBatch,
                                             pretrain_batch_to_device)

TRAIN_MAX_STEP = 20


def load_trajectory_jsonl(paths: Sequence[str]) -> List[dict]:
    data = []
    for p in paths:
        with open(p) as f:
            for line in f:
                line = line.strip()
                if line:
                    data.append(json.loads(line))
    return data


def random_word_masking(tokens: np.ndarray, rng: random.Random,
                        vocab_range=(1996, 29611), mask_id=103,
                        mlm_prob=0.15):
    """BERT MLM corruption: 15% of tokens -> 80% [MASK] / 10% random / 10% keep
    (pretrain_src/data/tasks.py:11-51 random_word semantics: the loop runs
    over EVERY position — [CLS]/[SEP] are maskable too — the random token is
    drawn from range(*vocab_range) with the upper bound EXCLUSIVE, and an
    all-unmasked draw falls back to masking position 0 so every example
    carries at least one MLM label)."""
    ids = tokens.copy()
    labels = np.full_like(ids, -1)
    for i in range(len(ids)):
        # single draw reused for the 80/10/10 subtype (random_word divides
        # the mask draw by 0.15, tasks.py:23-26) — same distribution, and a
        # random.Random seeded like the reference's `random.seed()` now
        # reproduces its decisions bit-exactly (tests/test_reference_oracle)
        prob = rng.random()
        if prob < mlm_prob:
            labels[i] = ids[i]
            prob /= mlm_prob
            if prob < 0.8:
                ids[i] = mask_id
            elif prob < 0.9:
                # random.choice(list(range(a, b))) and randrange(a, b) consume
                # the identical _randbelow(b-a) draw
                ids[i] = rng.randrange(*vocab_range)
    if (labels == -1).all():
        labels[0] = ids[0]
        ids[0] = mask_id
    return ids, labels


class TextPathDataset:
    """Builds PretrainBatch items from trajectory annotations + a world
    provider (see env/world.py).

    ``flavor`` selects the reference dataset class whose end-viewpoint
    sampling and SAP-teacher semantics apply (pretrain_src/data/dataset.py):
      * "r2r" (also RxR, train_rxr.py:30): R2RTextPathData — negs are uniform
        random PREFIXES of the GT path (:693-705), the teacher is the actual
        next GT node (:664-681)
      * "reverie": ReverieTextPathData — end_vp sampled from pos_vps /
        in-path non-pos / off-path nodes, the walked path is the shortest
        path to it (:234-246), the teacher argmins d(end,cand)+d(cand,pos)
        over pos_vps (:195-219)
      * "soon": REVERIE semantics with 'pos' pinned to path[-1] (:892-905)
    """

    def __init__(self, data: List[dict], world, graphs,
                 cfg: GridMMConfig, seed: int = 0,
                 shortest_paths: Optional[dict] = None,
                 flavor: str = "r2r"):
        if flavor not in ("r2r", "reverie", "soon"):
            raise ValueError(f"unknown pretrain data flavor {flavor!r}")
        self.data = data
        self.world = world
        self.graphs = graphs
        self.cfg = cfg
        self.flavor = flavor
        self.rng = random.Random(seed)
        self.angle_table = all_point_angle_features(cfg.model.angle_feat_size)
        tables = {s: g.all_pairs_tables() for s, g in graphs.items()}
        self.shortest_paths = shortest_paths or {
            s: t[1] for s, t in tables.items()}
        self.shortest_distances = {s: t[0] for s, t in tables.items()}

    def __len__(self):
        return len(self.data)

    def _pos_vps(self, item: dict) -> list:
        """REVERIE items carry multiple positive endpoints (any node where
        the target object is visible, dataset.py:231); others default to the
        GT goal."""
        return list(item.get("pos_vps") or [item["path"][-1]])

    def sample_trajectory(self, item: dict, end_vp_type: str):
        """Sample the trajectory to encode. Returns (walked, ref_path,
        end_vp, end_idx):

        * walked — the node sequence actually expanded into panorama steps,
          truncated to ``path[:TRAIN_MAX_STEP] + [end_vp]`` like the
          reference (dataset.py:251-253, 710-713)
        * ref_path — the path ``getGlobalMap`` indexes for the grid SAP
          target (``self.gt_path``): the FULL annotated path for r2r
          (:692, set before the prefix slice) and the untruncated shortest
          path to end_vp for reverie/soon (:247)
        * end_idx — index of end_vp in the item path (r2r only, for the
          next-GT-node teacher; None otherwise)
        """
        path = list(item["path"])
        scan = item["scan"]
        if self.flavor == "r2r":
            # R2RTextPathData.get_input:693-705 — both neg types are a
            # uniform random proper prefix (end_idx over path[:-1])
            if end_vp_type == "pos" or len(path) < 2:
                end_idx = len(path) - 1
            else:
                end_idx = self.rng.randrange(len(path) - 1)
            end_vp = path[end_idx]
            walked = path[: end_idx + 1]
            ref_path = path
        else:
            pos_vps = self._pos_vps(item)
            if end_vp_type == "pos":
                # SOON pins 'pos' to the annotated endpoint (:896-897)
                end_vp = (path[-1] if self.flavor == "soon"
                          else self.rng.choice(pos_vps))
            elif end_vp_type == "neg_in_gt_path":
                end_vps = [vp for vp in path if vp not in pos_vps] or path
                end_vp = self.rng.choice(end_vps)
            else:  # neg_others (:242-245)
                noneg = set(pos_vps) | set(path)
                others = [vp for vp in self.graphs[scan].positions
                          if vp not in noneg
                          and vp in self.shortest_paths[scan][path[0]]]
                if others:
                    end_vp = self.rng.choice(others)
                else:
                    end_vps = [vp for vp in path if vp not in pos_vps] or path
                    end_vp = self.rng.choice(end_vps)
            walked = list(self.shortest_paths[scan][path[0]][end_vp])
            ref_path = list(walked)
            end_idx = None
        if len(walked) > TRAIN_MAX_STEP:
            walked = walked[:TRAIN_MAX_STEP] + [end_vp]
        return walked, ref_path, end_vp, end_idx

    # ------------------------------------------------------------- geometry
    def _edge_view_index(self, scan: str, a: str, b: str) -> int:
        """The discrete panorama view index of the candidate leading a -> b —
        our model of the scanvp_cands entry's pointId (the reference loads
        precomputed scanvp_candview_relangles.json; the fine-tune agent
        builds the same table live from candidate pointIds, r2r/agent.py
        :257-265)."""
        g = self.graphs[scan]
        h, e, _ = rel_pos_features(g.positions[a], g.positions[b])
        return nearest_view_index(h, e)

    def _cur_angle(self, scan: str, walked_untrunc: list,
                   start_heading: float):
        """(cur_heading, cur_elevation) for the gmap/vp positional features:
        the QUANTIZED 30-degree view angle of the final edge — elevation
        included and possibly nonzero (get_cur_angle, dataset.py:313-323)."""
        if len(walked_untrunc) < 2:
            return start_heading, 0.0
        viewidx = self._edge_view_index(
            scan, walked_untrunc[-2], walked_untrunc[-1])
        return view_index_heading(viewidx), view_index_elevation(viewidx)

    def _full_graph_pos_fts(self, scan: str, cur_vp: str, vpids,
                            cur_heading: float, cur_elevation: float,
                            af: int) -> np.ndarray:
        """(len(vpids), af+3) positional features against the FULL scan
        graph — the pretraining dataset knows the whole connectivity, so
        unlike the fine-tune agent's incrementally-revealed FloydGraph it
        normalizes with networkx all-pairs tables (get_gmap_pos_fts,
        dataset.py:598-620: line_dist/30, shortest_dist/30, path_edges/10).
        ``None`` rows are the [stop] token (angle fts of (0,0), zero
        dists)."""
        g = self.graphs[scan]
        dists = self.shortest_distances[scan]
        paths = self.shortest_paths[scan]
        out = np.zeros((len(vpids), af + 3), np.float32)
        cur_pos = g.positions[cur_vp]
        for i, vp in enumerate(vpids):
            if vp is None:
                out[i, :af] = angle_features(0.0, 0.0, af)
                continue
            h, e, d = rel_pos_features(cur_pos, g.positions[vp],
                                       cur_heading, cur_elevation)
            out[i, :af] = angle_features(h, e, af)
            out[i, af + 0] = d / MAX_DIST
            out[i, af + 1] = dists[cur_vp][vp] / MAX_DIST
            out[i, af + 2] = (len(paths[cur_vp][vp]) - 1) / MAX_STEP
        return out

    def get_input(self, idx: int, end_vp_type: str = "pos") -> dict:
        cfg = self.cfg
        sh, mc, gc = cfg.shapes, cfg.model, cfg.grid
        item = self.data[idx]
        scan = item["scan"]
        g_nav = self.graphs[scan]
        path, ref_path, end_vp, end_idx = self.sample_trajectory(
            item, end_vp_type)
        # the untruncated walked path feeds get_cur_angle (dataset.py:248,
        # 707: called before the TRAIN_MAX_STEP slice)
        untrunc = ref_path[: end_idx + 1] if end_idx is not None else ref_path
        s_real = len(path)
        vm1 = sh.max_vp_len - 1
        af = mc.angle_feat_size
        d = mc.image_feat_size

        slot_of: Dict[str, int] = {}

        def slot(vp):
            if vp not in slot_of:
                slot_of[vp] = 1 + len(slot_of)
            return slot_of[vp]

        s_max = TRAIN_MAX_STEP if s_real <= TRAIN_MAX_STEP else s_real
        view_fts = np.zeros((s_max, vm1, d), np.float32)
        loc_fts = np.zeros((s_max, vm1, af + 3), np.float32)
        nav_types = np.zeros((s_max, vm1), np.int32)
        token_mask = np.zeros((s_max, vm1), bool)
        visited_idx = np.full((s_max, vm1), -1, np.int32)
        cand_idx = np.full((s_max, vm1), -1, np.int32)
        depth = np.zeros((s_max, gc.num_views, gc.patches_per_view), np.float32)
        patch_fts = np.zeros((s_max, gc.points_per_step, d), np.float32)
        pos_xy = np.zeros((s_max, 2), np.float32)
        headings = np.zeros((s_max,), np.float32)
        step_mask = np.zeros((s_max,), bool)
        last_view_ids = np.full((vm1,), -1, np.int32)  # token -> view index
        last_obj_ids: List[str] = []      # last step's object ids, token order
        last_obj_tokens: List[int] = []   # their vp-token indices ([stop]+1)

        start_heading = float(item.get("heading", 0.0))
        heading = start_heading
        for t, vp in enumerate(path):
            pos = self.world.position(scan, vp)
            cands = sorted(g_nav.neighbors(vp))
            vfts = self.world.view_features(scan, vp)
            if t > 0 and vp in g_nav.neighbors(path[t - 1]):
                # getGlobalMap's heading is the QUANTIZED 30-degree bin of
                # the candidate view that led here (dataset.py:496-499);
                # a truncation teleport (vp not a neighbor) keeps the old one
                heading = view_index_heading(
                    self._edge_view_index(scan, path[t - 1], vp))

            # panorama token angles are ABSOLUTE (relative to heading 0,
            # elevation 0): the reference indexes all_point_rel_angles[12]
            # — view 12 is the heading-0 middle-row view — for every step
            # regardless of agent heading (dataset.py:519-524, 810-815).
            # The fine-tune env is heading-relative (r2r/env.py:509-593);
            # the reference trains through that inconsistency.
            k = 0
            used = set()
            for cvp in cands:
                if k >= vm1:
                    break
                h, e, _dd = rel_pos_features(pos, g_nav.positions[cvp])
                pid = nearest_view_index(h, e)
                view_fts[t, k] = vfts[pid][:d]
                loc_fts[t, k, :af] = angle_features(h, e, af)
                loc_fts[t, k, af:] = 1.0
                nav_types[t, k] = 1
                cand_idx[t, k] = slot(cvp)
                if t == len(path) - 1:
                    last_view_ids[k] = pid
                used.add(pid)
                k += 1
            for ix in range(vfts.shape[0]):
                if k >= vm1:
                    break
                if ix in used:
                    continue
                view_fts[t, k] = vfts[ix][:d]
                loc_fts[t, k, :af] = self.angle_table[12, ix]
                loc_fts[t, k, af:] = 1.0
                if t == len(path) - 1:
                    last_view_ids[k] = ix
                k += 1
            # object tokens (nav_type 2) appended after views — REVERIE/SOON
            # object trajectories (pretrain_src/data/dataset.py:90-230
            # get_traj_pano_fts: [cand views | other views | objects])
            if mc.obj_feat_size > 0 and hasattr(self.world, "objects"):
                for obj in self.world.objects(scan, vp)[: sh.max_obj_len
                                                        or None]:
                    if k >= vm1:
                        break
                    view_fts[t, k] = np.asarray(obj["feature"])[:d]
                    loc_fts[t, k] = np.asarray(obj["loc_fts"])[: af + 3]
                    nav_types[t, k] = 2
                    if t == len(path) - 1:
                        last_obj_ids.append(obj["obj_id"])
                        last_obj_tokens.append(k + 1)  # +1: [stop] offset
                    k += 1
            token_mask[t, :k] = True
            visited_idx[t, :k] = slot(vp)
            step_mask[t] = True

            depth[t] = self.world.depth_patches(scan, vp).astype(np.float32)
            patch_fts[t] = self.world.grid_features(scan, vp)[:, :d]
            pos_xy[t] = (pos[0], pos[1])
            headings[t] = heading

        # visited contributions only from each node's LAST visit step
        # (_aggregate_gmap_features dict overwrite, pretrain vilmodel.py:590)
        last_visit = {}
        for t, vp in enumerate(path):
            last_visit[vp] = t
        for t, vp in enumerate(path):
            if last_visit[vp] != t:
                visited_idx[t, :] = -1
            # candidates of visited nodes never accumulate
        for t in range(s_real):
            for k in range(vm1):
                ci = cand_idx[t, k]
                if ci > 0:
                    vp = next((v for v, s in slot_of.items() if s == ci), None)
                    if vp in last_visit:
                        cand_idx[t, k] = -1

        # gmap arrays (stable slots); positional features are against the
        # FULL scan graph at the QUANTIZED final-edge angle — elevation
        # included (get_cur_angle + get_gmap_inputs, dataset.py:313-323,588)
        gmax = self.cfg.shapes.max_gmap_len
        gmap_mask = np.zeros((gmax,), bool)
        gmap_visited = np.zeros((gmax,), bool)
        gmap_step_ids = np.zeros((gmax,), np.int32)
        gmap_pos = np.zeros((gmax, af + 3), np.float32)
        gmap_mask[0] = True
        # [stop] slot positional features: angle_features(0, 0) = [0,1,0,1],
        # matching the reference's None branch (dataset.py:604-607)
        gmap_pos[0, :af] = angle_features(0.0, 0.0, af)
        cur_vp = path[-1]
        cur_heading, cur_elevation = self._cur_angle(scan, untrunc,
                                                     start_heading)
        for vp, s in slot_of.items():
            if s >= gmax:
                continue
            gmap_mask[s] = True
            gmap_visited[s] = vp in last_visit
            if vp in last_visit:
                gmap_step_ids[s] = min(last_visit[vp] + 1,
                                       mc.max_action_steps - 1)
            gmap_pos[s] = self._full_graph_pos_fts(
                scan, cur_vp, [vp], cur_heading, cur_elevation, af)[0]

        # grid build (the device path's geometry, on CPU tensors)
        t_ = torch.from_numpy
        state = G.PointCloudState.create(1, gc, self.cfg.shapes.max_points,
                                         device="cpu")
        for t in range(s_real):
            state = G.append_panorama(
                state, t_(depth[t:t + 1]), t_(patch_fts[t:t + 1]),
                t_(pos_xy[t:t + 1]), gc, headings=t_(headings[t:t + 1]))
        cells, half_len, grid_pos_fts = G.egocentric_grid_assignment(
            state, t_(pos_xy[s_real - 1:s_real]),
            t_(headings[s_real - 1:s_real]), gc)

        # SAP labels, flavor-exact (see class docstring). -100 is the CE
        # ignore id (train/losses.cross_entropy_ignore), matching the
        # reference's not-found fallback.
        dists = self.shortest_distances[scan]
        cands_all = sorted(g_nav.neighbors(cur_vp))
        # local labels index the ENCODED candidate tokens ([stop]+cands up
        # to the vp capacity) — reference cand lists are never capped but
        # our static vp axis is; an off-capacity teacher becomes ignore
        cands_enc = cands_all[:vm1]
        if self.flavor == "r2r":
            # R2RTextPathData.get_act_labels (dataset.py:664-681): stop iff
            # the sampled end IS the GT goal; otherwise the teacher is the
            # ACTUAL next GT node — by gmap membership globally, by
            # candidate index locally, -100 when not found
            if end_vp == item["path"][-1]:
                global_act = local_act = 0
            else:
                gt_next = item["path"][end_idx + 1]
                s_next = slot_of.get(gt_next)
                global_act = s_next if s_next is not None and s_next < gmax \
                    else -100
                local_act = (cands_enc.index(gt_next) + 1
                             if gt_next in cands_enc else -100)
        else:
            # ReverieTextPathData.get_act_labels (dataset.py:195-219): stop
            # iff end_vp is ANY positive viewpoint; otherwise global argmins
            # d(end,cand)+min_pos d(cand,pos) over UNVISITED gmap nodes and
            # local argmins the same score over the last step's candidate
            # list INDEPENDENTLY (visited candidates included; the two
            # teachers can disagree)
            pos_vps = self._pos_vps(item)
            if end_vp in pos_vps:
                global_act = local_act = 0
            else:
                def score(vp):
                    return dists[cur_vp][vp] + min(
                        dists[vp][p] for p in pos_vps)

                global_act = -100
                best = float("inf")
                for vp, s in sorted(slot_of.items(), key=lambda kv: kv[1]):
                    if s >= gmax or vp in last_visit:
                        continue
                    d_vp = score(vp)
                    if d_vp < best:
                        best, global_act = d_vp, s
                local_act = -100
                best = float("inf")
                for k_c, cvp in enumerate(cands_enc):
                    d_vp = score(cvp)
                    if d_vp < best:
                        best, local_act = d_vp, k_c + 1

        # grid SAP target (getGlobalMap, dataset.py:367-439): the NEXT node
        # of ref_path after the current walked step — [stop] (0) only when
        # the walked end IS ref_path's end. ref_path is the FULL annotated
        # path for r2r (self.gt_path is set before the prefix slice,
        # :692) and the untruncated shortest path for reverie/soon (:247),
        # so reverie negs always target [stop] while r2r negs target the
        # real next GT cell.
        cur_step_id = s_real - 1
        if cur_step_id < len(ref_path) - 1:
            npos = self.world.position(scan, ref_path[cur_step_id + 1])
            f32 = torch.float32
            grid_target = int(G.target_cell_id(
                torch.tensor(npos[0], dtype=f32),
                torch.tensor(npos[1], dtype=f32),
                torch.tensor(pos_xy[s_real - 1, 0], dtype=f32),
                torch.tensor(pos_xy[s_real - 1, 1], dtype=f32),
                torch.tensor(headings[s_real - 1], dtype=f32), half_len[0]))
        else:
            grid_target = 0

        # vp_pos_fts / nav masks for the last step (get_vp_pos_fts,
        # dataset.py:622-632: start fts broadcast over every row, candidate
        # fts in rows 1..n, both at the quantized cur angle)
        v = sh.max_vp_len
        vp_pos_fts = np.zeros((v, 2 * af + 6), np.float32)
        start_fts = self._full_graph_pos_fts(
            scan, cur_vp, [path[0]], cur_heading, cur_elevation, af)
        vp_pos_fts[:, : af + 3] = start_fts[0]
        cands_last = cands_enc
        cand_fts = self._full_graph_pos_fts(
            scan, cur_vp, cands_last, cur_heading, cur_elevation, af)
        vp_pos_fts[1: 1 + len(cands_last), af + 3:] = cand_fts
        vp_nav_mask = np.zeros((v,), bool)
        vp_nav_mask[0] = True
        vp_nav_mask[1: 1 + len(cands_last)] = True

        # object grounding supervision (pretrain_src/data/tasks.py:381-430
        # OGDataset): the GT object's vp-token index when visible at the
        # trajectory end, ignore (-100) otherwise
        vp_obj_mask = np.zeros((v,), bool)
        for tok in last_obj_tokens:
            if tok < v:
                vp_obj_mask[tok] = True
        # OG label: ungated by goal-ness — the reference matches the GT
        # object at WHATEVER end viewpoint was sampled (OGDataset always asks
        # for 'pos', tasks.py:390; ReverieTextPathData.get_obj_label
        # :183-194 scans last_vp_objids, SoonTextPathData :886-892 trusts the
        # precomputed index), falling back to -100 ignore
        gt_obj = item.get("objId") or item.get("obj_id")
        obj_label = np.int32(-100)
        pseudo = item.get("obj_pseudo_label")
        if pseudo is not None:
            # SOON contract: annotations carry a precomputed index into
            # the end-viewpoint object list rather than an object id
            # (SoonTextPathData.get_obj_label, dataset.py:886-892;
            # -100 when the index falls past the object capacity)
            oidx = int(pseudo["idx"])
            if 0 <= oidx < len(last_obj_tokens) \
                    and last_obj_tokens[oidx] < v:
                obj_label = np.int32(last_obj_tokens[oidx])
        elif gt_obj is not None:
            for oid, tok in zip(last_obj_ids, last_obj_tokens):
                if oid == str(gt_obj) and tok < v:
                    obj_label = np.int32(tok)
                    break

        fused_add_idx = np.full((gmax,), -2, np.int32)
        cand_backtrack = np.zeros((v,), bool)
        cand_slot = {cvp: j for j, cvp in enumerate(cands_last)}
        for vp, s in slot_of.items():
            if s >= gmax or vp in last_visit:
                continue
            fused_add_idx[s] = cand_slot[vp] + 1 if vp in cand_slot else -1
        for j, cvp in enumerate(cands_last):
            if cvp in last_visit:
                cand_backtrack[j + 1] = True

        return dict(
            instr_encoding=np.asarray(item["instr_encoding"], np.int32),
            traj_view_fts=view_fts, traj_loc_fts=loc_fts,
            traj_nav_types=nav_types, traj_token_mask=token_mask,
            traj_step_mask=step_mask, visited_idx=visited_idx,
            cand_idx=cand_idx,
            gmap_step_ids=gmap_step_ids, gmap_pos_fts=gmap_pos,
            gmap_mask=gmap_mask, gmap_visited_mask=gmap_visited,
            vp_pos_fts=vp_pos_fts, vp_nav_mask=vp_nav_mask,
            fused_add_idx=fused_add_idx, cand_backtrack_mask=cand_backtrack,
            grid_fts=state.features[0].numpy(),
            grid_cells=cells[0].numpy(),
            gridmap_pos_fts=grid_pos_fts[0].numpy(),
            global_act=np.int32(global_act), local_act=np.int32(local_act),
            grid_target=np.int32(grid_target),
            last_scan_vp=(scan, path[-1]),
            last_view_ids=last_view_ids,
            obj_label=obj_label, vp_obj_mask=vp_obj_mask,
        )

    # ---------------------------------------------------------------- batches
    def build_batch(self, indices: Sequence[int], task: str,
                    mlm_prob: float = 0.15, mrc_prob: float = 0.15):
        """Collate a PretrainBatch of CPU tensors for one task (tasks.py
        *_collate)."""
        cfg = self.cfg
        sh, mc = cfg.shapes, cfg.model
        # og always ends at the goal (OGDataset, tasks.py:381); sap mixes —
        # sampled PER EXAMPLE like SapDataset.__getitem__ (tasks.py:294-301),
        # so one batch carries a mix of pos/neg trajectories
        items = [self.get_input(
            i, self._sap_end_type() if task == "sap" else "pos")
            for i in indices]
        b = len(items)
        t_len = sh.max_txt_len
        # items are TRAIN_MAX_STEP rows except truncated long trajectories
        # (TRAIN_MAX_STEP+1: the reference appends end_vp, dataset.py:253);
        # pad every step-indexed array up to the batch max
        s = max(it["traj_view_fts"].shape[0] for it in items)
        step_keys = ("traj_view_fts", "traj_loc_fts", "traj_nav_types",
                     "traj_token_mask", "traj_step_mask", "visited_idx",
                     "cand_idx")
        for it in items:
            have = it["traj_view_fts"].shape[0]
            if have == s:
                continue
            for kk in step_keys:
                arr = it[kk]
                pad = np.zeros((s - have,) + arr.shape[1:], arr.dtype)
                if kk in ("visited_idx", "cand_idx"):
                    pad -= 1
                it[kk] = np.concatenate([arr, pad], axis=0)
        v = sh.max_vp_len

        txt_ids = np.zeros((b, t_len), np.int32)
        txt_mask = np.zeros((b, t_len), bool)
        txt_labels = np.full((b, t_len), -1, np.int32)
        for i, it in enumerate(items):
            enc = it["instr_encoding"][:t_len]
            if task == "mlm":
                ids, labels = random_word_masking(enc, self.rng,
                                                  mlm_prob=mlm_prob)
                txt_ids[i, : len(ids)] = ids
                txt_labels[i, : len(ids)] = labels
            else:
                txt_ids[i, : len(enc)] = enc
            txt_mask[i, : len(enc)] = True

        def stack(key):
            return np.stack([it[key] for it in items])

        view_mrc_masks = np.zeros((b, v - 1), bool)
        view_probs = np.full((b, v - 1, mc.image_prob_size),
                             1.0 / mc.image_prob_size, np.float32)
        if task == "mrc":
            for i, it in enumerate(items):
                last = int(it["traj_step_mask"].sum()) - 1
                ntok = int(it["traj_token_mask"][last].sum())
                eligible = []
                for k in range(ntok):
                    # only view tokens carry image-class soft labels; object
                    # tokens (nav_type 2) are masked by the separate obj-MRC
                    # variant in the reference (tasks.py:164-227)
                    if it["traj_nav_types"][last, k] == 2:
                        continue
                    eligible.append(k)
                    if self.rng.random() < mrc_prob:
                        view_mrc_masks[i, k] = True
                if eligible and not view_mrc_masks[i].any():
                    # _get_img_mask guarantees at least one masked view
                    # (tasks.py:145-151) so every MRC example carries signal
                    view_mrc_masks[i, self.rng.choice(eligible)] = True
                # soft labels from the provider's per-view class probs
                # (the reference view-feature files append prob columns);
                # uniform only when the provider has none
                probs_fn = getattr(self.world, "view_probs", None)
                if probs_fn is not None:
                    scan, vp = it["last_scan_vp"]
                    try:
                        vp_probs = probs_fn(scan, vp, mc.image_prob_size)
                    except TypeError:
                        vp_probs = probs_fn(scan, vp)
                    if vp_probs is not None:
                        for k, vid in enumerate(it["last_view_ids"][: v - 1]):
                            if vid >= 0 and vid < len(vp_probs):
                                p = vp_probs[vid][: mc.image_prob_size]
                                if p.sum() > 0:
                                    view_probs[i, k] = p / p.sum()

        return pretrain_batch_to_device(PretrainBatch(
            txt_ids=txt_ids, txt_mask=txt_mask,
            traj_view_fts=stack("traj_view_fts"),
            traj_loc_fts=stack("traj_loc_fts"),
            traj_nav_types=stack("traj_nav_types"),
            traj_token_mask=stack("traj_token_mask"),
            traj_step_mask=stack("traj_step_mask"),
            visited_idx=stack("visited_idx"), cand_idx=stack("cand_idx"),
            gmap_step_ids=stack("gmap_step_ids"),
            gmap_pos_fts=stack("gmap_pos_fts"), gmap_mask=stack("gmap_mask"),
            gmap_visited_mask=stack("gmap_visited_mask"),
            vp_pos_fts=stack("vp_pos_fts"), vp_nav_mask=stack("vp_nav_mask"),
            fused_add_idx=stack("fused_add_idx"),
            cand_backtrack_mask=stack("cand_backtrack_mask"),
            grid_fts=stack("grid_fts"), grid_cells=stack("grid_cells"),
            gridmap_pos_fts=stack("gridmap_pos_fts"),
            txt_labels=txt_labels, view_mrc_masks=view_mrc_masks,
            view_probs=view_probs,
            global_act_labels=stack("global_act"),
            local_act_labels=stack("local_act"),
            obj_labels=stack("obj_label"),
            vp_obj_mask=stack("vp_obj_mask")), "cpu")

    def _sap_end_type(self) -> str:
        """SAP end-vp mix 20/40/40 pos/neg_in_gt/neg_others
        (tasks.py:294-301)."""
        r = self.rng.random()
        if r < 0.2:
            return "pos"
        return "neg_in_gt_path" if r < 0.6 else "neg_others"

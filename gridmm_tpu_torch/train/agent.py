"""Interactive navigation agent: rollout, eval, DAgger data collection (twin
of gridmm_tpu/train/agent.py).

Host-side twin of GMapNavAgent (map_nav_src/r2r/agent.py:28-451):

  * One device step (train/step.py:nav_device_step) covers panorama encode +
    grid build + node aggregation + navigation forward; the host only
    assembles fixed-shape index maps and picks actions.
  * Gmap tokens live in a STABLE discovery-order slot space per episode
    (slot 0 = [stop]); the reference re-packs visited/unvisited every step.
  * Training uses rollout-then-replay: the rollout (student policy, under
    `torch.inference_mode`, dropout off) records every step's inputs +
    teacher actions; the recorded trajectory replays through
    `trajectory_loss` for one forward+backward, gradient-equivalent to the
    reference's interleaved accumulation (agent.py:301-448) because the
    forward is a pure function of the recorded inputs.
  * The agent holds the very `nn.Module` the optimizer updates: a rollout
    after an update sees the new weights with no copy.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gridmm_tpu_torch.config import GridMMConfig
from gridmm_tpu_torch.env.discrete import DiscreteNavEnv
from gridmm_tpu_torch.env.graph import TopoMap, angle_features
from gridmm_tpu_torch.models.navigator import GridMMNavigator
from gridmm_tpu_torch.train.step import (StepInputs, TrajectoryBatch,
                                         init_carry, nav_device_step)


class EpisodeBook:
    """Per-episode host bookkeeping: topo map + stable slot assignment."""

    def __init__(self, start_vp: str, max_slots: int):
        self.topo = TopoMap(start_vp)
        self.slot_of: Dict[str, int] = {}
        self.max_slots = max_slots

    def slot(self, vp: str) -> int:
        if vp not in self.slot_of:
            nxt = 1 + len(self.slot_of)
            if nxt >= self.max_slots:
                return -1  # graph overflow: drop (masked out)
            self.slot_of[vp] = nxt
        return self.slot_of[vp]


class NavAgent:
    def __init__(self, model: GridMMNavigator, cfg: GridMMConfig,
                 env: DiscreteNavEnv):
        self.model = model
        self.cfg = cfg
        self.env = env
        self.shapes = cfg.shapes
        need = cfg.train.max_action_len * cfg.grid.points_per_step
        if need > cfg.shapes.max_points:
            raise ValueError(
                f"point buffer too small: max_action_len="
                f"{cfg.train.max_action_len} needs {need} points but "
                f"max_points={cfg.shapes.max_points} (the append would "
                "clamp its start and corrupt the tail)")
        self.scanvp_cands: Dict[str, Dict[str, int]] = {}

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    # ------------------------------------------------------------- language
    def language_batch(self, obs) -> Tuple[np.ndarray, np.ndarray]:
        t = self.shapes.max_txt_len
        b = len(obs)
        ids = np.zeros((b, t), np.int32)
        mask = np.zeros((b, t), bool)
        for i, ob in enumerate(obs):
            enc = np.asarray(ob["instr_encoding"], np.int32)[:t]
            ids[i, : len(enc)] = enc
            mask[i, : len(enc)] = True
        return ids, mask

    # ----------------------------------------------------------- step build
    def _update_caches(self, obs) -> None:
        for ob in obs:
            key = f"{ob['scan']}_{ob['viewpoint']}"
            slot = self.scanvp_cands.setdefault(key, {})
            for c in ob["candidate"]:
                slot[c["viewpointId"]] = int(c["pointId"])

    def build_step_inputs(self, obs, books: List[EpisodeBook]
                          ) -> Tuple[StepInputs, List[List[Optional[str]]], List[Optional[str]]]:
        """Assemble fixed-shape StepInputs (numpy) for one step.

        Returns (inputs, slot_vpids per item, gmap slot->vpid map)."""
        sh, mc = self.shapes, self.cfg.model
        b = len(obs)
        v, g = sh.max_vp_len, sh.max_gmap_len
        vm1 = v - 1
        d = mc.image_feat_size
        af = mc.angle_feat_size

        view_img_fts = np.zeros((b, vm1, d), np.float32)
        loc_fts = np.zeros((b, vm1, af + 3), np.float32)
        nav_types = np.zeros((b, vm1), np.int32)
        view_mask = np.zeros((b, vm1), bool)
        depth = np.zeros((b, self.cfg.grid.num_views,
                          self.cfg.grid.patches_per_view), np.float32)
        patch_fts = np.zeros((b, self.cfg.grid.points_per_step, d), np.float32)
        pos_xy = np.zeros((b, 2), np.float32)
        heading = np.zeros((b,), np.float32)
        gmap_step_ids = np.zeros((b, g), np.int32)
        gmap_pos_fts = np.zeros((b, g, af + 3), np.float32)
        gmap_mask = np.zeros((b, g), bool)
        gmap_visited = np.zeros((b, g), bool)
        cur_node_idx = np.zeros((b,), np.int32)
        cand_gmap_idx = np.full((b, vm1), -1, np.int32)
        vp_pos_fts = np.zeros((b, v, 2 * af + 6), np.float32)
        vp_nav_mask = np.zeros((b, v), bool)
        fused_add_idx = np.full((b, g), -2, np.int32)
        cand_backtrack = np.zeros((b, v), bool)
        vp_obj_mask = np.zeros((b, v), bool)
        obj_token_idx: List[List[int]] = [[] for _ in range(b)]

        slot_vpids: List[List[Optional[str]]] = []
        cand_vpids_all: List[List[str]] = []

        for i, ob in enumerate(obs):
            book = books[i]
            topo = book.topo
            cur_vp = ob["viewpoint"]

            # --- panorama tokens: candidates first, then remaining views
            # (agent.py:56-76) ---
            cands = ob["candidate"][: vm1]
            used = set()
            k = 0
            # features are [visual || angle]; split at the stored visual width
            fd = ob["feature"].shape[-1] - af
            for c in cands:
                view_img_fts[i, k] = c["feature"][:fd][:d]
                loc_fts[i, k, :af] = c["feature"][fd:]
                loc_fts[i, k, af:] = 1.0
                nav_types[i, k] = 1
                used.add(int(c["pointId"]))
                k += 1
            for ix in range(ob["feature"].shape[0]):
                if ix in used or k >= vm1:
                    continue
                view_img_fts[i, k] = ob["feature"][ix, :fd][:d]
                loc_fts[i, k, :af] = ob["feature"][ix, fd:]
                loc_fts[i, k, af:] = 1.0
                nav_types[i, k] = 0
                k += 1
            view_mask[i, :k] = True
            cand_vpids = [c["viewpointId"] for c in cands]
            cand_vpids_all.append(cand_vpids)

            # --- grid ingredients ---
            depth[i] = ob["depth_patches"].astype(np.float32)
            patch_fts[i] = ob["grid_fts"][:, :d]
            pos_xy[i] = (ob["position"][0], ob["position"][1])
            heading[i] = ob["heading"]

            # --- gmap stable slots ---
            vpids: List[Optional[str]] = [None] * g
            for vp in topo.node_positions:
                s = book.slot(vp)
                if s < 0:
                    continue
                vpids[s] = vp
                gmap_mask[i, s] = True
                gmap_step_ids[i, s] = min(
                    topo.node_step_ids.get(vp, 0), mc.max_action_steps - 1)
                gmap_visited[i, s] = topo.graph.visited(vp)
            gmap_mask[i, 0] = True  # [stop]
            pos_list = [None] + [vpids[s] for s in range(1, g)]
            gmap_pos_fts[i] = topo.pos_features(
                cur_vp, pos_list, ob["heading"], ob["elevation"], af)
            cur_node_idx[i] = book.slot(cur_vp)
            slot_vpids.append(vpids)

            # --- candidate <-> gmap index maps ---
            cand_slot: Dict[str, int] = {}
            for j, cvp in enumerate(cand_vpids):
                s = book.slot(cvp)
                cand_gmap_idx[i, j] = s
                cand_slot[cvp] = j
                if topo.graph.visited(cvp):
                    cand_backtrack[i, j + 1] = True
            for s in range(1, g):
                vp = vpids[s]
                if vp is None or gmap_visited[i, s]:
                    continue
                if vp in cand_slot:
                    fused_add_idx[i, s] = cand_slot[vp] + 1  # +1: [stop] offset
                else:
                    fused_add_idx[i, s] = -1  # backtrack pool

            # --- local branch pos features (agent.py:179-195) ---
            start_fts = topo.pos_features(
                cur_vp, [topo.start_vp], ob["heading"], ob["elevation"], af)
            vp_pos_fts[i, :, : af + 3] = start_fts[0]
            cand_fts = topo.pos_features(
                cur_vp, cand_vpids, ob["heading"], ob["elevation"], af)
            vp_pos_fts[i, 1: 1 + len(cand_vpids), af + 3:] = cand_fts
            vp_nav_mask[i, 0] = True
            vp_nav_mask[i, 1: 1 + len(cand_vpids)] = True

            # object tokens (REVERIE/SOON, reverie/agent_obj.py): appended
            # after the view tokens with nav_type=2
            for obj in ob.get("objects", []):
                if k >= vm1:
                    break
                view_img_fts[i, k] = np.asarray(obj["feature"])[:d]
                loc_fts[i, k] = np.asarray(obj["loc_fts"])[: af + 3]
                nav_types[i, k] = 2
                view_mask[i, k] = True
                vp_obj_mask[i, k + 1] = True  # +1: [stop] offset
                obj_token_idx[i].append(k + 1)
                k += 1

        dummy_t = np.full((b,), self.cfg.train.ignoreid, np.int32)
        inputs = StepInputs(
            view_img_fts=view_img_fts, loc_fts=loc_fts, nav_types=nav_types,
            view_mask=view_mask, depth=depth, patch_fts=patch_fts,
            pos_xy=pos_xy, heading=heading,
            gmap_step_ids=gmap_step_ids, gmap_pos_fts=gmap_pos_fts,
            gmap_mask=gmap_mask, gmap_visited_mask=gmap_visited,
            cur_node_idx=cur_node_idx, cand_gmap_idx=cand_gmap_idx,
            vp_pos_fts=vp_pos_fts, vp_nav_mask=vp_nav_mask,
            fused_add_idx=fused_add_idx, cand_backtrack_mask=cand_backtrack,
            target=dummy_t, grid_target=dummy_t.copy(),
            vp_obj_mask=vp_obj_mask, obj_target=dummy_t.copy(),
        )
        self._last_obj_token_idx = obj_token_idx
        return inputs, slot_vpids, cand_vpids_all

    # ----------------------------------------------------------- supervision
    def teacher_actions(self, obs, slot_vpids, books, ended) -> np.ndarray:
        """Teacher oracle over gmap slots. expert_policy='spl' minimizes
        dist(cur->vp)+dist(vp->goal) (agent.py:207-237); 'ndtw' follows the GT
        path node sequence (the RxR expert, rxr flavor of _teacher_action)."""
        a = np.full((len(obs),), self.cfg.train.ignoreid, np.int64)
        ndtw = self.cfg.train.expert_policy == "ndtw"
        for i, ob in enumerate(obs):
            if ended[i]:
                continue
            if ob["viewpoint"] == ob["gt_path"][-1]:
                a[i] = 0
                continue
            scan, cur = ob["scan"], ob["viewpoint"]
            dists = self.env.shortest_distances[scan]
            if ndtw:
                # target = the earliest not-yet-visited GT-path node
                goal = next(
                    (vp for vp in ob["gt_path"]
                     if not books[i].topo.graph.visited(vp)),
                    ob["gt_path"][-1])
            else:
                goal = ob["gt_path"][-1]
            best, best_d = self.cfg.train.ignoreid, math.inf
            for s in range(1, self.shapes.max_gmap_len):
                vp = slot_vpids[i][s]
                if vp is None or books[i].topo.graph.visited(vp):
                    continue
                d = dists[vp][goal] + dists[cur][vp]
                if d < best_d:
                    best_d, best = d, s
            a[i] = best
        return a

    # --------------------------------------------------------------- rollout
    def rollout(self, feedback: str = "argmax",
                rng: Optional[np.random.Generator] = None,
                record: bool = False):
        """Run one minibatch of episodes.

        Returns (trajectories, recorded TrajectoryBatch (numpy) or None,
        stats). The model runs in eval mode under inference_mode and is put
        back into the mode it was in."""
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.inference_mode():
                return self._rollout(feedback, rng, record)
        finally:
            self.model.train(was_training)

    def _rollout(self, feedback, rng, record):
        cfg = self.cfg
        dev = self.device
        rng = rng or np.random.default_rng(0)
        obs = self.env.reset()
        self._update_caches(obs)
        b = len(obs)

        books = [EpisodeBook(ob["viewpoint"], self.shapes.max_gmap_len)
                 for ob in obs]
        for i, ob in enumerate(obs):
            books[i].topo.update(
                ob["viewpoint"], ob["position"],
                [(c["viewpointId"], c["position"]) for c in ob["candidate"]])

        traj = [{"instr_id": ob["instr_id"], "trajectory": [[ob["viewpoint"]]],
                 "stop_scores": {}} for ob in obs]

        txt_ids, txt_mask = self.language_batch(obs)
        txt_mask_dev = torch.as_tensor(txt_mask, device=dev)
        txt_embeds = self.model("language", {
            "txt_ids": torch.as_tensor(txt_ids, device=dev),
            "txt_mask": txt_mask_dev})

        carry = init_carry(cfg, b, device=dev)
        ended = np.zeros((b,), bool)
        recorded: List[StepInputs] = []
        # per-node predicted object (REVERIE/SOON), overwritten on revisit
        # like node_stop_scores (reverie/agent_obj.py:380-388)
        node_og: List[Dict[str, Optional[dict]]] = [{} for _ in range(b)]

        for t in range(cfg.train.max_action_len):
            for i, ob in enumerate(obs):
                if not ended[i]:
                    books[i].topo.node_step_ids[ob["viewpoint"]] = t + 1

            inputs, slot_vpids, cand_vpids = self.build_step_inputs(
                obs, books)
            targets = self.teacher_actions(obs, slot_vpids, books, ended)
            inputs = inputs._replace(target=targets.astype(np.int32))
            # object-grounding teacher (_teacher_object, reverie/agent_obj.py
            # :245-262): the GT object's token index — supervised ONLY when
            # the current node is an annotated end viewpoint (the reference
            # ignores object labels elsewhere, even if the object is visible)
            obj_targets = np.full((b,), self.cfg.train.ignoreid, np.int32)
            for i, ob in enumerate(obs):
                gt_obj = ob.get("gt_obj_id")
                if ended[i] or gt_obj is None:
                    continue
                if ob["viewpoint"] not in ob.get("gt_end_vps", ()):
                    continue
                for j, obj in enumerate(ob.get("objects", [])):
                    if obj["obj_id"] == gt_obj and \
                            j < len(self._last_obj_token_idx[i]):
                        obj_targets[i] = self._last_obj_token_idx[i][j]
                        break
            inputs = inputs._replace(obj_target=obj_targets)
            if record:
                recorded.append(inputs)

            carry, out = nav_device_step(
                self.model, cfg, txt_embeds, txt_mask_dev, carry,
                StepInputs(*(torch.as_tensor(a, device=dev) for a in inputs)))
            logits = out.fused_logits.double().cpu().numpy()

            # action selection (agent.py:373-398)
            if feedback == "teacher":
                a_t = targets.copy()
            elif feedback == "argmax":
                a_t = logits.argmax(-1)
            elif feedback == "sample":
                probs = np.exp(logits - logits.max(-1, keepdims=True))
                probs = np.where(np.isfinite(logits), probs, 0.0)
                probs /= probs.sum(-1, keepdims=True)
                a_t = np.array([rng.choice(len(p), p=p) for p in probs])
            elif feedback == "expl_sample":
                # argmax with epsilon-uniform exploration over valid actions
                # (agent.py:386-398; rand > expl_max_ratio explores)
                a_t = logits.argmax(-1)
                explores = rng.random(b) > self.cfg.train.expl_max_ratio
                for i in np.flatnonzero(explores):
                    valid = np.flatnonzero(np.isfinite(logits[i]))
                    if valid.size:
                        a_t[i] = rng.choice(valid)
            else:
                raise ValueError(feedback)

            # object-grounding prediction per node (REVERIE: og at the stop
            # node decides det success): record the argmax object PER NODE —
            # the final prediction is taken from whichever node wins the
            # stop-score ranking, not the last node visited
            # (reverie/agent_obj.py:380-388 node_stop_scores['og'], :458-469)
            if out.obj_logits is not None:
                obj_log = out.obj_logits.cpu().numpy()
                for i, ob in enumerate(obs):
                    if ended[i]:
                        continue
                    rec = None
                    if np.isfinite(obj_log[i]).any():
                        k = int(np.nanargmax(
                            np.where(np.isfinite(obj_log[i]), obj_log[i],
                                     -np.inf)))
                        toks = self._last_obj_token_idx[i]
                        if k in toks:
                            obj = obs[i]["objects"][toks.index(k)]
                            # SOON det metrics score the predicted object's
                            # direction against the GT bbox polygon in the
                            # CONVERTED [0,1) units the env attaches
                            # (soon/agent_obj.py:129 og_direction from
                            # obs obj_directions; env.py:279)
                            dirn = obj.get("direction")
                            rec = {"obj_id": obj["obj_id"],
                                   "heading": (float(dirn[0]) if dirn else
                                               float(obj.get("heading", 0.0))),
                                   "elevation":
                                       (float(dirn[1]) if dirn else
                                        float(obj.get("elevation", 0.0)))}
                    node_og[i][ob["viewpoint"]] = rec

            # stop-score bookkeeping (agent.py:350-355)
            finite = np.isfinite(logits)
            probs = np.exp(logits - np.where(finite, logits, -np.inf).max(
                -1, keepdims=True))
            probs = np.where(finite, probs, 0.0)
            probs /= np.maximum(probs.sum(-1, keepdims=True), 1e-12)
            for i, ob in enumerate(obs):
                if not ended[i]:
                    traj[i]["stop_scores"][ob["viewpoint"]] = float(probs[i, 0])

            # stop determination (agent.py:400-414)
            if feedback in ("teacher", "sample"):
                stop_now = np.array(
                    [ob["viewpoint"] == ob["gt_path"][-1] for ob in obs])
            else:
                stop_now = a_t == 0
            no_vp_left = np.array([
                all(vp is None or books[i].topo.graph.visited(vp)
                    for vp in slot_vpids[i][1:])
                for i in range(b)])

            just_ended = np.zeros((b,), bool)
            chosen: List[Optional[str]] = []
            for i in range(b):
                if stop_now[i] or ended[i] or no_vp_left[i] or \
                        t == cfg.train.max_action_len - 1:
                    chosen.append(None)
                    just_ended[i] = True
                else:
                    vp = slot_vpids[i][int(a_t[i])]
                    chosen.append(vp)

            # execute moves (make_equiv_action, agent.py:239-255)
            for i, vp in enumerate(chosen):
                if vp is None:
                    continue
                ob = obs[i]
                path = books[i].topo.graph.path(ob["viewpoint"], vp)
                traj[i]["trajectory"].append(path)
                prev = (traj[i]["trajectory"][-2][-1] if len(path) == 1
                        else path[-2])
                viewidx = self.scanvp_cands[f"{ob['scan']}_{prev}"][vp]
                self.env.teleport(
                    i, vp, (viewidx % 12) * math.radians(30),
                    (viewidx // 12 - 1) * math.radians(30))

            # post-stop: jump to the best stop-scored node (agent.py:418-431)
            # and take the object prediction recorded AT that node
            # (reverie/agent_obj.py:458-469 stop_score['og'])
            for i in range(b):
                if not ended[i] and just_ended[i] and traj[i]["stop_scores"]:
                    best_vp = max(traj[i]["stop_scores"],
                                  key=traj[i]["stop_scores"].get)
                    if best_vp != obs[i]["viewpoint"]:
                        traj[i]["trajectory"].append(
                            books[i].topo.graph.path(
                                obs[i]["viewpoint"], best_vp))
                    og = node_og[i].get(best_vp)
                    if og is not None:
                        traj[i]["pred_obj_id"] = og["obj_id"]
                        traj[i]["pred_obj_heading"] = og["heading"]
                        traj[i]["pred_obj_elevation"] = og["elevation"]

            obs = self.env._get_obs()
            self._update_caches(obs)
            for i, ob in enumerate(obs):
                if not ended[i]:
                    books[i].topo.update(
                        ob["viewpoint"], ob["position"],
                        [(c["viewpointId"], c["position"])
                         for c in ob["candidate"]])

            ended |= np.array([c is None for c in chosen])
            if ended.all():
                break

        batch = None
        if record:
            stacked = StepInputs(*[
                np.stack([np.asarray(getattr(s, f)) for s in recorded])
                for f in StepInputs._fields])
            batch = TrajectoryBatch(txt_ids=txt_ids, txt_mask=txt_mask,
                                    steps=stacked)
        stats = {"steps": t + 1}
        return traj, batch, stats

    # ------------------------------------------------------------------ eval
    def evaluate(self, num_batches: Optional[int] = None,
                 detailed_output: bool = False) -> Tuple[dict, List[dict]]:
        """Greedy eval with instr_id dedup (agent_base.py:43-65 test loop).

        num_batches=None iterates the WHOLE split to wraparound — reference
        `test()` semantics; a fixed count is a subsample and should only be
        used for cheap mid-training probes. detailed_output additionally
        records per-node stop probabilities (r2r/agent.py:427-431,
        agent_base.py:30-32 `details`)."""
        preds: Dict[str, dict] = {}
        self.env.reset_epoch(shuffle=False)
        total = self.env.size()
        batch_size = getattr(self.env, "batch_size", len(self.env._get_obs()))
        limit = num_batches if num_batches else (
            -(-total // max(batch_size, 1)) + 1)  # +1 absorbs wraparound
        for _ in range(limit):
            traj, _, _ = self.rollout(feedback="argmax")
            for item in traj:
                rec = {
                    "instr_id": item["instr_id"],
                    "trajectory": item["trajectory"],
                    "pred_obj_id": item.get("pred_obj_id"),
                    "pred_obj_heading": item.get("pred_obj_heading"),
                    "pred_obj_elevation": item.get("pred_obj_elevation")}
                if detailed_output:
                    rec["details"] = {
                        vp: {"stop_prob": score}
                        for vp, score in item["stop_scores"].items()}
                preds.setdefault(item["instr_id"], rec)
            if num_batches is None and len(preds) >= total:
                break
        pred_list = list(preds.values())
        avg, _ = self.env.eval_metrics(pred_list)
        return avg, pred_list

    @staticmethod
    def write_submission(preds, path: str, objects: bool = False,
                         fmt: str = "auto") -> None:
        """Reference-exact submission JSON — the reference dumps
        `get_results()` verbatim with sort_keys/indent=4
        (main_nav.py:246-260). Per-flavor trajectory contract:

        - r2r/rxr (r2r/agent_base.py:27-33): trajectory = the nested
          per-action path segments, exactly as rolled out.
        - reverie (reverie/agent_base.py:26-33): + `pred_objid` on every
          entry (null when the agent never grounded an object, so strict
          evaluators indexing the key don't KeyError).
        - soon (soon/agent_obj.py:26-33): trajectory = {path,
          obj_heading: [h], obj_elevation: [e]}.

        fmt='auto' picks reverie when objects=True or any pred_obj_id exists,
        else r2r — SOON must be requested explicitly (REVERIE and SOON
        predictions carry the same object keys here, so the flavor comes from
        the caller's --world). fmt='triples' keeps this framework's earlier
        flattened [[vp, 0.0, 0.0], ...] spelling (the classic R2R leaderboard
        upload shape, which the reference itself does not emit)."""
        import json

        if fmt == "auto":
            if objects or any(it.get("pred_obj_id") is not None
                              for it in preds):
                fmt = "reverie"
            else:
                fmt = "r2r"

        out = []
        for item in preds:
            segs = [list(seg) for seg in item["trajectory"]]
            if fmt == "triples":
                rec = {"instr_id": item["instr_id"],
                       "trajectory": [[vp, 0.0, 0.0]
                                      for seg in segs for vp in seg]}
                if objects or item.get("pred_obj_id") is not None:
                    oid = item.get("pred_obj_id")
                    rec["pred_objid"] = None if oid is None else str(oid)
            elif fmt == "soon":
                rec = {"instr_id": item["instr_id"],
                       "trajectory": {
                           "path": segs,
                           "obj_heading": [float(
                               item.get("pred_obj_heading") or 0.0)],
                           "obj_elevation": [float(
                               item.get("pred_obj_elevation") or 0.0)]}}
            else:
                rec = {"instr_id": item["instr_id"], "trajectory": segs}
                if fmt == "reverie":
                    oid = item.get("pred_obj_id")
                    rec["pred_objid"] = None if oid is None else str(oid)
            if item.get("details"):
                rec["details"] = item["details"]
            out.append(rec)
        with open(path, "w") as f:
            json.dump(out, f, sort_keys=True, indent=4,
                      separators=(",", ": "))

"""Continuous-environment navigation agent, the VLN-CE GridMap policy (twin
of gridmm_tpu/ce/agent.py).

Host orchestration of the CE stack (reference: ss_trainer_GridMap.py:141-451
+ Policy_ViewSelection_GridMap.py modes). Per step:

  1. encode the 12 RGB-D frames -> waypoint heatmap -> softmax -> circular
     NMS -> <= 5 candidate waypoints (angle, distance) (Policy:345-391);
  2. CLIP grid tokens (the packed-qkv attention and LayerNorm kernels on the
     card) stay on the device and enter the point buffer;
  3. panorama + navigation forward through the SAME `nav_device_step` as the
     discrete agent (and so through the grid-pool kernel); waypoints enter
     the topological map as frontier nodes;
  4. move via env.step_to; the teacher is the candidate that minimizes the
     oracle cand_dist_to_goal (ss_trainer:288-328).

Greedy (argmax) rollouts may run the whole policy step on the device
(`full_step`: perception, candidate extraction by ce/device_step.py, step
assembly, navigation), with one device-to-host copy per step; the host keeps
the trajectory history and moves the env. Teacher rollouts and train-time
sampling keep the host-assembly path (the oracle and the numpy RNG sit
between candidate extraction and the navigation forward). The agent holds
the very modules the trainer updates; every module runs in eval mode under
`torch.inference_mode` during a rollout.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from gridmm_tpu_torch.ce.device_step import (DIST_BIN, NUM_ANGLES, NUM_DISTS,
                                             ce_action_logits,
                                             device_build_step,
                                             device_candidates)
from gridmm_tpu_torch.ce.env import CEStepObs, ContinuousEnv, ce_episode_metrics
from gridmm_tpu_torch.config import GridMMConfig
from gridmm_tpu_torch.env.graph import angle_features
from gridmm_tpu_torch.models.clip_vit import (normalize_images,
                                              normalize_images_timm)
from gridmm_tpu_torch.models.navigator import GridMMNavigator
from gridmm_tpu_torch.models.waypoint import WaypointPredictor, waypoint_nms
from gridmm_tpu_torch.train.step import StepInputs, init_carry, nav_device_step


def rel_pos_features(a, b, base_heading: float = 0.0,
                     base_elevation: float = 0.0):
    """(rel_heading, rel_elevation, dist) between two positions.

    Transcribes calculate_vp_rel_pos_fts (VLN_CE models/utils.py:125-144):
    positions are habitat (x, height, y) triples; heading measured from +y
    toward +x (the simulator's transposed x-y convention), flipped past pi/2
    when the target is behind (dy < 0)."""
    dx = float(b[0] - a[0])
    dz = float(b[1] - a[1])
    dy = float(b[2] - a[2])
    if dx == 0.0 and dz == 0.0 and dy == 0.0:
        return 0.0, 0.0, 0.0
    xy = max(math.sqrt(dx * dx + dy * dy), 1e-8)
    xyz = max(math.sqrt(dx * dx + dy * dy + dz * dz), 1e-8)
    heading = math.asin(max(-1.0, min(1.0, dx / xy)))
    if dy < 0:
        heading = math.pi - heading
    heading -= base_heading
    elevation = math.asin(max(-1.0, min(1.0, dz / xyz)))
    elevation -= base_elevation
    return heading, elevation, xyz


def traj_pos_features(traj_positions, traj_step_dists, cur_heading: float,
                      af: int, max_dist: float,
                      max_step: float) -> np.ndarray:
    """7-dim positional features for every visited trajectory node relative
    to the CURRENT pose (Policy_ViewSelection_GridMap.py:549-560): angle fts
    of (rel heading, rel elevation) w.r.t. current heading, then
    [line dist/max_dist, along-path dist to current/max_dist,
    steps-since-visit/max_step].

    traj_positions: chronological (x, height, y) triples, last = current
    node. traj_step_dists[j] = distance walked from node j-1 to node j (0 at
    j=0). Returns (T, af+3) rows in chronological order."""
    T = len(traj_positions)
    cur = traj_positions[-1]
    out = np.zeros((T, af + 3), np.float32)
    path_dist = np.zeros((T,), np.float64)
    for j in range(T - 2, -1, -1):
        path_dist[j] = path_dist[j + 1] + traj_step_dists[j + 1]
    for j in range(T):
        h, e, d = rel_pos_features(cur, traj_positions[j], cur_heading)
        out[j, :af] = angle_features(h, e, af)
        out[j, af] = d / max_dist
        out[j, af + 1] = path_dist[j] / max_dist
        out[j, af + 2] = (T - 1 - j) / max_step
    return out


def start_pos_features(traj_positions, traj_step_dists, cur_heading: float,
                       af: int, max_dist: float,
                       max_step: float) -> np.ndarray:
    """cur_start_pos_fts (Policy:590-601): rel pos of the START node from the
    current pose + [line dist/max_dist, total path dist/max_dist,
    action_step/max_step] where action_step == node count
    (ss_trainer_GridMap.py:254 sets action_step = stepk + 1)."""
    h, e, d = rel_pos_features(traj_positions[-1], traj_positions[0],
                               cur_heading)
    out = np.zeros((af + 3,), np.float32)
    out[:af] = angle_features(h, e, af)
    out[af] = d / max_dist
    out[af + 1] = float(np.sum(traj_step_dists)) / max_dist
    out[af + 2] = len(traj_positions) / max_step
    return out


class CEAgent:
    def __init__(self, cfg: GridMMConfig, navigator: GridMMNavigator,
                 waypoint: WaypointPredictor, clip_model: nn.Module,
                 rgb_tower: nn.Module, depth_tower: nn.Module,
                 view_encoder: Optional[nn.Module] = None,
                 max_candidates: int = 5):
        self.cfg = cfg
        self.navigator = navigator
        self.waypoint = waypoint
        self.clip = clip_model
        # per-view features: timm ViT-B/16 cls when a view tower is given
        # (Policy:338 forward_features[:,0,:]); CLIP cls fallback otherwise
        self.view_encoder = view_encoder
        self.rgb_tower = rgb_tower
        self.depth_tower = depth_tower
        self.max_candidates = max_candidates
        # per-env trajectory history of the host path, reset at step 0
        self._traj_pos: List[List[np.ndarray]] = []
        self._traj_dist: List[List[float]] = []
        # greedy rollouts may run the whole step on the device
        # (_rollout_fused); the host path stays for teacher feedback and
        # train-time sampling. "auto" fuses single-env rollouts only, the
        # JAX package's rule (kept for parity; the two paths act
        # identically). GRIDMM_CE_FUSED=1/0 or True/False force either.
        self.fused_rollout = os.environ.get("GRIDMM_CE_FUSED", "auto")

    @property
    def device(self) -> torch.device:
        return next(self.navigator.parameters()).device

    def modules(self) -> List[nn.Module]:
        return [m for m in (self.navigator, self.waypoint, self.clip,
                            self.rgb_tower, self.depth_tower,
                            self.view_encoder) if m is not None]

    # ------------------------------------------------------------ device fns
    def language(self, txt_ids, txt_mask):
        return self.navigator("language", {"txt_ids": txt_ids,
                                           "txt_mask": txt_mask})

    def waypoints(self, rgb, depth):
        """(B,12,H,W,3) u8 + (B,12,Hd,Wd) -> (NMS'd heatmap, probs), each
        (B,120,12)."""
        b = rgb.shape[0]
        rgb_f = self.rgb_tower(rgb.reshape((-1,) + rgb.shape[2:]))
        dep_f = self.depth_tower(depth.reshape((-1,) + depth.shape[2:])[
            ..., None])
        logits = self.waypoint(rgb_f, dep_f)  # (B, 120, 12)
        probs = torch.softmax(logits.reshape(b, -1).float(), dim=-1).reshape(
            b, NUM_ANGLES, NUM_DISTS)
        return waypoint_nms(probs, max_predictions=self.max_candidates,
                            sigma=(7.0, 5.0)), probs

    def grid_features(self, rgb):
        """(B,12,H,W,3) u8 -> (patch_fts (B, 12*(T-1), d) f32, left on the
        device for the point buffer, and view_cls (B, 12, d) f32)."""
        d = self.cfg.model.image_feat_size
        b, v = rgb.shape[0], rgb.shape[1]
        toks = self.clip(normalize_images(rgb.reshape((-1,) + rgb.shape[2:])))
        toks = toks.reshape(b, v, *toks.shape[1:])
        patch = toks[:, :, 1:, :d].float().reshape(b, -1, d)
        return patch, toks[:, :, 0, :d].float()

    def view_features(self, rgb):
        """(B,12,H,W,3) u8 -> (B, 12, width) timm-ViT cls features
        (Policy:335-343: visual_encoder.forward_features[:, 0, :]), in the
        tower's compute type."""
        toks = self.view_encoder(normalize_images_timm(
            rgb.reshape((-1,) + rgb.shape[2:])))
        return toks[:, 0, :].reshape(rgb.shape[0], rgb.shape[1], -1)

    def perception(self, rgb, depth):
        """All per-step perception: waypoint towers + NMS, CLIP grid tokens,
        the optional timm view cls. Returns (nms_maps, probs, patch,
        view_cls, view_feats or None)."""
        nms_maps, probs = self.waypoints(rgb, depth)
        patch, view_cls = self.grid_features(rgb)
        view_feats = (self.view_features(rgb)
                      if self.view_encoder is not None else None)
        return nms_maps, probs, patch, view_cls, view_feats

    def full_step(self, txt_embeds, txt_mask, carry, rgb, depth, pos_xy,
                  heading, traj_pos, traj_dist, traj_len, t, ended=None):
        """The whole greedy policy step on the device: perception towers,
        waypoint candidates from the NMS heatmap, step assembly
        (ce/device_step.py twin of _build_step), navigation forward.
        Returns (carry, CE action logits, candidates)."""
        nms_maps, _probs, patch, view_cls, view_feats = self.perception(
            rgb, depth)
        cand = device_candidates(nms_maps, self.max_candidates)
        x = device_build_step(self.cfg, cand, view_cls, depth, pos_xy,
                              heading, traj_pos, traj_dist, traj_len, t,
                              view_feats=view_feats, ended=ended)
        x = x._replace(patch_fts=patch)
        carry, out = nav_device_step(self.navigator, self.cfg, txt_embeds,
                                     txt_mask, carry, x)
        logits = ce_action_logits(out.global_logits, out.local_logits,
                                  x.cand_gmap_idx)
        return carry, logits, cand

    # ------------------------------------------------------------ host logic
    @staticmethod
    def candidates_from_nms(nms_map: np.ndarray, heading: float,
                            max_candidates: int,
                            probs: Optional[np.ndarray] = None,
                            rng: Optional[np.random.Generator] = None):
        """Nonzero peaks -> [(abs_heading, distance, score)] (Policy:360-391;
        heatmap angle 0 is the agent's heading).

        Train-time augmentation (Policy:393-425): when `probs` is given, each
        peak's (angle, distance) is re-sampled from the probability mass of
        its 30-degree image sector instead of taken at the argmax."""
        out = []
        ang, dst = np.nonzero(nms_map)
        per_img = NUM_ANGLES // 12  # 10 angle bins per image sector
        for a, d in zip(ang, dst):
            score = float(nms_map[a, d])
            if probs is not None and rng is not None:
                img = ((a + per_img // 2) // per_img) % 12
                # sector 0 wraps: original angle bins {-5..4} mod 120 (the
                # reference rolls by HEATMAP_OFFSET before reshaping,
                # Policy:397-401). Sampling from the renormalized full-map
                # softmax over the sector == softmax of the sector logits
                # (Policy:412-413).
                start = (img * per_img - per_img // 2) % NUM_ANGLES
                rows = (start + np.arange(per_img)) % NUM_ANGLES
                region = probs[rows]  # (10, 12)
                p = region.reshape(-1).astype(np.float64)
                p = p / p.sum() if p.sum() > 0 else np.full(p.size,
                                                            1 / p.size)
                pick = rng.choice(p.size, p=p)
                k = pick // NUM_DISTS
                if img != 0:
                    a = (img - 1) * per_img + per_img // 2 + k  # true angle
                else:
                    # reference quirk (Policy:417-421): angle_pointer = 0 for
                    # sector 0, so its samples, drawn from the ROLLED rows
                    # {115..119, 0..4}, are labeled angles 0..9 verbatim.
                    # Released checkpoints trained through this off-by-5.
                    a = int(k)
                d = pick % NUM_DISTS
            abs_heading = heading + a * (2 * math.pi / NUM_ANGLES)
            out.append((abs_heading, (d + 1) * DIST_BIN, score))
        # reference order: np.nonzero row-major = angle-major ascending
        # (Policy:446-449); NMS already bounds the count at max_candidates
        return out[:max_candidates]

    def language_batch(self, obs) -> Tuple[np.ndarray, np.ndarray]:
        t = self.cfg.shapes.max_txt_len
        b = len(obs)
        ids = np.zeros((b, t), np.int32)
        mask = np.zeros((b, t), bool)
        for i, ob in enumerate(obs):
            enc = ob.instruction_ids[:t]
            ids[i, : len(enc)] = enc
            mask[i, : len(enc)] = True
        return ids, mask

    def observation_tensors(self, obs):
        """The batch's panoramas on the device: rgb (B,12,H,W,3) uint8 and
        depth (B,12,Hd,Wd) f32."""
        dev = self.device
        rgb = torch.from_numpy(np.stack([ob.rgb for ob in obs]))
        depth = torch.from_numpy(np.stack([ob.depth for ob in obs]))
        return rgb.to(dev), depth.to(dev)

    @contextlib.contextmanager
    def inference(self):
        """Every module in eval mode under torch.inference_mode; modes are
        restored after."""
        modes = [(m, m.training) for m in self.modules()]
        for m, _ in modes:
            m.eval()
        try:
            with torch.inference_mode():
                yield
        finally:
            for m, mode in modes:
                m.train(mode)

    def rollout(self, env: ContinuousEnv, max_steps: int = 8,
                feedback: str = "argmax",
                rng: Optional[np.random.Generator] = None,
                on_step=None, timer=None, trace: Optional[list] = None):
        """Run one batch of episodes; returns the per-episode metrics.

        on_step(t, obs) is invoked with the observation list at every step
        (t=0 is the reset state), the eval video hook
        (base_il_trainer.py:631-644). timer: an optional
        utils.logging.SectionTimer accumulating per-phase wall time. trace:
        an optional list that receives each step's CE action logits (B, V)
        as the host read them (float64)."""
        with self.inference():
            return self._rollout(env, max_steps, feedback, rng, on_step,
                                 timer, trace)

    def _rollout(self, env, max_steps, feedback, rng, on_step, timer,
                 trace):
        cfg = self.cfg
        dev = self.device
        # the point buffer caps episode length: appends past capacity would
        # overwrite the tail window. Clamp loudly instead (full-scale CE
        # presets carry a 20-step buffer matching IL.max_traj_len)
        cap = cfg.shapes.max_points // cfg.grid.points_per_step
        if max_steps > cap:
            print(f"[ce] max_steps {max_steps} exceeds the {cap}-step point "
                  f"buffer; clamping (raise NavigatorShapes.max_points for "
                  f"longer episodes)", flush=True)
            max_steps = cap
        sec = (timer.section if timer is not None
               else (lambda name: contextlib.nullcontext()))
        obs = env.reset()
        b = env.num_envs

        txt_ids, txt_mask = self.language_batch(obs)
        txt_mask_dev = torch.from_numpy(txt_mask).to(dev)
        txt_embeds = self.language(torch.from_numpy(txt_ids).to(dev),
                                   txt_mask_dev)
        carry = init_carry(cfg, b, device=dev)

        fuse = self.fused_rollout
        # "auto" may route B=1 and B>1 through different paths; that is safe
        # only because the fused step acts exactly as the host path does
        # (tests/test_torch_ce_agent.py holds their actions and metrics)
        if feedback == "argmax" and (
                fuse in (True, "1") or (fuse == "auto" and b == 1)):
            return self._rollout_fused(env, obs, txt_embeds, txt_mask_dev,
                                       carry, max_steps, on_step, sec, trace)

        ended = np.zeros((b,), bool)
        # ended on the agent's own STOP (success requires it, base_il_trainer
        # :598) + per-macro-step distance-to-goal series (Position measure)
        stopped = np.zeros((b,), bool)
        dist_hist = [[env.dist_to_goal(i)] for i in range(b)]
        next_slot = np.full((b,), 1, np.int32)
        # depth patch centers (Policy:728-730): 19 + 36*i over 256px maps
        centers = np.asarray([19 + 36 * i for i in range(7)])

        for t in range(max_steps):
            if on_step is not None:
                on_step(t, obs)
            with sec("transfer"):
                rgb, depth = self.observation_tensors(obs)
            with sec("perception"):
                nms_maps, _probs, patch, view_cls, view_feats = \
                    self.perception(rgb, depth)
                nms_maps = nms_maps.cpu().numpy()
                view_cls = view_cls.cpu().numpy()
                if view_feats is not None:
                    view_feats = view_feats.float().cpu().numpy()
            with sec("candidates"):
                cand_lists = [
                    self.candidates_from_nms(nms_maps[i], obs[i].heading,
                                             self.max_candidates)
                    for i in range(b)]
            with sec("build_step"):
                x, _ = self._build_step(obs, cand_lists, view_cls, centers,
                                        next_slot, t, view_feats=view_feats,
                                        ended=ended)
            if feedback == "teacher":
                # the oracle is a training-only signal; greedy eval and
                # inference skip it like the reference's _eval_checkpoint
                with sec("teacher"):
                    targets = self._teacher(env, obs, cand_lists, ended)
                x = x._replace(target=targets.astype(np.int32))
            with sec("nav"):
                x = step_to_device(x, dev, patch)
                carry, out = nav_device_step(self.navigator, cfg, txt_embeds,
                                             txt_mask_dev, carry, x)
                # CE acts on fused = global+local over [stop]+candidates
                # (gridmap/vilmodel.py:788-800; ss_trainer:269-330)
                logits = ce_action_logits(
                    out.global_logits, out.local_logits,
                    x.cand_gmap_idx).double().cpu().numpy()
            if trace is not None:
                trace.append(logits)

            if feedback == "teacher":
                a_t = targets.copy()
                a_t[a_t == cfg.train.ignoreid] = 0
            else:
                a_t = logits.argmax(-1)

            with sec("env_step"):
                for i in range(b):
                    if ended[i]:
                        continue
                    if a_t[i] == 0 or t == max_steps - 1:
                        stopped[i] = a_t[i] == 0
                        ended[i] = True
                        continue
                    heading_i, dist_i, _ = cand_lists[i][a_t[i] - 1]
                    env.step_to(i, heading_i, dist_i)
                    dist_hist[i].append(env.dist_to_goal(i))
                obs = env.observations()
            if ended.all():
                break
        return self._metrics(env, obs, stopped, dist_hist)

    @staticmethod
    def _metrics(env, obs, stopped, dist_hist):
        b = env.num_envs
        return [ce_episode_metrics(
            env.paths[i], obs[i].gt_path, stopped=bool(stopped[i]),
            dists=dist_hist[i],
            collisions=getattr(env, "collisions", [None] * b)[i])
            for i in range(b)]

    def _rollout_fused(self, env: ContinuousEnv, obs, txt_embeds, txt_mask,
                       carry, max_steps: int, on_step, sec, trace=None):
        """Greedy rollout driving the device step: the host only keeps the
        trajectory history, fetches (logits, candidate bins) once per step,
        and moves the env. Acts exactly as the host path does."""
        b = env.num_envs
        dev = self.device
        cap = self.cfg.model.max_action_steps
        traj_pos = np.zeros((b, cap, 3), np.float32)
        traj_dist = np.zeros((b, cap), np.float32)
        ended = np.zeros((b,), bool)
        stopped = np.zeros((b,), bool)
        dist_hist = [[env.dist_to_goal(i)] for i in range(b)]

        for t in range(max_steps):
            if on_step is not None:
                on_step(t, obs)
            r = min(t, cap - 1)
            for i, ob in enumerate(obs):
                p3 = np.array([ob.position[0], getattr(ob, "height", 0.0),
                               ob.position[1]], np.float32)
                traj_dist[i, r] = (0.0 if t == 0 else float(
                    np.linalg.norm(p3 - traj_pos[i, max(r - 1, 0)])))
                traj_pos[i, r] = p3
            with sec("transfer"):
                rgb, depth = self.observation_tensors(obs)
                host = (np.stack([ob.position for ob in obs]).astype(
                            np.float32),
                        np.asarray([ob.heading for ob in obs], np.float32),
                        traj_pos, traj_dist,
                        np.full((b,), min(t + 1, cap), np.int32),
                        np.asarray(t, np.int64), ended)
                pos, hd, tpos, tdist, tlen, t_dev, ended_dev = (
                    torch.from_numpy(np.array(a)).to(dev) for a in host)
            with sec("fused_step"):
                carry, logits, cand = self.full_step(
                    txt_embeds, txt_mask, carry, rgb, depth, pos, hd, tpos,
                    tdist, tlen, t_dev, ended_dev)
                logits = logits.double().cpu().numpy()
                ang = cand.ang_bins.cpu().numpy()
                dbin = cand.dist_bins.cpu().numpy()
                n_cands = cand.mask.sum(-1).cpu().numpy()
            if trace is not None:
                trace.append(logits)
            a_t = logits.argmax(-1)
            with sec("env_step"):
                for i in range(b):
                    if ended[i]:
                        continue
                    if a_t[i] == 0 or t == max_steps - 1 or \
                            a_t[i] > n_cands[i]:
                        stopped[i] = a_t[i] == 0
                        ended[i] = True
                        continue
                    j = int(a_t[i]) - 1
                    heading_i = obs[i].heading + \
                        ang[i, j] * (2 * math.pi / NUM_ANGLES)
                    env.step_to(i, heading_i, (dbin[i, j] + 1) * DIST_BIN)
                    dist_hist[i].append(env.dist_to_goal(i))
                obs = env.observations()
            if ended.all():
                break
        return self._metrics(env, obs, stopped, dist_hist)

    def _build_step(self, obs: List[CEStepObs], cand_lists, view_cls,
                    centers, next_slot, t, view_feats=None, ended=None
                    ) -> Tuple[StepInputs, np.ndarray]:
        """Assemble host-side StepInputs (numpy). view_cls is (B, 12, d)
        per-view cls features; the returned patch_fts field is a zero
        placeholder: the caller wires in the device-resident patch
        tokens."""
        cfg = self.cfg
        sh, gc = cfg.shapes, cfg.grid
        b = len(obs)
        v, g = sh.max_vp_len, sh.max_gmap_len
        vm1 = v - 1
        af = cfg.model.angle_feat_size
        d = cfg.model.image_feat_size

        view_img_fts = np.zeros((b, vm1, d), np.float32)
        loc_fts = np.zeros((b, vm1, af + 3), np.float32)
        nav_types = np.zeros((b, vm1), np.int32)
        view_mask = np.zeros((b, vm1), bool)
        depth_p = np.zeros((b, gc.num_views, gc.patches_per_view), np.float32)
        patch_fts = np.zeros((b, gc.points_per_step, d), np.float32)
        pos_xy = np.zeros((b, 2), np.float32)
        heading = np.zeros((b,), np.float32)
        gmap_step_ids = np.zeros((b, g), np.int32)
        gmap_pos_fts = np.zeros((b, g, af + 3), np.float32)
        gmap_mask = np.zeros((b, g), bool)
        gmap_visited = np.zeros((b, g), bool)
        cur_node = np.zeros((b,), np.int32)
        cand_gmap_idx = np.full((b, vm1), -1, np.int32)
        vp_pos_fts = np.zeros((b, v, 2 * af + 6), np.float32)
        vp_nav_mask = np.zeros((b, v), bool)
        fused_add_idx = np.full((b, g), -2, np.int32)

        # per-env trajectory history (reference traj_map, Policy:509-518):
        # current position appended each step with the walked distance
        if t == 0:
            self._traj_pos = [[] for _ in range(b)]
            self._traj_dist = [[] for _ in range(b)]
        for i, ob in enumerate(obs):
            p3 = np.asarray([ob.position[0], getattr(ob, "height", 0.0),
                             ob.position[1]], np.float64)
            step_d = (0.0 if not self._traj_pos[i] else
                      float(np.linalg.norm(p3 - self._traj_pos[i][-1])))
            self._traj_pos[i].append(p3)
            self._traj_dist[i].append(step_d)

        # the reference initializes the 12-view angle table ONCE before its
        # per-env loop and OVERWRITES the same variable with each env's
        # assembled [cand|non-cand] angle rows (Policy:461,470-480): for
        # batch index >= 1 the non-candidate angle features are read from
        # the PREVIOUS active env's assembled sequence, reproduced
        # deliberately
        ang_table = np.stack([
            angle_features(ix * 2 * math.pi / 12, 0.0, af)
            for ix in range(12)]).astype(np.float32)

        for i, ob in enumerate(obs):
            cands = cand_lists[i]
            # panorama tokens: one feature per view, candidates first: timm
            # ViT cls when a view tower is configured, CLIP cls otherwise
            view_cls_i = (view_feats[i][:, :d] if view_feats is not None
                          else view_cls[i])  # (12, d)
            k = 0
            used_views = set()
            cand_angs = []
            for heading_c, dist_c, _score in cands:
                rel = heading_c - ob.heading
                # nearest 30-degree sector via the INTEGER angle bin (the
                # float64 cancellation in rel is << half a 3-degree bin, so
                # the bin recovery is exact); half-up ties match the device
                # twin and the sector-sampling augmentation
                a_bin = int(round((rel % (2 * math.pi)) /
                                  (2 * math.pi / NUM_ANGLES))) % NUM_ANGLES
                per_img = NUM_ANGLES // 12
                # COUNTER-clockwise image index over the clockwise-ordered
                # frames (Policy:456-459: 12 - (a+5)//10, 12 -> 0)
                img_idx = (12 - (a_bin + per_img // 2) // per_img) % 12
                used_views.add(img_idx)
                # the reference's candidate angle is the CCW conversion of
                # the bin (Policy:451-452 angle_rad_cc = 2pi - a*3deg, NO
                # modulo: bin 0 keeps the literal 2pi)
                ang_cc = 2 * math.pi - a_bin * (2 * math.pi / NUM_ANGLES)
                cand_angs.append(ang_cc)
                view_img_fts[i, k] = view_cls_i[img_idx]
                loc_fts[i, k, :af] = angle_features(ang_cc, 0.0, af)
                loc_fts[i, k, af:] = 1.0
                nav_types[i, k] = 1
                k += 1
            # non-candidate views EXCLUDE the sectors claimed by candidates
            # (Policy:466-476); angle rows come from the (aliased) running
            # table rather than the raw view azimuths
            for ix in range(12):
                if ix in used_views or k >= vm1:
                    continue
                view_img_fts[i, k] = view_cls_i[ix]
                loc_fts[i, k, :af] = ang_table[ix]
                loc_fts[i, k, af:] = 1.0
                k += 1
            view_mask[i, :k] = True
            # the overwrite that feeds the NEXT env's non-cand rows: only
            # ACTIVE envs take part (the reference pauses ended envs,
            # ss_trainer_GridMap.py:436-450)
            if ended is None or not ended[i]:
                ang_table = loc_fts[i, :12, :af].copy()

            frame = ob.depth
            if gc.depth_normalized:
                # habitat [0,1] depth -> metres for the grid build with the
                # reference's column-max zero substitution + x100//100 scale
                # (GridMap.preprocess_depth, Policy:225-247)
                colmax = frame.max(axis=1, keepdims=True)
                frame = np.where(frame == 0,
                                 np.broadcast_to(colmax, frame.shape), frame)
                frame = (gc.min_depth * 100.0 +
                         frame * (gc.max_depth - gc.min_depth) * 100.0
                         ) / 100.0
            dm = frame[:, centers][:, :, centers]
            depth_p[i] = dm.reshape(gc.num_views, gc.patches_per_view)
            pos_xy[i] = ob.position
            heading[i] = ob.heading

            # current position becomes visited node slot t+1
            cur = min(t + 1, g - 1)
            cur_node[i] = cur
            next_slot[i] = cur + 1
            gmap_mask[i, 0] = True
            for s in range(1, cur + 1):
                gmap_mask[i, s] = True
                gmap_visited[i, s] = s < cur  # past positions
                gmap_step_ids[i, s] = min(s, cfg.model.max_action_steps - 1)
            gmap_visited[i, cur] = True
            gmap_step_ids[i, cur] = min(t + 1, cfg.model.max_action_steps - 1)

            # visited-chain positional features: each past node's 7-dim rel
            # pose w.r.t. the CURRENT pose, recomputed every step
            # (Policy:549-560; slot s holds chronological node s-1, slot cur
            # always the current node)
            gmap_pos_fts[i, 0, :af] = angle_features(0.0, 0.0, af)  # [stop]
            tf = traj_pos_features(self._traj_pos[i], self._traj_dist[i],
                                   ob.heading, af, gc.max_dist,
                                   gc.pos_step_norm)
            for s in range(1, cur):
                gmap_pos_fts[i, s] = tf[s - 1]
            gmap_pos_fts[i, cur] = tf[-1]

            # waypoints as ephemeral frontier slots after the visited chain
            # (Policy:537-547), with the batch_distances=batch_ANGLES
            # substitution of the trainer (ss_trainer_GridMap.py:275): the
            # "distance" entries carry the CCW angle; env stepping still
            # uses the true distance (ss_trainer:293-296)
            for j, ang_cc in enumerate(cand_angs):
                s = cur + 1 + j
                if s >= g:
                    break
                gmap_mask[i, s] = True
                gmap_pos_fts[i, s, :af] = angle_features(ang_cc, 0.0, af)
                gmap_pos_fts[i, s, af] = ang_cc / gc.max_dist
                gmap_pos_fts[i, s, af + 1] = ang_cc / gc.max_dist
                gmap_pos_fts[i, s, af + 2] = 1.0 / gc.pos_step_norm
                gmap_step_ids[i, s] = min(cur + 1,
                                          cfg.model.max_action_steps - 1)
                cand_gmap_idx[i, j] = s
                fused_add_idx[i, s] = j + 1

            # vp tokens: every row leads with the current-pose-to-start
            # features (Policy:604-606 vp_pos_fts[:, :7] = cur_start_pos_fts)
            vp_pos_fts[i, :, : af + 3] = start_pos_features(
                self._traj_pos[i], self._traj_dist[i], ob.heading, af,
                gc.max_dist, gc.pos_step_norm)
            vp_nav_mask[i, 0] = True
            vp_nav_mask[i, 1: 1 + len(cands)] = True
            for j, ang_cc in enumerate(cand_angs):
                vp_pos_fts[i, j + 1, af + 3: 2 * af + 3] = angle_features(
                    ang_cc, 0.0, af)
                # cur_cand_pos_fts triple (Policy:576-584) with the same
                # batch_distances=batch_angles substitution
                vp_pos_fts[i, j + 1, 2 * af + 3] = ang_cc / gc.max_dist
                vp_pos_fts[i, j + 1, 2 * af + 4] = ang_cc / gc.max_dist
                vp_pos_fts[i, j + 1, 2 * af + 5] = 1.0 / gc.pos_step_norm

        ig = np.full((b,), cfg.train.ignoreid, np.int32)
        return StepInputs(
            view_img_fts=view_img_fts, loc_fts=loc_fts, nav_types=nav_types,
            view_mask=view_mask, depth=depth_p, patch_fts=patch_fts,
            pos_xy=pos_xy, heading=heading, gmap_step_ids=gmap_step_ids,
            gmap_pos_fts=gmap_pos_fts, gmap_mask=gmap_mask,
            gmap_visited_mask=gmap_visited, cur_node_idx=cur_node,
            cand_gmap_idx=cand_gmap_idx, vp_pos_fts=vp_pos_fts,
            vp_nav_mask=vp_nav_mask, fused_add_idx=fused_add_idx,
            cand_backtrack_mask=np.zeros((b, v), bool),
            target=ig, grid_target=ig.copy(),
            vp_obj_mask=np.zeros((b, v), bool), obj_target=ig.copy(),
        ), cur_node

    def _teacher(self, env: ContinuousEnv, obs, cand_lists,
                 ended) -> np.ndarray:
        """Oracle teacher over [stop]+candidates (ss_trainer:288-328)."""
        b = len(obs)
        a = np.full((b,), self.cfg.train.ignoreid, np.int64)
        for i in range(b):
            if ended[i]:
                continue
            cur_d = env.dist_to_goal(i)
            # the reference stops inside 1.5 m: its comment says "def as
            # 3.0" but the code tests < 1.5 (ss_trainer_GridMap.py:305-308)
            if cur_d < 1.5:
                a[i] = 0
                continue
            # otherwise argmin over candidate end-distances UNCONDITIONALLY
            # (ss_trainer_GridMap.py:310): the oracle moves to the least-bad
            # candidate even when none improves on the current distance
            dists = [env.cand_dist_to_goal(i, heading_c, dist_c)
                     for heading_c, dist_c, _s in cand_lists[i]]
            a[i] = 1 + int(np.argmin(dists)) if dists else 0
        return a


def step_to_device(x: StepInputs, device, patch_fts=None) -> StepInputs:
    """Host StepInputs (numpy) as tensors on `device`; `patch_fts`, when
    given, replaces the placeholder (the device-resident CLIP tokens)."""
    x = StepInputs(*(torch.from_numpy(np.asarray(a)).to(device)
                     if not isinstance(a, torch.Tensor) else a.to(device)
                     for a in x))
    if patch_fts is not None:
        x = x._replace(patch_fts=patch_fts)
    return x

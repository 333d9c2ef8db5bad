"""Device-side CE step assembly (twin of gridmm_tpu/ce/device_step.py): the
VLN-CE policy step's candidate and graph assembly as tensor arithmetic on the
card.

The host path (`CEAgent._build_step` + `candidates_from_nms`) re-derives the
reference's per-step numpy/python assembly (Policy_ViewSelection_GridMap.py:
360-391 waypoint thresholding, :509-620 traj/vp positional features).
Everything in it is fixed-shape arithmetic on <= 5 candidates and <= G graph
slots, so this module re-expresses it on tensors: waypoint candidates by a
stable sort of the NMS heatmap, positional features from padded trajectory
arrays, masks from `arange` comparisons. A greedy rollout then runs
perception, candidate extraction, step assembly and navigation with one
device-to-host copy per step. Every write is of a device tensor: no Python
scalar goes through advanced indexing, so nothing here copies host to device
mid-step.

The reference's quirks are part of the contract, as in the JAX package: the
candidate pos features' "distance" entries carry the CCW angle
(batch_distances=batch_angles, ss_trainer_GridMap.py:275), and the
non-candidate angle rows alias the previous active env's (Policy:461,
470-480). Exact-equivalence tests against the host path:
tests/test_torch_ce_step.py.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from gridmm_tpu_torch.config import GridMMConfig
from gridmm_tpu_torch.train.step import StepInputs

NUM_ANGLES, NUM_DISTS = 120, 12
DIST_BIN = 0.25  # metres per distance bin


def device_angle_features(heading, elevation, af: int = 4) -> torch.Tensor:
    """Tensor twin of env/graph.angle_features over leading dims."""
    base = torch.stack([torch.sin(heading), torch.cos(heading),
                        torch.sin(elevation), torch.cos(elevation)], dim=-1)
    return torch.cat([base] * (af // 4), dim=-1).float()


def device_rel_pos_features(a, b, base_heading):
    """Vectorized ce/agent.rel_pos_features over (..., 3) habitat triples.

    Returns (rel_heading, rel_elevation, dist); exactly (0, 0, 0) when the
    positions coincide, BEFORE the base-heading subtraction (matching the
    host early-return)."""
    dx = b[..., 0] - a[..., 0]
    dz = b[..., 1] - a[..., 1]
    dy = b[..., 2] - a[..., 2]
    xy = torch.clamp(torch.sqrt(dx * dx + dy * dy), min=1e-8)
    xyz = torch.clamp(torch.sqrt(dx * dx + dy * dy + dz * dz), min=1e-8)
    h = torch.asin(torch.clamp(dx / xy, -1.0, 1.0))
    h = torch.where(dy < 0, math.pi - h, h) - base_heading
    e = torch.asin(torch.clamp(dz / xyz, -1.0, 1.0))
    zero = (dx == 0) & (dz == 0) & (dy == 0)
    z = torch.zeros_like(h)
    return (torch.where(zero, z, h), torch.where(zero, z, e),
            torch.where(zero, z, xyz))


def _current(traj_pos, traj_len):
    """(B, 1, 3) row of each trajectory's last valid node."""
    idx = torch.clamp(traj_len.long() - 1, min=0)[:, None, None]
    return torch.gather(traj_pos, 1, idx.expand(-1, 1, 3))


def device_traj_pos_features(traj_pos, traj_dist, traj_len, cur_heading,
                             af: int, max_dist: float,
                             max_step: float) -> torch.Tensor:
    """ce/agent.traj_pos_features over padded (B, T, 3) trajectories.

    traj_len (B,) counts valid chronological rows (last valid = current
    node); rows >= traj_len are garbage the caller must mask."""
    b, tcap = traj_dist.shape
    idx = torch.arange(tcap, device=traj_dist.device)
    valid = idx[None, :] < traj_len[:, None]
    d = torch.where(valid, traj_dist, torch.zeros_like(traj_dist))
    # path_dist[j] = sum_{k>j, k<len} dist[k]
    suffix = torch.flip(torch.cumsum(torch.flip(d, [1]), 1), [1])
    path_dist = suffix - d
    cur = _current(traj_pos, traj_len)
    h, e, dist = device_rel_pos_features(cur, traj_pos, cur_heading[:, None])
    recency = (traj_len[:, None] - 1 - idx).float() / max_step
    return torch.cat([
        device_angle_features(h, e, af),
        (dist / max_dist)[..., None].float(),
        (path_dist / max_dist)[..., None].float(),
        recency[..., None],
    ], dim=-1)


def device_start_pos_features(traj_pos, traj_dist, traj_len, cur_heading,
                              af: int, max_dist: float,
                              max_step: float) -> torch.Tensor:
    """ce/agent.start_pos_features over padded trajectories -> (B, af+3)."""
    b, tcap = traj_dist.shape
    idx = torch.arange(tcap, device=traj_dist.device)
    valid = idx[None, :] < traj_len[:, None]
    cur = _current(traj_pos, traj_len)[:, 0]
    h, e, dist = device_rel_pos_features(cur, traj_pos[:, 0], cur_heading)
    total = torch.where(valid, traj_dist, torch.zeros_like(traj_dist)).sum(1)
    return torch.cat([
        device_angle_features(h, e, af),
        (dist / max_dist)[:, None].float(),
        (total / max_dist)[:, None].float(),
        (traj_len.float() / max_step)[:, None],
    ], dim=-1)


class DeviceCandidates(NamedTuple):
    ang_bins: torch.Tensor   # (B, K) int32 heatmap angle bin (rel to heading)
    dist_bins: torch.Tensor  # (B, K) int32 distance bin
    scores: torch.Tensor     # (B, K) f32 NMS score
    mask: torch.Tensor       # (B, K) bool valid candidate


def device_candidates(nms_maps, max_candidates: int) -> DeviceCandidates:
    """Nonzero NMS peaks in the reference's enumeration order -> fixed-K
    candidate slots.

    Twin of CEAgent.candidates_from_nms (no sampling): the host enumerates
    nonzero entries row-major (Policy:446-449 nonzero() = angle-major
    ascending). Nonzero peaks get their flat index as sort key, zeros share
    one key and sort to the back in index order (a stable sort, as
    jnp.argsort is); NMS bounds the count at max_predictions."""
    b = nms_maps.shape[0]
    flat = nms_maps.reshape(b, -1)
    n_flat = flat.shape[1]
    ar = torch.arange(n_flat, device=flat.device)[None, :].expand(b, -1)
    key = torch.where(flat > 0, ar, torch.full_like(ar, n_flat))
    order = torch.argsort(key, dim=1, stable=True)[:, :max_candidates]
    scores = torch.gather(flat, 1, order)
    return DeviceCandidates(
        ang_bins=(order // NUM_DISTS).to(torch.int32),
        dist_bins=(order % NUM_DISTS).to(torch.int32),
        scores=scores,
        mask=scores > 0,
    )


def _take(src, idx):
    """take_along_axis over dim 1 for a (B, N, F) source and (B, M) index
    -> (B, M, F)."""
    return torch.gather(src, 1, idx.long()[..., None].expand(
        -1, -1, src.shape[-1]))


def device_build_step(
    cfg: GridMMConfig,
    cand: DeviceCandidates,
    view_cls,                  # (B, 12, d) per-view cls features
    depth,                     # (B, 12, Hd, Wd) metric depth
    pos_xy,                    # (B, 2)
    heading,                   # (B,)
    traj_pos,                  # (B, T, 3) padded habitat triples
    traj_dist,                 # (B, T) padded per-step distances
    traj_len,                  # (B,) valid rows (incl. current)
    t,                         # int step index, or a 0-d int tensor
    view_feats: Optional[torch.Tensor] = None,  # (B, 12, d_view) timm cls
    ended: Optional[torch.Tensor] = None,       # (B,) bool ended episodes
) -> StepInputs:
    """Tensor twin of CEAgent._build_step (candidate/graph/vp assembly).

    Returns StepInputs with a zero patch_fts placeholder (the caller wires
    the device-resident CLIP patch tokens, like the host path does)."""
    sh, gc = cfg.shapes, cfg.grid
    b = view_cls.shape[0]
    dev = view_cls.device
    v, g = sh.max_vp_len, sh.max_gmap_len
    vm1 = v - 1
    af = cfg.model.angle_feat_size
    d = cfg.model.image_feat_size
    k = cand.ang_bins.shape[1]
    ign = cfg.train.ignoreid
    mas = cfg.model.max_action_steps
    f32 = torch.float32

    def ar(n):
        return torch.arange(n, device=dev)

    view_src = (view_feats[..., :d] if view_feats is not None
                else view_cls).float()  # (B, 12, d)
    n = cand.mask.sum(dim=1)  # (B,) candidate count

    # candidate geometry. The reference's candidate angle is the CCW
    # conversion 2pi - bin*3deg with NO modulo (Policy:451-452), and its
    # view index is the COUNTER-clockwise sector over the clockwise-ordered
    # frames (Policy:456-459: 12 - (a+5)//10, 12 -> 0). The integer bin
    # space keeps half-up ties exact.
    ang_cc = (2 * math.pi -
              cand.ang_bins.to(f32) * (2 * math.pi / NUM_ANGLES))
    per_img = NUM_ANGLES // 12
    img_idx = (12 - (cand.ang_bins.long() + per_img // 2) // per_img) % 12
    cand_ang = device_angle_features(ang_cc, torch.zeros_like(ang_cc), af)

    # ---- panorama tokens: candidates first, then the views NOT claimed by
    # a candidate, in ascending view order (Policy:466-476) ----------------
    rows = ar(vm1)
    is_cand = rows[None, :] < n[:, None]                       # (B, vm1)
    crow = torch.clamp(rows, max=k - 1)[None, :].expand(b, -1)
    vix = ar(12)
    used = ((img_idx[:, None, :] == vix[None, :, None]) &
            cand.mask[:, None, :]).any(dim=2)                  # (B, 12)
    n_unused = 12 - used.sum(dim=1)
    # unused views first in ascending order, used views sorted to the back
    view_order = torch.argsort(vix[None, :] + used.long() * 100, dim=1,
                               stable=True)                    # (B, 12)
    vslot = torch.clamp(rows[None, :] - n[:, None], 0, 11)
    vrow = torch.gather(view_order, 1, vslot)                  # actual view
    in_view = (rows[None, :] >= n[:, None]) & \
        (rows[None, :] < (n + n_unused)[:, None])
    cand_img = _take(view_src, torch.gather(img_idx, 1, crow))
    view_img = _take(view_src, vrow)
    zero = torch.zeros((), dtype=f32, device=dev)
    view_img_fts = torch.where(is_cand[..., None], cand_img,
                               torch.where(in_view[..., None], view_img,
                                           zero))

    cand_ang_rows = _take(cand_ang, crow)
    # non-candidate angle rows come from a RUNNING table: the reference
    # initializes the 12-view angle table once before its per-env loop and
    # overwrites the variable with each env's assembled rows
    # (Policy:461,470-480): env i >= 1 reads the previous ACTIVE env's
    # sequence (ended envs are paused out of the batch,
    # ss_trainer_GridMap.py:436-450)
    table = device_angle_features(
        ar(12).to(f32) * (2 * math.pi / 12), torch.zeros(12, device=dev),
        af)                                                   # (12, af)
    loc_ang_rows = []
    for i in range(b):
        view_ang_i = table[vrow[i]]                           # (vm1, af)
        loc_ang_i = torch.where(is_cand[i][:, None], cand_ang_rows[i],
                                torch.where(in_view[i][:, None], view_ang_i,
                                            zero))
        loc_ang_rows.append(loc_ang_i)
        if ended is None:
            table = loc_ang_i[:12]
        else:
            table = torch.where(ended[i], table, loc_ang_i[:12])
    loc_ang = torch.stack(loc_ang_rows)
    loc_box = (is_cand | in_view)[..., None].to(f32).expand(b, vm1, 3)
    loc_fts = torch.cat([loc_ang, loc_box], dim=-1)
    nav_types = is_cand.to(torch.int32)
    view_mask = is_cand | in_view

    # ---- grid-memory ingredients ------------------------------------------
    depth = depth.float()
    if gc.depth_normalized:
        # habitat [0,1] depth -> metres with the reference's column-max zero
        # substitution + x100/100 scale (GridMap.preprocess_depth,
        # Policy:225-247); the waypoint towers upstream consume the raw maps
        colmax = depth.amax(dim=2, keepdim=True)
        depth = torch.where(depth == 0, colmax, depth)
        # divided by a tensor: PyTorch divides by a Python scalar on the
        # card as a product with its reciprocal, one ulp off the host's
        # quotient, and an ulp of depth moves points across cell borders
        hundred = torch.full((), 100.0, device=dev)
        depth = (gc.min_depth * 100.0 +
                 depth * (gc.max_depth - gc.min_depth) * 100.0) / hundred
    # depth patch centers (Policy:728-730): 19 + 36*i over 256px maps
    side = int(round(gc.patches_per_view ** 0.5))
    centers = 19 + 36 * ar(side)
    dm = depth[:, :, centers][:, :, :, centers]
    depth_p = dm.reshape(b, gc.num_views, gc.patches_per_view)

    # ---- topological graph slots ------------------------------------------
    t = torch.as_tensor(t, device=dev).long()
    cur = torch.clamp(t + 1, max=g - 1)                # same for all envs
    s = ar(g)[None, :]
    chain = (s >= 1) & (s <= cur)                               # (1, g)
    fr_j = s - cur - 1                                          # frontier idx
    frontier = (fr_j >= 0) & (fr_j < n[:, None])
    gmap_mask = (s == 0) | chain | frontier
    gmap_visited = chain.expand(b, g)
    gmap_step_ids = torch.where(
        frontier, torch.clamp(cur + 1, max=mas - 1),
        torch.where(s == cur, torch.clamp(t + 1, max=mas - 1),
                    torch.where(chain, torch.clamp(s, max=mas - 1),
                                torch.zeros_like(s)))).to(torch.int32)

    tf = device_traj_pos_features(traj_pos, traj_dist, traj_len, heading,
                                  af, gc.max_dist, gc.pos_step_norm)
    # chain slot s holds node s-1; the clamped last slot holds the CURRENT
    # node (host: gmap_pos_fts[cur] = tf[-1])
    tmax = tf.shape[1]
    tf_idx = torch.where(s == cur,
                         torch.clamp(traj_len.long() - 1, min=0)[:, None],
                         torch.clamp(s - 1, 0, tmax - 1))
    chain_fts = _take(tf, tf_idx)
    fr_c = torch.clamp(fr_j, 0, k - 1).expand(b, g)
    fr_ang = _take(cand_ang, fr_c)
    # the trainer passes batch_distances=batch_ANGLES into the navigation
    # forward (ss_trainer_GridMap.py:275), so the candidate pos-feature
    # "distance" entries carry the CCW angle value, a reference bug the
    # released checkpoints trained through (env stepping keeps true dists)
    fr_dist = torch.gather(ang_cc, 1, fr_c)
    fr_fts = torch.cat([
        fr_ang,
        (fr_dist / gc.max_dist)[..., None],
        (fr_dist / gc.max_dist)[..., None],
        torch.full((b, g, 1), 1.0 / gc.pos_step_norm, device=dev),
    ], dim=-1)
    zg = torch.zeros((b, g), device=dev)
    stop_fts = torch.cat([device_angle_features(zg, zg, af),
                          torch.zeros((b, g, 3), device=dev)], dim=-1)
    gmap_pos_fts = torch.where(
        frontier[..., None], fr_fts,
        torch.where(chain[..., None], chain_fts,
                    torch.where((s == 0)[..., None], stop_fts, zero)))

    # candidate j <-> frontier slot cur+1+j index maps
    j = ar(vm1)[None, :]
    slot = cur + 1 + j
    cand_ok = (j < n[:, None]) & (slot < g)
    cand_gmap_idx = torch.where(cand_ok, slot, torch.full_like(slot, -1)
                                ).to(torch.int32)
    fused_add_idx = torch.where(frontier, fr_j + 1, torch.full_like(fr_j, -2)
                                ).to(torch.int32)

    # ---- local (vp) branch --------------------------------------------------
    start = device_start_pos_features(traj_pos, traj_dist, traj_len, heading,
                                      af, gc.max_dist, gc.pos_step_norm)
    jv = ar(v)[None, :]
    vp_is_cand = (jv >= 1) & (jv <= n[:, None])
    vj = torch.clamp(jv - 1, 0, k - 1).expand(b, v)
    vp_cand_ang = _take(cand_ang, vj)
    # same batch_distances=batch_angles substitution as the frontier rows
    vp_cand_dist = torch.gather(ang_cc, 1, vj)
    vp_tail = torch.cat([
        vp_cand_ang,
        (vp_cand_dist / gc.max_dist)[..., None],
        (vp_cand_dist / gc.max_dist)[..., None],
        torch.full((b, v, 1), 1.0 / gc.pos_step_norm, device=dev),
    ], dim=-1)
    vp_pos_fts = torch.cat([
        start[:, None, :].expand(b, v, af + 3),
        torch.where(vp_is_cand[..., None], vp_tail, zero)], dim=-1)
    vp_nav_mask = (jv == 0) | vp_is_cand

    ig = torch.full((b,), ign, dtype=torch.int32, device=dev)
    return StepInputs(
        view_img_fts=view_img_fts, loc_fts=loc_fts,
        nav_types=nav_types, view_mask=view_mask,
        depth=depth_p.float(),
        patch_fts=torch.zeros((b, gc.points_per_step, d), device=dev),
        pos_xy=pos_xy.float(), heading=heading.float(),
        gmap_step_ids=gmap_step_ids, gmap_pos_fts=gmap_pos_fts,
        gmap_mask=gmap_mask, gmap_visited_mask=gmap_visited,
        cur_node_idx=cur.expand(b).to(torch.int32),
        cand_gmap_idx=cand_gmap_idx,
        vp_pos_fts=vp_pos_fts, vp_nav_mask=vp_nav_mask,
        fused_add_idx=fused_add_idx,
        cand_backtrack_mask=torch.zeros((b, v), dtype=torch.bool, device=dev),
        target=ig, grid_target=ig.clone(),
        vp_obj_mask=torch.zeros((b, v), dtype=torch.bool, device=dev),
        obj_target=ig.clone(),
    )


def ce_action_logits(global_logits, local_logits, cand_gmap_idx):
    """The CE action head: fused = global + local over the [stop]+candidates
    columns (gridmap/vilmodel.py:788-800 truncates global_logits to
    max(candidate_lengths) and adds local_logits). Under the reference's CE
    token layout the traj-gmap leads with [stop]+candidates, so column j IS
    candidate j; under the stable-slot layout candidate j's gmap column is
    cand_gmap_idx[:, j] (the ephemeral frontier slot) and [stop] is column
    0.

    A candidate whose waypoint slot overflowed the gmap capacity
    (cand_gmap_idx == -1, impossible in the reference's unpadded layout)
    falls back to its local logit alone."""
    b, v = local_logits.shape
    valid = cand_gmap_idx >= 0
    g_cand = torch.gather(global_logits, 1,
                          torch.clamp(cand_gmap_idx.long(), min=0))
    g_cand = torch.where(valid, g_cand, torch.zeros_like(g_cand))
    add = torch.cat([global_logits[:, :1], g_cand], dim=1)[:, :v]
    # local is already -inf outside [stop]+candidates; x + -inf stays -inf
    return local_logits + add

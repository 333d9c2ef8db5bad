"""Synthetic batch generators for tests, dry runs and smoke runs (twin of
gridmm_tpu/train/synthetic.py): the same numpy draws in the same order, so
one seed gives the same batch in both packages."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gridmm_tpu_torch.config import GridMMConfig
from gridmm_tpu_torch.train.pretrain import (PretrainBatch,
                                             pretrain_batch_to_device)
from gridmm_tpu_torch.train.step import (StepInputs, TrajectoryBatch,
                                         batch_to_device)


def synthetic_pretrain_batch(cfg: GridMMConfig, batch: int, num_steps: int,
                             seed: int = 0, device="cuda") -> PretrainBatch:
    """A self-consistent trajectory batch for the pretraining proxy tasks:
    every task's labels are filled."""
    rng = np.random.default_rng(seed)
    b, s = batch, num_steps
    t = cfg.shapes.max_txt_len
    g = cfg.shapes.max_gmap_len
    v = cfg.shapes.max_vp_len
    vm1 = v - 1
    d = cfg.model.image_feat_size
    a = cfg.model.angle_feat_size
    gc = cfg.grid
    n = cfg.shapes.max_points
    f32, i32 = np.float32, np.int32
    if g <= s + 3:
        raise ValueError("the gmap must hold the visited chain plus frontier")

    txt_len = rng.integers(8, t, size=(b,))
    txt_ids = rng.integers(5, cfg.model.vocab_size, size=(b, t)).astype(i32)
    txt_mask = np.arange(t)[None] < txt_len[:, None]
    # MLM labels: 15% of real tokens
    mlm_sel = (rng.random((b, t)) < 0.15) & txt_mask
    txt_labels = np.where(mlm_sel, txt_ids, -1).astype(i32)
    masked_ids = np.where(mlm_sel, 103, txt_ids).astype(i32)  # [MASK]

    n_tok = rng.integers(10, vm1, size=(b, s))
    token_mask = np.arange(vm1)[None, None] < n_tok[..., None]
    n_cand = rng.integers(2, 6, size=(b, s))
    nav_types = (np.arange(vm1)[None, None] < n_cand[..., None]).astype(i32)

    # visited chain: step t -> slot t+1; frontier slots s+1 .. s+3
    visited_idx = np.where(
        token_mask, (np.arange(s) + 1)[None, :, None], -1).astype(i32)
    frontier = np.stack([rng.integers(s + 1, s + 4, size=(b, s))
                         for _ in range(vm1)], axis=-1)
    cand_idx = np.where(nav_types == 1, frontier, -1).astype(i32)

    gmap_mask = np.zeros((b, g), bool)
    gmap_mask[:, : s + 4] = True
    gmap_visited = np.zeros((b, g), bool)
    gmap_visited[:, 1: s + 1] = True
    gmap_step_ids = np.zeros((b, g), i32)
    gmap_step_ids[:, 1: s + 1] = np.arange(1, s + 1)

    vp_nav_mask = np.zeros((b, v), bool)
    vp_nav_mask[:, 0] = True
    for i in range(b):
        vp_nav_mask[i, 1: 1 + n_cand[i, -1]] = True

    fused_add_idx = np.full((b, g), -2, i32)
    for i in range(b):
        for slot in range(s + 1, s + 4):
            fused_add_idx[i, slot] = (
                -1 if rng.random() < 0.5
                else 1 + rng.integers(0, n_cand[i, -1]))

    global_act = np.where(rng.random(b) < 0.3, 0,
                          rng.integers(s + 1, s + 4, size=b)).astype(i32)
    local_act = np.where(global_act == 0, 0,
                         1 + rng.integers(0, 2, size=b)).astype(i32)

    view_mrc_masks = rng.random((b, vm1)) < 0.15
    for i in range(b):
        view_mrc_masks[i, n_tok[i, -1]:] = False
    probs = rng.random((b, vm1, cfg.model.image_prob_size)).astype(f32)
    probs /= probs.sum(-1, keepdims=True)

    # the remaining draws in the JAX package's argument order
    traj_view_fts = rng.standard_normal((b, s, vm1, d)).astype(f32) * 0.3
    traj_loc_fts = rng.standard_normal((b, s, vm1, a + 3)).astype(f32) * 0.3
    gmap_pos_fts = rng.standard_normal((b, g, a + 3)).astype(f32) * 0.3
    vp_pos_fts = rng.standard_normal((b, v, 2 * a + 6)).astype(f32) * 0.3
    grid_fts = rng.standard_normal((b, n, d)).astype(f32) * 0.3
    grid_cells = np.where(
        np.arange(n)[None] < s * gc.points_per_step,
        rng.integers(0, 196, size=(b, n)), -1).astype(i32)
    gridmap_pos_fts = rng.standard_normal(
        (b, cfg.shapes.num_cells, 5)).astype(f32) * 0.1

    return pretrain_batch_to_device(PretrainBatch(
        txt_ids=masked_ids, txt_mask=txt_mask,
        traj_view_fts=traj_view_fts, traj_loc_fts=traj_loc_fts,
        traj_nav_types=nav_types, traj_token_mask=token_mask,
        traj_step_mask=np.ones((b, s), bool),
        visited_idx=visited_idx, cand_idx=cand_idx,
        gmap_step_ids=gmap_step_ids, gmap_pos_fts=gmap_pos_fts,
        gmap_mask=gmap_mask, gmap_visited_mask=gmap_visited,
        vp_pos_fts=vp_pos_fts, vp_nav_mask=vp_nav_mask,
        fused_add_idx=fused_add_idx,
        cand_backtrack_mask=np.zeros((b, v), bool),
        grid_fts=grid_fts, grid_cells=grid_cells,
        gridmap_pos_fts=gridmap_pos_fts,
        txt_labels=txt_labels, view_mrc_masks=view_mrc_masks,
        view_probs=probs, global_act_labels=global_act,
        local_act_labels=local_act, obj_labels=np.zeros((b,), i32),
        vp_obj_mask=np.zeros((b, v), bool)), device)


def synthetic_trajectory_batch(
    cfg: GridMMConfig, batch: int, num_steps: int, seed: int = 0,
    views: Optional[int] = None, device="cuda",
) -> TrajectoryBatch:
    """A self-consistent teacher-forced batch: every step has a finite-logit
    teacher action, the last step is marked done."""
    rng = np.random.default_rng(seed)
    b, s = batch, num_steps
    t = cfg.shapes.max_txt_len
    g = cfg.shapes.max_gmap_len
    v = views if views is not None else cfg.shapes.max_vp_len
    vm1 = v - 1
    d = cfg.model.image_feat_size
    gc = cfg.grid

    f32 = np.float32
    txt_len = rng.integers(8, t, size=(b,))
    txt_ids = rng.integers(1, cfg.model.vocab_size, size=(b, t)
                           ).astype(np.int32)
    txt_mask = np.arange(t)[None, :] < txt_len[:, None]

    gmap_len = rng.integers(4, g, size=(s, b))
    gmap_mask = np.arange(g)[None, None, :] < gmap_len[..., None]
    visited = np.zeros((s, b, g), bool)
    for ti in range(s):
        for bi in range(b):
            # visit slots 1..t+1 but always leave the last slot unvisited so
            # a valid (finite-logit) teacher action exists
            visited[ti, bi, 1:min(ti + 2, gmap_len[ti, bi] - 1)] = True
    visited[..., 0] = False

    n_cand = rng.integers(2, 8, size=(s, b))
    view_mask = np.zeros((s, b, vm1), bool)
    view_mask[..., :36] = True
    nav_types = np.zeros((s, b, vm1), np.int32)
    for ti in range(s):
        for bi in range(b):
            nav_types[ti, bi, :n_cand[ti, bi]] = 1
    vp_nav_mask = np.concatenate(
        [np.ones((s, b, 1), bool), nav_types == 1], axis=-1)

    cand_gmap_idx = np.full((s, b, vm1), -1, np.int32)
    for ti in range(s):
        for bi in range(b):
            k = n_cand[ti, bi]
            cand_gmap_idx[ti, bi, :k] = rng.choice(
                np.arange(1, max(gmap_len[ti, bi], 2)), size=k, replace=True)

    # teacher action: stop (0) or the last (always-unvisited) gmap slot
    stop = rng.random((s, b)) < 0.3
    target = np.where(stop, 0, gmap_len - 1).astype(np.int32)
    target[s - 1:] = cfg.train.ignoreid  # final step marked done

    steps = StepInputs(
        view_img_fts=(rng.standard_normal((s, b, vm1, d)) * 0.3).astype(f32),
        loc_fts=(rng.standard_normal(
            (s, b, vm1, cfg.model.angle_feat_size + 3)) * 0.3).astype(f32),
        nav_types=nav_types,
        view_mask=view_mask,
        depth=rng.integers(
            0, 18000, size=(s, b, gc.num_views, gc.patches_per_view)
        ).astype(f32),
        patch_fts=(rng.standard_normal(
            (s, b, gc.points_per_step, d)) * 0.3).astype(f32),
        pos_xy=rng.uniform(-5, 5, size=(s, b, 2)).astype(f32),
        heading=rng.uniform(-np.pi, np.pi, size=(s, b)).astype(f32),
        gmap_step_ids=np.minimum(
            rng.integers(0, s + 1, size=(s, b, g)),
            cfg.model.max_action_steps - 1).astype(np.int32),
        gmap_pos_fts=(rng.standard_normal(
            (s, b, g, cfg.model.angle_feat_size + 3)) * 0.3).astype(f32),
        gmap_mask=gmap_mask,
        gmap_visited_mask=visited,
        cur_node_idx=np.minimum(1 + np.arange(s)[:, None], gmap_len - 1
                                ).astype(np.int32) * np.ones((s, b), np.int32),
        cand_gmap_idx=cand_gmap_idx,
        vp_pos_fts=(rng.standard_normal(
            (s, b, v, 2 * cfg.model.angle_feat_size + 6)) * 0.3).astype(f32),
        vp_nav_mask=vp_nav_mask,
        # index maps only ever point at real candidates (finite local logits)
        fused_add_idx=np.where(
            rng.random((s, b, g)) < 0.5, -1,
            1 + rng.integers(0, 1 << 30, size=(s, b, g))
            % n_cand[..., None]).astype(np.int32),
        cand_backtrack_mask=(rng.random((s, b, v)) < 0.2) & vp_nav_mask,
        target=target,
        grid_target=rng.integers(0, 197, size=(s, b)).astype(np.int32),
        vp_obj_mask=np.zeros((s, b, v), bool),
        obj_target=np.full((s, b), cfg.train.ignoreid, np.int32),
    )
    return batch_to_device(
        TrajectoryBatch(txt_ids=txt_ids, txt_mask=txt_mask, steps=steps),
        device)

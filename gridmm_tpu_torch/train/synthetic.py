"""Synthetic batch generators for tests, dry runs and smoke runs (twin of
gridmm_tpu/train/synthetic.py): the same numpy draws in the same order, so
one seed gives the same batch in both packages."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gridmm_tpu_torch.config import GridMMConfig
from gridmm_tpu_torch.train.step import (StepInputs, TrajectoryBatch,
                                         batch_to_device)


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

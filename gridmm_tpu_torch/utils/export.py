"""Serving helpers (twin of part of gridmm_tpu/utils/export.py).

Only `zero_step_inputs` is ported so far; the export bundle is a later
slice.
"""

from __future__ import annotations

import torch


def zero_step_inputs(cfg, batch: int, device="cuda"):
    """Zero-filled StepInputs at the static serving caps (B, ...)."""
    from gridmm_tpu_torch.train.step import StepInputs

    sh, mc, gc = cfg.shapes, cfg.model, cfg.grid
    b, v, g = batch, sh.max_vp_len, sh.max_gmap_len
    d = mc.image_feat_size
    f32, i32, bool_ = torch.float32, torch.int32, torch.bool

    def z(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(shape, value):
        return torch.full(shape, value, dtype=i32, device=device)

    return StepInputs(
        view_img_fts=z(b, v - 1, d),
        loc_fts=z(b, v - 1, mc.angle_feat_size + 3),
        nav_types=z(b, v - 1, dtype=i32),
        view_mask=z(b, v - 1, dtype=bool_),
        depth=z(b, gc.num_views, gc.patches_per_view),
        patch_fts=z(b, gc.points_per_step, d),
        pos_xy=z(b, 2),
        heading=z(b),
        gmap_step_ids=z(b, g, dtype=i32),
        gmap_pos_fts=z(b, g, mc.angle_feat_size + 3),
        gmap_mask=z(b, g, dtype=bool_),
        gmap_visited_mask=z(b, g, dtype=bool_),
        cur_node_idx=z(b, dtype=i32),
        cand_gmap_idx=full((b, v - 1), -1),
        vp_pos_fts=z(b, v, 2 * mc.angle_feat_size + 6),
        vp_nav_mask=z(b, v, dtype=bool_),
        fused_add_idx=full((b, g), -2),
        cand_backtrack_mask=z(b, v, dtype=bool_),
        target=z(b, dtype=i32),
        grid_target=z(b, dtype=i32),
        vp_obj_mask=z(b, v, dtype=bool_),
        obj_target=z(b, dtype=i32),
    )

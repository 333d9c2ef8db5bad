"""Encode -> grid-memory -> pool pipeline (twin of the `pipeline` closure in
bench.py:95-114).

One call takes a batch of panoramas (12 views each) through the path that
fills and reads the grid memory, as the reference does per viewpoint
(preprocess/get_map_feature.py:109-137, map_nav_src/r2r/env.py:267-374,
models/vilmodel.py:788-824):

  uint8 views -> CLIP tower (all tokens) -> patch tokens
  -> text projection, instruction relevance and grid projection of the NEW
     points only (projected once at insertion)
  -> append_panorama into the episode point buffer
  -> egocentric_grid_assignment over the full buffer
  -> relevance scatter-pool into the 196 cells (the grid-pool kernel on the
     card).

The point buffer's feature dtype sets the precision of the projections:
bf16 on the card (the reference stores grid features as fp16), f32 in the
CPU tests.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from gridmm_tpu_torch.config import GridConfig
from gridmm_tpu_torch.models.clip_vit import (ClipVisionTransformer,
                                              normalize_images)
from gridmm_tpu_torch.ops import geometry as G
from gridmm_tpu_torch.ops.grid_pool import grid_pool, instruction_relevance


class PipelineOut(NamedTuple):
    state: G.PointCloudState  # the buffer with this step's points appended
    cells: torch.Tensor       # (B, N) int32 cell of every point, -1 invalid
    pooled: torch.Tensor      # (B, 196, D) f32 pooled cell features
    cell_mask: torch.Tensor   # (B, 196) bool, cell holds a point


def encode_and_pool(
    model: ClipVisionTransformer,
    images_u8: torch.Tensor,         # (B*V, H, W, 3) uint8, V views per pano
    state: G.PointCloudState,        # (B, N, D) buffer, written in place
    depth: torch.Tensor,             # (B, V, P) raw depth patches
    pos_xy: torch.Tensor,            # (B, 2) agent world position
    heading: torch.Tensor,           # (B,) agent heading
    txt: torch.Tensor,               # (B, T, D) instruction embeddings
    text_proj: Tuple[torch.Tensor, torch.Tensor],  # (D, D) x @ W, (D,)
    grid_proj: Tuple[torch.Tensor, torch.Tensor],
    grid_cfg: GridConfig,
) -> PipelineOut:
    """One pipeline step for B panoramas; see the module docstring."""
    b = state.xy.shape[0]
    d = state.features.shape[-1]
    ct = state.features.dtype
    with torch.no_grad():
        tokens = model(normalize_images(images_u8))         # (B*V, T, W)
        patch = tokens[:, 1:, :].reshape(
            b, grid_cfg.points_per_step, d).to(ct)
        wt, bt = text_proj
        wg, bg = grid_proj
        proj_txt = txt.to(ct) @ wt.to(ct) + bt.to(ct)
        w_new = instruction_relevance(patch, proj_txt).float()
        g_new = patch @ wg.to(ct) + bg.to(ct)
        state = G.append_panorama(state, depth, g_new, pos_xy, grid_cfg,
                                  w_new)
        cells, _, _ = G.egocentric_grid_assignment(state, pos_xy, heading,
                                                   grid_cfg)
        pooled, mask = grid_pool(state.features, cells, state.weights)
    return PipelineOut(state, cells, pooled, mask)

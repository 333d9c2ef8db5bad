"""The per-step navigation graph, inference half (twin of the rollout part of
gridmm_tpu/train/step.py).

One call of `nav_device_step` is one action for a batch of episodes:
panorama encode, project + score the 588 new grid points, append them to the
on-device point buffer, egocentric cell assignment over the whole buffer,
graph-node embedding aggregation, navigation forward. Host work is limited to
assembling the `StepInputs` index maps.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gridmm_tpu_torch.config import GridMMConfig
from gridmm_tpu_torch.models.navigator import GridMMNavigator, NavOutputs
from gridmm_tpu_torch.ops import geometry as G


class StepInputs(NamedTuple):
    """Per-step tensors for a batch of B episodes (leading dim B)."""

    # panorama tokens (V-1 view/object tokens; stop slot added here)
    view_img_fts: torch.Tensor   # (B, V-1, D_img)
    loc_fts: torch.Tensor        # (B, V-1, angle+3)
    nav_types: torch.Tensor      # (B, V-1) int
    view_mask: torch.Tensor      # (B, V-1) bool
    # grid memory inputs
    depth: torch.Tensor          # (B, views, patches) raw depth
    patch_fts: torch.Tensor      # (B, views*patches, D_img) CLIP patch fts
    pos_xy: torch.Tensor         # (B, 2) agent world position
    heading: torch.Tensor        # (B,)
    # topological graph (host-assembled index maps)
    gmap_step_ids: torch.Tensor      # (B, G)
    gmap_pos_fts: torch.Tensor       # (B, G, angle+3)
    gmap_mask: torch.Tensor          # (B, G) bool
    gmap_visited_mask: torch.Tensor  # (B, G) bool
    cur_node_idx: torch.Tensor       # (B,) gmap slot of the current node
    cand_gmap_idx: torch.Tensor      # (B, V-1) gmap slot per view, -1 none
    # local branch
    vp_pos_fts: torch.Tensor     # (B, V, 2*angle+6)
    vp_nav_mask: torch.Tensor    # (B, V) bool
    # fusion index maps
    fused_add_idx: torch.Tensor        # (B, G)
    cand_backtrack_mask: torch.Tensor  # (B, V)
    # supervision (unused by the inference step; kept for field parity)
    target: torch.Tensor         # (B,)
    grid_target: torch.Tensor    # (B,)
    # object grounding (REVERIE/SOON; zero-filled otherwise)
    vp_obj_mask: torch.Tensor    # (B, V) bool
    obj_target: torch.Tensor     # (B,)


class NavCarry(NamedTuple):
    """Cross-step device state of an episode batch."""

    point_state: G.PointCloudState
    gmap_sum: torch.Tensor  # (B, G, D) running node-embedding sums
    gmap_cnt: torch.Tensor  # (B, G)


def init_carry(cfg: GridMMConfig, batch: int, gmap_len: Optional[int] = None,
               device="cuda") -> NavCarry:
    g = gmap_len if gmap_len is not None else cfg.shapes.max_gmap_len
    d = cfg.model.hidden_size
    return NavCarry(
        point_state=G.PointCloudState.create(batch, cfg.grid,
                                             cfg.shapes.max_points,
                                             device=device),
        gmap_sum=torch.zeros((batch, g, d), dtype=torch.float32,
                             device=device),
        gmap_cnt=torch.zeros((batch, g), dtype=torch.float32, device=device),
    )


def _update_node_embeds(gmap_sum, gmap_cnt, pano_embeds, pano_mask,
                        cur_node_idx, cand_gmap_idx, gmap_visited_mask,
                        accumulate: bool = True):
    """GraphMap.update_node_embed (agent.py:312-320): the current node is
    rewritten with the masked-average pano embedding; unvisited candidate
    nodes accumulate a running sum of their view embeddings.

    accumulate=False (VLN-CE, ModelConfig.frontier_accumulate): every slot
    past the current node is cleared first, so a frontier slot holds exactly
    this step's candidate embedding. Returns new tensors."""
    b = pano_embeds.shape[0]
    bi = torch.arange(b, device=pano_embeds.device)
    avg = (pano_embeds * pano_mask[..., None]).sum(dim=1) / torch.clamp(
        pano_mask.sum(dim=1, keepdim=True), min=1)

    gmap_sum = gmap_sum.clone()
    gmap_cnt = gmap_cnt.clone()
    cur = cur_node_idx.long()
    if not accumulate:
        g = gmap_sum.shape[1]
        future = (torch.arange(g, device=gmap_sum.device)[None, :]
                  > cur[:, None])
        gmap_sum.masked_fill_(future[..., None], 0.0)
        gmap_cnt.masked_fill_(future, 0.0)

    gmap_sum[bi, cur] = avg
    gmap_cnt[bi, cur] = 1.0

    cand = cand_gmap_idx.long()
    valid = (cand >= 0) & ~torch.gather(gmap_visited_mask, 1,
                                        cand.clamp(min=0))
    tgt = torch.where(valid, cand, torch.zeros_like(cand))
    contrib = pano_embeds.masked_fill(~valid[..., None], 0.0)
    rows = bi[:, None].expand_as(tgt)
    # repeated slots add up, like JAX's .at[].add
    gmap_sum.index_put_((rows, tgt), contrib, accumulate=True)
    gmap_cnt.index_put_((rows, tgt), valid.float(), accumulate=True)
    return gmap_sum, gmap_cnt


def _nav_inputs(cfg, txt_embeds, txt_mask, gmap_img_embeds, x: StepInputs,
                pano_embeds, grid_fts, grid_cells, grid_weights,
                gridmap_pos_fts) -> dict:
    """The per-step "navigation" batch dict (shared definition with the
    JAX package's replay loss)."""
    b = txt_mask.shape[0]
    d = cfg.model.hidden_size
    vp_img_embeds = torch.cat(
        [pano_embeds.new_zeros((b, 1, d)), pano_embeds], dim=1)
    vp_mask = torch.cat([torch.ones((b, 1), dtype=torch.bool,
                                    device=txt_mask.device), x.view_mask],
                        dim=1)
    return {
        "txt_embeds": txt_embeds, "txt_mask": txt_mask,
        "gmap_img_embeds": gmap_img_embeds.to(cfg.model.dtype),
        "gmap_step_ids": x.gmap_step_ids, "gmap_pos_fts": x.gmap_pos_fts,
        "gmap_mask": x.gmap_mask, "gmap_visited_mask": x.gmap_visited_mask,
        "vp_img_embeds": vp_img_embeds, "vp_pos_fts": x.vp_pos_fts,
        "vp_mask": vp_mask, "vp_nav_mask": x.vp_nav_mask,
        "grid_fts": grid_fts, "grid_cells": grid_cells,
        "grid_weights": grid_weights, "gridmap_pos_fts": gridmap_pos_fts,
        "fused_add_idx": x.fused_add_idx,
        "cand_backtrack_mask": x.cand_backtrack_mask,
        "vp_obj_mask": x.vp_obj_mask if cfg.model.obj_feat_size > 0 else None,
        # None = the reference's max over PADDED text
        "txt_relevance_mask":
            txt_mask if cfg.model.mask_txt_relevance else None,
    }


def nav_device_step(model: GridMMNavigator, cfg: GridMMConfig, txt_embeds,
                    txt_mask, carry: NavCarry, x: StepInputs):
    """One navigation step: returns (new carry, NavOutputs).

    Gmap tokens use a stable discovery-order slot space (slot 0 = [stop]);
    attention is permutation-equivariant under masks, so this equals the
    reference's per-step repacking (agent.py:104-147). The point buffer in
    `carry` is written in place (geometry.append_panorama)."""
    pano_embeds, pano_mask = model("panorama", {
        "view_img_fts": x.view_img_fts, "loc_fts": x.loc_fts,
        "nav_types": x.nav_types, "view_mask": x.view_mask})

    # project + score the 588 new points once; the buffer stores them ready
    # to pool
    proj_new, w_new = model("project_grid", {
        "txt_embeds": txt_embeds, "patch_fts": x.patch_fts,
        "txt_relevance_mask":
            txt_mask if cfg.model.mask_txt_relevance else None})
    point_state = G.append_panorama(carry.point_state, x.depth, proj_new,
                                    x.pos_xy, cfg.grid, w_new,
                                    headings=x.heading)
    cells, _, grid_pos_fts = G.egocentric_grid_assignment(
        point_state, x.pos_xy, x.heading, cfg.grid)

    gmap_sum, gmap_cnt = _update_node_embeds(
        carry.gmap_sum, carry.gmap_cnt, pano_embeds.float(), pano_mask,
        x.cur_node_idx, x.cand_gmap_idx, x.gmap_visited_mask,
        accumulate=cfg.model.frontier_accumulate)
    gmap_img_embeds = gmap_sum / torch.clamp(gmap_cnt, min=1.0)[..., None]
    gmap_img_embeds[:, 0] = 0.0  # slot 0 is [stop] (agent.py:127-129)

    out: NavOutputs = model("navigation", _nav_inputs(
        cfg, txt_embeds, txt_mask, gmap_img_embeds, x, pano_embeds,
        point_state.features, cells, point_state.weights, grid_pos_fts))
    return NavCarry(point_state, gmap_sum, gmap_cnt), out

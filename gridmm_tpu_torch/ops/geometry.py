"""Grid-memory geometry core (twin of gridmm_tpu/ops/geometry.py).

The single parameterized implementation of the grid-map math that the
reference copies three times with different constants
(map_nav_src/r2r/env.py:115-121,242-374; pretrain_src/data/dataset.py:351-473;
VLN_CE/vlnce_baselines/models/Policy_ViewSelection_GridMap.py:632-807).
Every function is batched and shape-static; the arithmetic follows the JAX
package operation by operation so that cell ids agree bit for bit.

Conventions (matching the reference):
  * World frame: x, y in metres.
  * A panorama contributes `num_views` horizon views; view k faces
    angle k * 2pi/num_views (env.py:289-290).
  * Each view contributes a 7x7 grid of depth-patch centers; the lateral
    offset of column c is ((2c-6)/7) * tan(half_hfov) (env.py:118).
  * The egocentric window is a square of half-side
    half_len = (2/3) * max extent of all observed points around the agent
    (env.py:322-331), rotated by -heading (env.py:337).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from gridmm_tpu_torch.config import GridConfig

_F32 = torch.float32


def lateral_offsets(patches_per_side: int = 7, device=None) -> torch.Tensor:
    """Per-column lateral ray offsets, tiled row-major over the 7x7 patches
    (env.py:118 builds [-6/7, -4/7, ..., 6/7] * 7)."""
    c = torch.arange(patches_per_side, dtype=_F32, device=device)
    offs = (2.0 * c - (patches_per_side - 1)) / patches_per_side
    return offs.repeat(patches_per_side)  # (49,)


def backproject_view(
    depth_raw: torch.Tensor,   # (..., P) raw depth (uint16 counts or metres)
    view_angle: torch.Tensor,  # (...,) view azimuth in radians
    *,
    depth_scale: float,
    tan_half_hfov: float,
    patches_per_side: int = 7,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Back-project one view's depth patches into viewpoint-relative x/y
    (get_rel_position, env.py:115-121). Returns (rel_x, rel_y), (..., P)."""
    depth_y = depth_raw.to(_F32) / depth_scale
    offs = lateral_offsets(patches_per_side, depth_raw.device)
    depth_x = depth_y * (offs * tan_half_hfov)
    cos_a = torch.cos(view_angle)[..., None]
    sin_a = torch.sin(view_angle)[..., None]
    rel_x = depth_x * cos_a + depth_y * sin_a
    rel_y = depth_y * cos_a - depth_x * sin_a
    return rel_x, rel_y


def backproject_panorama(
    depth_raw: torch.Tensor,   # (..., V, P) raw horizon-view depth patches
    cfg: GridConfig,
    heading: torch.Tensor | float = 0.0,  # (...,) or scalar
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Back-project all `V` horizon views of a panorama.

    Batched over any leading dims (the JAX function takes one panorama and is
    vmapped). Returns (rel_x, rel_y, valid), each (..., V*P); `valid` masks
    zero-depth pixels (env.py:283-285). In the continuous variant view
    azimuths are heading-relative and rel_y is negated (Policy:779-782).
    """
    v = torch.arange(cfg.num_views, dtype=_F32, device=depth_raw.device)
    angles = v * (2.0 * math.pi / cfg.num_views)
    if cfg.view_angles_relative:
        heading = torch.as_tensor(heading, dtype=_F32, device=depth_raw.device)
        angles = angles - heading[..., None]
    rel_x, rel_y = backproject_view(
        depth_raw, angles,
        depth_scale=cfg.depth_scale, tan_half_hfov=cfg.tan_half_hfov)
    valid = depth_raw > 0
    lead = depth_raw.shape[:-2]
    return (rel_x.reshape(*lead, -1), cfg.y_sign * rel_y.reshape(*lead, -1),
            valid.reshape(*lead, -1))


def compute_half_len(min_x, max_x, min_y, max_y, pos_x, pos_y,
                     window_scale: float = 2.0 / 3.0) -> torch.Tensor:
    """Egocentric window half-side (env.py:322-331)."""
    x_half = torch.maximum(pos_x - min_x, max_x - pos_x)
    y_half = torch.maximum(pos_y - min_y, max_y - pos_y)
    return torch.maximum(x_half, y_half) * window_scale


def rotate_into_agent_frame(px, py, pos_x, pos_y, heading, *,
                            heading_sign: float = -1.0,
                            heading_offset: float = 0.0):
    """Translate world points to the agent and rotate by the heading
    convention (env.py:337-348; continuous variant Policy:785,797)."""
    angle = heading_sign * heading + heading_offset
    tx = px - pos_x
    ty = py - pos_y
    cos_a, sin_a = torch.cos(angle), torch.sin(angle)
    map_x = tx * cos_a + ty * sin_a
    map_y = ty * cos_a - tx * sin_a
    return map_x, map_y


def quantize_to_cells(map_x, map_y, half_len, grid_width: int = 14,
                      grid_height: int = 14) -> torch.Tensor:
    """Quantize agent-frame points to int32 cell ids in [0, W*H)
    (env.py:349-361; floor+clip equals the reference's truncate+clip)."""
    denom = torch.clamp(2.0 * half_len, min=1e-8)
    gx = torch.floor((map_x + half_len) / denom * (grid_width - 1)).to(
        torch.int32)
    gy = torch.floor((map_y + half_len) / denom * (grid_height - 1)).to(
        torch.int32)
    gx = gx.clamp(0, grid_width - 1)
    gy = gy.clamp(0, grid_height - 1)
    return gx * grid_height + gy


def rel_heading_elevation(dx, dy, dz):
    """Relative heading/elevation/distance (models/graph_utils.py:15-32):
    heading = arcsin(dx / |dxy|), reflected to pi - heading when dy < 0."""
    xy_dist = torch.clamp(torch.sqrt(dx * dx + dy * dy), min=1e-8)
    xyz_dist = torch.clamp(torch.sqrt(dx * dx + dy * dy + dz * dz), min=1e-8)
    heading = torch.arcsin(torch.clamp(dx / xy_dist, -1.0, 1.0))
    heading = torch.where(dy < 0, math.pi - heading, heading)
    elevation = torch.arcsin(torch.clamp(dz / xyz_dist, -1.0, 1.0))
    return heading, elevation, xyz_dist


def angle_fts(headings, elevations, angle_feat_size: int = 4) -> torch.Tensor:
    """[sin h, cos h, sin e, cos e] tiled to angle_feat_size
    (graph_utils.py:34-40)."""
    base = torch.stack([torch.sin(headings), torch.cos(headings),
                        torch.sin(elevations), torch.cos(elevations)], dim=-1)
    reps = angle_feat_size // 4
    if reps > 1:
        base = torch.cat([base] * reps, dim=-1)
    return base


def gridmap_pos_fts(half_len, grid_width: int = 14, grid_height: int = 14,
                    max_dist: float = 30.0,
                    convention: str = "discrete") -> torch.Tensor:
    """Per-cell positional features (..., W*H, 5): angle fts + dist/max_dist
    (get_gridmap_pos_fts, env.py:242-265; flat index i*H + j, cell centers
    (i*cell - half + cell/2, j*cell - half + cell/2, 0)).

    convention "discrete" unpacks (x, y, z) as map_nav does; "ce" reproduces
    VLN_CE's (x, z, y) unpacking (models/utils.py:125-144), where the heading
    degenerates to +/-pi/2 and cy lands in the elevation.
    """
    half = torch.as_tensor(half_len, dtype=_F32)[..., None]
    cell = half * 2.0 / grid_width
    flat = torch.arange(grid_width * grid_height, dtype=_F32,
                        device=half.device)
    # the JAX package floor-divides a float arange; floor division of these
    # small exact integers gives the same values
    i = torch.div(flat, grid_height, rounding_mode="floor")
    j = torch.remainder(flat, grid_height)
    cx = i * cell - half + cell / 2.0
    cy = j * cell - half + cell / 2.0
    if convention == "ce":
        xy = torch.clamp(torch.abs(cx), min=1e-8)
        dist = torch.clamp(torch.sqrt(cx * cx + cy * cy), min=1e-8)
        heading = torch.arcsin(torch.clamp(cx / xy, -1.0, 1.0))
        elevation = torch.arcsin(torch.clamp(cy / dist, -1.0, 1.0))
    else:
        heading, elevation, dist = rel_heading_elevation(
            cx, cy, torch.zeros_like(cx))
    ang = angle_fts(heading, elevation)
    return torch.cat([ang, (dist / max_dist)[..., None]], dim=-1)


def target_cell_id(target_x, target_y, pos_x, pos_y, heading, half_len,
                   grid_width: int = 14, grid_height: int = 14,
                   heading_sign: float = -1.0) -> torch.Tensor:
    """Supervision target: grid cell of the next GT viewpoint, 1-indexed
    (0 = stop). get_global_target (env.py:196-240) quantizes with
    *14 // (2*half_len), unlike the map build's *(W-1) — kept faithfully."""
    angle = heading_sign * heading
    dx = target_x - pos_x
    dy = target_y - pos_y
    rx = dx * torch.cos(angle) + dy * torch.sin(angle)
    ry = dy * torch.cos(angle) - dx * torch.sin(angle)
    denom = torch.clamp(2.0 * half_len, min=1e-8)
    tx = torch.floor((rx + half_len) * grid_width / denom).to(torch.int32)
    ty = torch.floor((ry + half_len) * grid_height / denom).to(torch.int32)
    tx = tx.clamp(0, grid_width - 1)
    ty = ty.clamp(0, grid_height - 1)
    return 1 + tx * grid_height + ty


class PointCloudState(NamedTuple):
    """Fixed-capacity per-episode point buffer (the reference grows numpy
    lists, env.py:142-151,298-310).

    `features` holds already-projected (grid_proj) features and `weights`
    each point's cached instruction-relevance logit: both are constant over
    an episode, so they are computed once at insertion (project_grid_points).
    All tensors are batched over episodes (leading dim B).
    """

    xy: torch.Tensor        # (B, N, 2) world-frame point positions, f32
    features: torch.Tensor  # (B, N, D) point features
    weights: torch.Tensor   # (B, N) cached relevance logits
    valid: torch.Tensor     # (B, N) bool — inserted AND nonzero depth
    inserted: torch.Tensor  # (B, N) bool — slot holds a real point
    count: torch.Tensor     # (B,) int32 — number of inserted points

    @classmethod
    def create(cls, batch: int, cfg: GridConfig,
               max_points: Optional[int] = None, feature_dtype=None,
               device="cuda") -> "PointCloudState":
        n = max_points if max_points is not None else cfg.max_points
        if feature_dtype is None:
            feature_dtype = getattr(torch, cfg.feature_dtype)
        z = dict(device=device)
        return cls(
            xy=torch.zeros((batch, n, 2), dtype=_F32, **z),
            features=torch.zeros((batch, n, cfg.feature_dim),
                                 dtype=feature_dtype, **z),
            weights=torch.zeros((batch, n), dtype=_F32, **z),
            valid=torch.zeros((batch, n), dtype=torch.bool, **z),
            inserted=torch.zeros((batch, n), dtype=torch.bool, **z),
            count=torch.zeros((batch,), dtype=torch.int32, **z),
        )


def append_panorama(
    state: PointCloudState,
    depth_raw: torch.Tensor,       # (B, V, P) raw depth patches for this step
    patch_features: torch.Tensor,  # (B, V*P, D) point features
    pos_xy: torch.Tensor,          # (B, 2) agent world position
    cfg: GridConfig,
    point_weights: Optional[torch.Tensor] = None,  # (B, V*P) relevance logits
    headings: Optional[torch.Tensor] = None,       # (B,) for heading-relative
                                                   # view angles
) -> PointCloudState:
    """Append one panorama's back-projected points to every episode's buffer.

    Writes INTO the state's buffers (the JAX package donates them; in place
    saves a whole-buffer copy per step) and returns the state with `count`
    advanced. Like `jax.lax.dynamic_update_slice`, the write start is clamped
    to N - V*P once `count` passes capacity, while `count` itself keeps
    growing (geometry.py:318-326).
    """
    b, n, _ = state.xy.shape
    ppstep = cfg.points_per_step
    dev = state.xy.device
    if point_weights is None:
        point_weights = torch.zeros(patch_features.shape[:2], dtype=_F32,
                                    device=dev)
    if headings is None:
        headings = torch.zeros((b,), dtype=_F32, device=dev)
    rel_x, rel_y, dvalid = backproject_panorama(depth_raw, cfg, headings)
    pts = torch.stack([rel_x + pos_xy[:, 0:1], rel_y + pos_xy[:, 1:2]],
                      dim=-1)                                  # (B, VP, 2)
    start = state.count.clamp(0, n - ppstep).to(torch.long)
    rows = torch.arange(b, device=dev)[:, None]
    cols = start[:, None] + torch.arange(ppstep, device=dev)[None, :]
    state.xy[rows, cols] = pts
    state.features[rows, cols] = patch_features.to(state.features.dtype)
    state.weights[rows, cols] = point_weights.to(state.weights.dtype)
    state.valid[rows, cols] = dvalid
    # tensors on the buffer's device, not Python scalars: a scalar would be
    # copied from the host, which a CUDA graph cannot capture
    state.inserted[rows, cols] = torch.ones_like(dvalid)
    return state._replace(count=state.count + ppstep)


def egocentric_grid_assignment(
    state: PointCloudState,
    pos_xy: torch.Tensor,    # (B, 2) current agent position
    heading: torch.Tensor,   # (B,) current agent heading
    cfg: GridConfig,
    num_active: Optional[torch.Tensor] = None,  # (B,) or scalar prefix length
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Recompute every point's egocentric cell id for the current pose.

    Returns (cell_ids (B,N) int32 with -1 for invalid/uninserted slots,
    half_len (B,), pos_fts (B, W*H, 5)). The window extent is taken over ALL
    inserted points (zero-depth points back-project onto the agent and
    participate), only nonzero-depth points receive a cell (env.py:322-374).
    """
    px, py = state.xy[..., 0], state.xy[..., 1]
    # a Python scalar, not a tensor made on the host: the step stays free
    # of host-to-device copies, so that a CUDA graph can capture it
    big = 1e4  # env.py:146-149
    ins = state.inserted
    valid = state.valid
    if num_active is not None:
        lim = (torch.arange(px.shape[1], device=px.device)[None, :]
               < torch.as_tensor(num_active, device=px.device).reshape(-1, 1))
        ins = ins & lim
        valid = valid & lim
    min_x = torch.where(ins, px, big).amin(dim=1)
    max_x = torch.where(ins, px, -big).amax(dim=1)
    min_y = torch.where(ins, py, big).amin(dim=1)
    max_y = torch.where(ins, py, -big).amax(dim=1)

    half_len = compute_half_len(min_x, max_x, min_y, max_y,
                                pos_xy[:, 0], pos_xy[:, 1], cfg.window_scale)
    map_x, map_y = rotate_into_agent_frame(
        px, py, pos_xy[:, 0:1], pos_xy[:, 1:2], heading[:, None],
        heading_sign=cfg.heading_sign, heading_offset=cfg.heading_offset)
    cells = quantize_to_cells(cfg.map_x_sign * map_x, map_y,
                              half_len[:, None], cfg.grid_width,
                              cfg.grid_height)
    cells = torch.where(valid, cells, torch.full_like(cells, -1))
    pos_fts = gridmap_pos_fts(half_len, cfg.grid_width, cfg.grid_height,
                              cfg.max_dist, convention=cfg.pos_fts_convention)
    return cells, half_len, pos_fts


def stacked_point_state(
    depth_raw: torch.Tensor,   # (S, B, V, P) per-step raw depth patches
    features: torch.Tensor,    # (B, S*V*P, D) step-major point features
    weights: torch.Tensor,     # (B, S*V*P) relevance logits
    pos_xy: torch.Tensor,      # (S, B, 2) agent position per step
    headings: torch.Tensor,    # (S, B)
    cfg: GridConfig,
) -> PointCloudState:
    """Build the full-trajectory point buffer in one shot (stacked replay).

    Step s's points occupy rows [s*V*P, (s+1)*V*P), the layout the
    `append_panorama` chain produces from a fresh buffer, so a prefix of this
    buffer (egocentric_grid_assignment's num_active) is bit-identical to the
    step-s incremental state. Nothing is written in place: `features` and
    `weights` stay in the autograd graph, and the backward pass keeps one
    buffer instead of one per step (train/step.py).
    """
    s, b = depth_raw.shape[:2]
    rel_x, rel_y, valid = backproject_panorama(depth_raw, cfg, headings)
    xy = torch.stack([rel_x + pos_xy[..., 0:1], rel_y + pos_xy[..., 1:2]],
                     dim=-1)                                # (S, B, VP, 2)
    n = s * xy.shape[2]
    xy = xy.permute(1, 0, 2, 3).reshape(b, n, 2)
    valid = valid.permute(1, 0, 2).reshape(b, n)
    dev = xy.device
    return PointCloudState(
        # the buffer dtype of PointCloudState.create/append_panorama, so
        # training pools the same quantized features serving does
        xy=xy, features=features.to(getattr(torch, cfg.feature_dtype)),
        weights=weights.to(_F32), valid=valid,
        inserted=torch.ones((b, n), dtype=torch.bool, device=dev),
        count=torch.full((b,), n, dtype=torch.int32, device=dev),
    )

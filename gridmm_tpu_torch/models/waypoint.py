"""Waypoint predictor for continuous environments, VLN-CE (twin of
gridmm_tpu/models/waypoint.py).

Re-implements BinaryDistPredictor_TRM / DepthDistPredictor_TRM
(VLN_CE/waypoint_prediction/TRM_net.py:9-164): per-view RGB/depth feature
projection, a 2-layer transformer with a circular neighbor attention mask
(waypoint_prediction/utils.py:90-102), and a (120 angles x 12 distance bins)
heatmap rolled by the heading offset. The two BertLayers are the
navigator's (models/layers.py); their attention over 12 views is plain, as
the JAX package computes it with einsums. `waypoint_nms` is the iterative
NMS candidate selection (utils.py:37-64), reference-exact.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from gridmm_tpu_torch.config import ModelConfig
from gridmm_tpu_torch.models.layers import BertLayer, Dense


@dataclasses.dataclass(frozen=True)
class WaypointConfig:
    hidden_dim: int = 768
    num_angles: int = 120
    num_imgs: int = 12
    n_classes: int = 12          # distance bins
    num_layers: int = 2
    num_heads: int = 12
    intermediate_size: int = 3072  # BertConfig() default (TRM_net.py:38-44)
    neighbor: int = 1            # attention neighborhood radius
    heatmap_offset: int = 5      # each view points at the agent heading
    rgb_feat_dim: int = 2048 * 7 * 7     # flattened ResNet feature
    depth_feat_dim: int = 128 * 4 * 4    # flattened ddppo depth feature
    use_rgb: bool = True         # False = DepthDistPredictor (RxR)


def neighbor_attention_mask(num_imgs: int, neighbor: int,
                            device=None) -> torch.Tensor:
    """Circulant bool mask: view i attends to i-neighbor..i+neighbor
    (utils.py:90-102)."""
    idx = torch.arange(num_imgs, device=device)
    diff = (idx[None, :] - idx[:, None]).abs()
    diff = torch.minimum(diff, num_imgs - diff)  # circular distance
    return diff <= neighbor


class WaypointPredictor(nn.Module):
    """(B*12, rgb_feat_dim) or None, (B*12, depth_feat_dim) ->
    (B, num_angles, n_classes) logits.

    The depth-only variant (use_rgb=False) has no `visual_fc_rgb` or
    `visual_merge`: the released depth-only checkpoint carries merge
    weights its forward never applies (TRM_net.py:146-156 vis_x = depth_x),
    and the importer reports them unused, as the JAX package does."""

    def __init__(self, cfg: WaypointConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_dim
        self.visual_fc_depth = Dense(cfg.depth_feat_dim, h)
        if cfg.use_rgb:
            self.visual_fc_rgb = Dense(cfg.rgb_feat_dim, h)
            self.visual_merge = Dense(2 * h, h)
        bert_cfg = ModelConfig(
            hidden_size=h, num_attention_heads=cfg.num_heads,
            intermediate_size=cfg.intermediate_size, hidden_dropout_prob=0.3,
            attention_probs_dropout_prob=0.1)
        self.layer = nn.ModuleList(BertLayer(bert_cfg)
                                   for _ in range(cfg.num_layers))
        # WaypointBert drops out the sequence output before classification
        # (waypoint_bert.py WaypointBert.forward, p=hidden_dropout_prob)
        self.dropout = nn.Dropout(0.3)
        per_img = cfg.num_angles // cfg.num_imgs
        self.cls_hidden = Dense(h, h)
        self.cls_out = Dense(h, cfg.n_classes * per_img)

    def forward(self, rgb_feats, depth_feats):
        c = self.cfg
        bsi = depth_feats.shape[0] // c.num_imgs
        depth_x = F.relu(self.visual_fc_depth(
            depth_feats.reshape(bsi * c.num_imgs, -1)))
        if c.use_rgb:
            rgb_x = F.relu(self.visual_fc_rgb(
                rgb_feats.reshape(bsi * c.num_imgs, -1)))
            vis = F.relu(self.visual_merge(torch.cat([rgb_x, depth_x], -1)))
        else:
            vis = depth_x
        vis = vis.reshape(bsi, c.num_imgs, c.hidden_dim)
        mask = neighbor_attention_mask(c.num_imgs, c.neighbor, vis.device)
        bias = ((~mask).float() * -10000.0)[None, None]  # (1, 1, V, V)
        for layer in self.layer:
            vis = layer(vis, bias)
        vis = self.dropout(vis)
        logits = self.cls_out(F.relu(self.cls_hidden(vis)))
        logits = logits.reshape(bsi, c.num_angles, c.n_classes)
        # roll so angle 0 aligns with the agent heading (TRM_net.py:77-80)
        return torch.roll(logits, shifts=-c.heatmap_offset, dims=1)


def waypoint_nms(heatmap: torch.Tensor, max_predictions: int = 10,
                 sigma: tuple = (7.0, 5.0)) -> torch.Tensor:
    """Iterative non-maximum suppression over an (angles, dists) heatmap,
    batched, reference-exact including the call-site wrap rows: the Policy
    concatenates the last angle row before and the first after, runs nms on
    the (A+2, D) map, and strips the pads (Policy_ViewSelection_GridMap.py
    :373-384; utils.py:37-64).

    The reference's quirks are reproduced deliberately, as in the JAX
    package (gridmm_tpu/models/waypoint.py:103-121):

    * sigma follows the reference's (distance_radius, angle_radius) order:
      sigma[0] applies to the LAST axis (distance bins), sigma[1] to angles;
    * the angle-axis window is centered at the FRACTIONAL y_mu = flat_ix / D
      (true division in f32), so for a peak at distance bin > 0 it covers
      rows [ang-(sigma_ang-1), ang+sigma_ang];
    * the distance-axis wrap is ONE-SIDED: min(|dx|, |dx + D|);
    * a global max that lands on a duplicated pad row is recorded there and
      stripped: it burns an iteration. Ties resolve to the first flat index
      (torch.argmax, like the reference's torch.max and jnp.argmax).

    heatmap: (B, A, D) non-negative scores. Returns (B, A, D) sparse map of
    kept peaks."""
    b, a, d = heatmap.shape
    sigma_dist, sigma_ang = sigma
    pad = torch.cat([heatmap[:, -1:], heatmap, heatmap[:, :1]], dim=1)
    h = a + 2
    dev = heatmap.device
    flat_pad = pad.reshape(b, h * d)
    yi = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xi = torch.arange(d, dtype=torch.float32, device=dev)[None, None, :]
    rows = torch.arange(b, device=dev)
    supp = pad
    out = torch.zeros_like(flat_pad)
    for _ in range(max_predictions):
        ix = torch.argmax(supp.reshape(b, h * d), dim=1)
        out[rows, ix] = flat_pad[rows, ix]
        y_mu = (ix.to(torch.float32) / d)[:, None, None]
        x_mu = (ix % d).to(torch.float32)[:, None, None]
        x_diff = xi - x_mu
        xd = torch.minimum(x_diff.abs(), (x_diff + d).abs())
        g = (xd <= sigma_dist) & ((yi - y_mu).abs() <= sigma_ang)
        supp = supp * (1.0 - g.to(supp.dtype))
    return torch.clamp(out.reshape(b, h, d)[:, 1:-1], min=0.0)

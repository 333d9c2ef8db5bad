"""Trajectory-level pretraining model and the proxy-task heads (twin of
gridmm_tpu/models/pretrain.py): MLM, MRC, SAP and OG.

GlocalTextPathCMT (pretrain_src/model/vilmodel.py:640-854) and
GlocalTextPathCMTPreTraining (pretrain_src/model/pretrain_cmt.py:38-321) on
the navigator trunk:

  * trajectories are a fixed (B, S, V-1) token grid with step and token
    masks, not the reference's ragged per-batch lists;
  * the per-item gmap aggregation loops (vilmodel.py:578-612) are two
    scatter-means over host-built index maps: `visited_idx` routes a visit
    step's tokens to its node slot, `cand_idx` candidate tokens to frontier
    slots;
  * grid pooling and the map/fusion trunk are the navigator's
    (`encode_grid`, `encode_map`, `fusion_trunk`): on the card the pool runs
    the grid-pool kernels, forward and backward; MLM runs the local
    encoder's language branch (`lang2visn`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from gridmm_tpu_torch.config import ModelConfig
from gridmm_tpu_torch.models.layers import (ACT2FN, ClsPrediction, Dense,
                                            LayerNorm)
from gridmm_tpu_torch.models.navigator import GridMMNavigator
from gridmm_tpu_torch.ops.masking import compaction_stray_count, mask_logits

_F32 = torch.float32


class TrajectoryEncodings(NamedTuple):
    txt_embeds: torch.Tensor     # (B, T, D)
    gmap_out: torch.Tensor       # (B, G, D) fused gmap tokens
    vp_out: torch.Tensor         # (B, V, D) fused last-step viewpoint tokens
    grid_gmap_out: torch.Tensor  # (B, G, D) map-encoder gmap tokens (grid head)
    vp_mask: torch.Tensor        # (B, V)


class MLMHead(nn.Module):
    """BertLMPredictionHead (vilmodel.py:274-306). The decoder is tied to
    the word embeddings (pretrain_cmt.py:68-71): the caller passes the
    embedding module and the head owns only the transform and the output
    bias. A table sharded over the vocabulary gives logits over the rank's
    rows, gathered to the full vocabulary before the bias."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        hs = cfg.hidden_size
        self.act = ACT2FN[cfg.hidden_act]
        self.transform_dense = Dense(hs, hs, cfg.dtype)
        self.transform_LayerNorm = LayerNorm(hs, cfg.layer_norm_eps)
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size))

    def forward(self, hidden, word_embeddings):
        h = self.transform_LayerNorm(self.act(self.transform_dense(hidden)))
        table = word_embeddings.weight.to(h.dtype)
        if word_embeddings.tp is not None:
            return word_embeddings.tp.tied_logits(h, table) + self.bias
        return F.linear(h, table) + self.bias


class GridMMPretrain(nn.Module):
    """`bert` trunk + task heads (pretrain_cmt.py:38-66). `bert` is the
    navigator with the local encoder's language branch built. The reference
    wrapper's obj_classifier has no parameters here: no task calls it, and
    the JAX package's tree (built by running every task) has none."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.bert = GridMMNavigator(cfg, local_lang_branch=True)
        self.mlm_head = MLMHead(cfg)
        self.image_classifier = ClsPrediction(cfg,
                                              output_size=cfg.image_prob_size)

    def _stray(self, cell_mask) -> Optional[torch.Tensor]:
        """Compaction-alias stray keys (ops/masking.compaction_stray_count);
        the pretraining model has the navigator's aliased compaction loop."""
        if not self.cfg.compaction_stray_keys:
            return None
        return compaction_stray_count(cell_mask, self.bert.batch_max)

    # ------------------------------------------------------------ aggregation
    @staticmethod
    def _aggregate_gmap(pano_embeds, pano_mask, visited_idx, cand_idx, g):
        """Scatter-mean trajectory tokens into gmap node slots.

        pano_embeds: (B, S, V, D); *_idx: (B, S, V) int slot or -1 (a slot
        past G is dropped, as JAX's scatter drops it). Visited nodes take
        their visit step's masked token mean, frontier nodes the mean of
        their candidate-token occurrences (pretrain vilmodel.py:578-612)."""
        b, s, v, d = pano_embeds.shape
        flat = pano_embeds.reshape(b * s * v, d).float()
        mask = pano_mask.reshape(b, s * v)
        base = (torch.arange(b, device=flat.device) * g)[:, None]

        def scatter(idx):
            idxf = idx.reshape(b, s * v).long()
            valid = (idxf >= 0) & (idxf < g) & mask
            rows = (base + torch.where(valid, idxf, 0)).reshape(-1)
            vf = valid.reshape(-1)
            ssum = flat.new_zeros((b * g, d)).index_put(
                (rows,), torch.where(vf[:, None], flat, 0.0),
                accumulate=True)
            cnt = flat.new_zeros((b * g,)).index_put(
                (rows,), vf.to(_F32), accumulate=True)
            return ssum.view(b, g, d), cnt.view(b, g)

        vsum, vcnt = scatter(visited_idx)
        csum, ccnt = scatter(cand_idx)
        # visited slots take the visit-step mean; the others the candidates'
        use_visited = vcnt > 0
        ssum = torch.where(use_visited[..., None], vsum, csum)
        cnt = torch.where(use_visited, vcnt, ccnt)
        gmap_img = ssum / torch.clamp(cnt, min=1.0)[..., None]
        # slot 0 is [stop]
        return torch.cat([torch.zeros_like(gmap_img[:, :1]), gmap_img[:, 1:]],
                         dim=1)

    # --------------------------------------------------------------- encoding
    def _encode_trunk(self, txt_ids, txt_mask, traj_view_fts, traj_loc_fts,
                      traj_nav_types, traj_token_mask, traj_step_mask,
                      visited_idx, cand_idx, gmap_step_ids, gmap_pos_fts,
                      gmap_mask, vp_pos_fts, grid_fts, grid_cells,
                      gridmap_pos_fts):
        """Shared prefix of encode() and forward_mlm_logits(): text encode,
        every step's panorama encode, gmap aggregation, last-step vp tokens,
        grid encode. Returns (txt_embeds, gmap_embeds, vp_embeds, vp_mask,
        grid_embeds, cell_mask)."""
        b, s, vm1, _ = traj_view_fts.shape
        c = self.cfg
        bert = self.bert
        g = gmap_mask.shape[1]

        txt_embeds = bert.forward_text(txt_ids, txt_mask)

        def flat(x):  # (B, S, ...) -> (B*S, ...)
            return x.reshape((b * s,) + x.shape[2:])

        pano, _ = bert.forward_panorama(
            flat(traj_view_fts), flat(traj_loc_fts), flat(traj_nav_types),
            flat(traj_token_mask))
        pano = pano.reshape(b, s, vm1, c.hidden_size)
        token_mask = traj_token_mask & traj_step_mask[..., None]

        gmap_img = self._aggregate_gmap(pano, token_mask, visited_idx,
                                        cand_idx, g)
        gmap_embeds = (
            gmap_img.to(c.dtype)
            + bert.gmap_step_embeddings(gmap_step_ids.long()).to(c.dtype)
            + bert.gmap_pos_ln(bert.gmap_pos_dense(gmap_pos_fts)))

        # vp tokens: [stop] + the last VALID step's panorama tokens
        # (pretrain vilmodel.py:543-565)
        last_idx = torch.clamp(
            traj_step_mask.sum(dim=1).to(torch.long) - 1, min=0)
        bi = torch.arange(b, device=last_idx.device)
        last_pano = pano[bi, last_idx]                 # (B, V-1, D)
        last_tok_mask = traj_token_mask[bi, last_idx]  # (B, V-1)
        vp_img = torch.cat([last_pano.new_zeros((b, 1, c.hidden_size)),
                            last_pano], dim=1)
        vp_mask = torch.cat([torch.ones_like(last_tok_mask[:, :1]),
                             last_tok_mask], dim=1)
        vp_embeds = vp_img + bert.vp_pos_ln(bert.vp_pos_dense(vp_pos_fts))

        grid_embeds, cell_mask = bert.encode_grid(
            txt_embeds, grid_fts, grid_cells, gridmap_pos_fts,
            # None = the reference pretrain model's max over PADDED text
            # (pretrain_src/model/vilmodel.py:688-692 applies no mask)
            txt_mask if c.mask_txt_relevance else None)
        return (txt_embeds, gmap_embeds, vp_embeds, vp_mask, grid_embeds,
                cell_mask)

    def encode(self, txt_ids, txt_mask,
               traj_view_fts,    # (B, S, V-1, D_img) per-step tokens
               traj_loc_fts,     # (B, S, V-1, angle+3)
               traj_nav_types,   # (B, S, V-1)
               traj_token_mask,  # (B, S, V-1)
               traj_step_mask,   # (B, S)
               visited_idx,      # (B, S, V-1)
               cand_idx,         # (B, S, V-1)
               gmap_step_ids, gmap_pos_fts, gmap_mask, vp_pos_fts,
               grid_fts, grid_cells, gridmap_pos_fts
               ) -> TrajectoryEncodings:
        (txt_embeds, gmap_embeds, vp_embeds, vp_mask, grid_embeds,
         cell_mask) = self._encode_trunk(
            txt_ids, txt_mask, traj_view_fts, traj_loc_fts, traj_nav_types,
            traj_token_mask, traj_step_mask, visited_idx, cand_idx,
            gmap_step_ids, gmap_pos_fts, gmap_mask, vp_pos_fts, grid_fts,
            grid_cells, gridmap_pos_fts)
        map_embeds, gmap_out, vp_out = self.bert.fusion_trunk(
            txt_embeds, txt_mask, grid_embeds, cell_mask, gmap_embeds,
            gmap_mask, vp_embeds, vp_mask,
            stray_count=self._stray(cell_mask))
        return TrajectoryEncodings(
            txt_embeds=txt_embeds, gmap_out=gmap_out, vp_out=vp_out,
            grid_gmap_out=map_embeds[:, -gmap_mask.shape[1]:],
            vp_mask=vp_mask)

    # ------------------------------------------------------------------ tasks
    def forward_mlm_logits(self, txt_ids, txt_mask, enc_kwargs):
        """Language tokens re-attend to the [gmap||vp] context, then the
        tied-embedding MLM head scores every position (pretrain
        vilmodel.py:765-854, pretrain_cmt.py:125-153)."""
        gmap_mask = enc_kwargs["gmap_mask"]
        (txt_embeds, gmap_embeds, vp_embeds, vp_mask, grid_embeds,
         cell_mask) = self._encode_trunk(txt_ids, txt_mask, **enc_kwargs)
        # the map encoder only (no fusion of vp queries)
        map_embeds, _, _ = self.bert.encode_map(
            txt_embeds, txt_mask, grid_embeds, cell_mask, gmap_embeds,
            gmap_mask, self._stray(cell_mask))
        # the lang2visn context is [gmap||vp] WITHOUT the stray token: the
        # reference concatenates map_embeds[:, max_cell_num:] (the gmap
        # region) and vp (pretrain vilmodel.py:846-853); strays live in the
        # map region below max_cell_num
        gmap_ctx = map_embeds[:, -gmap_mask.shape[1]:]
        visn = torch.cat([gmap_ctx, vp_embeds], dim=1)
        visn_mask = torch.cat([gmap_mask, vp_mask], dim=1)
        txt_embeds = self.bert.local_encoder.lang2visn(txt_embeds, txt_mask,
                                                       visn, visn_mask)
        return self.mlm_head(txt_embeds, self.bert.embeddings.word_embeddings)

    def forward_mrc_logits(self, enc: TrajectoryEncodings):
        """Soft-label region classification over the last step's view tokens
        (pretrain_cmt.py:161-212): (B, V-1, image_prob_size) logits."""
        return self.image_classifier(enc.vp_out[:, 1:])

    def forward_sap_logits(self, enc: TrajectoryEncodings, gmap_mask,
                           gmap_visited_mask, vp_nav_mask, fused_add_idx,
                           cand_backtrack_mask):
        """Four-head SAP logits (pretrain_cmt.py:217-289) through the
        navigator's heads. Returns (global, local, fused, grid)."""
        b = self.bert
        if b.sap_fuse_linear is None:
            fuse = 0.5
        else:
            fuse = torch.sigmoid(b.sap_fuse_linear(torch.cat(
                [enc.gmap_out[:, 0], enc.vp_out[:, 0]], dim=-1)))
        valid_unvisited = gmap_mask & ~gmap_visited_mask
        global_logits = mask_logits(
            b.global_sap_head(enc.gmap_out)[..., 0].float() * fuse,
            valid_unvisited)
        grid_logits = mask_logits(
            b.grid_sap_head(enc.grid_gmap_out)[..., 0].float(),
            valid_unvisited)
        local_logits = mask_logits(
            b.local_sap_head(enc.vp_out)[..., 0].float() * (1.0 - fuse),
            vp_nav_mask)

        stop = torch.zeros_like(global_logits)
        stop[:, 0] = local_logits[:, 0]
        fused = global_logits + stop
        bt = cand_backtrack_mask & vp_nav_mask
        bt = torch.cat([torch.zeros_like(bt[:, :1]), bt[:, 1:]], dim=1)
        zero = torch.zeros_like(local_logits)
        bw = torch.where(bt, local_logits, zero).sum(dim=1)
        fai = fused_add_idx.long()
        gathered = torch.gather(local_logits, 1, fai.clamp(min=0))
        add = torch.where(fai >= 0, gathered,
                          torch.where(fai == -1, bw[:, None], 0.0))
        slot = torch.arange(fused.shape[1], device=fused.device)[None, :]
        addable = valid_unvisited & (slot > 0) & (fai != -2)
        fused = fused + torch.where(addable, add, 0.0)
        return global_logits, local_logits, fused, grid_logits

    def forward_og_logits(self, enc: TrajectoryEncodings, vp_obj_mask):
        return mask_logits(self.bert.og_head(enc.vp_out)[..., 0].float(),
                           vp_obj_mask)


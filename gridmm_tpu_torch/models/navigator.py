"""GridMM navigator (twin of gridmm_tpu/models/navigator.py).

The cross-modal grid/graph/viewpoint policy network (GlocalTextPathNavCMT,
map_nav_src/models/vilmodel.py:676-939). `forward(mode, batch)` mirrors the
reference's 3-mode callable (models/model.py:21-40) plus the two grid modes:

  * "language"     — instruction encoding (vilmodel.py:730-734)
  * "panorama"     — per-step panorama token encoding (vilmodel.py:736-780)
  * "navigation"   — per-step action prediction (vilmodel.py:782-918)
  * "project_grid" — project + score newly observed grid points once
  * "grid_pool"    — pool pre-projected points into cell embeddings

Every sequence is padded to a static cap with a boolean mask; all 196 cell
slots stay with an occupancy mask; the grid pool goes through the
device-dispatching `ops.grid_pool.grid_pool` (the CUDA kernel on the card).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from gridmm_tpu_torch.config import ModelConfig
from gridmm_tpu_torch.models.layers import (BertEmbeddings, BertLayer,
                                            ClsPrediction, CrossmodalEncoder,
                                            Dense, LayerNorm, PreNormEncoder,
                                            init_weights)
from gridmm_tpu_torch.ops.grid_pool import grid_pool, instruction_relevance
from gridmm_tpu_torch.ops.masking import (attn_bias_from_mask,
                                          compaction_stray_count, mask_logits)

_F32 = torch.float32


class NavOutputs(NamedTuple):
    """Per-step policy outputs (vilmodel.py:909-917)."""

    gmap_embeds: torch.Tensor
    vp_embeds: torch.Tensor
    global_logits: torch.Tensor
    local_logits: torch.Tensor
    fused_logits: torch.Tensor
    grid_logits: torch.Tensor
    obj_logits: Optional[torch.Tensor]


class LanguageEncoder(nn.Module):
    """num_l_layers BERT layers (vilmodel.py:429-449)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.layer = nn.ModuleList(BertLayer(cfg)
                                   for _ in range(cfg.num_l_layers))

    def forward(self, txt_embeds, txt_mask):
        bias = attn_bias_from_mask(txt_mask)
        x = txt_embeds
        for layer in self.layer:
            x = layer(x, bias)
        if not self.cfg.update_lang_bert:
            x = x.detach()
        return x


class ImageEmbeddings(nn.Module):
    """Panorama token embedder + pano self-attention (vilmodel.py:470-541).
    Object tokens, when enabled, are concatenated after the view tokens."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        hs, dt = cfg.hidden_size, cfg.dtype
        self.feat_dropout = nn.Dropout(cfg.feat_dropout)
        self.img_linear = Dense(cfg.image_feat_size, hs, dt)
        self.img_layer_norm = LayerNorm(hs, 1e-12)
        if cfg.obj_feat_size > 0 and cfg.obj_feat_size != cfg.image_feat_size:
            self.obj_linear = Dense(cfg.obj_feat_size, hs, dt)
            self.obj_layer_norm = LayerNorm(hs, 1e-12)
        self.loc_linear = Dense(cfg.angle_feat_size + 3, hs, dt)
        self.loc_layer_norm = LayerNorm(hs, 1e-12)
        self.nav_type_embedding = nn.Embedding(3, hs)
        self.layer_norm = LayerNorm(hs, 1e-12)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)
        if cfg.num_pano_layers > 0:
            self.pano_encoder = PreNormEncoder(cfg, cfg.num_pano_layers)

    def forward(self, view_img_fts, loc_fts, nav_types, mask,
                token_type_embeds, obj_img_fts=None):
        c = self.cfg
        # visual-feature dropout before projection (models/model.py:29-31)
        img = self.img_layer_norm(self.img_linear(
            self.feat_dropout(view_img_fts)))
        if obj_img_fts is not None and c.obj_feat_size > 0:
            obj_img_fts = self.feat_dropout(obj_img_fts)
            if c.obj_feat_size != c.image_feat_size:
                obj = self.obj_layer_norm(self.obj_linear(obj_img_fts))
            else:
                # equal dims share the image projection (vilmodel.py:506-509)
                obj = self.img_layer_norm(self.img_linear(obj_img_fts))
            img = torch.cat([img, obj], dim=1)
        loc = self.loc_layer_norm(self.loc_linear(loc_fts))
        nav = self.nav_type_embedding(nav_types.long()).to(c.dtype)
        # token_type_embeddings(1), the "image" type slot (vilmodel.py:768-771)
        x = img + loc + nav + token_type_embeds
        x = self.dropout(self.layer_norm(x))
        if c.num_pano_layers > 0:
            x = self.pano_encoder(x, mask)
        return x


class Critic(nn.Module):
    """Value head for A2C (models/model.py:43-54); inactive in the shipped
    recipes (gamma=0)."""

    def __init__(self, cfg: ModelConfig, dropout: float = 0.5):
        super().__init__()
        self.fc1 = Dense(cfg.hidden_size, 512, cfg.dtype)
        self.dropout = nn.Dropout(dropout)
        self.fc2 = Dense(512, 1, cfg.dtype)

    def forward(self, state):
        x = self.dropout(torch.relu(self.fc1(state)))
        return self.fc2(x)[..., 0]


class GridMMNavigator(nn.Module):
    """The flagship model; parameter names mirror the JAX package's tree.

    `local_lang_branch` builds the local encoder's language branch
    (`CrossmodalEncoder.lang2visn`), which only pretraining's MLM runs
    (models/pretrain.py); navigation never calls it, and flax creates its
    parameters only where it runs.

    `batch_max` (set by parallel/mesh.ShardedParams during a sharded
    update) takes the stray-key count's batch max over the data ranks."""

    batch_max = None

    def __init__(self, cfg: ModelConfig, local_lang_branch: bool = False):
        super().__init__()
        self.cfg = cfg
        hs, dt = cfg.hidden_size, cfg.dtype
        # shared token-type table (text id 0, panorama id 1)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, hs)
        self.embeddings = BertEmbeddings(cfg)
        self.lang_encoder = LanguageEncoder(cfg)
        self.img_embeddings = ImageEmbeddings(cfg)

        # local branch (LocalVPEncoder, vilmodel.py:543-575)
        self.vp_pos_dense = Dense(2 * cfg.angle_feat_size + 6, hs, dt)
        self.vp_pos_ln = LayerNorm(hs, 1e-12)
        self.local_encoder = CrossmodalEncoder(cfg, cfg.num_x_layers,
                                               lang_branch=local_lang_branch)
        # global branch (GlobalMapEncoder, vilmodel.py:577-660)
        self.gmap_pos_dense = Dense(cfg.angle_feat_size + 3, hs, dt)
        self.gmap_pos_ln = LayerNorm(hs, 1e-12)
        self.gmap_step_embeddings = nn.Embedding(cfg.max_action_steps, hs)
        # grid branch (vilmodel.py:691-703)
        self.grid_encoder = PreNormEncoder(cfg, 1)
        self.grid_txt_encoder = CrossmodalEncoder(cfg, 1, lang_branch=False)
        self.grid_pos_dense = Dense(5, hs, dt)
        self.grid_pos_ln = LayerNorm(hs, 1e-12)
        self.text_proj = Dense(hs, hs, _F32)
        self.grid_proj = Dense(cfg.image_feat_size, hs, _F32)
        # heads (vilmodel.py:687-710)
        self.global_sap_head = ClsPrediction(cfg)
        self.local_sap_head = ClsPrediction(cfg)
        self.grid_sap_head = ClsPrediction(cfg)
        self.sap_fuse_linear = (ClsPrediction(cfg, input_size=2 * hs)
                                if cfg.glocal_fuse else None)
        self.og_head = ClsPrediction(cfg) if cfg.obj_feat_size > 0 else None

    # ------------------------------------------------------------------ text
    def forward_text(self, txt_ids, txt_mask):
        tok = self.token_type_embeddings(torch.zeros_like(txt_ids).long())
        emb = self.embeddings(txt_ids, tok.to(self.cfg.dtype))
        return self.lang_encoder(emb, txt_mask)

    # -------------------------------------------------------------- panorama
    def forward_panorama(self, view_img_fts, loc_fts, nav_types, view_mask,
                         obj_img_fts=None):
        tok = self.token_type_embeddings.weight[1].view(1, 1, -1)
        pano = self.img_embeddings(view_img_fts, loc_fts, nav_types,
                                   view_mask, tok.to(self.cfg.dtype),
                                   obj_img_fts)
        return pano, view_mask

    # ----------------------------------------------------------- shared trunk
    def project_grid_points(self, txt_embeds, patch_fts,
                            txt_relevance_mask=None):
        """Project newly observed points once at insertion: returns
        (grid_proj(patch_fts), relevance weights). Exact factoring of
        vilmodel.py:793-807 (both are constant over an episode)."""
        proj_txt = self.text_proj(txt_embeds.float())
        w = instruction_relevance(patch_fts.float(), proj_txt,
                                  txt_relevance_mask)
        g = self.grid_proj(patch_fts.float())
        return g, w

    def encode_grid_prepooled(self, proj_fts, weights, grid_cells,
                              gridmap_pos_fts):
        """Pool already-projected points (see project_grid_points). The
        buffer's own dtype (f32 or bf16) goes to the pool, which accumulates
        in f32."""
        num_cells = gridmap_pos_fts.shape[1]
        pooled, cell_mask = grid_pool(proj_fts.contiguous(),
                                      grid_cells.to(torch.int32).contiguous(),
                                      weights.float().contiguous(), num_cells)
        grid_embeds = pooled.to(self.cfg.dtype) + self.grid_pos_ln(
            self.grid_pos_dense(gridmap_pos_fts))
        return grid_embeds, cell_mask

    def encode_grid(self, txt_embeds, grid_fts, grid_cells, gridmap_pos_fts,
                    txt_relevance_mask=None):
        """Instruction-relevance pooling of raw grid points into cell
        embeddings (vilmodel.py:788-824). Returns (grid_embeds, cell_mask)."""
        g, w = self.project_grid_points(txt_embeds, grid_fts,
                                        txt_relevance_mask)
        return self.encode_grid_prepooled(g, w, grid_cells, gridmap_pos_fts)

    def encode_map(self, txt_embeds, txt_mask, grid_embeds, cell_mask,
                   gmap_embeds, gmap_mask, stray_count=None):
        """The map encoder over [cells (+ stray token) || gmap tokens], then
        its cross-attention to the text (vilmodel.py:837-845). Returns
        (map_embeds, map_mask, key_bias); key_bias is None without strays
        (see fusion_trunk)."""
        b = grid_embeds.shape[0]
        key_bias = None
        if stray_count is not None:
            zero_tok = grid_embeds.new_zeros((b, 1, grid_embeds.shape[-1]))
            grid_embeds = torch.cat([grid_embeds, zero_tok], dim=1)
            cell_mask = torch.cat([cell_mask, (stray_count > 0)[:, None]],
                                  dim=1)
            key_bias = grid_embeds.new_zeros(
                (b, grid_embeds.shape[1] + gmap_mask.shape[1]), dtype=_F32)
            key_bias[:, grid_embeds.shape[1] - 1] = torch.log(
                torch.clamp(stray_count.float(), min=1.0))
        map_embeds = torch.cat([grid_embeds, gmap_embeds], dim=1)
        map_mask = torch.cat([cell_mask, gmap_mask], dim=1)
        map_embeds = self.grid_encoder(map_embeds, map_mask,
                                       key_bias=key_bias)
        map_embeds = self.grid_txt_encoder(txt_embeds, txt_mask, map_embeds,
                                           map_mask, img_key_bias=key_bias)
        return map_embeds, map_mask, key_bias

    def fusion_trunk(self, txt_embeds, txt_mask, grid_embeds, cell_mask,
                     gmap_embeds, gmap_mask, vp_embeds, vp_mask,
                     stray_count=None):
        """Map encoder + cross-modal fusion (vilmodel.py:837-856).

        `stray_count` (B,) int32 emulates the reference's compaction-alias
        stray keys: n identical zero rows are one extra zero token whose key
        column carries +log(n) in every attention where map tokens are keys.
        The token sits between the grid cells and the gmap tokens.

        Returns (map_embeds, gmap_out, vp_out)."""
        b = grid_embeds.shape[0]
        map_embeds, map_mask, key_bias = self.encode_map(
            txt_embeds, txt_mask, grid_embeds, cell_mask, gmap_embeds,
            gmap_mask, stray_count)
        gmap_embeds = map_embeds[:, -gmap_mask.shape[1]:]

        kv_embeds = torch.cat([map_embeds, txt_embeds], dim=1)
        kv_mask = torch.cat([map_mask, txt_mask], dim=1)
        kv_key_bias = None
        if key_bias is not None:
            kv_key_bias = torch.cat(
                [key_bias, key_bias.new_zeros((b, txt_mask.shape[1]))], dim=1)
        q_embeds = torch.cat([gmap_embeds, vp_embeds], dim=1)
        q_mask = torch.cat([gmap_mask, vp_mask], dim=1)
        q_embeds = self.local_encoder(kv_embeds, kv_mask, q_embeds, q_mask,
                                      txt_key_bias=kv_key_bias)
        g_len = gmap_mask.shape[1]
        return map_embeds, q_embeds[:, :g_len], q_embeds[:, g_len:]

    # ------------------------------------------------------------ navigation
    def forward_navigation(
        self,
        txt_embeds, txt_mask,
        gmap_img_embeds, gmap_step_ids, gmap_pos_fts, gmap_mask,
        gmap_visited_mask,
        vp_img_embeds, vp_pos_fts, vp_mask, vp_nav_mask,
        grid_fts, grid_cells, gridmap_pos_fts,
        fused_add_idx,            # (B, G) int: k>=0 gather local[k];
                                  # -1 add backtrack sum; -2 add nothing
        cand_backtrack_mask,      # (B, V) bool: candidate is a visited node
        vp_obj_mask=None,
        txt_relevance_mask=None,  # None reproduces the unmasked max
        grid_weights=None,        # set when grid_fts are pre-projected
        grid_embeds=None,         # pre-pooled (B, C, D) cell embeddings
        cell_mask=None,
    ) -> NavOutputs:
        c = self.cfg
        # --- grid memory pooling (vilmodel.py:788-824) ---
        if grid_embeds is not None:
            pass  # caller pooled already (mode "grid_pool")
        elif grid_weights is not None:
            grid_embeds, cell_mask = self.encode_grid_prepooled(
                grid_fts, grid_weights, grid_cells, gridmap_pos_fts)
        else:
            grid_embeds, cell_mask = self.encode_grid(
                txt_embeds, grid_fts, grid_cells, gridmap_pos_fts,
                txt_relevance_mask)

        # --- global branch input (vilmodel.py:828-830) ---
        gmap_embeds = (gmap_img_embeds
                       + self.gmap_step_embeddings(gmap_step_ids.long()
                                                   ).to(c.dtype)
                       + self.gmap_pos_ln(self.gmap_pos_dense(gmap_pos_fts)))
        # --- local branch input (vilmodel.py:833) ---
        vp_embeds = vp_img_embeds + self.vp_pos_ln(
            self.vp_pos_dense(vp_pos_fts))

        stray_count = (compaction_stray_count(cell_mask, self.batch_max)
                       if c.compaction_stray_keys else None)
        map_embeds, gmap_out, vp_out = self.fusion_trunk(
            txt_embeds, txt_mask, grid_embeds, cell_mask,
            gmap_embeds, gmap_mask, vp_embeds, vp_mask,
            stray_count=stray_count)

        # --- logits (vilmodel.py:859-907) ---
        if self.sap_fuse_linear is None:
            fuse = 0.5
        else:
            fuse = torch.sigmoid(self.sap_fuse_linear(
                torch.cat([gmap_out[:, 0], vp_out[:, 0]], dim=-1)))

        valid_unvisited = gmap_mask & ~gmap_visited_mask
        global_logits = self.global_sap_head(gmap_out)[..., 0].float() * fuse
        global_logits = mask_logits(global_logits, valid_unvisited)

        grid_logits = self.grid_sap_head(
            map_embeds[:, -gmap_mask.shape[1]:])[..., 0].float()
        grid_logits = mask_logits(grid_logits, valid_unvisited)

        local_logits = (self.local_sap_head(vp_out)[..., 0].float()
                        * (1.0 - fuse))
        local_logits = mask_logits(local_logits, vp_nav_mask)

        # graph-aware fusion (vilmodel.py:881-899): visited candidates pool
        # into one "backtrack" logit; unvisited gmap nodes pick up their
        # candidate's local logit, or the backtrack logit if not visible
        fused = global_logits.clone()
        fused[:, 0] = fused[:, 0] + local_logits[:, 0]
        bt_mask = cand_backtrack_mask & vp_nav_mask
        bt_mask[:, 0] = False
        bw_logits = torch.where(bt_mask, local_logits,
                                torch.zeros_like(local_logits)).sum(dim=1)

        fai = fused_add_idx.long()
        gathered = torch.gather(local_logits, 1, fai.clamp(min=0))
        zero = torch.zeros_like(gathered)
        add = torch.where(fai >= 0, gathered,
                          torch.where(fai == -1, bw_logits[:, None].expand_as(
                              gathered), zero))
        slot = torch.arange(fused.shape[1], device=fused.device)[None, :]
        addable = valid_unvisited & (slot > 0) & (fai != -2)
        fused = fused + torch.where(addable & torch.isfinite(fused), add,
                                    zero)

        if self.og_head is not None and vp_obj_mask is not None:
            obj_logits = mask_logits(self.og_head(vp_out)[..., 0].float(),
                                     vp_obj_mask)
        else:
            obj_logits = None

        return NavOutputs(gmap_embeds=gmap_out, vp_embeds=vp_out,
                          global_logits=global_logits,
                          local_logits=local_logits, fused_logits=fused,
                          grid_logits=grid_logits, obj_logits=obj_logits)

    def forward(self, mode: str, batch: dict):
        """Mode dispatch (models/model.py:21-40)."""
        if mode == "language":
            return self.forward_text(batch["txt_ids"], batch["txt_mask"])
        if mode == "panorama":
            return self.forward_panorama(
                batch["view_img_fts"], batch["loc_fts"], batch["nav_types"],
                batch["view_mask"], batch.get("obj_img_fts"))
        if mode == "navigation":
            return self.forward_navigation(
                batch["txt_embeds"], batch["txt_mask"],
                batch["gmap_img_embeds"], batch["gmap_step_ids"],
                batch["gmap_pos_fts"], batch["gmap_mask"],
                batch["gmap_visited_mask"],
                batch["vp_img_embeds"], batch["vp_pos_fts"], batch["vp_mask"],
                batch["vp_nav_mask"],
                batch.get("grid_fts"), batch.get("grid_cells"),
                batch.get("gridmap_pos_fts"),
                batch["fused_add_idx"], batch["cand_backtrack_mask"],
                batch.get("vp_obj_mask"),
                batch.get("txt_relevance_mask"),
                batch.get("grid_weights"),
                grid_embeds=batch.get("grid_embeds"),
                cell_mask=batch.get("cell_mask"))
        if mode == "project_grid":
            return self.project_grid_points(
                batch["txt_embeds"], batch["patch_fts"],
                batch.get("txt_relevance_mask"))
        if mode == "grid_pool":
            return self.encode_grid_prepooled(
                batch["proj_fts"], batch["weights"], batch["grid_cells"],
                batch["gridmap_pos_fts"])
        raise ValueError(f"unknown mode {mode!r}")


def dummy_batches(shapes, model_cfg: ModelConfig, batch: int = 1,
                  device="cuda"):
    """Zero-filled batches at the static caps (shape checks and smoke runs).
    Returns (txt_ids, txt_mask, pano_batch, nav_batch)."""
    b = batch
    t, g, v, n, c = (shapes.max_txt_len, shapes.max_gmap_len,
                     shapes.max_vp_len, shapes.max_points, shapes.num_cells)
    d = model_cfg.image_feat_size
    a = model_cfg.angle_feat_size

    def z(*shape, dtype=_F32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def o(*shape):
        return torch.ones(shape, dtype=torch.bool, device=device)

    i32 = torch.int32
    txt_ids = z(b, t, dtype=i32)
    txt_mask = o(b, t)
    pano_batch = dict(view_img_fts=z(b, v - 1, d), loc_fts=z(b, v - 1, a + 3),
                      nav_types=z(b, v - 1, dtype=i32),
                      view_mask=o(b, v - 1))
    if model_cfg.obj_feat_size > 0:
        n_obj = max(int(getattr(shapes, "max_obj_len", 0) or 0), 1)
        pano_batch["obj_img_fts"] = z(b, n_obj, model_cfg.obj_feat_size)
        pano_batch["loc_fts"] = z(b, v - 1 + n_obj, a + 3)
        pano_batch["nav_types"] = z(b, v - 1 + n_obj, dtype=i32)
        pano_batch["view_mask"] = o(b, v - 1 + n_obj)
    nav_batch = dict(
        gmap_img_embeds=z(b, g, model_cfg.hidden_size),
        gmap_step_ids=z(b, g, dtype=i32), gmap_pos_fts=z(b, g, a + 3),
        gmap_mask=o(b, g), gmap_visited_mask=z(b, g, dtype=torch.bool),
        vp_img_embeds=z(b, v, model_cfg.hidden_size),
        vp_pos_fts=z(b, v, 2 * a + 6), vp_mask=o(b, v), vp_nav_mask=o(b, v),
        grid_fts=z(b, n, d), grid_cells=z(b, n, dtype=i32),
        gridmap_pos_fts=z(b, c, 5),
        fused_add_idx=torch.full((b, g), -2, dtype=i32, device=device),
        cand_backtrack_mask=z(b, v, dtype=torch.bool))
    if model_cfg.obj_feat_size > 0:
        nav_batch["vp_obj_mask"] = z(b, v, dtype=torch.bool)
    return txt_ids, txt_mask, pano_batch, nav_batch


def init_navigator(cfg: ModelConfig, seed: int = 0,
                   device="cuda") -> GridMMNavigator:
    """A navigator with seeded random weights (see layers.init_weights), in
    eval mode, on `device`."""
    model = GridMMNavigator(cfg)
    init_weights(model, torch.Generator().manual_seed(seed),
                 cfg.initializer_range)
    return model.to(device).eval()

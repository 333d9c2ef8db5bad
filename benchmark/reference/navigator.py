"""Plain PyTorch reference of the GridMM navigator: the yardstick that the
serving and training cells are judged against.

A frozen copy of the navigation path's plain modules (the BERT blocks, the
pre-norm map encoder, the cross-modal layers, the heads, the grid-memory
geometry, the relevance pool, the episode step, the teacher-forced
trajectory loss and the clipped AdamW update), written with `torch` operations
only: no custom kernel, no custom op, no tensor parallelism, no int8 path.
The module and parameter names are those of the navigator's `state_dict`, so
the benchmark hands the same tensors to both sides. It imports nothing of
the system under test.

Departures from the program, each of which gives the same values to rounding:
the pool is the segment softmax written with `index_add_` and autograd
through it (the cell max detached, which leaves the gradient unchanged); the
embeddings and the fused-logit gather use torch's own backward. Dropout
modules are called in the program's order on tensors of the program's shapes,
so that seeded runs draw the same masks.
"""

from __future__ import annotations

import contextlib
import math
from types import SimpleNamespace
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

F32 = torch.float32
NEG_MASK = -10000.0
CELL_PAD = 256
# what every product's operands go through: None keeps them (float32);
# `tf32_operands` rounds them as TF32 does (the control on the CPU)
OPERANDS = None


def _op(t):
    return t if OPERANDS is None else OPERANDS(t)


def tf32_operands(t):
    """float32 rounded to TF32's 10 mantissa bits, to nearest; the
    gradient passes through."""
    t = t.float()
    bits = t.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return t + (rounded - t).detach()


@contextlib.contextmanager
def tf32(device):
    """The reference in TF32, the precision below the configured float32:
    cuBLAS's TF32 on the card, rounded operands on the CPU."""
    global OPERANDS
    on_card = torch.device(device).type == "cuda"
    before = torch.backends.cuda.matmul.allow_tf32
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = True
    else:
        OPERANDS = tf32_operands
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
        OPERANDS = None


def namespace(cfg: dict) -> SimpleNamespace:
    """A configuration file's sections as attribute namespaces."""
    out = SimpleNamespace(**{k: SimpleNamespace(**v) for k, v in cfg.items()
                             if k in ("model", "grid", "shapes", "train")})
    if hasattr(out, "model"):
        out.model.head_dim = (out.model.hidden_size
                              // out.model.num_attention_heads)
    g = out.grid
    g.num_cells = g.grid_width * g.grid_height
    g.points_per_step = g.num_views * g.patches_per_view
    return out


def attn_bias(mask, neg=NEG_MASK):
    return ((1.0 - mask.to(F32)) * neg)[:, None, None, :]


def gelu(x):
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


# ------------------------------------------------------------------ layers
class Dense(nn.Linear):
    def forward(self, x):
        return F.linear(_op(x.float()), _op(self.weight), self.bias)


class LayerNorm(nn.Module):
    def __init__(self, size, eps=1e-12):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(size))
        self.bias = nn.Parameter(torch.zeros(size))

    def forward(self, x):
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight,
                            self.bias, self.eps)


class MHA(nn.Module):
    def __init__(self, m):
        super().__init__()
        hs = m.hidden_size
        self.h, self.hd = m.num_attention_heads, m.head_dim
        self.query, self.key, self.value = (Dense(hs, hs) for _ in range(3))
        self.dropout = nn.Dropout(m.attention_probs_dropout_prob)

    def forward(self, q_in, kv_in, bias=None):
        def split(x):
            b, l, _ = x.shape
            return x.view(b, l, self.h, self.hd).transpose(1, 2)

        q, k, v = (split(self.query(q_in)), split(self.key(kv_in)),
                   split(self.value(kv_in)))
        scores = torch.matmul(_op(q), _op(k.transpose(-1, -2))) / math.sqrt(
            self.hd)
        if bias is not None:
            scores = scores + bias
        probs = self.dropout(torch.softmax(scores, dim=-1))
        ctx = torch.matmul(_op(probs), _op(v))
        b, _, lq, _ = ctx.shape
        return ctx.transpose(1, 2).reshape(b, lq, self.h * self.hd)


class AttnOut(nn.Module):
    def __init__(self, m):
        super().__init__()
        self.dense = Dense(m.hidden_size, m.hidden_size)
        self.dropout = nn.Dropout(m.hidden_dropout_prob)
        self.LayerNorm = LayerNorm(m.hidden_size, m.layer_norm_eps)

    def forward(self, x, residual):
        return self.LayerNorm(self.dropout(self.dense(x)) + residual)


class SelfAttention(nn.Module):
    def __init__(self, m):
        super().__init__()
        self.self = MHA(m)
        self.output = AttnOut(m)

    def forward(self, x, bias=None):
        return self.output(self.self(x, x, bias), x)


class CrossAttention(nn.Module):
    def __init__(self, m):
        super().__init__()
        self.att = MHA(m)
        self.output = AttnOut(m)

    def forward(self, x, ctx, ctx_bias=None):
        return self.output(self.att(x, ctx, ctx_bias), x)


class FFN(nn.Module):
    def __init__(self, m):
        super().__init__()
        self.intermediate_dense = Dense(m.hidden_size, m.intermediate_size)
        self.output_dense = Dense(m.intermediate_size, m.hidden_size)
        self.dropout = nn.Dropout(m.hidden_dropout_prob)
        self.output_LayerNorm = LayerNorm(m.hidden_size, m.layer_norm_eps)

    def forward(self, x):
        h = gelu(self.intermediate_dense(x))
        return self.output_LayerNorm(self.dropout(self.output_dense(h)) + x)


class BertLayer(nn.Module):
    def __init__(self, m):
        super().__init__()
        self.attention = SelfAttention(m)
        self.ffn = FFN(m)

    def forward(self, x, bias=None):
        return self.ffn(self.attention(x, bias))


class XLayer(nn.Module):
    """Visual tokens cross-attend to the context, self-attend, FFN."""

    def __init__(self, m):
        super().__init__()
        self.visual_attention = CrossAttention(m)
        self.visn_self_att = SelfAttention(m)
        self.visn_ffn = FFN(m)

    def forward(self, lang, lang_bias, visn, visn_bias):
        x = self.visual_attention(visn, lang, lang_bias)
        return self.visn_ffn(self.visn_self_att(x, visn_bias))


class XEncoder(nn.Module):
    def __init__(self, m, n):
        super().__init__()
        self.x_layers = nn.ModuleList(XLayer(m) for _ in range(n))

    def forward(self, txt, txt_mask, img, img_mask, txt_key_bias=None,
                img_key_bias=None):
        tb, ib = attn_bias(txt_mask), attn_bias(img_mask)
        if txt_key_bias is not None:
            tb = tb + txt_key_bias[:, None, None, :]
        if img_key_bias is not None:
            ib = ib + img_key_bias[:, None, None, :]
        for layer in self.x_layers:
            img = layer(txt, tb, img, ib)
        return img


class PreNormLayer(nn.Module):
    def __init__(self, m):
        super().__init__()
        hs, inter = m.hidden_size, m.intermediate_size
        self.norm1 = LayerNorm(hs, m.layer_norm_eps)
        self.self_attn = MHA(m)
        self.attn_out = Dense(hs, hs)
        self.norm2 = LayerNorm(hs, m.layer_norm_eps)
        self.linear1 = Dense(hs, inter)
        self.linear2 = Dense(inter, hs)
        self.dropout = nn.Dropout(m.hidden_dropout_prob)

    def forward(self, x, bias=None):
        h = self.norm1(x)
        x = x + self.dropout(self.attn_out(self.self_attn(h, h, bias)))
        h = self.dropout(gelu(self.linear1(self.norm2(x))))
        return x + self.dropout(self.linear2(h))


class PreNormEncoder(nn.Module):
    def __init__(self, m, n):
        super().__init__()
        self.layers = nn.ModuleList(PreNormLayer(m) for _ in range(n))
        self.norm = LayerNorm(m.hidden_size, m.layer_norm_eps)

    def forward(self, x, mask=None, key_bias=None):
        bias = None if mask is None else attn_bias(mask, neg=-1e9)
        if key_bias is not None:
            kb = key_bias[:, None, None, :]
            bias = kb if bias is None else bias + kb
        for layer in self.layers:
            x = layer(x, bias)
        return self.norm(x)


class Head(nn.Module):
    def __init__(self, hs, in_size=None):
        super().__init__()
        self.net = nn.Sequential(Dense(in_size or hs, hs), nn.ReLU(),
                                 LayerNorm(hs), Dense(hs, 1))

    def forward(self, x):
        return self.net(x)


class Embeddings(nn.Module):
    def __init__(self, m):
        super().__init__()
        self.word_embeddings = nn.Embedding(m.vocab_size, m.hidden_size)
        self.position_embeddings = nn.Embedding(m.max_position_embeddings,
                                                m.hidden_size)
        self.LayerNorm = LayerNorm(m.hidden_size, m.layer_norm_eps)
        self.dropout = nn.Dropout(m.hidden_dropout_prob)

    def forward(self, ids, token_type):
        b, l = ids.shape
        pos = torch.arange(l, device=ids.device).expand(b, l)
        emb = (self.word_embeddings(ids.long())
               + self.position_embeddings(pos) + token_type)
        return self.dropout(self.LayerNorm(emb))


class LangEncoder(nn.Module):
    def __init__(self, m):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(m)
                                   for _ in range(m.num_l_layers))

    def forward(self, x, mask):
        bias = attn_bias(mask)
        for layer in self.layer:
            x = layer(x, bias)
        return x


class ImageEmbeddings(nn.Module):
    def __init__(self, m):
        super().__init__()
        hs = m.hidden_size
        self.feat_dropout = nn.Dropout(m.feat_dropout)
        self.img_linear = Dense(m.image_feat_size, hs)
        self.img_layer_norm = LayerNorm(hs)
        self.loc_linear = Dense(m.angle_feat_size + 3, hs)
        self.loc_layer_norm = LayerNorm(hs)
        self.nav_type_embedding = nn.Embedding(3, hs)
        self.layer_norm = LayerNorm(hs)
        self.dropout = nn.Dropout(m.hidden_dropout_prob)
        self.pano_encoder = PreNormEncoder(m, m.num_pano_layers)

    def forward(self, view_img_fts, loc_fts, nav_types, mask, token_type):
        img = self.img_layer_norm(self.img_linear(
            self.feat_dropout(view_img_fts)))
        loc = self.loc_layer_norm(self.loc_linear(loc_fts))
        x = img + loc + self.nav_type_embedding(nav_types.long()) + token_type
        return self.pano_encoder(self.dropout(self.layer_norm(x)), mask)


class NavOut(NamedTuple):
    global_logits: torch.Tensor
    local_logits: torch.Tensor
    fused_logits: torch.Tensor
    grid_logits: torch.Tensor


class Navigator(nn.Module):
    """The navigator's language, panorama, grid-projection and navigation
    forwards (GridMM, arXiv:2307.12907, map_nav_src/models/vilmodel.py)."""

    def __init__(self, m):
        super().__init__()
        if m.obj_feat_size or not m.glocal_fuse or m.num_pano_layers < 1:
            raise ValueError("the reference covers the R2R/RxR navigator")
        hs = m.hidden_size
        self.m = m
        self.token_type_embeddings = nn.Embedding(m.type_vocab_size, hs)
        self.embeddings = Embeddings(m)
        self.lang_encoder = LangEncoder(m)
        self.img_embeddings = ImageEmbeddings(m)
        self.vp_pos_dense = Dense(2 * m.angle_feat_size + 6, hs)
        self.vp_pos_ln = LayerNorm(hs)
        self.local_encoder = XEncoder(m, m.num_x_layers)
        self.gmap_pos_dense = Dense(m.angle_feat_size + 3, hs)
        self.gmap_pos_ln = LayerNorm(hs)
        self.gmap_step_embeddings = nn.Embedding(m.max_action_steps, hs)
        self.grid_encoder = PreNormEncoder(m, 1)
        self.grid_txt_encoder = XEncoder(m, 1)
        self.grid_pos_dense = Dense(5, hs)
        self.grid_pos_ln = LayerNorm(hs)
        self.text_proj = Dense(hs, hs)
        self.grid_proj = Dense(m.image_feat_size, hs)
        self.global_sap_head = Head(hs)
        self.local_sap_head = Head(hs)
        self.grid_sap_head = Head(hs)
        self.sap_fuse_linear = Head(hs, 2 * hs)

    def language(self, ids, mask):
        tok = self.token_type_embeddings(torch.zeros_like(ids).long())
        return self.lang_encoder(self.embeddings(ids, tok), mask)

    def panorama(self, view_img_fts, loc_fts, nav_types, view_mask):
        tok = self.token_type_embeddings.weight[1].view(1, 1, -1)
        return self.img_embeddings(view_img_fts, loc_fts, nav_types,
                                   view_mask, tok)

    def project_grid(self, txt, patch_fts):
        """(grid_proj(patch), relevance): the max over the padded text of
        each point's product with the projected text (the reference's
        unmasked max, ModelConfig.mask_txt_relevance False)."""
        proj_txt = self.text_proj(txt)
        w = torch.einsum("bnd,btd->bnt", _op(patch_fts.float()),
                         _op(proj_txt)).amax(dim=-1)
        return self.grid_proj(patch_fts), w

    def navigation(self, txt, txt_mask, gmap_img_embeds, x, vp_img_embeds,
                   vp_mask, proj_fts, weights, cells, gridmap_pos_fts,
                   stray_keys: bool):
        m = self.m
        pooled, cell_mask = relevance_pool(proj_fts, cells, weights,
                                           gridmap_pos_fts.shape[1])
        grid = pooled + self.grid_pos_ln(self.grid_pos_dense(gridmap_pos_fts))
        gmap = (gmap_img_embeds
                + self.gmap_step_embeddings(x.gmap_step_ids.long())
                + self.gmap_pos_ln(self.gmap_pos_dense(x.gmap_pos_fts)))
        vp = vp_img_embeds + self.vp_pos_ln(self.vp_pos_dense(x.vp_pos_fts))
        gmap_mask = x.gmap_mask
        b = grid.shape[0]
        key_bias = None
        if stray_keys:
            n = stray_count(cell_mask)
            grid = torch.cat([grid, grid.new_zeros((b, 1, grid.shape[-1]))],
                             dim=1)
            cell_mask = torch.cat([cell_mask, (n > 0)[:, None]], dim=1)
            key_bias = grid.new_zeros((b, grid.shape[1] + gmap_mask.shape[1]))
            key_bias[:, grid.shape[1] - 1] = torch.log(
                torch.clamp(n.float(), min=1.0))
        map_embeds = torch.cat([grid, gmap], dim=1)
        map_mask = torch.cat([cell_mask, gmap_mask], dim=1)
        map_embeds = self.grid_encoder(map_embeds, map_mask, key_bias)
        map_embeds = self.grid_txt_encoder(txt, txt_mask, map_embeds,
                                           map_mask, img_key_bias=key_bias)
        g_len = gmap_mask.shape[1]
        gmap = map_embeds[:, -g_len:]
        kv = torch.cat([map_embeds, txt], dim=1)
        kv_mask = torch.cat([map_mask, txt_mask], dim=1)
        kv_bias = None if key_bias is None else torch.cat(
            [key_bias, key_bias.new_zeros((b, txt_mask.shape[1]))], dim=1)
        q = self.local_encoder(kv, kv_mask, torch.cat([gmap, vp], dim=1),
                               torch.cat([gmap_mask, vp_mask], dim=1),
                               txt_key_bias=kv_bias)
        gmap_out, vp_out = q[:, :g_len], q[:, g_len:]

        fuse = torch.sigmoid(self.sap_fuse_linear(
            torch.cat([gmap_out[:, 0], vp_out[:, 0]], dim=-1)))
        ninf = float("-inf")
        valid = gmap_mask & ~x.gmap_visited_mask
        glob = (self.global_sap_head(gmap_out)[..., 0] * fuse
                ).masked_fill(~valid, ninf)
        grid_logits = self.grid_sap_head(map_embeds[:, -g_len:])[..., 0
                                                                  ].masked_fill(~valid, ninf)
        local = (self.local_sap_head(vp_out)[..., 0] * (1.0 - fuse)
                 ).masked_fill(~x.vp_nav_mask, ninf)
        # graph-aware fusion (vilmodel.py:881-899)
        fused = glob.clone()
        fused[:, 0] = fused[:, 0] + local[:, 0]
        bt = x.cand_backtrack_mask & x.vp_nav_mask
        bt[:, 0] = False
        back = torch.where(bt, local, torch.zeros_like(local)).sum(dim=1)
        fai = x.fused_add_idx.long()
        gathered = torch.gather(local, 1, fai.clamp(min=0))
        zero = torch.zeros_like(gathered)
        add = torch.where(fai >= 0, gathered, torch.where(
            fai == -1, back[:, None].expand_as(gathered), zero))
        slot = torch.arange(fused.shape[1], device=fused.device)[None, :]
        addable = valid & (slot > 0) & (fai != -2)
        fused = fused + torch.where(addable & torch.isfinite(fused), add,
                                    zero)
        return NavOut(glob, local, fused, grid_logits)


def stray_count(cell_mask):
    """The reference's compaction-alias stray keys (vilmodel.py:816-820): per
    row, the occupied bits at positions [cnt, min(cnt + k, batch max)),
    where k counts the occupied bits at positions >= cnt."""
    m = cell_mask.to(torch.int32)
    cnt = m.sum(dim=1)
    idx = torch.arange(cell_mask.shape[1], device=cell_mask.device)[None, :]
    ge = m * (idx >= cnt[:, None])
    hi = torch.minimum(cnt + ge.sum(dim=1), cnt.max())[:, None]
    return (ge * (idx < hi)).sum(dim=1)


def relevance_pool(fts, cells, weights, num_cells):
    """Per-cell softmax of the relevance weights over the cell's points, the
    weighted mean of their features; empty cells 0 and masked."""
    b, n, d = fts.shape
    valid = (cells >= 0) & (cells < num_cells)
    seg = torch.where(valid, cells, torch.full_like(cells, num_cells)).long()
    w = weights.float().masked_fill(~valid, float("-inf"))
    cmax = torch.full((b, num_cells + 1), float("-inf"), device=fts.device
                      ).scatter_reduce(1, seg, w.detach(), "amax")
    e = torch.exp(w - cmax.gather(1, seg)).masked_fill(~valid, 0.0)
    denom = torch.zeros((b, num_cells + 1), device=fts.device
                        ).scatter_add(1, seg, e)
    rows = torch.arange(b, device=fts.device)[:, None] * (num_cells + 1) + seg
    numer = torch.zeros((b * (num_cells + 1), d), device=fts.device
                        ).index_add(0, rows.reshape(-1),
                                    (e[..., None] * fts.float()).reshape(-1, d))
    numer = numer.view(b, num_cells + 1, d)[:, :num_cells]
    denom = denom[:, :num_cells]
    mask = denom > 0
    pooled = numer / torch.where(mask, denom, torch.ones_like(denom))[..., None]
    return pooled.masked_fill(~mask[..., None], 0.0), mask


# ---------------------------------------------------------------- geometry
class Points(NamedTuple):
    xy: torch.Tensor
    features: torch.Tensor
    weights: torch.Tensor
    valid: torch.Tensor
    inserted: torch.Tensor
    count: torch.Tensor


def empty_points(b, n, d, device, dtype=F32):
    return Points(torch.zeros((b, n, 2), device=device),
                  torch.zeros((b, n, d), dtype=dtype, device=device),
                  torch.zeros((b, n), device=device),
                  torch.zeros((b, n), dtype=torch.bool, device=device),
                  torch.zeros((b, n), dtype=torch.bool, device=device),
                  torch.zeros((b,), dtype=torch.int32, device=device))


def backproject(depth, g):
    """(..., V, P) raw depth -> viewpoint-relative x, y and the nonzero-depth
    mask, each (..., V*P) (r2r/env.py:115-121, 283-285)."""
    dev = depth.device
    angles = torch.arange(g.num_views, dtype=F32, device=dev) * (
        2.0 * math.pi / g.num_views)
    side = int(round(math.sqrt(g.patches_per_view)))
    c = torch.arange(side, dtype=F32, device=dev)
    offs = ((2.0 * c - (side - 1)) / side).repeat(side)
    dy = depth.float() / g.depth_scale
    dx = dy * (offs * g.tan_half_hfov)
    cos_a, sin_a = torch.cos(angles)[..., None], torch.sin(angles)[..., None]
    rx = dx * cos_a + dy * sin_a
    ry = dy * cos_a - dx * sin_a
    lead = depth.shape[:-2]
    return (rx.reshape(*lead, -1), g.y_sign * ry.reshape(*lead, -1),
            (depth > 0).reshape(*lead, -1))


def append(state: Points, depth, feats, weights, pos_xy, g) -> Points:
    """Write one panorama's points at the buffer's count, the start held at
    N - V*P once the buffer is full (a clamped dynamic_update_slice)."""
    b, n, _ = state.xy.shape
    pp = g.points_per_step
    rx, ry, ok = backproject(depth, g)
    pts = torch.stack([rx + pos_xy[:, 0:1], ry + pos_xy[:, 1:2]], dim=-1)
    start = state.count.clamp(0, n - pp).long()
    rows = torch.arange(b, device=pts.device)[:, None]
    cols = start[:, None] + torch.arange(pp, device=pts.device)[None, :]
    out = Points(*(t.clone() for t in state))
    out.xy[rows, cols] = pts
    out.features[rows, cols] = feats.to(out.features.dtype)
    out.weights[rows, cols] = weights.float()
    out.valid[rows, cols] = ok
    out.inserted[rows, cols] = True
    return out._replace(count=state.count + pp)


def assign_cells(state: Points, pos_xy, heading, g, num_active=None):
    """Egocentric cell of every point (-1 for none), and the cells'
    positional features (r2r/env.py:242-374)."""
    px, py = state.xy[..., 0], state.xy[..., 1]
    ins, valid = state.inserted, state.valid
    if num_active is not None:
        lim = torch.arange(px.shape[1], device=px.device)[None, :] < num_active
        ins, valid = ins & lim, valid & lim
    big = 1e4
    min_x = torch.where(ins, px, big).amin(dim=1)
    max_x = torch.where(ins, px, -big).amax(dim=1)
    min_y = torch.where(ins, py, big).amin(dim=1)
    max_y = torch.where(ins, py, -big).amax(dim=1)
    ax, ay = pos_xy[:, 0], pos_xy[:, 1]
    half = torch.maximum(torch.maximum(ax - min_x, max_x - ax),
                         torch.maximum(ay - min_y, max_y - ay)) * g.window_scale
    ang = (g.heading_sign * heading + g.heading_offset)[:, None]
    tx, ty = px - pos_xy[:, 0:1], py - pos_xy[:, 1:2]
    mx = tx * torch.cos(ang) + ty * torch.sin(ang)
    my = ty * torch.cos(ang) - tx * torch.sin(ang)
    h = half[:, None]
    den = torch.clamp(2.0 * h, min=1e-8)
    gx = torch.floor((g.map_x_sign * mx + h) / den * (g.grid_width - 1)
                     ).to(torch.int32).clamp(0, g.grid_width - 1)
    gy = torch.floor((my + h) / den * (g.grid_height - 1)
                     ).to(torch.int32).clamp(0, g.grid_height - 1)
    cells = torch.where(valid, gx * g.grid_height + gy,
                        torch.full_like(gx, -1))
    return cells, cell_pos_fts(half, g)


def cell_pos_fts(half, g):
    """Per-cell [sin h, cos h, sin e, cos e, dist / max_dist] of the cell
    centres (env.py:242-265, graph_utils.py:15-40)."""
    half = half[..., None]
    cell = half * 2.0 / g.grid_width
    flat = torch.arange(g.grid_width * g.grid_height, dtype=F32,
                        device=half.device)
    i = torch.div(flat, g.grid_height, rounding_mode="floor")
    j = torch.remainder(flat, g.grid_height)
    cx = i * cell - half + cell / 2.0
    cy = j * cell - half + cell / 2.0
    dist = torch.clamp(torch.sqrt(cx * cx + cy * cy), min=1e-8)
    head = torch.arcsin(torch.clamp(cx / dist, -1.0, 1.0))
    head = torch.where(cy < 0, math.pi - head, head)
    elev = torch.zeros_like(head)
    return torch.stack([torch.sin(head), torch.cos(head), torch.sin(elev),
                        torch.cos(elev), dist / g.max_dist], dim=-1)


# ------------------------------------------------------------ the episode
class Steps(NamedTuple):
    """One step's inputs for a batch of episodes (leading dim B), or a
    trajectory's (S, B, ...)."""

    view_img_fts: torch.Tensor
    loc_fts: torch.Tensor
    nav_types: torch.Tensor
    view_mask: torch.Tensor
    depth: torch.Tensor
    patch_fts: torch.Tensor
    pos_xy: torch.Tensor
    heading: torch.Tensor
    gmap_step_ids: torch.Tensor
    gmap_pos_fts: torch.Tensor
    gmap_mask: torch.Tensor
    gmap_visited_mask: torch.Tensor
    cur_node_idx: torch.Tensor
    cand_gmap_idx: torch.Tensor
    vp_pos_fts: torch.Tensor
    vp_nav_mask: torch.Tensor
    fused_add_idx: torch.Tensor
    cand_backtrack_mask: torch.Tensor
    target: torch.Tensor


class Carry(NamedTuple):
    points: Points
    gmap_sum: torch.Tensor
    gmap_cnt: torch.Tensor


def empty_carry(cfg, b, device) -> Carry:
    sh, m = cfg.shapes, cfg.model
    return Carry(empty_points(b, sh.max_points, m.image_feat_size, device),
                 torch.zeros((b, sh.max_gmap_len, m.hidden_size),
                             device=device),
                 torch.zeros((b, sh.max_gmap_len), device=device))


def keep_rows(live, new: Carry, old: Carry) -> Carry:
    """`new` in the rows where `live`, `old` elsewhere."""
    def pick(a, b):
        return torch.where(live.view((-1,) + (1,) * (a.dim() - 1)), a, b)

    return Carry(Points(*(pick(a, b) for a, b in zip(new.points, old.points))),
                 pick(new.gmap_sum, old.gmap_sum),
                 pick(new.gmap_cnt, old.gmap_cnt))


def node_embeds(gsum, gcnt, pano, pano_mask, x):
    """GraphMap.update_node_embed (agent.py:312-320): the current node takes
    the masked mean of the panorama; unvisited candidates add their view."""
    b = pano.shape[0]
    bi = torch.arange(b, device=pano.device)
    avg = (pano * pano_mask[..., None]).sum(dim=1) / torch.clamp(
        pano_mask.sum(dim=1, keepdim=True), min=1)
    gsum, gcnt = gsum.clone(), gcnt.clone()
    cur = x.cur_node_idx.long()
    gsum[bi, cur] = avg
    gcnt[bi, cur] = 1.0
    cand = x.cand_gmap_idx.long()
    ok = (cand >= 0) & ~torch.gather(x.gmap_visited_mask, 1,
                                     cand.clamp(min=0))
    tgt = torch.where(ok, cand, torch.zeros_like(cand))
    rows = bi[:, None].expand_as(tgt)
    gsum = gsum.index_put((rows, tgt), pano.masked_fill(~ok[..., None], 0.0),
                          accumulate=True)
    gcnt = gcnt.index_put((rows, tgt), ok.float(), accumulate=True)
    return gsum, gcnt


def gmap_inputs(gsum, gcnt):
    emb = gsum / torch.clamp(gcnt, min=1.0)[..., None]
    return torch.cat([torch.zeros_like(emb[:, :1]), emb[:, 1:]], dim=1)


def vp_inputs(pano, view_mask):
    b = pano.shape[0]
    vp = torch.cat([pano.new_zeros((b, 1, pano.shape[-1])), pano], dim=1)
    vp_mask = torch.cat([torch.ones((b, 1), dtype=torch.bool,
                                    device=pano.device), view_mask], dim=1)
    return vp, vp_mask


def serve_step(model: Navigator, cfg, txt, txt_mask, carry: Carry, x):
    """One served step (the clean masked semantics the serving engine runs:
    no stray keys). Returns (new carry, NavOut)."""
    pano = model.panorama(x.view_img_fts, x.loc_fts, x.nav_types, x.view_mask)
    proj, w = model.project_grid(txt, x.patch_fts)
    pts = append(carry.points, x.depth, proj, w, x.pos_xy, cfg.grid)
    cells, pos_fts = assign_cells(pts, x.pos_xy, x.heading, cfg.grid)
    gsum, gcnt = node_embeds(carry.gmap_sum, carry.gmap_cnt, pano,
                             x.view_mask, x)
    vp, vp_mask = vp_inputs(pano, x.view_mask)
    out = model.navigation(txt, txt_mask, gmap_inputs(gsum, gcnt), x, vp,
                           vp_mask, pts.features, pts.weights, cells,
                           pos_fts, stray_keys=False)
    return Carry(pts, gsum, gcnt), out


def log_softmax_masked(logits):
    mx = logits.amax(dim=-1, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    sh = logits - mx
    se = torch.where(torch.isfinite(sh), torch.exp(sh),
                     torch.zeros_like(sh)).sum(dim=-1, keepdim=True)
    return sh - torch.log(torch.clamp(se, min=1e-30))


def ce_sum(logits, target, ignore):
    ok = target != ignore
    t = torch.where(ok, target, torch.zeros_like(target)).long()
    nll = -torch.gather(log_softmax_masked(logits), 1, t[:, None])[:, 0]
    return torch.where(ok, nll, torch.zeros_like(nll)).sum()


def trajectory_loss(model: Navigator, cfg, txt_ids, txt_mask, steps):
    """The teacher-forced loss of a (S, B) trajectory batch: one shared
    full-trajectory point buffer, each step's assignment over its prefix,
    the fused head's summed CE (with RxR's doubled stop CE where the
    configuration says so), times ml_weight / B."""
    tr, g = cfg.train, cfg.grid
    s, b = steps.target.shape
    pp = g.points_per_step
    txt = model.language(txt_ids, txt_mask)

    def fold(a):
        return a.reshape((s * b,) + a.shape[2:])

    pano = model.panorama(fold(steps.view_img_fts), fold(steps.loc_fts),
                          fold(steps.nav_types), fold(steps.view_mask))
    pano = pano.reshape((s, b) + pano.shape[1:])
    patch = steps.patch_fts.permute(1, 0, 2, 3).reshape(
        b, s * pp, steps.patch_fts.shape[-1])
    proj, w = model.project_grid(txt, patch)
    rx, ry, ok = backproject(steps.depth, g)
    xy = torch.stack([rx + steps.pos_xy[..., 0:1],
                      ry + steps.pos_xy[..., 1:2]], dim=-1)
    n = s * pp
    pts = Points(xy.permute(1, 0, 2, 3).reshape(b, n, 2), proj, w,
                 ok.permute(1, 0, 2).reshape(b, n),
                 torch.ones((b, n), dtype=torch.bool, device=xy.device),
                 torch.full((b,), n, dtype=torch.int32, device=xy.device))
    gsum = torch.zeros((b, steps.gmap_mask.shape[-1], cfg.model.hidden_size),
                       device=xy.device)
    gcnt = torch.zeros(gsum.shape[:2], device=xy.device)

    def nav_step(x, gmap_emb, pano_t, active):
        cells, pos_fts = assign_cells(pts, x.pos_xy, x.heading, g, active)
        vp, vp_mask = vp_inputs(pano_t, x.view_mask)
        out = model.navigation(txt, txt_mask, gmap_emb, x, vp, vp_mask,
                               pts.features, pts.weights, cells, pos_fts,
                               stray_keys=cfg.model.compaction_stray_keys)
        loss = ce_sum(out.fused_logits, x.target, tr.ignoreid)
        if tr.stop_extra_ce:
            stop = torch.where(x.target == 0, torch.zeros_like(x.target),
                               torch.full_like(x.target, tr.ignoreid))
            loss = loss + ce_sum(out.fused_logits, stop, tr.ignoreid)
        return loss

    total = torch.zeros((), device=xy.device)
    for t in range(s):
        x = type(steps)(*(a[t] for a in steps))
        gsum, gcnt = node_embeds(gsum, gcnt, pano[t], x.view_mask, x)
        args = (x, gmap_inputs(gsum, gcnt), pano[t], (t + 1) * pp)
        if tr.remat_steps:
            total = total + checkpoint(nav_step, *args, use_reentrant=False)
        else:
            total = total + nav_step(*args)
    return total * tr.ml_weight / b


class AdamW:
    """clip_by_global_norm(clip) -> Adam moments with bias correction ->
    + weight_decay * p -> scale by -lr, on every parameter (optax's chain,
    agent_base.py:122-138, 205)."""

    def __init__(self, params, tr):
        self.params = list(params)
        self.lr, self.clip, self.eps = tr.lr, tr.grad_norm_clip, tr.adam_eps
        self.b1, self.b2 = tr.betas
        self.wd = tr.weight_decay
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self):
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        scale = torch.where(norm < self.clip, torch.ones_like(norm),
                            self.clip / norm)
        self.t += 1
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = g * scale
            mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = (mu / (1 - self.b1 ** self.t)) / (
                torch.sqrt(nu / (1 - self.b2 ** self.t)) + self.eps)
            p.add_(u + self.wd * p, alpha=-self.lr)
        return norm

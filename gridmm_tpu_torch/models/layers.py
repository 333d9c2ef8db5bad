"""Transformer building blocks (twin of gridmm_tpu/models/layers.py).

The reference's vendored BERT blocks (map_nav_src/models/vilmodel.py:64-427)
and the DETR-style pre-norm TransformerEncoder (map_nav_src/models/
transformer.py). Module and parameter names follow the JAX package's flax
tree, so `gridmm_tpu_torch.convert` maps one onto the other mechanically:
flax `foo_3` is the torch ModuleList entry `foo.3`.

The navigator's attention runs over <= ~600 tokens; the JAX package leaves it
to XLA einsums (no Pallas kernel), and here it is plain PyTorch.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from gridmm_tpu_torch.config import ModelConfig
from gridmm_tpu_torch.ops.masking import attn_bias_from_mask
from gridmm_tpu_torch.ops.quant import int8_dense_q, quantize_per_channel
from gridmm_tpu_torch.parallel.tp import TensorParallel, all_max


def gelu_erf(x):
    """BERT's exact-erf gelu (vilmodel.py:47-53)."""
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


ACT2FN: dict[str, Callable] = {
    "gelu": gelu_erf,
    "relu": F.relu,
    "swish": F.silu,
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
}


class Dense(nn.Linear):
    """flax `nn.Dense` twin: computes in `dtype` (inputs and parameters cast,
    as flax promotes them); parameters stay f32. Under tensor parallelism
    (`tp`, set by parallel/mesh.py) the weight is the rank's shard and the
    product a column- or row-parallel one."""

    tp: Optional[TensorParallel] = None

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        if self.tp is not None:
            return self.tp.linear(x.to(dt), self.weight.to(dt), b)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Embedding(nn.Embedding):
    """nn.Embedding whose table may be sharded over the vocabulary (`tp`,
    set by parallel/mesh.py for the word embeddings)."""

    tp: Optional[TensorParallel] = None

    def forward(self, ids):
        if self.tp is not None:
            return self.tp.embedding(ids, self.weight)
        return super().forward(ids)


class Int8Dense(Dense):
    """`Dense` with the same parameters whose product runs on the int8 path
    (ops/quant.py): the JAX package's `Int8Dense`, for serving. The result
    is in the input's dtype.

    The JAX package quantizes the weight inside `jit`, where XLA hoists it
    out of the step; eager torch would quantize again at every call. So the
    int8 weight and its scales are cached in buffers that are not
    persistent (the `state_dict` is `Dense`'s) and rebuilt when the weight
    is another tensor or was written since (`_version`). A weight given in
    place of the parameter (`torch.func.functional_call`, the exported
    programs) is quantized in the call.

    Over a mesh (the sharded serving bundle), `batch_group` is the process
    group that splits the batch (set by parallel/mesh.set_int8_batch_group):
    the activation's absmax is a MAX over it. A row-parallel layer (`tp`)
    also takes both absmaxes over `model` and sums its int32 products
    there before the rescale (parallel/tp.py)."""

    batch_group: Optional[object] = None

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, bias: bool = True):
        super().__init__(in_features, out_features, dtype, bias)
        self.register_buffer("weight_q", None, persistent=False)
        self.register_buffer("weight_scale", None, persistent=False)
        self._cache_key = None

    def _row_group(self):
        """The `model` group where this layer splits its input, else None."""
        tp = self.tp
        return tp.group if tp is not None and tp.kind == "row" else None

    def quantized(self):
        """(int8 weight (out, in), f32 scale (out,))."""
        w = self.weight
        amax = _max_over([self._row_group()])
        if not isinstance(w, nn.Parameter) or torch.compiler.is_compiling():
            return quantize_per_channel(w, amax)
        key = (w.data_ptr(), w.device, w._version)
        if key != self._cache_key:
            with torch.no_grad():
                self.weight_q, self.weight_scale = quantize_per_channel(
                    w, amax)
            self._cache_key = key
        return self.weight_q, self.weight_scale

    def forward(self, x):
        wq, scale = self.quantized()
        row = self._row_group()
        return int8_dense_q(x, wq, scale, self.bias,
                            _max_over([self.batch_group, row]),
                            None if row is None else self.tp.reduce_from)


def _max_over(groups):
    """A MAX over each of the process groups given (None: none), or None
    where there is none to take."""
    groups = [g for g in groups if g is not None]
    if not groups:
        return None

    def amax(t):
        for g in groups:
            t = all_max(t, g)
        return t

    return amax


def dense(in_features: int, out_features: int, cfg: ModelConfig) -> Dense:
    """The trunk projections: `Int8Dense` under cfg.int8_matmuls, as the
    JAX package's `_dense(..., c.int8_matmuls)`, else `Dense`."""
    cls = Int8Dense if cfg.int8_matmuls else Dense
    return cls(in_features, out_features, cfg.dtype)


class LayerNorm(nn.Module):
    """LayerNorm computed in f32 regardless of activation dtype."""

    def __init__(self, size: int, eps: float = 1e-12):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(size))
        self.bias = nn.Parameter(torch.zeros(size))

    def forward(self, x):
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias,
                         self.eps)
        return y.to(x.dtype)


class MultiHeadAttention(nn.Module):
    """Scaled dot-product attention with separate q / kv inputs: both
    BertSelfAttention (vilmodel.py:95-157) and BertOutAttention
    (vilmodel.py:317-368). `bias` is additive, broadcastable to
    (B, H, Lq, Lk)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        hs = cfg.hidden_size
        self.query = dense(hs, hs, cfg)
        self.key = dense(hs, hs, cfg)
        self.value = dense(hs, hs, cfg)
        self.dropout = nn.Dropout(cfg.attention_probs_dropout_prob)

    def forward(self, q_in, kv_in, bias=None):
        c = self.cfg
        h, hd = c.num_attention_heads, c.head_dim
        if self.query.tp is not None:  # column-parallel: this rank's heads
            h //= self.query.tp.size

        def split(x):  # (B, L, W) -> (B, H, L, hd)
            b, l, _ = x.shape
            return x.view(b, l, h, hd).transpose(1, 2)

        q = split(self.query(q_in))
        k = split(self.key(kv_in))
        v = split(self.value(kv_in))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        scores = scores / math.sqrt(hd)
        if bias is not None:
            scores = scores + bias.float()
        probs = self.dropout(torch.softmax(scores, dim=-1))
        ctx = torch.matmul(probs.to(v.dtype), v).to(c.dtype)
        b, _, lq, _ = ctx.shape
        return ctx.transpose(1, 2).reshape(b, lq, h * hd)


class AttentionOutput(nn.Module):
    """dense -> dropout -> LN(residual + x) (BertSelfOutput,
    vilmodel.py:159-170)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.dense = dense(cfg.hidden_size, cfg.hidden_size, cfg)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)
        self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, x, residual):
        return self.LayerNorm(self.dropout(self.dense(x)) + residual)


class BertAttention(nn.Module):
    """Self-attention block (vilmodel.py:172-182)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.self = MultiHeadAttention(cfg)
        self.output = AttentionOutput(cfg)

    def forward(self, x, bias=None):
        return self.output(self.self(x, x, bias), x)


class BertCrossAttention(nn.Module):
    """Cross-attention block (BertXAttention, vilmodel.py:370-379)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.att = MultiHeadAttention(cfg)
        self.output = AttentionOutput(cfg)

    def forward(self, x, ctx, ctx_bias=None):
        return self.output(self.att(x, ctx, ctx_bias), x)


class BertFFN(nn.Module):
    """intermediate + output (vilmodel.py:184-209)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.act = ACT2FN[cfg.hidden_act]
        self.intermediate_dense = dense(cfg.hidden_size,
                                        cfg.intermediate_size, cfg)
        self.output_dense = dense(cfg.intermediate_size, cfg.hidden_size,
                                  cfg)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)
        self.output_LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, x):
        h = self.act(self.intermediate_dense(x))
        h = self.dropout(self.output_dense(h))
        return self.output_LayerNorm(h + x)


class BertLayer(nn.Module):
    """attention -> FFN (vilmodel.py:211-224)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.ffn = BertFFN(cfg)

    def forward(self, x, bias=None):
        return self.ffn(self.attention(x, bias))


class BertEmbeddings(nn.Module):
    """word + position (+ externally shared token-type) embeddings
    (vilmodel.py:64-93); the navigator owns the token-type table because the
    panorama embedder reuses it (vilmodel.py:768-771)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)
        self.compute_dtype = cfg.dtype

    def forward(self, input_ids, token_type_embeds, position_ids=None):
        b, l = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(l, device=input_ids.device
                                        ).expand(b, l)
        dt = self.compute_dtype
        emb = (self.word_embeddings(input_ids.long()).to(dt)
               + self.position_embeddings(position_ids.long()).to(dt))
        emb = emb + token_type_embeds
        return self.dropout(self.LayerNorm(emb))


class GraphLXRTXLayer(nn.Module):
    """Cross-modal layer (vilmodel.py:381-427): visn cross-attends to language,
    self-attends (optionally graph-biased), then FFN. `lang2visn` (pretraining
    MLM, vilmodel.py:416-427) runs language queries over visual keys through a
    separate lang branch that shares the cross-attention.

    `lang_branch` builds that branch's parameters. It defaults to
    cfg.use_lang2visn_attn; the navigator passes False because it never calls
    lang2visn, and flax materializes those parameters only when it runs."""

    def __init__(self, cfg: ModelConfig, lang_branch: Optional[bool] = None):
        super().__init__()
        self.visual_attention = BertCrossAttention(cfg)
        self.visn_self_att = BertAttention(cfg)
        self.visn_ffn = BertFFN(cfg)
        if cfg.use_lang2visn_attn if lang_branch is None else lang_branch:
            self.lang_self_att = BertAttention(cfg)
            self.lang_ffn = BertFFN(cfg)

    def forward(self, lang, lang_bias, visn, visn_bias, graph_sprels=None):
        x = self.visual_attention(visn, lang, lang_bias)
        self_bias = visn_bias if graph_sprels is None else (
            visn_bias + graph_sprels)
        x = self.visn_self_att(x, self_bias)
        return self.visn_ffn(x)

    def lang2visn(self, lang, lang_bias, visn, visn_bias):
        x = self.visual_attention(lang, visn, visn_bias)
        x = self.lang_self_att(x, lang_bias)
        return self.lang_ffn(x)


class CrossmodalEncoder(nn.Module):
    """Stack of GraphLXRTXLayers (vilmodel.py:451-468). Masks are bool
    (B, L)."""

    def __init__(self, cfg: ModelConfig, num_layers: int,
                 lang_branch: Optional[bool] = None):
        super().__init__()
        self.x_layers = nn.ModuleList(
            GraphLXRTXLayer(cfg, lang_branch) for _ in range(num_layers))

    def forward(self, txt, txt_mask, img, img_mask, graph_sprels=None,
                txt_key_bias=None, img_key_bias=None):
        """`*_key_bias`: optional (B, L) float added to that side's additive
        attention bias — weights one key as n identical keys (the
        compaction-stray emulation, ops/masking.py)."""
        txt_bias = attn_bias_from_mask(txt_mask)
        img_bias = attn_bias_from_mask(img_mask)
        if txt_key_bias is not None:
            txt_bias = txt_bias + txt_key_bias[:, None, None, :]
        if img_key_bias is not None:
            img_bias = img_bias + img_key_bias[:, None, None, :]
        for layer in self.x_layers:
            img = layer(txt, txt_bias, img, img_bias, graph_sprels)
        return img

    def lang2visn(self, txt, txt_mask, visn, visn_mask):
        """Language tokens attend to visual context through every layer's
        lang branch (pretrain forward_mlm, vilmodel.py:846-853)."""
        txt_bias = attn_bias_from_mask(txt_mask)
        visn_bias = attn_bias_from_mask(visn_mask)
        for layer in self.x_layers:
            txt = layer.lang2visn(txt, txt_bias, visn, visn_bias)
        return txt


class PreNormEncoderLayer(nn.Module):
    """Pre-norm transformer encoder layer (models/transformer.py with
    normalize_before=True)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        hs, inter = cfg.hidden_size, cfg.intermediate_size
        self.act = ACT2FN[cfg.hidden_act]
        self.norm1 = LayerNorm(hs, cfg.layer_norm_eps)
        self.self_attn = MultiHeadAttention(cfg)
        self.attn_out = dense(hs, hs, cfg)
        self.norm2 = LayerNorm(hs, cfg.layer_norm_eps)
        self.linear1 = dense(hs, inter, cfg)
        self.linear2 = dense(inter, hs, cfg)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, x, bias=None):
        h = self.norm1(x)
        h = self.attn_out(self.self_attn(h, h, bias))
        x = x + self.dropout(h)
        h = self.norm2(x)
        h = self.dropout(self.act(self.linear1(h)))
        return x + self.dropout(self.linear2(h))


class PreNormEncoder(nn.Module):
    """Stack of pre-norm layers + final LayerNorm (create_transformer_encoder
    with norm=True)."""

    def __init__(self, cfg: ModelConfig, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(
            PreNormEncoderLayer(cfg) for _ in range(num_layers))
        self.norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, x, mask=None, key_bias=None):
        bias = None if mask is None else attn_bias_from_mask(mask, neg=-1e9)
        if key_bias is not None:
            kb = key_bias[:, None, None, :]
            bias = kb if bias is None else bias + kb
        for layer in self.layers:
            x = layer(x, bias)
        return self.norm(x)


class ClsPrediction(nn.Module):
    """linear -> ReLU -> LN -> linear(output_size) head (vilmodel.py:663-674;
    with output_size > 1 pretraining's RegionClassification,
    pretrain_cmt.py:12-22); the Sequential indices are the flax names
    net_0 / net_2 / net_3."""

    def __init__(self, cfg: ModelConfig, input_size: Optional[int] = None,
                 output_size: int = 1):
        super().__init__()
        hs = cfg.hidden_size
        self.net = nn.Sequential(
            Dense(input_size or hs, hs, cfg.dtype), nn.ReLU(),
            LayerNorm(hs, 1e-12), Dense(hs, output_size, cfg.dtype))

    def forward(self, x):
        return self.net(x)


def init_weights(module: nn.Module, generator: torch.Generator,
                 std: float = 0.02) -> None:
    """Seeded init in the JAX package's scheme: dense kernels and embeddings
    ~ N(0, std), biases 0, LayerNorm scale 1 / bias 0."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                w = torch.empty(m.weight.shape)
                w.normal_(0.0, std, generator=generator)
                m.weight.copy_(w)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

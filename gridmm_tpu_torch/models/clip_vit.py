"""CLIP Vision Transformer, the visual tower (twin of
gridmm_tpu/models/clip_vit.py).

The reference's vendored OpenAI CLIP visual encoder
(preprocess/model_clip.py:29-98): patchify -> [cls] + positional embedding
-> ln_pre -> N pre-norm residual attention blocks (QuickGELU) -> ln_post,
returning ALL token hidden states (no projection or pooling); the patch
tokens feed the grid memory downstream. The timm ViT-B/16 variant
(`vit_b16_timm`) swaps in a biased patchify, no ln_pre and the erf GELU.

Images are (B, H, W, 3), as in the JAX package. Patchify is unfold plus a
Linear whose weight is (width, p*p*3) in (ph, pw, c) order, and the modules
carry the flax names (`conv1`, `class_embedding`, `positional_embedding`,
`resblock.<i>`, `ln_*`), so `gridmm_tpu_torch.convert` maps a flax tree onto
the tower mechanically. Parameters stay f32 and are cast to
`compute_dtype` where they are used; LayerNorm statistics are f32.

The LayerNorms and the attention dispatch by device (ops/layernorm.py,
ops/attention.py): on the card they are hand-written kernels, on the CPU
their plain versions. The projections and the MLP are `F.linear`, as the
JAX package leaves them to XLA, or int8 products under `int8_matmuls`
(`MaybeInt8Dense`, ops/quant.py).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from gridmm_tpu_torch.models.layers import Dense, Int8Dense
from gridmm_tpu_torch.ops.attention import attention_qkv
from gridmm_tpu_torch.ops.layernorm import layernorm


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    """The JAX config without its three TPU dispatch flags
    (`use_pallas_attention`, `use_pallas_ln`, `use_qkv_attention`): the port
    dispatches by device instead."""

    input_resolution: int = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    compute_dtype: str = "bfloat16"
    # serving: int8 products in the projections and the MLP (ops/quant.py)
    int8_matmuls: bool = False
    # plain path only: raw attention scores in f32 (True) or in
    # compute_dtype; the kernels always keep scores in f32 on chip
    attn_scores_f32: bool = True
    # timm-ViT variant knobs (vit_base_patch16_224, the CE view encoder):
    # biased conv patchify, no ln_pre, erf GELU. CLIP keeps the defaults.
    gelu: str = "quick"  # "quick" (CLIP) | "erf" (timm)
    ln_pre: bool = True
    conv_bias: bool = False

    @property
    def grid(self) -> int:
        return self.input_resolution // self.patch_size

    @property
    def num_tokens(self) -> int:
        return self.grid * self.grid + 1

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


def clip_b32() -> ClipVisionConfig:
    """ViT-B/32: the 7x7+1 = 50 grid tokens the grid memory consumes
    (map_nav_src/r2r/env.py:100)."""
    return ClipVisionConfig(patch_size=32)


def clip_b16() -> ClipVisionConfig:
    """ViT-B/16: 196+1 tokens (preprocess/get_map_feature.py:41-50)."""
    return ClipVisionConfig(patch_size=16)


def vit_b16_timm() -> ClipVisionConfig:
    """timm vit_base_patch16_224, the CE live view encoder whose cls token
    is the per-view feature (Policy_ViewSelection_GridMap.py:338)."""
    return ClipVisionConfig(patch_size=16, gelu="erf", ln_pre=False,
                            conv_bias=True)


class ClipLayerNorm(nn.Module):
    """f32-statistics LayerNorm, eps 1e-5 (model_clip.py:15-21); output in
    the input's type."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return layernorm(x, self.weight, self.bias, eps=1e-5)


def MaybeInt8Dense(in_features: int, out_features: int, use_int8: bool,
                   dtype: torch.dtype) -> Dense:
    """The JAX package's `MaybeInt8Dense` (clip_vit.py:120-138): the same
    parameters, with an int8 product when `use_int8` (`Int8Dense`, whose
    result keeps the input's dtype, so a bf16 tower stays bf16) and a
    product in `dtype` otherwise (`Dense`)."""
    return (Int8Dense if use_int8 else Dense)(in_features, out_features,
                                              dtype)


class ResidualAttentionBlock(nn.Module):
    """Pre-norm attention + MLP (model_clip.py:29-54)."""

    def __init__(self, cfg: ClipVisionConfig):
        super().__init__()
        self.cfg = cfg
        w, dt, i8 = cfg.width, cfg.dtype, cfg.int8_matmuls
        self.ln_1 = ClipLayerNorm(w)
        self.attn_in_proj = MaybeInt8Dense(w, 3 * w, i8, dt)
        self.attn_out_proj = MaybeInt8Dense(w, w, i8, dt)
        self.ln_2 = ClipLayerNorm(w)
        self.mlp_c_fc = MaybeInt8Dense(w, 4 * w, i8, dt)
        self.mlp_c_proj = MaybeInt8Dense(4 * w, w, i8, dt)

    def forward(self, x):
        c = self.cfg
        ctx = attention_qkv(self.attn_in_proj(self.ln_1(x)), c.heads,
                            c.attn_scores_f32)
        x = x + self.attn_out_proj(ctx)
        y = self.mlp_c_fc(self.ln_2(x))
        if c.gelu == "quick":
            y = y * torch.sigmoid(1.702 * y)  # QuickGELU (model_clip.py:24-26)
        else:
            y = F.gelu(y.float()).to(c.dtype)  # timm nn.GELU (erf)
        return x + self.mlp_c_proj(y)


class ClipVisionTransformer(nn.Module):
    """(B, H, W, 3) CLIP-normalized images -> all token hiddens
    (B, grid^2 + 1, width) in compute_dtype."""

    def __init__(self, cfg: ClipVisionConfig):
        super().__init__()
        self.cfg = cfg
        p, w = cfg.patch_size, cfg.width
        self.conv1 = Dense(p * p * 3, w, cfg.dtype, bias=cfg.conv_bias)
        self.class_embedding = nn.Parameter(torch.zeros(w))
        self.positional_embedding = nn.Parameter(
            torch.zeros(cfg.num_tokens, w))
        if cfg.ln_pre:
            self.ln_pre = ClipLayerNorm(w)
        self.resblock = nn.ModuleList(
            ResidualAttentionBlock(cfg) for _ in range(cfg.layers))
        self.ln_post = ClipLayerNorm(w)

    def forward(self, images):
        c = self.cfg
        dt = c.dtype
        b = images.shape[0]
        p, g = c.patch_size, c.grid
        # patchify: (B, g, p, g, p, 3) -> (B, g*g, p*p*3) in (ph, pw, c) order
        x = images.to(dt).reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5)
        x = self.conv1(x.reshape(b, g * g, p * p * 3))
        cls = self.class_embedding.to(dt).expand(b, 1, c.width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)
        if c.ln_pre:
            x = self.ln_pre(x)
        for block in self.resblock:
            x = block(x)
        return self.ln_post(x)


def init_clip_vision(cfg: ClipVisionConfig, seed: int = 0,
                     device="cuda") -> ClipVisionTransformer:
    """A tower with seeded random weights in the JAX package's scheme:
    dense kernels ~ N(0, 1/fan_in) (flax's lecun_normal, untruncated here),
    biases 0, class and positional embeddings ~ N(0, width^-1),
    LayerNorm 1 and 0."""
    model = ClipVisionTransformer(cfg)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Dense):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               / math.sqrt(m.in_features))
                if m.bias is not None:
                    m.bias.zero_()
        for prm in (model.class_embedding, model.positional_embedding):
            prm.copy_(torch.randn(prm.shape, generator=gen)
                      / math.sqrt(cfg.width))
    return model.to(device).eval()


# OpenAI CLIP normalization (preprocess/get_map_feature.py img_transforms)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
# timm vit_base_patch16_224 (resolve_data_config defaults used by the
# reference CE policy, gridmap/vilmodel.py:632-633)
TIMM_MEAN = (0.5, 0.5, 0.5)
TIMM_STD = (0.5, 0.5, 0.5)


def _normalize(images_uint8, mean, std):
    x = images_uint8.to(torch.float32) / 255.0
    dev = images_uint8.device
    return (x - torch.tensor(mean, device=dev)) / torch.tensor(std, device=dev)


def normalize_images(images_uint8):
    """(B, H, W, 3) uint8 -> CLIP-normalized float32."""
    return _normalize(images_uint8, CLIP_MEAN, CLIP_STD)


def normalize_images_timm(images_uint8):
    """(B, H, W, 3) uint8 -> timm-ViT-normalized float32."""
    return _normalize(images_uint8, TIMM_MEAN, TIMM_STD)

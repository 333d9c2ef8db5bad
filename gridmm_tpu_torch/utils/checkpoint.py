"""Checkpoint import (twin of part of gridmm_tpu/utils/checkpoint.py).

Only the OpenAI CLIP visual tower is ported so far; the navigator's released
key spaces, timm's ViT and the saver are later slices.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from gridmm_tpu_torch.models.clip_vit import ClipVisionTransformer


def _strip_prefixes(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Drop DDP 'module.' wrappers (agent_base.py:230-262, save.py:23-45)."""
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in state_dict.items()}


def import_torch_clip_visual(state_dict: Dict[str, Any],
                             model: ClipVisionTransformer
                             ) -> ClipVisionTransformer:
    """OpenAI CLIP 'visual.' tower -> the port's ClipVisionTransformer, in
    place; returns the model (gridmm_tpu/utils/checkpoint.py:800-845).

    conv1 (width, 3, p, p) becomes the patchify Linear, whose input is the
    (ph, pw, channel)-ordered patch. Keys the tower has no use for
    (`visual.proj`, the text tower) are left alone; a missing key raises.
    """
    sd = {k[len("visual."):]: v for k, v in _strip_prefixes(state_dict).items()
          if k.startswith("visual.")}
    width = model.cfg.width

    def t(key):
        return torch.as_tensor(sd[key]).detach().to(torch.float32)

    out = {
        "conv1.weight": t("conv1.weight").permute(0, 2, 3, 1).reshape(
            width, -1),
        "class_embedding": t("class_embedding"),
        "positional_embedding": t("positional_embedding"),
        "ln_pre.weight": t("ln_pre.weight"),
        "ln_pre.bias": t("ln_pre.bias"),
        "ln_post.weight": t("ln_post.weight"),
        "ln_post.bias": t("ln_post.bias"),
    }
    for i in range(model.cfg.layers):
        s, d = f"transformer.resblocks.{i}", f"resblock.{i}"
        out.update({
            f"{d}.attn_in_proj.weight": t(f"{s}.attn.in_proj_weight"),
            f"{d}.attn_in_proj.bias": t(f"{s}.attn.in_proj_bias"),
            f"{d}.attn_out_proj.weight": t(f"{s}.attn.out_proj.weight"),
            f"{d}.attn_out_proj.bias": t(f"{s}.attn.out_proj.bias"),
            f"{d}.mlp_c_fc.weight": t(f"{s}.mlp.c_fc.weight"),
            f"{d}.mlp_c_fc.bias": t(f"{s}.mlp.c_fc.bias"),
            f"{d}.mlp_c_proj.weight": t(f"{s}.mlp.c_proj.weight"),
            f"{d}.mlp_c_proj.bias": t(f"{s}.mlp.c_proj.bias"),
        })
        for ln in ("ln_1", "ln_2"):
            out[f"{d}.{ln}.weight"] = t(f"{s}.{ln}.weight")
            out[f"{d}.{ln}.bias"] = t(f"{s}.{ln}.bias")
    with torch.no_grad():
        model.load_state_dict(out, strict=True)
    return model

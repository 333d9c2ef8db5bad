"""Checkpoint persistence and import (twin of part of
gridmm_tpu/utils/checkpoint.py).

`save_checkpoint` / `AsyncSaver` / `restore_checkpoint` stand in for the JAX
package's orbax calls, with `torch.save` files written to a temporary name
and renamed into place. Of the importers only the OpenAI CLIP visual tower
is ported so far; the navigator's released key spaces and timm's ViT are
later slices.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional

import torch

from gridmm_tpu_torch.models.clip_vit import ClipVisionTransformer


def _host_copy(tree):
    """Tensors of a nested dict/list/tuple copied to host memory; anything
    else as it is."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree


def _write(path: str, host_state) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(host_state, tmp)
    os.replace(tmp, path)       # a reader never sees a half-written file


def save_checkpoint(path: str, state) -> None:
    """Write `state` (a state_dict, or any nested dict/list of tensors and
    plain values) to the file `path`, atomically."""
    _write(path, _host_copy(state))


class AsyncSaver:
    """Background checkpoint writes overlapping training compute.

    save() copies the tensors to host memory before it returns, so the
    caller may update them in place at once, and serializes and writes in a
    background thread that renames the file into place (the reference's
    torch.save blocks the step loop, agent_base.py:213-228). One write is
    outstanding at a time. wait() makes the last save durable and raises
    what the writer raised; close() at shutdown. The files are read by
    `restore_checkpoint`.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path: str, state) -> None:
        self.wait()
        host_state = _host_copy(state)

        def run():
            try:
                _write(path, host_state)
            except Exception as e:   # raised in the caller by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=False)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def restore_checkpoint(path: str, model: Optional[torch.nn.Module] = None):
    """Read a checkpoint file onto the host. With `model`, load it as that
    module's state_dict (strict) and return the module; else return the
    stored tree."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if model is None:
        return state
    model.load_state_dict(state, strict=True)
    return model


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

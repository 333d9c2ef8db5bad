"""JAX (flax) parameter tree -> the port's `state_dict`.

Input: nested dicts of numpy arrays, e.g. `jax.tree.map(np.asarray, params)`
(with or without the outer {"params": ...}). The port's modules carry the
flax names, so the mapping is mechanical:

  * a path component `name_<k>` is the ModuleList/Sequential entry `name.<k>`,
    except the CLIP block's `ln_1` and `ln_2`, which are plain names;
  * the f32 LayerNorm wrapper's inner `ln` level disappears;
  * Dense `kernel` (in, out) -> Linear `weight` (out, in), transposed;
  * Conv `kernel` (kh, kw, in, out), HWIO -> Conv2d `weight` (out, in, kh,
    kw), OIHW;
  * LayerNorm, GroupNorm and the ResNets' frozen BatchNorm `scale` ->
    `weight`; Embed `embedding` -> `weight`.

Every flax leaf must land on a parameter of the same shape and every
parameter must be covered; anything else raises.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_INDEXED = re.compile(r"^(.+)_(\d+)$")
# flax module names that end in a number but are not list entries
_NOT_INDEXED = {"ln_1", "ln_2"}


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def torch_name(path) -> str:
    """Flax parameter path (tuple of names) -> torch state_dict key."""
    *mods, leaf = path
    parts = []
    for m in mods:
        if m == "ln":
            continue
        hit = None if m in _NOT_INDEXED else _INDEXED.match(m)
        parts.extend(hit.groups() if hit else (m,))
    parts.append({"kernel": "weight", "scale": "weight",
                  "embedding": "weight"}.get(leaf, leaf))
    return ".".join(parts)


def kernel_to_torch(arr: np.ndarray) -> np.ndarray:
    """A flax kernel in the layout of the torch weight: Dense (in, out) ->
    (out, in); Conv HWIO -> OIHW."""
    return arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T


def kernel_to_flax(arr: np.ndarray) -> np.ndarray:
    """The inverse of `kernel_to_torch`."""
    return arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T


def flax_paths(model: torch.nn.Module) -> Dict[str, str]:
    """The inverse of `torch_name` on one module: {state_dict key: flax
    path} for every parameter, the path "/"-joined (a ModuleList entry
    `name.<k>` is `name_<k>`; a Linear weight is the (in, out) `kernel`, a
    LayerNorm of the port's its `ln/scale` and `ln/bias`, an Embedding
    weight its `embedding`, a Conv2d weight its `kernel`, a GroupNorm's or
    frozen BatchNorm's weight its `scale`)."""
    from gridmm_tpu_torch.models.layers import LayerNorm
    from gridmm_tpu_torch.models.resnet import FrozenBatchNorm

    out: Dict[str, str] = {}
    for mod_name, mod in model.named_modules():
        parts = []
        for part in mod_name.split(".") if mod_name else ():
            if part.isdigit():
                parts[-1] = f"{parts[-1]}_{part}"
            else:
                parts.append(part)
        for leaf, _ in mod.named_parameters(recurse=False):
            key = f"{mod_name}.{leaf}" if mod_name else leaf
            if isinstance(mod, LayerNorm):
                path = parts + ["ln", {"weight": "scale"}.get(leaf, leaf)]
            elif isinstance(mod, torch.nn.Embedding):
                path = parts + ["embedding"]
            elif isinstance(mod, (torch.nn.Linear, torch.nn.Conv2d)) \
                    and leaf == "weight":
                path = parts + ["kernel"]
            elif isinstance(mod, (torch.nn.GroupNorm, FrozenBatchNorm)) \
                    and leaf == "weight":
                path = parts + ["scale"]
            else:
                path = parts + [leaf]
            out[key] = "/".join(path)
    return out


def flax_to_state_dict(params: Mapping, model: torch.nn.Module
                       ) -> Dict[str, torch.Tensor]:
    """Converted tensors for `model.load_state_dict`; raises on any
    unmatched or leftover key, in both directions, and on shape mismatch."""
    if set(params) == {"params"}:
        params = params["params"]
    want = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    unmatched = []
    for path, value in _flatten(params):
        name = torch_name(path)
        if name not in want:
            unmatched.append("/".join(path))
            continue
        arr = np.asarray(value, dtype=np.float32)
        if path[-1] == "kernel":
            arr = kernel_to_torch(arr)
        if tuple(arr.shape) != tuple(want[name].shape):
            raise ValueError(f"{'/'.join(path)} -> {name}: shape "
                             f"{arr.shape} != {tuple(want[name].shape)}")
        out[name] = torch.tensor(arr)
    missing = sorted(set(want) - set(out))
    if unmatched or missing:
        raise KeyError(f"flax leaves without a torch parameter: {unmatched}; "
                       f"torch parameters without a flax leaf: {missing}")
    return out


def load_flax_params(model: torch.nn.Module, params: Mapping
                     ) -> torch.nn.Module:
    """Copy a flax tree into `model` (strict both ways); returns model."""
    sd = flax_to_state_dict(params, model)
    with torch.no_grad():
        model.load_state_dict(sd, strict=True)
    return model


def to_flax_tree(tensors: Mapping[str, torch.Tensor], template: Mapping
                 ) -> Dict:
    """The reverse of `flax_to_state_dict`, for gradients and updated
    parameters: `tensors` maps torch parameter names to tensors (e.g.
    `{n: p.grad for n, p in model.named_parameters()}`); the result has the
    paths and layouts of the flax tree `template` ((in, out) kernels), as
    nested dicts of numpy arrays. A tensor that is None comes back as zeros
    (a parameter the loss did not reach)."""
    if set(template) == {"params"}:
        return {"params": to_flax_tree(tensors, template["params"])}
    out: Dict = {}
    for path, like in _flatten(template):
        t = tensors[torch_name(path)]
        if t is None:
            arr = np.zeros(np.shape(like), np.float32)
        else:
            arr = t.detach().cpu().numpy()
            if path[-1] == "kernel":
                arr = kernel_to_flax(arr)
        if tuple(arr.shape) != tuple(np.shape(like)):
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape} != "
                             f"{tuple(np.shape(like))}")
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return out

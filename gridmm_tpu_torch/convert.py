"""JAX (flax) parameter tree -> the port's `state_dict`.

Input: nested dicts of numpy arrays, e.g. `jax.tree.map(np.asarray, params)`
(with or without the outer {"params": ...}). The port's modules carry the
flax names, so the mapping is mechanical:

  * a path component `name_<k>` is the ModuleList/Sequential entry `name.<k>`,
    except the CLIP block's `ln_1` and `ln_2`, which are plain names;
  * the f32 LayerNorm wrapper's inner `ln` level disappears;
  * Dense `kernel` (in, out) -> Linear `weight` (out, in), transposed;
  * LayerNorm `scale` -> `weight`; Embed `embedding` -> `weight`.

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
            arr = arr.T
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

"""Entry points of the port (twin of __graft_entry__.py).

    python -m gridmm_tpu_torch.entry [--device cpu]

entry()             -> (fn, example_args): the flagship forward, the
                       language encode followed by the navigation forward,
                       returning the fused logits, at r2r_config() widths
                       with a 1176-point buffer and batch 2. Its compile
                       check is `compile_check`: `torch.export.export` of
                       fn (the JAX package jits it), which K1's custom op
                       allows through its fake body.
dryrun_multichip(n) -> one sharded training step on n gloo ranks of the
                       CPU (parallel/dryrun.py).

The JAX fn takes the parameters as its first argument; here fn is a module
that holds them, as torch.export wants.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch
from torch import nn

from gridmm_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: F401


class FlagshipForward(nn.Module):
    """fn(txt_ids, txt_mask, nav_batch) -> fused_logits (B, G)."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, txt_ids, txt_mask, nav_batch):
        txt = self.model("language", {"txt_ids": txt_ids,
                                      "txt_mask": txt_mask})
        out = self.model("navigation", dict(nav_batch, txt_embeds=txt,
                                            txt_mask=txt_mask))
        return out.fused_logits


def entry(device: str = "cuda", cfg=None, model=None, batch: int = 2,
          seed: int = 0):
    """(fn, (txt_ids, txt_mask, nav_batch)): the flagship forward over
    `model` (default: seed-`seed` weights at cfg's widths; cfg defaults to
    r2r_config() with max_points 1176, the JAX entry's moderate shapes) and
    zero-filled example arguments at the static caps (dummy_batches)."""
    from gridmm_tpu_torch.config import r2r_config
    from gridmm_tpu_torch.models.navigator import (dummy_batches,
                                                   init_navigator)
    from gridmm_tpu_torch.utils import device as D

    dev = D.resolve(device)
    if cfg is None:
        cfg = r2r_config()
        cfg = dataclasses.replace(
            cfg, shapes=dataclasses.replace(cfg.shapes, max_points=1176))
    if model is None:
        model = init_navigator(cfg.model, seed=seed, device=dev)
    txt_ids, txt_mask, _, nav_batch = dummy_batches(cfg.shapes, cfg.model,
                                                    batch=batch, device=dev)
    return FlagshipForward(model.to(dev).eval()), (txt_ids, txt_mask,
                                                   nav_batch)


def compile_check(fn, args):
    """The single-device compile check: `torch.export.export(fn, args)`
    under no_grad; returns the ExportedProgram."""
    with torch.no_grad():
        return torch.export.export(fn, args)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    fn, example = entry(args.device)
    with torch.no_grad():
        eager = fn(*example)
        program = compile_check(fn, example)
        exported = program.module()(*example)
    fin = torch.isfinite(eager)
    if not torch.equal(fin, torch.isfinite(exported)):
        raise AssertionError("exported logits are finite elsewhere")
    diff = (exported[fin] - eager[fin]).abs().max().item() if fin.any() \
        else 0.0
    print(f"entry() fused_logits: {tuple(eager.shape)}, exported program "
          f"max|diff| {diff:.3e}")
    return {"shape": tuple(eager.shape), "max_abs_diff": diff}


if __name__ == "__main__":
    main()

"""Drive the port through its public surface: a simulated 3-step
navigation episode (twin of scripts/drive_episode.py).

    python -m gridmm_tpu_torch.cli.drive_episode                   # the card
    python -m gridmm_tpu_torch.cli.drive_episode --device cpu [--tiny]

At `r2r_config()` with B = 2 and seeded random weights: the language
encode once, then per step the point-buffer append (append_panorama), the
egocentric grid assignment, the panorama encode and the navigation forward
(K1 on the card) to the action logits. Prints the parameter count
(~161M), each step's point count, occupied cells and finite-logit count,
then probes an all-invalid grid (step 0 with zero depth must not give
NaN) and prints EPISODE OK. The inputs are drawn from numpy seed 0 in the
JAX script's order (`episode_inputs`), so at r2r widths they are its
inputs.

Valid unvisited gmap slots (2..5; slots 0 and 1 are marked visited) must
have finite fused logits and every other slot -inf: the reference's
masked_fill semantics.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

B, STEPS, GMAP, VIEWS = 2, 3, 16, 38


def episode_inputs(cfg, seed: int = 0, steps: int = STEPS):
    """(txt_ids (B, T) int32, txt_mask (B, T) bool, [per step: dict of numpy
    arrays]) drawn from numpy seed `seed` in scripts/drive_episode.py's
    order, at cfg's widths."""
    rng = np.random.default_rng(seed)
    m, gc = cfg.model, cfg.grid
    t, d, h, a = (cfg.shapes.max_txt_len, m.image_feat_size, m.hidden_size,
                  m.angle_feat_size + 3)
    f32 = np.float32
    txt_ids = rng.integers(1, 30000, (B, t)).astype(np.int32)
    txt_mask = np.arange(t)[None] < np.asarray([12, 9])[:, None]
    rows = []
    for _ in range(steps):
        rows.append(dict(
            depth=rng.integers(0, 18000, (B, gc.num_views,
                                          gc.patches_per_view)).astype(f32),
            patch_fts=rng.standard_normal(
                (B, gc.points_per_step, d)).astype(f32) * f32(0.4),
            pos=rng.uniform(-4, 4, (B, 2)).astype(f32),
            heading=rng.uniform(-3, 3, (B,)).astype(f32),
            view_img_fts=rng.standard_normal((B, VIEWS, d)).astype(f32),
            loc_fts=rng.standard_normal((B, VIEWS, a)).astype(f32),
            nav_types=rng.integers(0, 2, (B, VIEWS)).astype(np.int32),
            gmap_img_embeds=rng.standard_normal((B, GMAP, h)).astype(f32),
            gmap_step_ids=rng.integers(0, 5, (B, GMAP)).astype(np.int32),
            gmap_pos_fts=rng.standard_normal((B, GMAP, a)).astype(f32),
            vp_pos_fts=rng.standard_normal((B, VIEWS + 1,
                                            2 * a)).astype(f32)))
    return txt_ids, txt_mask, rows


def run(model=None, cfg=None, device: str = "cuda", tiny: bool = False,
        seed: int = 0) -> dict:
    """The episode on `model` (default: a seeded navigator at cfg's widths,
    r2r_config() or with `tiny` tiny_config()). Returns {"params",
    "steps": [per step: points, cells occupied, the NavOutputs' logits
    (numpy)], "empty": the probe's fused logits}; raises where a check
    fails."""
    from gridmm_tpu_torch.config import r2r_config, tiny_config
    from gridmm_tpu_torch.models.navigator import init_navigator
    from gridmm_tpu_torch.ops import geometry as G
    from gridmm_tpu_torch.utils import device as D

    dev = D.resolve(device)
    print(f"package: gridmm_tpu_torch | device: {D.name(dev)}")
    if cfg is None:
        cfg = tiny_config() if tiny else r2r_config()
    if model is None:
        model = init_navigator(cfg.model, seed=seed, device=dev)
    model = model.to(dev).eval()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"navigator params: {n_params / 1e6:.1f}M")
    txt_ids, txt_mask, rows = episode_inputs(cfg, seed)
    h = cfg.model.hidden_size

    def put(a):
        return torch.as_tensor(a, device=dev)

    gm = torch.arange(GMAP, device=dev)[None].expand(B, GMAP)
    vm = torch.arange(VIEWS + 1, device=dev)[None].expand(B, VIEWS + 1)
    out = {"params": n_params, "steps": []}
    with torch.inference_mode():
        mask = put(txt_mask)
        txt = model("language", {"txt_ids": put(txt_ids), "txt_mask": mask})
        print("language out:", tuple(txt.shape))
        state = G.PointCloudState.create(B, cfg.grid, cfg.shapes.max_points,
                                         device=dev)
        for t, r in enumerate(rows):
            pos, heading = put(r["pos"]), put(r["heading"])
            state = G.append_panorama(state, put(r["depth"]),
                                      put(r["patch_fts"]), pos, cfg.grid)
            cells, _, grid_pos = G.egocentric_grid_assignment(
                state, pos, heading, cfg.grid)
            pano, _ = model("panorama", {
                "view_img_fts": put(r["view_img_fts"]),
                "loc_fts": put(r["loc_fts"]),
                "nav_types": put(r["nav_types"]),
                "view_mask": torch.ones((B, VIEWS), dtype=torch.bool,
                                        device=dev)})
            nav = model("navigation", {
                "txt_embeds": txt, "txt_mask": mask,
                "gmap_img_embeds": put(r["gmap_img_embeds"]),
                "gmap_step_ids": put(r["gmap_step_ids"]),
                "gmap_pos_fts": put(r["gmap_pos_fts"]),
                "gmap_mask": gm < 6, "gmap_visited_mask": gm < 2,
                "vp_img_embeds": torch.cat(
                    [torch.zeros((B, 1, h), device=dev), pano], 1),
                "vp_pos_fts": put(r["vp_pos_fts"]),
                "vp_mask": torch.ones((B, VIEWS + 1), dtype=torch.bool,
                                      device=dev),
                "vp_nav_mask": vm < 8,
                "grid_fts": state.features, "grid_cells": cells,
                "gridmap_pos_fts": grid_pos,
                "fused_add_idx": torch.full((B, GMAP), -2, dtype=torch.int32,
                                            device=dev),
                "cand_backtrack_mask": torch.zeros((B, VIEWS + 1),
                                                   dtype=torch.bool,
                                                   device=dev)})
            fl = nav.fused_logits
            step = {"points": int(state.count[0]),
                    "cells_occupied": int((cells[0] >= 0).sum()),
                    "cells": cells.cpu().numpy(),
                    **{f: getattr(nav, f).float().cpu().numpy() for f in
                       ("fused_logits", "global_logits", "local_logits")}}
            out["steps"].append(step)
            print(f"step {t}: points={step['points']} "
                  f"cells_occupied={step['cells_occupied']} fused_logits "
                  f"finite={int(torch.isfinite(fl).sum())}/{fl.numel()} "
                  f"argmax={fl.argmax(-1).cpu().numpy()}")
        if not torch.isfinite(fl[:, 2:6]).all():
            raise AssertionError("unvisited slots must be finite")
        if torch.isfinite(fl[:, 6:]).any():
            raise AssertionError("masked slots must be -inf")
        if torch.isnan(fl).any():
            raise AssertionError("no NaNs")

        # probe: an all-invalid grid (step 0 with zero depth) must not NaN
        empty = G.PointCloudState.create(B, cfg.grid, cfg.shapes.max_points,
                                         device=dev)
        cells0 = torch.full((B, cfg.shapes.max_points), -1,
                            dtype=torch.int32, device=dev)
        out0 = model("navigation", {
            "txt_embeds": txt, "txt_mask": mask,
            "gmap_img_embeds": torch.zeros((B, GMAP, h), device=dev),
            "gmap_step_ids": torch.zeros((B, GMAP), dtype=torch.int32,
                                         device=dev),
            "gmap_pos_fts": torch.zeros((B, GMAP, rows[0]["gmap_pos_fts"]
                                         .shape[-1]), device=dev),
            "gmap_mask": gm < 2,
            "gmap_visited_mask": torch.zeros((B, GMAP), dtype=torch.bool,
                                             device=dev),
            "vp_img_embeds": torch.zeros((B, VIEWS + 1, h), device=dev),
            "vp_pos_fts": torch.zeros((B, VIEWS + 1, rows[0]["vp_pos_fts"]
                                       .shape[-1]), device=dev),
            "vp_mask": torch.ones((B, VIEWS + 1), dtype=torch.bool,
                                  device=dev),
            "vp_nav_mask": vm < 3,
            "grid_fts": empty.features, "grid_cells": cells0,
            "gridmap_pos_fts": grid_pos,
            "fused_add_idx": torch.full((B, GMAP), -2, dtype=torch.int32,
                                        device=dev),
            "cand_backtrack_mask": torch.zeros((B, VIEWS + 1),
                                               dtype=torch.bool,
                                               device=dev)})
        if not torch.isfinite(out0.fused_logits[:, :2]).all():
            raise AssertionError("empty grid must stay finite")
        out["empty"] = out0.fused_logits.float().cpu().numpy()
    print("EMPTY-GRID PROBE OK")
    print("EPISODE OK")
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true",
                   help="tiny_config() widths")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    return run(device=args.device, tiny=args.tiny)


if __name__ == "__main__":
    main()

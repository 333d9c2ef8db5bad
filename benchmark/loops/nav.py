"""What the navigator's loops share: the port's configuration built from a
configuration file, seeded weights on the device, the synthetic episode
steps, and the fixed mixes of episode and instruction lengths."""

from __future__ import annotations

import numpy as np

from benchmark import harness


def port_config(conf: dict):
    """The port's GridMMConfig from a configuration file's sections."""
    from gridmm_tpu_torch.config import (GridConfig, GridMMConfig,
                                         ModelConfig, NavigatorShapes,
                                         TrainConfig)

    def make(cls, d):
        d = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
        return cls(**d)

    return GridMMConfig(model=make(ModelConfig, conf["model"]),
                        grid=make(GridConfig, conf["grid"]),
                        shapes=make(NavigatorShapes, conf["shapes"]),
                        train=make(TrainConfig, conf["train"]))


def nav_init(model, std: float):
    """The navigator's scheme (layers.init_weights): kernels and embeddings
    N(0, std), biases 0, LayerNorm 1 and 0."""
    ln = {name for name, mod in model.named_modules()
          if type(mod).__name__.endswith("LayerNorm")}

    def init(name, _t):
        owner, _, leaf = name.rpartition(".")
        if owner in ln:
            return ("ones",) if leaf == "weight" else ("zeros",)
        if leaf == "bias":
            return ("zeros",)
        return ("normal", std)

    return init


def navigator(cfg, seed: int, device):
    """The port's navigator on `device` with weights made there from
    `seed`, in eval mode; returns (model, state dict)."""
    import torch

    from gridmm_tpu_torch.models.navigator import GridMMNavigator

    with torch.device("meta"):
        model = GridMMNavigator(cfg.model)
    sd = harness.seeded_weights(model, seed, device,
                                nav_init(model, cfg.model.initializer_range))
    model.load_state_dict(sd, assign=True)
    return model.eval(), sd


def reference_navigator(conf: dict, sd: dict):
    """The plain reference navigator holding the tensors of `sd`, in eval
    mode."""
    import torch

    from benchmark.reference import navigator as R

    with torch.device("meta"):
        ref = R.Navigator(R.namespace(conf).model)
    ref.load_state_dict(sd, assign=True, strict=True)
    return ref.eval()


def length_pool(parts, count: int) -> np.ndarray:
    """`count` lengths in the shares of `parts` ([{share, min, max}]), each
    part spread evenly over its range: the same multiset for every seed."""
    out = []
    for i, p in enumerate(parts):
        n = (count - len(out) if i == len(parts) - 1
             else int(round(p["share"] * count)))
        span = np.arange(p["min"], p["max"] + 1)
        out.extend(span[(np.arange(n) * len(span)) // max(n, 1)])
    return np.asarray(out, np.int64)


def even_pool(lo: int, hi: int, count: int) -> np.ndarray:
    return lo + (np.arange(count) * (hi - lo + 1)) // count


def step_bank(cfg, rng, steps: int, variants: int, features: bool = True):
    """Synthetic StepInputs rows for step t = 0..steps-1, `variants` each
    (row t * variants + k), numpy, each field (R, 1, ...): slot t+1
    the current node, slots 1..t+1 visited, three frontier slots after it
    (one per candidate view) and one backtrack candidate; depth in
    MatterSim counts with ~10% zero patches; the rest normal. Without
    `features`, the two feature fields (view and patch) are None."""
    m, sh, gc = cfg.model, cfg.shapes, cfg.grid
    g, v, a, d = (sh.max_gmap_len, sh.max_vp_len, m.angle_feat_size,
                  m.image_feat_size)
    r = steps * variants
    shape = (r, 1)
    t = np.repeat(np.arange(steps), variants).reshape(r, 1)
    f32, i32 = np.float32, np.int32
    cur = np.minimum(t + 1, g - 4)
    gi, vi = np.arange(g), np.arange(v)
    gmap_mask = gi < cur[..., None] + 4
    visited = (gi >= 1) & (gi <= cur[..., None])
    cand = np.full(shape + (v - 1,), -1, i32)
    cand[..., :3] = cur[..., None] + 1 + np.arange(3)
    cand[..., 3] = np.where(cur > 1, cur - 1, -1)
    vp_nav = np.broadcast_to(vi < 5, shape + (v,)).copy()
    fused = np.full(shape + (g,), -2, i32)
    off = gi - cur[..., None]
    fused = np.where((off >= 1) & (off <= 3), off, fused).astype(i32)
    back = np.zeros(shape + (v,), bool)
    back[..., 4] = cur > 1
    depth = rng.uniform(2000, 20000, size=shape + (gc.num_views,
                                                   gc.patches_per_view))
    depth[rng.random(depth.shape) < 0.1] = 0.0
    n_view = rng.integers(8, v, size=shape)
    nrm = (lambda *s: rng.standard_normal(shape + s, dtype=f32))
    from gridmm_tpu_torch.train.step import StepInputs

    return StepInputs(
        view_img_fts=nrm(v - 1, d) if features else None,
        loc_fts=nrm(v - 1, a + 3),
        nav_types=rng.integers(0, 3, size=shape + (v - 1,)).astype(i32),
        view_mask=np.arange(v - 1) < n_view[..., None],
        depth=depth.astype(f32),
        patch_fts=nrm(gc.points_per_step, d) if features else None,
        pos_xy=(rng.uniform(-1, 1, size=shape + (2,))
                + 0.5 * t[..., None]).astype(f32),
        heading=rng.uniform(-np.pi, np.pi, size=shape).astype(f32),
        gmap_step_ids=np.broadcast_to(np.minimum(gi, t[..., None] + 1),
                                      shape + (g,)).astype(i32),
        gmap_pos_fts=nrm(g, a + 3),
        gmap_mask=np.broadcast_to(gmap_mask, shape + (g,)).copy(),
        gmap_visited_mask=np.broadcast_to(visited, shape + (g,)).copy(),
        cur_node_idx=np.broadcast_to(cur, shape).astype(i32),
        cand_gmap_idx=cand, vp_pos_fts=nrm(v, 2 * a + 6),
        vp_nav_mask=vp_nav, fused_add_idx=fused,
        cand_backtrack_mask=back,
        target=np.zeros(shape, i32), grid_target=np.zeros(shape, i32),
        vp_obj_mask=np.zeros(shape + (v,), bool),
        obj_target=np.zeros(shape, i32))


def valid_points(bank) -> np.ndarray:
    """Points with nonzero depth in each bank row."""
    d = bank.depth
    return (d > 0).reshape(d.shape[0], -1).sum(axis=1)


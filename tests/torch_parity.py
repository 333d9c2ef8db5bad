"""Shared helpers of the port's CPU parity tests (tests/test_torch_*.py).

Both packages get the same numpy-seeded inputs and the same weights: the JAX
navigator is initialised with flax, and its tree is carried into the port by
gridmm_tpu_torch.convert.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import torch  # noqa: E402

import gridmm_tpu.config as JC  # noqa: E402
import gridmm_tpu_torch.config as TC  # noqa: E402

# The parity tests run tiny shapes in several pytest workers at once: more
# than one intra-op thread per worker only makes them wait on each other
# (the training tests run four times longer with the default pool).
torch.set_num_threads(1)

# the fields the port drops: it dispatches by device instead
DROPPED_MODEL_FIELDS = {"use_pallas_attention", "use_pallas_grid_pool"}


def port_config(jcfg):
    """The port's GridMMConfig with the same values as a JAX one."""
    def conv(obj, cls, drop=()):
        vals = {f.name: getattr(obj, f.name)
                for f in dataclasses.fields(obj) if f.name not in drop}
        return cls(**vals)

    return TC.GridMMConfig(
        model=conv(jcfg.model, TC.ModelConfig, DROPPED_MODEL_FIELDS),
        grid=conv(jcfg.grid, TC.GridConfig),
        shapes=conv(jcfg.shapes, TC.NavigatorShapes),
        mesh=conv(jcfg.mesh, TC.MeshConfig),
        train=conv(jcfg.train, TC.TrainConfig))


def jax_navigator(jcfg, seed=0):
    """(flax module, params) with every mode's parameters materialized."""
    from gridmm_tpu.models.navigator import GridMMNavigator, init_navigator

    model = GridMMNavigator(jcfg.model)
    params = init_navigator(model, jcfg.shapes, jax.random.PRNGKey(seed))
    return model, params


def port_navigator(tcfg, params):
    """The port's navigator on the CPU carrying the flax weights."""
    from gridmm_tpu_torch.convert import load_flax_params
    from gridmm_tpu_torch.models.navigator import GridMMNavigator

    model = GridMMNavigator(tcfg.model)
    load_flax_params(model, jax.tree.map(np.asarray, params))
    return model.eval()


def to_torch(tree):
    """numpy (nested dict / NamedTuple / array) -> torch CPU tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_torch(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_torch(v) for v in tree)
    if tree is None:
        return None
    return torch.from_numpy(np.array(tree))


def to_numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def assert_close(got, want, rtol=1e-5, atol=1e-5, msg=""):
    """f32 comparison; -inf entries must match position for position."""
    got, want = to_numpy(got), to_numpy(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=msg)
    np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=msg)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol,
                               err_msg=msg)


def nav_batch(cfg, rng, b=3, staggered_cells=True):
    """A random "navigation" batch (numpy) with consistent masks and index
    maps. staggered_cells: item k only uses cells < 196 - 40k, so items
    occupy different cell counts and the compaction stray keys fire."""
    m, sh = cfg.model, cfg.shapes
    t, g, v, n = sh.max_txt_len, sh.max_gmap_len, sh.max_vp_len, 600
    h, a = m.hidden_size, m.angle_feat_size
    f32 = np.float32
    txt_len = rng.integers(t // 2, t + 1, size=b)
    g_len = rng.integers(3, g + 1, size=b)
    v_len = rng.integers(4, v + 1, size=b)
    gmap_mask = np.arange(g)[None] < g_len[:, None]
    visited = (rng.random((b, g)) < 0.4) & gmap_mask
    visited[:, 0] = False
    vp_mask = np.arange(v)[None] < v_len[:, None]
    vp_nav = (rng.random((b, v)) < 0.6) & vp_mask
    vp_nav[:, 0] = True
    cells = np.stack([rng.integers(0, 196 - (40 * k if staggered_cells
                                            else 0), size=n)
                      for k in range(b)]).astype(np.int32)
    cells[rng.random((b, n)) < 0.2] = -1
    batch = {
        "txt_embeds": rng.standard_normal((b, t, h)).astype(f32),
        "txt_mask": np.arange(t)[None] < txt_len[:, None],
        "gmap_img_embeds": rng.standard_normal((b, g, h)).astype(f32),
        "gmap_step_ids": rng.integers(0, 10, size=(b, g)).astype(np.int32),
        "gmap_pos_fts": rng.standard_normal((b, g, a + 3)).astype(f32),
        "gmap_mask": gmap_mask,
        "gmap_visited_mask": visited,
        "vp_img_embeds": rng.standard_normal((b, v, h)).astype(f32),
        "vp_pos_fts": rng.standard_normal((b, v, 2 * a + 6)).astype(f32),
        "vp_mask": vp_mask,
        "vp_nav_mask": vp_nav,
        "grid_fts": rng.standard_normal(
            (b, n, m.image_feat_size)).astype(f32),
        "grid_cells": cells,
        "gridmap_pos_fts": rng.standard_normal((b, 196, 5)).astype(f32),
        "fused_add_idx": rng.integers(-2, v, size=(b, g)).astype(np.int32),
        "cand_backtrack_mask": rng.random((b, v)) < 0.3,
    }
    if m.obj_feat_size > 0:
        batch["vp_obj_mask"] = (rng.random((b, v)) < 0.3) & vp_mask
    return batch


def step_rows(cfg, rng, t, b=1):
    """Random StepInputs (numpy, leading dim b) for step t of an episode:
    gmap slot t+1 is the current node, slots 1..t+1 are visited, a few
    frontier slots follow; depth has ~10% zero (invalid) patches."""
    from gridmm_tpu.train.step import StepInputs

    m, sh, gc = cfg.model, cfg.shapes, cfg.grid
    g, v, a, d = sh.max_gmap_len, sh.max_vp_len, m.angle_feat_size, \
        m.image_feat_size
    f32, i32 = np.float32, np.int32
    cur = min(t + 1, g - 2)
    n_front = int(min(3, g - cur - 1))
    g_len = cur + 1 + n_front
    gmap_mask = np.zeros((b, g), bool)
    gmap_mask[:, :g_len] = True
    visited = np.zeros((b, g), bool)
    visited[:, 1:cur + 1] = True
    n_view = int(rng.integers(6, v))
    view_mask = np.arange(v - 1)[None].repeat(b, 0) < n_view
    cand = np.full((b, v - 1), -1, i32)
    cand[:, :n_front] = np.arange(cur + 1, cur + 1 + n_front)
    if cur > 1:
        cand[:, n_front] = cur - 1           # a visited (backtrack) node
    vp_nav = np.zeros((b, v), bool)
    vp_nav[:, 0] = True
    vp_nav[:, 1:2 + n_front] = True
    fused_add = np.full((b, g), -2, i32)
    fused_add[:, cur + 1:g_len] = np.arange(1, 1 + n_front)
    backtrack = np.zeros((b, v), bool)
    backtrack[:, 1 + n_front] = cur > 1
    depth = rng.uniform(2000, 20000, size=(b, gc.num_views,
                                           gc.patches_per_view)).astype(f32)
    depth[rng.random(depth.shape) < 0.1] = 0.0
    return StepInputs(
        view_img_fts=rng.standard_normal((b, v - 1, d)).astype(f32),
        loc_fts=rng.standard_normal((b, v - 1, a + 3)).astype(f32),
        nav_types=rng.integers(0, 3, size=(b, v - 1)).astype(i32),
        view_mask=view_mask,
        depth=depth,
        patch_fts=rng.standard_normal(
            (b, gc.points_per_step, d)).astype(f32),
        pos_xy=rng.uniform(-5, 5, size=(b, 2)).astype(f32),
        heading=rng.uniform(-np.pi, np.pi, size=(b,)).astype(f32),
        gmap_step_ids=np.minimum(np.arange(g), t + 1)[None].repeat(
            b, 0).astype(i32),
        gmap_pos_fts=rng.standard_normal((b, g, a + 3)).astype(f32),
        gmap_mask=gmap_mask,
        gmap_visited_mask=visited,
        cur_node_idx=np.full((b,), cur, i32),
        cand_gmap_idx=cand,
        vp_pos_fts=rng.standard_normal((b, v, 2 * a + 6)).astype(f32),
        vp_nav_mask=vp_nav,
        fused_add_idx=fused_add,
        cand_backtrack_mask=backtrack,
        target=np.zeros((b,), i32),
        grid_target=np.zeros((b,), i32),
        vp_obj_mask=np.zeros((b, v), bool),
        obj_target=np.zeros((b,), i32),
    )


# the fields the port's ClipVisionConfig drops, for the same reason
DROPPED_CLIP_FIELDS = {"use_pallas_attention", "use_pallas_ln",
                       "use_qkv_attention"}


def port_clip_config(jcfg):
    """The port's ClipVisionConfig with the values of a JAX one."""
    from gridmm_tpu_torch.models.clip_vit import ClipVisionConfig

    return ClipVisionConfig(**{
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
        if f.name not in DROPPED_CLIP_FIELDS})


def openai_visual_state_dict(width=64, layers=2, patch=8, res=56, seed=0):
    """A numpy-made state dict in the OpenAI CLIP checkpoint's key layout:
    the visual tower's keys plus the projection and one text-tower key the
    importer must leave alone, under DDP's 'module.' prefix for one key."""
    rng = np.random.default_rng(seed)
    tokens = (res // patch) ** 2 + 1

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * 0.1)

    sd = {"visual.conv1.weight": arr(width, 3, patch, patch),
          "visual.class_embedding": arr(width),
          "visual.positional_embedding": arr(tokens, width),
          "visual.ln_pre.weight": 1.0 + arr(width),
          "visual.ln_pre.bias": arr(width),
          "module.visual.ln_post.weight": 1.0 + arr(width),
          "visual.ln_post.bias": arr(width),
          "visual.proj": arr(width, 32),
          "token_embedding.weight": arr(10, 32)}
    for i in range(layers):
        s = f"visual.transformer.resblocks.{i}"
        sd.update({f"{s}.attn.in_proj_weight": arr(3 * width, width),
                   f"{s}.attn.in_proj_bias": arr(3 * width),
                   f"{s}.attn.out_proj.weight": arr(width, width),
                   f"{s}.attn.out_proj.bias": arr(width),
                   f"{s}.ln_1.weight": 1.0 + arr(width),
                   f"{s}.ln_1.bias": arr(width),
                   f"{s}.mlp.c_fc.weight": arr(4 * width, width),
                   f"{s}.mlp.c_fc.bias": arr(4 * width),
                   f"{s}.mlp.c_proj.weight": arr(width, 4 * width),
                   f"{s}.mlp.c_proj.bias": arr(width),
                   f"{s}.ln_2.weight": 1.0 + arr(width),
                   f"{s}.ln_2.bias": arr(width)})
    return sd


def jax_tiny_ce_config(preset="r2r"):
    """The JAX factory's tiny VLN-CE config (gridmm_tpu/ce/factory.py,
    tiny=True)."""
    base = JC.rxr_ce_config() if preset == "rxr" else JC.r2r_ce_config()
    return dataclasses.replace(
        base,
        model=JC.ModelConfig(
            vocab_size=30522, hidden_size=64, num_attention_heads=4,
            intermediate_size=128, num_l_layers=1, num_x_layers=1,
            num_pano_layers=1, image_feat_size=64,
            max_position_embeddings=32),
        grid=dataclasses.replace(base.grid, feature_dim=64, max_steps=4),
        shapes=JC.NavigatorShapes(max_txt_len=16, max_gmap_len=16,
                                  max_vp_len=20, max_points=4 * 588),
        train=JC.TrainConfig(max_action_len=4, loss_norm="actions"),
    )


def port_ce_agent(jagent, tcfg=None):
    """The port's CEAgent on the CPU carrying every weight of a JAX
    CEAgent (navigator, waypoint predictor, both towers, CLIP and the view
    tower), converted by gridmm_tpu_torch.convert. `tcfg` overrides the
    port config (default: port_config(jagent.cfg))."""
    import gridmm_tpu.ce.encoders as JE
    import gridmm_tpu_torch.ce.encoders as TE
    import gridmm_tpu_torch.models.resnet as TR
    from gridmm_tpu_torch.ce.agent import CEAgent
    from gridmm_tpu_torch.convert import load_flax_params
    from gridmm_tpu_torch.models.clip_vit import ClipVisionTransformer
    from gridmm_tpu_torch.models.waypoint import (WaypointConfig,
                                                  WaypointPredictor)

    tcfg = tcfg or port_config(jagent.cfg)

    def load(module, params):
        return load_flax_params(module, jax.tree.map(np.asarray, params)
                                ).eval()

    jw = jagent.waypoint.cfg
    wp_fields = {f.name: getattr(jw, f.name) for f in dataclasses.fields(jw)}
    if jw.use_rgb:  # the flax Dense infers its input width
        wp_fields["rgb_feat_dim"] = int(np.shape(
            jagent.wp_params["params"]["visual_fc_rgb"]["kernel"])[0])
    waypoint = load(WaypointPredictor(WaypointConfig(**wp_fields)),
                    jagent.wp_params)
    if isinstance(jagent.rgb_tower, JE.RgbTower):
        rgb = TE.RgbTower(jagent.rgb_tower.out_ch, jagent.rgb_tower.grid)
        depth = TE.DepthTower(jagent.depth_tower.out_ch)
    else:
        rgb = TR.RgbResNet50Tower()
        depth = TR.DdppoDepthEncoder()
    view = None
    if jagent.view_encoder is not None:
        view = load(ClipVisionTransformer(port_clip_config(
            jagent.view_encoder.cfg)), jagent.view_params)
    return CEAgent(
        tcfg, port_navigator(tcfg, jagent.nav_params), waypoint,
        load(ClipVisionTransformer(port_clip_config(jagent.clip.cfg)),
             jagent.clip_params),
        load(rgb, jagent.rgb_params), load(depth, jagent.depth_params), view)


# ---------------------------------------------------- the parallel layer
def shallow_parity_config(jcfg, clip=0.5, **train):
    """A JAX config cut for the sharded-update tests: one language and one
    cross-modal layer, every dropout 0 (the ranks would draw different
    masks), image_prob_size 32, adam_eps 1e-2 (see test_torch_train.py) and
    a global-norm clip of `clip`."""
    return dataclasses.replace(
        jcfg,
        model=dataclasses.replace(jcfg.model, num_l_layers=1, num_x_layers=1,
                                  hidden_dropout_prob=0.0,
                                  attention_probs_dropout_prob=0.0,
                                  feat_dropout=0.0, image_prob_size=32),
        train=dataclasses.replace(jcfg.train, adam_eps=1e-2,
                                  grad_norm_clip=clip, **train))


def jax_params_of(model, init_fn):
    """The flax tree of a port module's weights, shaped by `init_fn`
    (a JAX init taking a PRNG key) through jax.eval_shape: no JAX init is
    run."""
    from gridmm_tpu_torch.convert import to_flax_tree

    template = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, to_flax_tree(
        dict(model.named_parameters()), template))


def state_dict_np(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def assert_state_close(got_sd, want_params, template_model, what,
                       rel=1e-5):
    """Every parameter of a port state dict (numpy) within `rel` of the
    JAX leaf's max (1e-8 floor for analytically zero updates)."""
    from gridmm_tpu_torch.convert import flax_to_state_dict

    want = flax_to_state_dict(jax.tree.map(np.asarray, want_params),
                              template_model)
    bad = {}
    for k, w in want.items():
        w = w.numpy()
        err = np.abs(got_sd[k] - w).max()
        if not err <= rel * np.abs(w).max() + 1e-8:
            bad[k] = (float(err), float(np.abs(w).max()))
    assert not bad, f"{what}: {len(bad)} leaves differ, e.g. " \
        f"{sorted(bad.items(), key=lambda kv: -kv[1][0])[:3]}"

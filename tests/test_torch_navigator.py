"""Port vs JAX package: models/navigator.py and the inference step of
train/step.py on the CPU, at tiny width with the weights carried by
gridmm_tpu_torch.convert. f32 outputs agree within 1e-5 absolute and
relative (logits masked to -inf must match position for position)."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import gridmm_tpu.config as JC  # noqa: E402
from gridmm_tpu.models.navigator import Critic as JCritic  # noqa: E402
from gridmm_tpu.train import step as JS  # noqa: E402
from gridmm_tpu_torch.convert import load_flax_params  # noqa: E402
from gridmm_tpu_torch.models.navigator import Critic as TCritic  # noqa: E402
from gridmm_tpu_torch.models.navigator import dummy_batches  # noqa: E402
from gridmm_tpu_torch.train import step as TS  # noqa: E402
from torch_parity import (assert_close, jax_navigator, nav_batch,  # noqa: E402
                          port_config, port_navigator, step_rows, to_torch)


def _reverie_tiny(obj_feat_size):
    base = JC.tiny_config()
    return dataclasses.replace(
        base,
        model=dataclasses.replace(base.model, obj_feat_size=obj_feat_size),
        shapes=dataclasses.replace(base.shapes, max_obj_len=5))


@pytest.fixture(scope="module")
def pairs():
    """name -> (jax cfg, flax module, params, port cfg, port module), built
    once per module on first use."""
    made = {}

    def get(name):
        if name not in made:
            jcfg = {"tiny": JC.tiny_config,
                    "reverie_shared": lambda: _reverie_tiny(128),
                    "reverie_own": lambda: _reverie_tiny(64)}[name]()
            jmodel, params = jax_navigator(jcfg, seed=0)
            tcfg = port_config(jcfg)
            made[name] = (jcfg, jmodel, params, tcfg,
                          port_navigator(tcfg, params))
        return made[name]

    return get


ALL = ["tiny", "reverie_shared", "reverie_own"]


def _run(jmodel, params, tmodel, mode, batch):
    want = jmodel.apply(params, mode, jax.tree.map(
        lambda a: None if a is None else jnp.asarray(a), batch))
    with torch.no_grad():
        got = tmodel(mode, to_torch(batch))
    return got, want


@pytest.mark.parametrize("name", ALL)
def test_language_and_panorama_modes(pairs, name):
    jcfg, jmodel, params, tcfg, tmodel = pairs(name)
    rng = np.random.default_rng(0)
    t, v, d = jcfg.shapes.max_txt_len, jcfg.shapes.max_vp_len, \
        jcfg.model.image_feat_size
    ids = rng.integers(0, 1000, size=(2, t)).astype(np.int32)
    mask = np.arange(t)[None] < np.array([[9], [t]])
    got, want = _run(jmodel, params, tmodel, "language",
                     {"txt_ids": ids, "txt_mask": mask})
    assert_close(got, want)
    pano = {"view_img_fts": rng.standard_normal((2, v - 1, d)
                                                ).astype(np.float32),
            "loc_fts": rng.standard_normal((2, v - 1, 7)).astype(np.float32),
            "nav_types": rng.integers(0, 3, size=(2, v - 1)).astype(np.int32),
            "view_mask": np.arange(v - 1)[None] < np.array([[20], [30]])}
    if jcfg.model.obj_feat_size:
        n_obj = jcfg.shapes.max_obj_len
        pano["obj_img_fts"] = rng.standard_normal(
            (2, n_obj, jcfg.model.obj_feat_size)).astype(np.float32)
        for k, w in (("loc_fts", 7),):
            pano[k] = rng.standard_normal((2, v - 1 + n_obj, w)
                                          ).astype(np.float32)
        pano["nav_types"] = rng.integers(0, 3, size=(2, v - 1 + n_obj)
                                         ).astype(np.int32)
        pano["view_mask"] = np.arange(v - 1 + n_obj)[None] < np.array(
            [[20], [v + 2]])
    got, want = _run(jmodel, params, tmodel, "panorama", pano)
    assert_close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("name,grid_path,strays", [
    ("tiny", "raw", True), ("tiny", "raw", False),
    ("tiny", "prepooled", True), ("tiny", "masked_txt", True),
    ("reverie_shared", "raw", True), ("reverie_own", "prepooled", False)])
def test_navigation_mode(pairs, name, grid_path, strays):
    jcfg, jmodel, params, tcfg, tmodel = pairs(name)
    if not strays:
        jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(
            jcfg.model, compaction_stray_keys=False))
        jmodel = type(jmodel)(jcfg.model)
        tcfg = port_config(jcfg)
        tmodel = port_navigator(tcfg, params)
    rng = np.random.default_rng(1)
    batch = nav_batch(jcfg, rng)
    if grid_path == "prepooled":
        batch["grid_fts"] = rng.standard_normal(
            batch["grid_fts"].shape[:2] + (jcfg.model.hidden_size,)
        ).astype(np.float32)
        batch["grid_weights"] = rng.standard_normal(
            batch["grid_cells"].shape).astype(np.float32)
    if grid_path == "masked_txt":
        batch["txt_relevance_mask"] = batch["txt_mask"]
    got, want = _run(jmodel, params, tmodel, "navigation", batch)
    for f in got._fields:
        if getattr(want, f) is None:
            assert getattr(got, f) is None, f
            continue
        assert_close(getattr(got, f), getattr(want, f), msg=f)
    assert (jcfg.model.obj_feat_size > 0) == (got.obj_logits is not None)


def test_project_and_pool_modes(pairs):
    jcfg, jmodel, params, tcfg, tmodel = pairs("tiny")
    rng = np.random.default_rng(2)
    b, t, h = 2, jcfg.shapes.max_txt_len, jcfg.model.hidden_size
    txt = rng.standard_normal((b, t, h)).astype(np.float32)
    patch = rng.standard_normal((b, 588, jcfg.model.image_feat_size)
                                ).astype(np.float32)
    got, want = _run(jmodel, params, tmodel, "project_grid",
                     {"txt_embeds": txt, "patch_fts": patch})
    for g_, w_ in zip(got, want):
        assert_close(g_, w_)
    cells = rng.integers(-1, 196, size=(b, 588)).astype(np.int32)
    pos = rng.standard_normal((b, 196, 5)).astype(np.float32)
    got, want = _run(jmodel, params, tmodel, "grid_pool",
                     {"proj_fts": np.asarray(want[0]),
                      "weights": np.asarray(want[1]), "grid_cells": cells,
                      "gridmap_pos_fts": pos})
    assert_close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_critic_and_dummy_batches():
    from gridmm_tpu.models.navigator import dummy_batches as jdummy

    jcfg = _reverie_tiny(64)
    tcfg = port_config(jcfg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 128)).astype(np.float32)
    jc = JCritic(jcfg.model)
    params = jc.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tc = load_flax_params(TCritic(tcfg.model), jax.tree.map(np.asarray,
                                                            params)).eval()
    with torch.no_grad():
        assert_close(tc(torch.from_numpy(x)), jc.apply(params, jnp.asarray(x)))
    for jpart, tpart in zip(jdummy(jcfg.shapes, jcfg.model, 2),
                            dummy_batches(tcfg.shapes, tcfg.model, 2, "cpu")):
        if isinstance(jpart, dict):
            assert set(jpart) == set(tpart)
            pairs = [(jpart[k], tpart[k]) for k in jpart]
        else:
            pairs = [(jpart, tpart)]
        for j, t in pairs:
            assert tuple(t.shape) == j.shape
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_nav_device_step_four_steps(pairs):
    """The whole inference step, 4 steps, carries included: the buffer's
    integer state matches exactly, logits and sums within 1e-5."""
    jcfg, jmodel, params, tcfg, tmodel = pairs("tiny")
    rng = np.random.default_rng(4)
    b, t = 2, jcfg.shapes.max_txt_len
    txt = rng.standard_normal((b, t, jcfg.model.hidden_size)
                              ).astype(np.float32)
    tmask = np.arange(t)[None] < np.array([[10], [t]])
    jcarry = JS.init_carry(jcfg, b)
    tcarry = TS.init_carry(tcfg, b, device="cpu")
    for step in range(4):
        x = step_rows(jcfg, rng, step, b)
        jcarry, jout = JS.nav_device_step(jmodel, jcfg, params,
                                          jnp.asarray(txt),
                                          jnp.asarray(tmask), jcarry,
                                          jax.tree.map(jnp.asarray, x))
        with torch.inference_mode():
            tcarry, tout = TS.nav_device_step(
                tmodel, tcfg, *to_torch((txt, tmask)), tcarry,
                to_torch(TS.StepInputs(*x)))
        for f in ("fused_logits", "global_logits", "local_logits",
                  "grid_logits"):
            assert_close(getattr(tout, f), getattr(jout, f),
                         msg=f"step {step} {f}")
        ps_t, ps_j = tcarry.point_state, jcarry.point_state
        for f in ("valid", "inserted", "count"):
            np.testing.assert_array_equal(getattr(ps_t, f).numpy(),
                                          np.asarray(getattr(ps_j, f)))
        for f in ("features", "weights", "xy"):
            assert_close(getattr(ps_t, f), getattr(ps_j, f), msg=f)
        assert_close(tcarry.gmap_sum, jcarry.gmap_sum)
        assert_close(tcarry.gmap_cnt, jcarry.gmap_cnt, atol=0, rtol=0)

"""bf16 compute (`--bf16`, ModelConfig.compute_dtype="bfloat16") against
f32, in both packages, and the port's bf16 against the JAX package's, at
tiny_config() width on the CPU with the same weights (dropout off).

Bounds, set from the type before any run: bf16 keeps 8 significant bits
(2^-8 relative a rounding), and the tiny navigator's 5 layers round each
product and residual again, so each side's bf16 logits stay within 2^-4 of
the f32 logits' largest magnitude and its trajectory loss within 2^-5
relative. The two packages' bf16 round at other places; a scratch run of
this comparison found them 9.8e-4 apart in the logits (max |logit| 0.52)
and 1.3e-4 relative in the loss, and these inputs give 1.27e-3 and 1.8e-4:
the bounds, 2e-3 and 5e-4, leave 1.6x and 2.8x of room. Masked positions
are -inf in every run. Each side's bf16 was seen within 0.6% of its f32
logits' max and 2.2e-4 relative of its f32 loss."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gridmm_tpu.config as JC  # noqa: E402
import gridmm_tpu.train.step as JS  # noqa: E402
import gridmm_tpu.train.synthetic as JSYN  # noqa: E402
from gridmm_tpu.models.navigator import GridMMNavigator  # noqa: E402
import gridmm_tpu_torch.train.step as TS  # noqa: E402
from torch_parity import (jax_navigator, nav_batch, port_config,  # noqa: E402
                          port_navigator, to_numpy, to_torch)

LOGITS = ("global_logits", "local_logits", "fused_logits", "grid_logits")
VS_F32 = 2.0 ** -4        # of the f32 logits' max |value|
LOSS_VS_F32 = 2.0 ** -5   # relative
VS_JAX = 2e-3             # absolute, logits
LOSS_VS_JAX = 5e-4        # relative


def _cfgs():
    base = JC.tiny_config()
    base = dataclasses.replace(base, model=dataclasses.replace(
        base.model, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, feat_dropout=0.0))
    bf16 = dataclasses.replace(base, model=dataclasses.replace(
        base.model, compute_dtype="bfloat16"))
    return {"f32": base, "bf16": bf16}


@pytest.fixture(scope="module")
def sides():
    """{(package, dtype): (cfg, module, flax params or None)}, every one
    with the same weights."""
    cfgs = _cfgs()
    _, params = jax_navigator(cfgs["f32"], seed=0)
    out = {}
    for dt, jcfg in cfgs.items():
        jmodel = GridMMNavigator(jcfg.model)
        tcfg = port_config(jcfg)
        tmodel = port_navigator(tcfg, params)
        assert str(tmodel.cfg.compute_dtype) == jcfg.model.compute_dtype
        out[("jax", dt)] = (jcfg, jmodel, params)
        out[("port", dt)] = (tcfg, tmodel, None)
    return out


def _navigation(sides, key, batch):
    cfg, model, params = sides[key]
    if key[0] == "jax":
        got = model.apply(params, "navigation", jax.tree.map(
            lambda a: None if a is None else jnp.asarray(a), batch))
    else:
        with torch.no_grad():
            got = model("navigation", to_torch(batch))
    return {f: to_numpy(getattr(got, f)).astype(np.float32) for f in LOGITS}


def _loss(sides, key, jbatch):
    cfg, model, params = sides[key]
    if key[0] == "jax":
        return float(JS.trajectory_loss(model, cfg, params, jbatch))
    batch = TS.batch_to_device(jax.tree.map(np.array, jbatch), "cpu")
    with torch.no_grad():
        return float(TS.trajectory_loss(model, cfg, batch))


def _max_diff(got, want):
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    return float(np.abs(got[fin] - want[fin]).max()), \
        float(np.abs(want[fin]).max())


@pytest.mark.parametrize("package", ["jax", "port"])
def test_bf16_navigation_and_loss_track_f32(sides, package):
    batch = nav_batch(_cfgs()["f32"], np.random.default_rng(1))
    lo = _navigation(sides, (package, "bf16"), batch)
    hi = _navigation(sides, (package, "f32"), batch)
    for f in LOGITS:
        diff, scale = _max_diff(lo[f], hi[f])
        assert diff <= VS_F32 * scale, (f, diff, scale)
    jbatch = JSYN.synthetic_trajectory_batch(_cfgs()["f32"], 2, 3, seed=0)
    loss_lo = _loss(sides, (package, "bf16"), jbatch)
    loss_hi = _loss(sides, (package, "f32"), jbatch)
    assert np.isfinite(loss_lo)
    assert abs(loss_lo - loss_hi) <= LOSS_VS_F32 * abs(loss_hi)


def test_port_bf16_matches_jax_bf16(sides):
    batch = nav_batch(_cfgs()["f32"], np.random.default_rng(1))
    got = _navigation(sides, ("port", "bf16"), batch)
    want = _navigation(sides, ("jax", "bf16"), batch)
    for f in LOGITS:
        diff, _ = _max_diff(got[f], want[f])
        assert diff <= VS_JAX, (f, diff)
    jbatch = JSYN.synthetic_trajectory_batch(_cfgs()["f32"], 2, 3, seed=0)
    loss_t = _loss(sides, ("port", "bf16"), jbatch)
    loss_j = _loss(sides, ("jax", "bf16"), jbatch)
    assert abs(loss_t - loss_j) <= LOSS_VS_JAX * abs(loss_j)

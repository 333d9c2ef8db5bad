"""The int8 serving path (ops/quant.py, models/layers.Int8Dense,
models/clip_vit.MaybeInt8Dense, `export_serving --int8`) against
gridmm_tpu on the CPU.

The op level is exact: the int8 weights, the scales and the int32 product
are the JAX package's bit for bit, and y agrees within 1e-6 relative (the
same f32 operations in the same order). The navigator and the CLIP tower
agree with the JAX int8 forward up to one quantization step: the two
frameworks' f32 activations differ in their last bits, and where an
activation lies within that of a rounding boundary (k + 0.5) / scale, its
int8 value differs by one. The per-tensor activation scale couples a
batch's rows, so int8 outputs are compared batch for batch."""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gridmm_tpu.config as JC  # noqa: E402
import gridmm_tpu.ops.quant as JQ  # noqa: E402
import gridmm_tpu.train.step as JS  # noqa: E402
import gridmm_tpu_torch.ops.quant as TQ  # noqa: E402
import gridmm_tpu_torch.train.step as TS  # noqa: E402
from gridmm_tpu_torch.cli import export_serving as TEXP  # noqa: E402
from gridmm_tpu_torch.models.layers import Dense, Int8Dense  # noqa: E402
from gridmm_tpu_torch.models.navigator import init_navigator  # noqa: E402
from gridmm_tpu_torch.serve.engine import NavServingEngine  # noqa: E402
from torch_parity import (jax_navigator, port_clip_config,  # noqa: E402
                          port_config, port_navigator, step_rows, to_torch)

OUT_FIELDS = ("global_logits", "local_logits", "fused_logits",
              "grid_logits")
# the navigator's and the CLIP tower's tolerance, relative to the output's
# spread: an activation whose int8 value differs by one step between the
# two frameworks moves every product it enters by x_scale * w_scale * w_q.
# Observed at these inputs: 1.05e-3 of the logits' spread (navigator,
# tiny_config(), three steps), 2.2e-7 of the tokens' range (f32 CLIP:
# no activation sat on a boundary) and 7.3e-3 (bf16 CLIP, where one bf16
# rounding of a token sits on top of a step)
STEP_TOL = 2e-3
BF16_STEP_TOL = 1.5e-2


def _int8_cfg(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, int8_matmuls=True))


def _tie_inputs(rng, m, k, n, dtype):
    """x (m, k) and an (out, in) weight whose rows have absmax 127, so
    that the scales are 1.0 and the .5 entries are exact rounding ties
    (round half to even: 2.5 -> 2, -3.5 -> -4)."""
    w = rng.uniform(-100, 100, size=(n, k)).astype(np.float32)
    w[:, 0] = 127.0
    w[:, 1] = 2.5
    w[:, 2] = -3.5
    w[:, 3] = 0.5
    x = rng.standard_normal((m, k)).astype(np.float32) * 30.0
    x[0, 0] = 127.0
    x[1, 1:4] = (4.5, -6.5, 1.5)
    if dtype == "bfloat16":
        # exactly representable in bf16, so both sides quantize one value
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
def test_int8_dense_matches_jax_bit_for_bit(dtype, with_bias):
    rng = np.random.default_rng(3)
    m, k, n = 9, 48, 24
    x, w = _tie_inputs(rng, m, k, n, dtype)
    bias = rng.standard_normal(n).astype(np.float32) if with_bias else None

    jq, jscale = JQ.quantize_per_channel(jnp.asarray(w.T))
    tq, tscale = TQ.quantize_per_channel(torch.from_numpy(w))
    assert tq.dtype == torch.int8 and tscale.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale)[0])
    assert tq[:, 1].eq(2).all() and tq[:, 2].eq(-4).all()
    assert tq[:, 3].eq(0).all()

    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jy = JQ.int8_dense(jx, jnp.asarray(w.T),
                       None if bias is None else jnp.asarray(bias))
    ty = TQ.int8_dense(tx, torch.from_numpy(w),
                       None if bias is None else torch.from_numpy(bias))
    assert ty.dtype == tx.dtype and ty.shape == (m, n)
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               rtol=1e-6, atol=0)
    # the int32 product of the quantized activations, exactly
    xs = np.abs(x).max() / 127.0
    xq = np.clip(np.round(x / np.float32(xs)), -127, 127).astype(np.int32)
    acc = TQ._int_mm(torch.from_numpy(xq.astype(np.int8)), tq.t())
    np.testing.assert_array_equal(acc.numpy(), xq @ tq.numpy().T.astype(
        np.int32))


def test_int8_dense_keeps_leading_dims_and_zero_input():
    w = torch.randn(16, 8)
    x = torch.zeros(2, 3, 8)
    y = TQ.int8_dense(x, w, torch.ones(16))
    assert y.shape == (2, 3, 16) and torch.equal(y, torch.ones(2, 3, 16))


def test_int8_dense_layer_caches_and_follows_the_weight():
    torch.manual_seed(0)
    layer = Int8Dense(32, 16)
    x = torch.randn(5, 32)
    y0 = layer(x)
    q0 = layer.weight_q
    assert q0 is not None and layer(x).equal(y0) and layer.weight_q is q0
    assert set(layer.state_dict()) == {"weight", "bias"}
    plain = Dense(32, 16)
    assert set(plain.state_dict()) == set(layer.state_dict())
    layer.load_state_dict(plain.state_dict())  # writes the weight in place
    y1 = layer(x)
    assert layer.weight_q is not q0
    assert torch.equal(y1, TQ.int8_dense(x, plain.weight, plain.bias))
    # a weight given in place of the parameter is quantized in the call
    y2 = torch.func.functional_call(layer, {"weight": plain.weight * 2,
                                            "bias": plain.bias}, (x,))
    assert torch.equal(y2, TQ.int8_dense(x, plain.weight * 2, plain.bias))


# ----------------------------------------------------------- the navigator
@pytest.fixture(scope="module")
def nav_pair():
    jcfg = JC.tiny_config()
    jcfg8 = _int8_cfg(jcfg)
    jmodel8, params = jax_navigator(jcfg8, seed=0)
    tcfg8 = port_config(jcfg8)
    return jcfg8, jmodel8, params, tcfg8, port_navigator(tcfg8, params)


def _jax_steps(jmodel, jcfg, params, ids, mask, rows):
    jtxt = jmodel.apply(params, "language", {"txt_ids": jnp.asarray(ids),
                                             "txt_mask": jnp.asarray(mask)})
    step = jax.jit(lambda p, t, m, c, x: JS.nav_device_step(
        jmodel, jcfg, p, t, m, c, x))
    carry = JS.init_carry(jcfg, ids.shape[0])
    outs = []
    for x in rows:
        carry, out = step(params, jtxt, jnp.asarray(mask), carry,
                          jax.tree.map(jnp.asarray, x))
        outs.append(out)
    return outs


def _port_steps(model, cfg, ids, mask, rows):
    outs = []
    with torch.inference_mode():
        txt = model("language", {"txt_ids": torch.from_numpy(ids),
                                 "txt_mask": torch.from_numpy(mask)})
        carry = TS.init_carry(cfg, ids.shape[0], device="cpu")
        for x in rows:
            carry, out = TS.nav_device_step(model, cfg, txt,
                                            torch.from_numpy(mask), carry,
                                            to_torch(TS.StepInputs(*x)))
            outs.append(out)
    return outs


def _inputs(cfg, b=3, steps=3, seed=1):
    rng = np.random.default_rng(seed)
    t = cfg.shapes.max_txt_len
    ids = rng.integers(1, 1000, size=(b, t)).astype(np.int32)
    mask = np.arange(t)[None] < rng.integers(4, t + 1, size=(b, 1))
    return ids, mask, [step_rows(cfg, rng, s, b) for s in range(steps)]


def test_int8_navigator_matches_jax_int8_step(nav_pair):
    jcfg8, jmodel8, params, tcfg8, tmodel8 = nav_pair
    ids, mask, rows = _inputs(jcfg8)
    jouts = _jax_steps(jmodel8, jcfg8, params, ids, mask, rows)
    touts = _port_steps(tmodel8, tcfg8, ids, mask, rows)
    worst = 0.0
    for s, (jo, to) in enumerate(zip(jouts, touts)):
        for f in OUT_FIELDS:
            want = np.asarray(getattr(jo, f))
            got = getattr(to, f).numpy()
            fin = np.isfinite(want)
            np.testing.assert_array_equal(np.isfinite(got), fin,
                                          err_msg=f"{s} {f}")
            spread = want[fin].max() - want[fin].min() + 1e-9
            err = np.abs(got[fin] - want[fin]).max() / spread
            worst = max(worst, err)
    assert worst < STEP_TOL, worst


def test_int8_navigator_tracks_f32_and_keeps_the_state_dict(nav_pair):
    """The JAX test's own gates (tests/test_int8_nav.py): cosine > 0.99 and
    max|diff| / spread < 0.2 against the f32 forward of the same weights;
    the state dict has the same keys and shapes with and without int8."""
    jcfg8, _, params, tcfg8, tmodel8 = nav_pair
    tcfg = dataclasses.replace(tcfg8, model=dataclasses.replace(
        tcfg8.model, int8_matmuls=False))
    tmodel = port_navigator(tcfg, params)
    sd, sd8 = tmodel.state_dict(), tmodel8.state_dict()
    assert [(k, v.shape) for k, v in sd.items()] == \
        [(k, v.shape) for k, v in sd8.items()]
    assert any(isinstance(m, Int8Dense) for m in tmodel8.modules())
    ids, mask, rows = _inputs(jcfg8, seed=4)
    ref = _port_steps(tmodel, tcfg, ids, mask, rows)[-1].fused_logits.numpy()
    got = _port_steps(tmodel8, tcfg8, ids, mask, rows)[-1]
    got = got.fused_logits.numpy()
    fin = np.isfinite(ref)
    assert (np.isfinite(got) == fin).all()
    a, b = got[fin].ravel(), ref[fin].ravel()
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))
    assert cos > 0.99
    spread = b.max() - b.min() + 1e-9
    assert np.abs(a - b).max() / spread < 0.2


# ----------------------------------------------------------- the CLIP tower
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_clip_matches_jax_int8_tower(dtype):
    from gridmm_tpu.models.clip_vit import ClipVisionConfig as JCV
    from gridmm_tpu.models.clip_vit import ClipVisionTransformer as JVT

    from gridmm_tpu_torch.convert import load_flax_params
    from gridmm_tpu_torch.models.clip_vit import ClipVisionTransformer

    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
    jcfg = JCV(input_resolution=64, patch_size=32, width=64, layers=2,
               heads=4, compute_dtype=dtype, int8_matmuls=True)
    jm = JVT(jcfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(imgs))
    want = np.asarray(jm.apply(params, jnp.asarray(imgs)).astype(
        jnp.float32))
    tcfg = port_clip_config(jcfg)
    tm = ClipVisionTransformer(tcfg)
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    with torch.inference_mode():
        got = tm.eval()(torch.from_numpy(imgs))
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    span = want.max() - want.min()
    tol = STEP_TOL if dtype == "float32" else BF16_STEP_TOL
    assert np.abs(got - want).max() / span < tol
    # the f32 tower's own gate (tests/test_misc.py): cosine > 0.98
    f32 = ClipVisionTransformer(dataclasses.replace(
        tcfg, int8_matmuls=False, compute_dtype="float32"))
    load_flax_params(f32, jax.tree.map(np.asarray, params))
    with torch.inference_mode():
        ref = f32.eval()(torch.from_numpy(imgs)).numpy()
    a, b = got.reshape(-1, 64), ref.reshape(-1, 64)
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                             * np.linalg.norm(b, axis=-1) + 1e-9)
    assert cos.min() > 0.98


# ----------------------------------------------------------- the bundle
def test_int8_bundle_serves_the_bits_of_the_live_engine(tmp_path, capsys):
    """`export_serving --int8` writes a bundle whose programs quantize the
    weights they are given; served by `from_bundle` with seed-7 weights it
    gives the bits of a `create` engine over the same int8 model."""
    man = TEXP.main(["--tiny", "--int8", "--device", "cpu", "--batch", "2",
                     "--max_action_len", "3", "--out_dir",
                     str(tmp_path / "b")])
    assert man["int8"] is True
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == man
    tcfg8 = _int8_cfg(port_config(JC.tiny_config()))
    tcfg8 = dataclasses.replace(
        tcfg8, train=dataclasses.replace(tcfg8.train, max_action_len=3),
        shapes=dataclasses.replace(tcfg8.shapes, max_points=3 * 588))
    model = init_navigator(tcfg8.model, seed=7, device="cpu")
    live = NavServingEngine.create(model, tcfg8, 2, device="cpu")
    served = NavServingEngine.from_bundle(str(tmp_path / "b"), tcfg8,
                                          dict(model.state_dict()), 2,
                                          device="cpu")
    rng = np.random.default_rng(2)
    t = tcfg8.shapes.max_txt_len
    for r in range(2):
        ids = rng.integers(1, 1000, size=t).astype(np.int32)
        m = np.arange(t) < rng.integers(3, t + 1)
        for eng in (live, served):
            eng.submit(r, ids, m)
    assert live.admit() == served.admit() == {0: 0, 1: 1}
    jcfg = JC.tiny_config()
    for s in range(2):
        rows = {slot: step_rows(jcfg, rng, s) for slot in (0, 1)}
        a, b = live.step(rows), served.step(rows)
        for f in OUT_FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), (s, f)
    f32_cfg = dataclasses.replace(tcfg8, model=dataclasses.replace(
        tcfg8.model, int8_matmuls=False))
    with pytest.raises(ValueError, match="int8"):
        NavServingEngine.from_bundle(str(tmp_path / "b"), f32_cfg,
                                     dict(model.state_dict()), 2,
                                     device="cpu")


def test_create_engine_rebuilds_an_f32_model_as_int8():
    """`create` with an int8 config over an f32 module serves the int8
    trunk on the same parameters."""
    tcfg = port_config(JC.tiny_config())
    model = init_navigator(tcfg.model, seed=1, device="cpu")
    eng = NavServingEngine.create(model, _int8_cfg(tcfg), 1, device="cpu")
    assert any(isinstance(m, Int8Dense) for m in eng.model.modules())
    assert eng.model.state_dict().keys() == model.state_dict().keys()

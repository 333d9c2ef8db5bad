"""Port vs JAX package on the CPU: the CLIP tower and its three kernels'
plain versions (ops/layernorm.py, ops/attention.py, models/clip_vit.py,
utils/checkpoint.py).

Each plain version is held against the JAX package's plain path and its
Pallas kernel in interpret mode, on the same numpy inputs: LayerNorm within
1e-5, attention within 2e-5 (the bound tests/test_pallas_attention_qkv.py
holds JAX's own two paths to), whole towers within 2e-4 (the bound of
test_pallas_attention_qkv.py:66), weights carried by gridmm_tpu_torch.convert.
"""

import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import gridmm_tpu.models.clip_vit as JV  # noqa: E402
import gridmm_tpu.ops.pallas.attention as jax_attention  # noqa: E402
import gridmm_tpu_torch.models.clip_vit as TV  # noqa: E402
from gridmm_tpu.ops.pallas.attention_qkv import \
    fused_attention_qkv  # noqa: E402
from gridmm_tpu.ops.pallas.layernorm import fused_layernorm  # noqa: E402
from gridmm_tpu_torch.convert import (flax_to_state_dict,  # noqa: E402
                                      load_flax_params)
from gridmm_tpu_torch.ops.attention import (attention,  # noqa: E402
                                            attention_qkv,
                                            attention_qkv_plain)
from gridmm_tpu_torch.ops.layernorm import layernorm  # noqa: E402
from torch_parity import (DROPPED_CLIP_FIELDS,  # noqa: E402
                          assert_close, openai_visual_state_dict,
                          port_clip_config, to_torch)


def jax_tower(jcfg, seed=0):
    """(flax module, params as numpy) for a JAX tower."""
    model = JV.ClipVisionTransformer(jcfg)
    x = jnp.zeros((1, jcfg.input_resolution, jcfg.input_resolution, 3))
    params = model.init(jax.random.PRNGKey(seed), x)
    return model, jax.tree.map(np.asarray, params)


def port_tower(jcfg, params):
    model = TV.ClipVisionTransformer(port_clip_config(jcfg))
    return load_flax_params(model, params).eval()


def test_config_fields_match_jax():
    """Field for field, minus the three TPU dispatch flags; the presets
    agree; int8_matmuls puts Int8Dense in the four projections of every
    block (ops/quant.py)."""
    jf = {f.name for f in dataclasses.fields(JV.ClipVisionConfig)}
    tf = {f.name for f in dataclasses.fields(TV.ClipVisionConfig)}
    assert tf == jf - DROPPED_CLIP_FIELDS
    for name in ("clip_b32", "clip_b16", "vit_b16_timm"):
        assert port_clip_config(getattr(JV, name)()) == getattr(TV, name)()
    assert TV.clip_b32().num_tokens == 50 and TV.clip_b32().dtype == \
        torch.bfloat16
    from gridmm_tpu_torch.models.layers import Int8Dense

    tower = TV.ClipVisionTransformer(TV.ClipVisionConfig(
        input_resolution=64, width=64, layers=2, heads=4,
        int8_matmuls=True))
    assert sum(isinstance(m, Int8Dense) for m in tower.modules()) == 4 * 2


@pytest.mark.parametrize("c", [768, 64, 17, 1500])
def test_layernorm_matches_jax(c):
    """Both JAX formulations: flax nn.LayerNorm (fast variance, the default
    ClipLayerNorm) and the Pallas kernel (centred variance; off C % 128 == 0,
    at C = 64, 17 and 1500, its wrapper takes the unfused fallback). 17 and
    1500 are the widths at which the CUDA kernel runs its scalar bodies."""
    rng = np.random.default_rng(c)
    x = (rng.standard_normal((3, 50, c)) * 2.0 + 0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    got = layernorm(*to_torch((x, scale, bias)))
    flax_ln = JV.ClipLayerNorm(use_pallas=False).apply(
        {"params": {"ln": {"scale": scale, "bias": bias}}}, jnp.asarray(x))
    pallas = fused_layernorm(jnp.asarray(x), jnp.asarray(scale),
                             jnp.asarray(bias), interpret=True)
    assert got.dtype == torch.float32
    assert_close(got, flax_ln, rtol=1e-5, atol=1e-5)
    assert_close(got, pallas, rtol=1e-5, atol=1e-5)


def jax_einsum_attention(qkv, heads):
    """The JAX tower's plain path, clip_vit.py:162-182 and :192."""
    b, l, w3 = qkv.shape
    hd = w3 // 3 // heads
    q, k, v = (t.reshape(b, l, heads, hd) for t in jnp.split(qkv, 3, -1))
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k,
                   preferred_element_type=jnp.float32) / jnp.sqrt(
                       jnp.float32(hd))
    p = jax.nn.softmax(s, axis=-1).astype(qkv.dtype)
    ctx = jnp.einsum("bhqk,bkhd->bqhd", p, v,
                     preferred_element_type=jnp.float32).astype(qkv.dtype)
    return ctx.reshape(b, l, w3 // 3)


@pytest.mark.parametrize("b,l,heads", [(3, 50, 4), (2, 64, 2), (5, 197, 12)])
def test_attention_qkv_matches_jax(b, l, heads):
    rng = np.random.default_rng(b + l)
    qkv = rng.standard_normal((b, l, 3 * heads * 64)).astype(np.float32)
    got = attention_qkv(torch.from_numpy(qkv), heads)
    pallas = fused_attention_qkv(jnp.asarray(qkv), heads=heads,
                                 imgs_per_block=2, interpret=True)
    assert tuple(got.shape) == (b, l, heads * 64)
    assert_close(got, pallas, rtol=2e-5, atol=2e-5)
    assert_close(got, jax_einsum_attention(jnp.asarray(qkv), heads),
                 rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,l,heads", [(4, 1, 2), (3, 17, 4), (1, 500, 2),
                                       (1, 800, 2)])
def test_attention_qkv_plain_matches_jax_at_tile_edges(b, l, heads):
    """L = 1 and 17, the edges of the CUDA kernel's 16-key tiles, and L =
    500 and 800, past what a head's K and V in shared memory once allowed
    (the kernel now streams them): its oracle `attention_qkv_plain` against
    the Pallas kernel in interpret mode (one image a block: L is no multiple
    of 8) and the einsum path, within 2e-5."""
    rng = np.random.default_rng(b + l)
    qkv = rng.standard_normal((b, l, 3 * heads * 64)).astype(np.float32)
    got = attention_qkv_plain(torch.from_numpy(qkv), heads)
    pallas = fused_attention_qkv(jnp.asarray(qkv), heads=heads,
                                 imgs_per_block=1, interpret=True)
    assert tuple(got.shape) == (b, l, heads * 64)
    assert_close(got, pallas, rtol=2e-5, atol=2e-5)
    assert_close(got, jax_einsum_attention(jnp.asarray(qkv), heads),
                 rtol=2e-5, atol=2e-5)
    if l == 1:      # one key: the context is v itself
        assert_close(got, qkv[..., 2 * heads * 64:], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hd,l", [(hd, 33) for hd in (1, 16, 20, 48, 64, 80,
                                                      128, 200)]
                         + [(80, 700), (320, 60)])
def test_attention_matches_jax(hd, l):
    """head_dim 1 to 200 at L = 33; hd 80 at L = 700 (K and V stream
    through the CUDA kernel's ring) and hd 320 (its wide kernel, 128 output
    columns a work item), against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(hd + l)
    q, k, v = (rng.standard_normal((6, l, hd)).astype(np.float32)
               for _ in range(3))
    got = attention(*to_torch((q, k, v)))
    want = jax_attention.fused_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads_per_block=4,
        interpret=True)
    assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("hd,dtype,packed", [
    (64, "bfloat16", True), (64, "float32", True), (16, "float32", False),
    (80, "bfloat16", False), (256, "bfloat16", False), (256, "float32", False),
    (320, "bfloat16", False), (320, "float32", False)])
def test_attention_kernels_shared_memory_is_the_same_at_every_length(
        hd, dtype, packed):
    """A block's shared memory as the CUDA launchers set it (`_smem_bytes`,
    mirrored on the CPU and held to the launchers' own on the card by
    tests/test_torch_cuda.py): the ring's, the same at L = 50, 197, 2048
    and 100,000 and within the 232,448 bytes a block may use."""
    from gridmm_tpu_torch.ops.cuda.attention import MAX_SMEM, _smem_bytes

    dt = getattr(torch, dtype)
    got = {n: _smem_bytes(n, hd, dt, packed) for n in (50, 197, 2048, 100000)}
    assert len(set(got.values())) == 1, got
    assert 0 < got[50] <= MAX_SMEM


TOWERS = {
    # head_dim 64: the flags on route JAX through the packed-qkv kernel
    "clip": (JV.ClipVisionConfig(input_resolution=64, patch_size=32,
                                 width=128, layers=2, heads=2,
                                 compute_dtype="float32"),
             dict(use_qkv_attention=True, use_pallas_ln=True)),
    "timm": (JV.ClipVisionConfig(input_resolution=64, patch_size=16,
                                 width=128, layers=2, heads=2,
                                 compute_dtype="float32", gelu="erf",
                                 ln_pre=False, conv_bias=True),
             dict(use_qkv_attention=True, use_pallas_ln=True)),
    # head_dim 16: the per-head kernel (the --tiny preprocess tower's shape)
    "hd16": (JV.ClipVisionConfig(input_resolution=56, patch_size=8,
                                 width=64, layers=2, heads=4,
                                 compute_dtype="float32"),
             dict(use_pallas_attention=True, use_pallas_ln=True)),
    # head_dim 80: the per-head kernel at ViT-H/14's head width
    "hd80": (JV.ClipVisionConfig(input_resolution=56, patch_size=8,
                                 width=160, layers=2, heads=2,
                                 compute_dtype="float32"),
             dict(use_pallas_attention=True, use_pallas_ln=True)),
    # 785 tokens (patch 8 at 224 px, ViT-B/16 at 448 px's count): one layer,
    # width 128, head_dim 64; past what K and V in shared memory once took
    "long": (JV.ClipVisionConfig(input_resolution=224, patch_size=8,
                                 width=128, layers=1, heads=2,
                                 compute_dtype="float32"),
             dict(use_qkv_attention=True, use_pallas_ln=True)),
}


@pytest.mark.parametrize("flags", ["off", "on"])
@pytest.mark.parametrize("variant", sorted(TOWERS))
def test_tower_matches_jax(variant, flags, monkeypatch):
    """f32, 2 layers; the JAX tower with its dispatch flags off (XLA) and on
    (Pallas kernels in interpret mode), the port's tower on the CPU."""
    jcfg, on = TOWERS[variant]
    model, params = jax_tower(jcfg)
    if flags == "on":
        jcfg = dataclasses.replace(jcfg, **on)
        model = JV.ClipVisionTransformer(jcfg)
        # the tower calls fused_attention without `interpret`, i.e. for a TPU
        monkeypatch.setattr(jax_attention, "fused_attention", functools.partial(
            jax_attention.fused_attention, interpret=True))
    rng = np.random.default_rng(7)
    r = jcfg.input_resolution
    imgs = rng.integers(0, 256, (3, r, r, 3)).astype(np.uint8)
    want = model.apply(params, JV.normalize_images(jnp.asarray(imgs)))
    tower = port_tower(jcfg, params)
    with torch.no_grad():
        got = tower(TV.normalize_images(torch.from_numpy(imgs)))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (3, jcfg.num_tokens, jcfg.width)
    assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_normalize_images_match_jax():
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (2, 8, 8, 3)).astype(np.uint8)
    for jf, tf in ((JV.normalize_images, TV.normalize_images),
                   (JV.normalize_images_timm, TV.normalize_images_timm)):
        assert_close(tf(torch.from_numpy(imgs)), jf(jnp.asarray(imgs)),
                     rtol=1e-6, atol=1e-6)


def test_import_torch_clip_visual_matches_jax():
    """The port's importer loads exactly the tensors the JAX importer puts
    in the flax tree (carried over by convert), and the towers agree."""
    from gridmm_tpu.utils.checkpoint import \
        import_torch_clip_visual as jax_import
    from gridmm_tpu_torch.utils.checkpoint import import_torch_clip_visual

    jcfg = JV.ClipVisionConfig(input_resolution=56, patch_size=8, width=64,
                               layers=2, heads=4, compute_dtype="float32")
    sd = openai_visual_state_dict()
    jmodel, template = jax_tower(jcfg, seed=1)
    jparams = jax.tree.map(np.asarray, jax_import(sd, template, layers=2))
    tower = TV.ClipVisionTransformer(port_clip_config(jcfg))
    assert import_torch_clip_visual(sd, tower) is tower
    want_sd = flax_to_state_dict(jparams, tower)
    got_sd = tower.state_dict()
    assert set(got_sd) == set(want_sd)
    for k in got_sd:
        assert torch.equal(got_sd[k], want_sd[k]), k

    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (2, 56, 56, 3)).astype(np.uint8)
    want = jmodel.apply(jparams, JV.normalize_images(jnp.asarray(imgs)))
    with torch.no_grad():
        got = tower(TV.normalize_images(torch.from_numpy(imgs)))
    assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_init_clip_vision_is_seeded():
    cfg = TV.ClipVisionConfig(input_resolution=64, patch_size=32, width=64,
                              layers=1, heads=4, compute_dtype="float32")
    a = TV.init_clip_vision(cfg, seed=3, device="cpu").state_dict()
    b = TV.init_clip_vision(cfg, seed=3, device="cpu").state_dict()
    c = TV.init_clip_vision(cfg, seed=4, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1.weight"], c["conv1.weight"])
    assert "conv1.bias" not in a

"""Port vs JAX package on the CPU: the VLN-CE perception modules.

The frozen ResNet towers at real widths (gridmm_tpu_torch/models/resnet.py),
the tiny stand-ins (ce/encoders.py) at the factory's sizes and at sizes where
the adaptive pool resizes, the waypoint predictor (RGB and depth-only) and
`waypoint_nms` with its four reference quirks, the four importers (on the
same reference-layout dicts as the JAX importers), and the full factory's
tower shapes. Weights go through gridmm_tpu_torch.convert; inputs are numpy
draws. Tolerances: whole towers 2e-4 (relative to the output's largest
magnitude: flax's GroupNorm and conv sum in another order), modules 1e-5,
NMS maps bit-exact.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import gridmm_tpu.ce.encoders as JE  # noqa: E402
import gridmm_tpu.models.resnet as JR  # noqa: E402
import gridmm_tpu.models.waypoint as JW  # noqa: E402
import gridmm_tpu.utils.checkpoint as JCK  # noqa: E402
import gridmm_tpu_torch.ce.encoders as TE  # noqa: E402
import gridmm_tpu_torch.models.resnet as TR  # noqa: E402
import gridmm_tpu_torch.models.waypoint as TW  # noqa: E402
import gridmm_tpu_torch.utils.checkpoint as TCK  # noqa: E402
from gridmm_tpu_torch.convert import (flax_to_state_dict,  # noqa: E402
                                      load_flax_params)
from torch_parity import assert_close  # noqa: E402

TOWER_TOL = 2e-4


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _randomize_norms(params, rng):
    """Non-trivial norm parameters (and BN running stats) in a flax tree:
    scale in [0.5, 1.5), shift ~ 0.2 N(0, 1), mean ~ 0.3 N(0, 1), var in
    [0.5, 1.5)."""
    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            v = np.asarray(v)
            if k in ("scale", "var"):
                v = (0.5 + rng.random(v.shape)).astype(np.float32)
            elif k == "mean" or (k == "bias" and "kernel" not in tree):
                v = (rng.standard_normal(v.shape) * 0.2).astype(np.float32)
            out[k] = v
        return out
    return walk(_np_tree(params))


def _tower_close(got, want):
    want = np.asarray(want)
    assert_close(got, want, rtol=0, atol=TOWER_TOL * np.abs(want).max())


# ------------------------------------------------------------ ResNet towers
def test_rgb_resnet50_tower_matches_jax():
    """Real widths and depths (3, 4, 6, 3) on 64 px uint8 images; the
    flattened features in CHW order."""
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    jm = JR.RgbResNet50Tower()
    params = _randomize_norms(jm.init(jax.random.PRNGKey(0),
                                      jnp.asarray(imgs)), rng)
    want = jm.apply(params, jnp.asarray(imgs))
    tm = load_flax_params(TR.RgbResNet50Tower(), params).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(imgs))
    assert got.shape == (2, 2048 * 2 * 2)
    _tower_close(got, want)


def test_ddppo_depth_encoder_matches_jax():
    """Real widths (GroupNorm resnet50, baseplanes 32) at 256 px: 128x4x4
    features in CHW order."""
    rng = np.random.default_rng(1)
    depth = rng.random((2, 256, 256, 1)).astype(np.float32)
    jm = JR.DdppoDepthEncoder()
    params = _randomize_norms(jm.init(jax.random.PRNGKey(0),
                                      jnp.asarray(depth)), rng)
    want = jm.apply(params, jnp.asarray(depth))
    tm = load_flax_params(TR.DdppoDepthEncoder(input_size=256), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(depth))
    assert got.shape == (2, 128 * 4 * 4)
    _tower_close(got, want)


# ---------------------------------------------------------------- stand-ins
@pytest.mark.parametrize("size", [56, 64], ids=["identity_7", "shrink_8_7"])
def test_rgb_stand_in_matches_jax(size):
    """"SAME" strided pads (0, 1) on even sides, the per-cell Dense and the
    HWC flatten; at 64 px the last conv map is 8x8 and the linear resize
    shrinks it to 7x7 (antialiased)."""
    rng = np.random.default_rng(size)
    imgs = rng.integers(0, 256, (3, size, size, 3), dtype=np.uint8)
    jm = JE.RgbTower(out_ch=41, grid=7)
    params = _np_tree(jm.init(jax.random.PRNGKey(2), jnp.asarray(imgs)))
    want = jm.apply(params, jnp.asarray(imgs))
    tm = load_flax_params(TE.RgbTower(out_ch=41, grid=7), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(imgs))
    assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", [256, 128, 40],
                         ids=["identity_4", "grow_2_4", "grow_3_4"])
def test_depth_stand_in_matches_jax(size):
    """At 256 px the conv stack ends at 4x4 (identity resize); at 128 px at
    2x2 and at 40 px at 3x3 (the odd side pads unevenly), which the linear
    resize grows to 4x4."""
    rng = np.random.default_rng(size)
    depth = rng.uniform(0.5, 6.0, (2, size, size, 1)).astype(np.float32)
    jm = JE.DepthTower(out_ch=128)
    params = _np_tree(jm.init(jax.random.PRNGKey(3), jnp.asarray(depth)))
    want = jm.apply(params, jnp.asarray(depth))
    tm = load_flax_params(TE.DepthTower(out_ch=128), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(depth))
    assert got.shape == (2, 128 * 16)
    assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_linear_resize_matches_jax_both_ways():
    """The adaptive pool alone, shrinking and growing, against
    jax.image.resize(method="linear") within 1e-5."""
    rng = np.random.default_rng(4)
    for src, dst in ((9, 7), (13, 4), (2, 4), (5, 7), (7, 7)):
        x = rng.standard_normal((2, src, src, 3)).astype(np.float32)
        want = jax.image.resize(jnp.asarray(x), (2, dst, dst, 3), "linear")
        got = TE.resize_linear(torch.from_numpy(x).permute(0, 3, 1, 2), dst)
        assert_close(got.permute(0, 2, 3, 1), want, rtol=1e-5, atol=1e-5,
                     msg=f"{src}->{dst}")


# ------------------------------------------------------- waypoint predictor
def _wp_cfgs(use_rgb):
    kw = dict(hidden_dim=64, num_heads=4, num_layers=2,
              intermediate_size=128, rgb_feat_dim=96, depth_feat_dim=48,
              use_rgb=use_rgb)
    return JW.WaypointConfig(**kw), TW.WaypointConfig(**kw)


@pytest.mark.parametrize("use_rgb", [True, False], ids=["rgb", "depth_only"])
def test_waypoint_predictor_matches_jax(use_rgb):
    """(B*12, feats) -> (B, 120, 12) logits within 1e-5; the depth-only
    variant has no merge layer in either package."""
    jcfg, tcfg = _wp_cfgs(use_rgb)
    rng = np.random.default_rng(5)
    rgb = rng.standard_normal((24, 96)).astype(np.float32)
    depth = rng.standard_normal((24, 48)).astype(np.float32)
    jm = JW.WaypointPredictor(jcfg)
    jr = jnp.asarray(rgb) if use_rgb else None
    params = _np_tree(jm.init(jax.random.PRNGKey(4), jr, jnp.asarray(depth)))
    want = jm.apply(params, jr, jnp.asarray(depth))
    tm = load_flax_params(TW.WaypointPredictor(tcfg), params).eval()
    assert hasattr(tm, "visual_merge") == use_rgb
    with torch.no_grad():
        got = tm(torch.from_numpy(rgb) if use_rgb else None,
                 torch.from_numpy(depth))
    assert got.shape == (2, 120, 12)
    assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_neighbor_mask_matches_jax():
    for n, k in ((12, 1), (12, 2), (7, 3)):
        np.testing.assert_array_equal(
            TW.neighbor_attention_mask(n, k).numpy(),
            np.asarray(JW.neighbor_attention_mask(n, k)))


# --------------------------------------------------------------------- NMS
def _nms_both(hm, mp, sigma):
    got = TW.waypoint_nms(torch.from_numpy(hm), max_predictions=mp,
                          sigma=sigma).numpy()
    want = np.asarray(JW.waypoint_nms(jnp.asarray(hm), max_predictions=mp,
                                      sigma=sigma))
    np.testing.assert_array_equal(got, want)
    return got


def test_nms_random_heatmaps_bit_exact():
    """Softmax heatmaps as the agent makes them, at the agent's and other
    settings: the kept peaks, bit for bit."""
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(6, 120 * 12)).astype(np.float32) * 3
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1)).reshape(
        6, 120, 12)
    for mp, sigma in ((5, (7.0, 5.0)), (10, (4.0, 4.0)), (3, (2.0, 9.0))):
        out = _nms_both(probs, mp, sigma)
        assert ((out > 0).sum(axis=(1, 2)) <= mp).all()


def test_nms_tie_takes_first_flat_index():
    """Equal maxima: the first in flat (angle-major) order wins, as the
    reference's torch.max and jnp.argmax choose."""
    hm = np.zeros((1, 120, 12), np.float32)
    hm[0, 30, 4] = hm[0, 90, 2] = 2.0
    out = _nms_both(hm, 1, (4.0, 4.0))
    assert out[0, 30, 4] == 2.0 and out[0, 90, 2] == 0.0


def test_nms_quirk_pad_row_duplicate_burns_iteration():
    """An angle-0 peak duplicated onto the trailing pad row is picked there
    later and stripped; its window reaches back across the boundary to kill
    the weaker angle-118 peak."""
    hm = np.zeros((1, 120, 12), np.float32)
    hm[0, 0, 5] = 3.0
    hm[0, 118, 5] = 2.5
    for mp in (2, 4):
        out = _nms_both(hm, mp, (4.0, 4.0))
        assert out[0, 0, 5] > 0 and out[0, 118, 5] == 0


def test_nms_quirk_one_sided_distance_wrap():
    """min(|dx|, |dx + D|): a far-distance peak suppresses the near bins of
    its column, not the reverse."""
    hm = np.zeros((1, 120, 12), np.float32)
    hm[0, 50, 11] = 3.0
    hm[0, 50, 1] = 2.5
    out = _nms_both(hm, 2, (4.0, 4.0))
    assert out[0, 50, 11] > 0 and out[0, 50, 1] == 0
    hm2 = np.zeros((1, 120, 12), np.float32)
    hm2[0, 50, 1] = 3.0
    hm2[0, 50, 11] = 2.5
    out2 = _nms_both(hm2, 2, (4.0, 4.0))
    assert out2[0, 50, 1] > 0 and out2[0, 50, 11] == 2.5


def test_nms_quirk_fractional_angle_center():
    """y = ix / W true division: at distance bin > 0 the angle window is
    [ang - (sigma-1), ang + sigma]."""
    hm = np.zeros((1, 120, 12), np.float32)
    hm[0, 50, 6] = 3.0
    hm[0, 46, 6] = 2.5    # dy = -4.5 -> survives
    hm[0, 54, 6] = 2.0    # dy = +3.5 -> suppressed
    out = _nms_both(hm, 3, (4.0, 4.0))
    assert out[0, 50, 6] > 0 and out[0, 46, 6] == 2.5 and out[0, 54, 6] == 0


def test_nms_quirk_sigma_order():
    """sigma[0] is the distance radius, sigma[1] the angle radius."""
    hm = np.zeros((1, 120, 12), np.float32)
    hm[0, 60, 0] = 3.0
    hm[0, 60, 6] = 2.0    # 6 distance bins away
    hm[0, 63, 0] = 1.0    # 3 angle rows away
    out = _nms_both(hm, 3, (7.0, 2.0))
    assert out[0, 60, 6] == 0 and out[0, 63, 0] == 1.0


# ---------------------------------------------------------------- importers
def test_torchvision_resnet50_import_matches_jax():
    """The same torchvision-layout dict through both importers gives the
    same weights, and the tower imported directly equals the JAX one
    converted."""
    from test_resnet_towers import LAYERS, TResNet50, _randomize_bn_stats

    rng = np.random.default_rng(7)
    tm = TResNet50()
    with torch.no_grad():
        _randomize_bn_stats(tm, rng)
    sd = tm.state_dict()
    jm = JR.ResNet50Backbone(layers=LAYERS)
    template = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    want = flax_to_state_dict(_np_tree(JR.import_torchvision_resnet50(
        sd, template, layers=LAYERS)), TR.ResNet50Backbone(LAYERS))
    got = TR.import_torchvision_resnet50(sd, TR.ResNet50Backbone(LAYERS))
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    # the tower's own key prefix
    tower = TR.RgbResNet50Tower(LAYERS)
    tower.load_state_dict(TR.import_torchvision_resnet50(sd, tower))


def test_ddppo_import_matches_jax():
    from test_resnet_towers import LAYERS, TDdppoEncoder

    tm = TDdppoEncoder()
    sd = tm.state_dict()
    jm = JR.DdppoDepthEncoder(layers=LAYERS)
    template = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 1)))
    port = TR.DdppoDepthEncoder(layers=LAYERS, input_size=128)
    want = flax_to_state_dict(_np_tree(JR.import_ddppo_depth_encoder(
        sd, template, layers=LAYERS)), port)
    got = TR.import_ddppo_depth_encoder(sd, port)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("use_rgb", [True, False], ids=["rgb", "depth_only"])
def test_waypoint_import_matches_jax(use_rgb):
    """A TRM_net-layout dict: the same weights and the same report (the
    depth-only checkpoint's merge weights reported unused) from both
    importers."""
    from test_waypoint import _build_torch_trm

    sd = _build_torch_trm(use_rgb, rgb_dim=96, depth_dim=48).state_dict()
    jcfg, tcfg = _wp_cfgs(use_rgb)
    jm = JW.WaypointPredictor(jcfg)
    template = jm.init(jax.random.PRNGKey(0), jnp.zeros((24, 96)),
                       jnp.zeros((24, 48)))
    jparams, jrep = JCK.import_torch_waypoint(sd, template, num_layers=2,
                                              use_rgb=use_rgb)
    port = TW.WaypointPredictor(tcfg)
    got, rep = TCK.import_torch_waypoint(sd, port, num_layers=2,
                                         use_rgb=use_rgb)
    assert rep == jrep
    assert not rep["unfilled_flax_leaves"]
    want = flax_to_state_dict(_np_tree(jparams), port)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_timm_vit_import_matches_jax():
    """A timm vit_base_patch16_224-layout dict at tiny width (nested under
    'model.'): the same weights from both importers."""
    import dataclasses

    import gridmm_tpu.models.clip_vit as JV
    import gridmm_tpu_torch.models.clip_vit as TV
    from torch_parity import port_clip_config

    jcfg = dataclasses.replace(JV.vit_b16_timm(), input_resolution=32,
                               width=64, layers=2, heads=4,
                               compute_dtype="float32")
    jm = JV.ClipVisionTransformer(jcfg)
    template = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    rng = np.random.default_rng(8)
    w, p, t = 64, 16, (32 // 16) ** 2 + 1

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.02
    sd = {"patch_embed.proj.weight": r(w, 3, p, p),
          "patch_embed.proj.bias": r(w), "cls_token": r(1, 1, w),
          "pos_embed": r(1, t, w), "norm.weight": r(w), "norm.bias": r(w),
          "head.weight": r(10, w), "head.bias": r(10)}
    for i in range(2):
        for name, shape in (("attn.qkv.weight", (3 * w, w)),
                            ("attn.qkv.bias", (3 * w,)),
                            ("attn.proj.weight", (w, w)),
                            ("attn.proj.bias", (w,)),
                            ("mlp.fc1.weight", (4 * w, w)),
                            ("mlp.fc1.bias", (4 * w,)),
                            ("mlp.fc2.weight", (w, 4 * w)),
                            ("mlp.fc2.bias", (w,)),
                            ("norm1.weight", (w,)), ("norm1.bias", (w,)),
                            ("norm2.weight", (w,)), ("norm2.bias", (w,))):
            sd[f"blocks.{i}.{name}"] = r(*shape)
    sd = {f"model.{k}": torch.from_numpy(v) for k, v in sd.items()}
    jparams = JCK.import_timm_vit(sd, template, layers=2)
    port = TV.ClipVisionTransformer(port_clip_config(jcfg))
    want = flax_to_state_dict(_np_tree(jparams), port)
    got = TCK.import_timm_vit(sd, port)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


# ----------------------------------------------------------- full factory
def test_full_factory_tower_shapes():
    """tiny=False wires the ResNet towers to the (2048*7*7) / (128*4*4)
    waypoint contracts (shapes only, on the meta device)."""
    with torch.device("meta"):
        rgb = TR.RgbResNet50Tower()(
            torch.zeros((1, 224, 224, 3), dtype=torch.uint8))
        dep = TR.DdppoDepthEncoder()(torch.zeros((1, 256, 256, 1)))
        wp = TW.WaypointPredictor(TW.WaypointConfig())(
            torch.zeros((12, 2048 * 49)), torch.zeros((12, 128 * 16)))
    assert rgb.shape == (1, 2048 * 7 * 7)
    assert dep.shape == (1, 128 * 4 * 4)
    assert wp.shape == (1, 120, 12)

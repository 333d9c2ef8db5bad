"""Port vs JAX package: ops/masking.py and ops/geometry.py on the CPU.

Integer outputs (cell ids, masks, counts) must match bit for bit; f32 values
within 1e-5 (absolute and relative)."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import gridmm_tpu.config as JC  # noqa: E402
import gridmm_tpu.ops.geometry as JG  # noqa: E402
import gridmm_tpu.ops.masking as JM  # noqa: E402
import gridmm_tpu_torch.ops.geometry as TG  # noqa: E402
import gridmm_tpu_torch.ops.masking as TM  # noqa: E402
from torch_parity import assert_close, port_config  # noqa: E402


def T(x):
    return torch.from_numpy(np.array(x))


def test_masking_functions():
    rng = np.random.default_rng(0)
    lengths = rng.integers(0, 12, size=5).astype(np.int32)
    np.testing.assert_array_equal(
        TM.seq_mask(T(lengths), 12).numpy(),
        np.asarray(JM.seq_mask(jnp.asarray(lengths), 12)))
    mask = rng.random((4, 9)) < 0.5
    assert_close(TM.attn_bias_from_mask(T(mask)),
                 JM.attn_bias_from_mask(jnp.asarray(mask)), atol=0, rtol=0)
    assert_close(TM.attn_bias_from_mask(T(mask), neg=-1e9),
                 JM.attn_bias_from_mask(jnp.asarray(mask), neg=-1e9),
                 atol=0, rtol=0)
    logits = rng.standard_normal((4, 9)).astype(np.float32)
    assert_close(TM.mask_logits(T(logits), T(mask)),
                 JM.mask_logits(jnp.asarray(logits), jnp.asarray(mask)),
                 atol=0, rtol=0)
    for occupancy in (0.05, 0.3, 0.8):
        cm = rng.random((6, 196)) < occupancy
        cm[0] = False
        np.testing.assert_array_equal(
            TM.compaction_stray_count(T(cm)).numpy(),
            np.asarray(JM.compaction_stray_count(jnp.asarray(cm))))


@pytest.mark.parametrize("convention", ["discrete", "ce"])
def test_angle_and_position_features(convention):
    rng = np.random.default_rng(1)
    half = rng.uniform(0.5, 12.0, size=(3,)).astype(np.float32)
    assert_close(TG.gridmap_pos_fts(T(half), 14, 14, 30.0, convention),
                 JG.gridmap_pos_fts(jnp.asarray(half), 14, 14, 30.0,
                                    convention))
    dx, dy, dz = (rng.standard_normal(50).astype(np.float32)
                  for _ in range(3))
    for got, want in zip(TG.rel_heading_elevation(T(dx), T(dy), T(dz)),
                         JG.rel_heading_elevation(jnp.asarray(dx),
                                                  jnp.asarray(dy),
                                                  jnp.asarray(dz))):
        assert_close(got, want)
    assert_close(TG.angle_fts(T(dx), T(dy), 8),
                 JG.angle_fts(jnp.asarray(dx), jnp.asarray(dy), 8))
    assert_close(TG.lateral_offsets(), JG.lateral_offsets(), atol=0, rtol=0)


def test_frame_quantize_and_target_cell():
    rng = np.random.default_rng(2)
    b, n = 4, 300
    px, py = (rng.uniform(-8, 8, size=(b, n)).astype(np.float32)
              for _ in range(2))
    pos = rng.uniform(-2, 2, size=(b, 2)).astype(np.float32)
    head = rng.uniform(-np.pi, np.pi, size=(b,)).astype(np.float32)
    args = (px, py, pos[:, :1], pos[:, 1:], head[:, None])
    got = TG.rotate_into_agent_frame(*map(T, args), heading_sign=-1.0,
                                     heading_offset=np.pi)
    want = JG.rotate_into_agent_frame(*map(jnp.asarray, args),
                                      heading_sign=-1.0,
                                      heading_offset=np.pi)
    for g_, w_ in zip(got, want):
        assert_close(g_, w_)
    half = rng.uniform(4, 10, size=(b, 1)).astype(np.float32)
    mx, my = (np.asarray(w_) for w_ in want)
    np.testing.assert_array_equal(
        TG.quantize_to_cells(T(mx), T(my), T(half)).numpy(),
        np.asarray(JG.quantize_to_cells(jnp.asarray(mx), jnp.asarray(my),
                                        jnp.asarray(half))))
    mins = [rng.uniform(-9, -1, size=b).astype(np.float32) for _ in range(2)]
    maxs = [rng.uniform(1, 9, size=b).astype(np.float32) for _ in range(2)]
    hl_args = (mins[0], maxs[0], mins[1], maxs[1], pos[:, 0], pos[:, 1])
    assert_close(TG.compute_half_len(*map(T, hl_args)),
                 JG.compute_half_len(*map(jnp.asarray, hl_args)))
    tgt = rng.uniform(-6, 6, size=(2, b)).astype(np.float32)
    tc_args = (tgt[0], tgt[1], pos[:, 0], pos[:, 1], head, half[:, 0])
    np.testing.assert_array_equal(
        TG.target_cell_id(*map(T, tc_args)).numpy(),
        np.asarray(JG.target_cell_id(*map(jnp.asarray, tc_args))))


@pytest.mark.parametrize("preset", ["r2r", "r2r_ce"])
def test_point_buffer_append_and_assignment_through_clamp(preset):
    """16 appends into a 15-step buffer: the 16th write clamps its start to
    N - 588 while count keeps growing; cell ids match at every step."""
    jgrid = dataclasses.replace(getattr(JC, f"{preset}_config")().grid,
                                feature_dim=8)
    if preset == "r2r_ce":
        jgrid = dataclasses.replace(jgrid, max_steps=15)
    tgrid = port_config(JC.GridMMConfig(grid=jgrid)).grid
    b, ppstep = 2, jgrid.points_per_step
    cap = 15 * ppstep
    rng = np.random.default_rng(3)
    jstate = JG.PointCloudState.create(b, jgrid, cap)
    tstate = TG.PointCloudState.create(b, tgrid, cap, device="cpu")
    scale = jgrid.depth_scale
    flips = 0
    for step in range(16):
        depth = (rng.uniform(0.5, 6.0, size=(b, 12, 49)) * scale
                 ).astype(np.float32)
        depth[rng.random(depth.shape) < 0.1] = 0.0
        feats = rng.standard_normal((b, ppstep, 8)).astype(np.float32)
        w = rng.standard_normal((b, ppstep)).astype(np.float32)
        pos = rng.uniform(-4, 4, size=(b, 2)).astype(np.float32)
        head = rng.uniform(-np.pi, np.pi, size=(b,)).astype(np.float32)
        jstate = JG.append_panorama(jstate, jnp.asarray(depth),
                                    jnp.asarray(feats), jnp.asarray(pos),
                                    jgrid, jnp.asarray(w),
                                    headings=jnp.asarray(head))
        tstate = TG.append_panorama(tstate, T(depth), T(feats), T(pos),
                                    tgrid, T(w), headings=T(head))
        np.testing.assert_array_equal(tstate.count.numpy(),
                                      np.asarray(jstate.count))
        for f in ("valid", "inserted"):
            np.testing.assert_array_equal(getattr(tstate, f).numpy(),
                                          np.asarray(getattr(jstate, f)))
        for f in ("xy", "features", "weights"):
            assert_close(getattr(tstate, f), getattr(jstate, f), msg=f)
        jc, jh, jp = JG.egocentric_grid_assignment(
            jstate, jnp.asarray(pos), jnp.asarray(head), jgrid)
        tc, th, tp = TG.egocentric_grid_assignment(tstate, T(pos), T(head),
                                                   tgrid)
        assert tc.dtype == torch.int32
        flips += int((tc.numpy() != np.asarray(jc)).sum())
        assert_close(th, jh)
        assert_close(tp, jp)
    assert int(tstate.count[0]) == 16 * ppstep
    # no boundary cell flipped: sin/cos and the quantization agree bit for
    # bit on these inputs
    assert flips == 0

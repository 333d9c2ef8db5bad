"""Port vs JAX package on the CPU: the VLN-CE step assembly and its loss.

The device features (angle, rel-pos, trajectory, start), `device_candidates`
(zero entries tie on one key: a stable sort keeps them in index order),
the train-time sector sampling, and `device_build_step` over an episode of
the synthetic arena against the host path (`CEAgent._build_step`) of both
packages, as tests/test_ce_device_step.py drives the JAX twins; the CE
action head; and the teacher-forced loss on that head, loss and gradients
against `jax.grad`. The quirks of the reference (candidate "distances" that
carry angles, the per-env angle-table aliasing, the sector-0 off-by-5) are
part of what must agree.

Tolerances: integer and boolean fields and candidate bins bit-exact; the
host path's float fields bit-exact between the packages (the same numpy);
the device path within 1e-5 of the JAX device path and 1e-4 of the host
path (f32 against f64 arithmetic, as the JAX test holds it); the loss within
1e-5 relative and every gradient leaf within 1e-4 of its max.
"""

import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import gridmm_tpu.ce.agent as JA  # noqa: E402
import gridmm_tpu.ce.device_step as JD  # noqa: E402
import gridmm_tpu.models.waypoint as JW  # noqa: E402
import gridmm_tpu.train.step as JS  # noqa: E402
import gridmm_tpu_torch.ce.agent as TA  # noqa: E402
import gridmm_tpu_torch.ce.device_step as TD  # noqa: E402
import gridmm_tpu_torch.train.step as TS  # noqa: E402
from gridmm_tpu.ce.env import SyntheticContinuousEnv  # noqa: E402
from gridmm_tpu_torch.ce.factory import tiny_ce_configs  # noqa: E402
from gridmm_tpu_torch.convert import to_flax_tree  # noqa: E402
from torch_parity import (assert_close, jax_navigator,  # noqa: E402
                          jax_tiny_ce_config, port_config, port_navigator)

EXACT = {"nav_types", "view_mask", "gmap_step_ids", "gmap_mask",
         "gmap_visited_mask", "cur_node_idx", "cand_gmap_idx",
         "vp_nav_mask", "fused_add_idx", "cand_backtrack_mask", "target",
         "grid_target", "vp_obj_mask", "obj_target"}


@pytest.fixture(scope="module")
def cfgs():
    jcfg = jax_tiny_ce_config()
    tcfg = port_config(jcfg)
    assert tcfg == tiny_ce_configs()[0]
    return jcfg, tcfg


def _t(a):
    return torch.from_numpy(np.array(a))


def _nms_maps(rng, b, mp=5):
    logits = rng.normal(size=(b, 120 * 12)).astype(np.float32) * 3
    probs = jax.nn.softmax(jnp.asarray(logits), -1).reshape(b, 120, 12)
    nms = JW.waypoint_nms(probs, max_predictions=mp, sigma=(7.0, 5.0))
    return np.array(nms), np.array(probs)


# ------------------------------------------------------------- features
def test_traj_and_start_features_match_jax_and_host():
    rng = np.random.default_rng(1)
    af, max_dist, max_step = 4, 25.0, 20.0
    b, cap = 3, 8
    lens = np.array([1, 4, 8], np.int32)
    heads = rng.uniform(0, 2 * np.pi, b).astype(np.float32)
    tp = np.zeros((b, cap, 3), np.float32)
    td = np.zeros((b, cap), np.float32)
    for i in range(b):
        tp[i, : lens[i]] = rng.normal(size=(lens[i], 3)) * 3
        td[i, 1: lens[i]] = rng.uniform(0.1, 2.0, max(lens[i] - 1, 0))
    tp[1, 2] = tp[1, 3]   # a node on the current position: (0, 0, 0)
    args = (af, max_dist, max_step)
    got_tf = TD.device_traj_pos_features(_t(tp), _t(td), _t(lens), _t(heads),
                                         *args)
    got_sf = TD.device_start_pos_features(_t(tp), _t(td), _t(lens),
                                          _t(heads), *args)
    want_tf = JD.device_traj_pos_features(
        jnp.asarray(tp), jnp.asarray(td), jnp.asarray(lens),
        jnp.asarray(heads), *args)
    want_sf = JD.device_start_pos_features(
        jnp.asarray(tp), jnp.asarray(td), jnp.asarray(lens),
        jnp.asarray(heads), *args)
    for i in range(b):
        n = lens[i]
        assert_close(got_tf[i, :n], np.asarray(want_tf)[i, :n], 1e-5, 1e-5)
        pos = [tp[i, j].astype(np.float64) for j in range(n)]
        dist = [float(td[i, j]) for j in range(n)]
        host_tf = TA.traj_pos_features(pos, dist, float(heads[i]), *args)
        np.testing.assert_array_equal(
            host_tf, JA.traj_pos_features(pos, dist, float(heads[i]), *args))
        assert_close(got_tf[i, :n], host_tf, 2e-5, 2e-5)
        host_sf = TA.start_pos_features(pos, dist, float(heads[i]), *args)
        np.testing.assert_array_equal(
            host_sf, JA.start_pos_features(pos, dist, float(heads[i]), *args))
        assert_close(got_sf[i], host_sf, 2e-5, 2e-5)
    assert_close(got_sf, want_sf, 1e-5, 1e-5)
    h = rng.uniform(-4, 4, (5,)).astype(np.float32)
    e = rng.uniform(-1, 1, (5,)).astype(np.float32)
    for af in (4, 8):
        assert_close(TD.device_angle_features(_t(h), _t(e), af),
                     JD.device_angle_features(jnp.asarray(h),
                                              jnp.asarray(e), af), 1e-6, 1e-6)


# ----------------------------------------------------------- candidates
def test_device_candidates_match_jax_and_host():
    """Random NMS maps, an all-zero map and maps with fewer peaks than
    slots: every slot (the zero-score fillers too, whose keys tie) equal to
    JAX's; the valid ones equal to the host enumeration."""
    rng = np.random.default_rng(0)
    nms, _ = _nms_maps(rng, 4)
    nms = np.concatenate([nms, np.zeros((1, 120, 12), np.float32),
                          _nms_maps(rng, 1, mp=2)[0]])
    got = TD.device_candidates(_t(nms), 5)
    want = JD.device_candidates(jnp.asarray(nms), 5)
    for f in ("ang_bins", "dist_bins", "scores", "mask"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    for i in range(nms.shape[0]):
        heading = float(rng.uniform(0, 2 * np.pi))
        host = TA.CEAgent.candidates_from_nms(nms[i], heading, 5)
        assert host == JA.CEAgent.candidates_from_nms(nms[i], heading, 5)
        assert int(got.mask[i].sum()) == len(host)
        for j, (h, dst, sc) in enumerate(host):
            a, d = int(got.ang_bins[i, j]), int(got.dist_bins[i, j])
            assert h == heading + a * (2 * math.pi / TD.NUM_ANGLES)
            assert dst == (d + 1) * TD.DIST_BIN
            assert float(got.scores[i, j]) == sc


def test_train_sampling_matches_jax():
    """Sector re-sampling (Policy:393-425) with the same generator state in
    both packages: the same candidates, sector 0's off-by-5 included."""
    rng = np.random.default_rng(2)
    nms, probs = _nms_maps(rng, 3)
    nms[2] = 0.0
    nms[2, 117, 3] = 0.5   # a sector-0 peak (wraps)
    for i in range(3):
        got = TA.CEAgent.candidates_from_nms(
            nms[i], 0.3, 5, probs=probs[i], rng=np.random.default_rng(i))
        want = JA.CEAgent.candidates_from_nms(
            nms[i], 0.3, 5, probs=probs[i], rng=np.random.default_rng(i))
        assert got == want


# --------------------------------------------------------- step assembly
def _agents(jcfg, tcfg):
    """Bare agents of both packages: _build_step needs only the config."""
    return (JA.CEAgent(jcfg, None, None, None, None),
            TA.CEAgent(tcfg, None, None, None, None, None))


def _device_step_both(jcfg, tcfg, nms, view_cls, view_feats, depth, obs,
                      tpos, tdist, tlen, t, ended):
    pos = np.stack([ob.position for ob in obs]).astype(np.float32)
    head = np.asarray([ob.heading for ob in obs], np.float32)
    got = TD.device_build_step(
        tcfg, TD.device_candidates(_t(nms), 5), _t(view_cls), _t(depth),
        _t(pos), _t(head), _t(tpos), _t(tdist), _t(tlen), t,
        view_feats=None if view_feats is None else _t(view_feats),
        ended=None if ended is None else _t(ended))
    want = JD.device_build_step(
        jcfg, JD.device_candidates(jnp.asarray(nms), 5),
        jnp.asarray(view_cls), jnp.asarray(depth), jnp.asarray(pos),
        jnp.asarray(head), jnp.asarray(tpos), jnp.asarray(tdist),
        jnp.asarray(tlen), np.int32(t),
        view_feats=None if view_feats is None else jnp.asarray(view_feats),
        ended=None if ended is None else jnp.asarray(ended))
    return got, want


def _compare_steps(got, want, tol, what):
    for f in TS.StepInputs._fields:
        g = np.asarray(getattr(got, f))
        w = np.asarray(getattr(want, f))
        assert g.shape == w.shape, (what, f)
        if f in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}: {f}")
        else:
            assert_close(g, w, rtol=0, atol=tol, msg=f"{what}: {f}")


@pytest.mark.parametrize("view_tower", [False, True],
                         ids=["clip_cls", "view_tower"])
def test_device_build_step_matches_host_over_episode(cfgs, view_tower):
    """Four steps of three envs walking their first candidate; env 1 ends
    after step 1, which takes it out of the angle-table chain. Host paths
    of the two packages equal, device paths within 1e-5, device vs host
    within 1e-4."""
    jcfg, tcfg = cfgs
    jagent, tagent = _agents(jcfg, tcfg)
    b, d = 3, jcfg.model.image_feat_size
    rng = np.random.default_rng(3)
    env = SyntheticContinuousEnv(num_envs=b, image_size=8, depth_size=256,
                                 seed=3)
    obs = env.reset()
    centers = np.asarray([19 + 36 * i for i in range(7)])
    cap = jcfg.model.max_action_steps
    tpos = np.zeros((b, cap, 3), np.float32)
    tdist = np.zeros((b, cap), np.float32)
    ended = np.zeros((b,), bool)
    for t in range(4):
        nms, _ = _nms_maps(rng, b)
        view_cls = rng.standard_normal((b, 12, d)).astype(np.float32)
        view_feats = (rng.standard_normal((b, 12, 2 * d)).astype(np.float32)
                      if view_tower else None)
        depth = np.stack([ob.depth for ob in obs])
        cands = [TA.CEAgent.candidates_from_nms(nms[i], obs[i].heading, 5)
                 for i in range(b)]
        x_t, _ = tagent._build_step(obs, cands, view_cls, centers,
                                    np.ones(b, np.int32), t,
                                    view_feats=view_feats, ended=ended)
        x_j, _ = jagent._build_step(obs, cands, view_cls, centers,
                                    np.ones(b, np.int32), t,
                                    view_feats=view_feats, ended=ended)
        _compare_steps(x_t, x_j, 0.0, f"host step {t}")
        for i, ob in enumerate(obs):
            p3 = np.array([ob.position[0], 0.0, ob.position[1]], np.float32)
            tdist[i, t] = (0.0 if t == 0 else
                           float(np.linalg.norm(p3 - tpos[i, t - 1])))
            tpos[i, t] = p3
        tlen = np.full((b,), t + 1, np.int32)
        got, want = _device_step_both(jcfg, tcfg, nms, view_cls, view_feats,
                                      depth, obs, tpos, tdist, tlen, t,
                                      ended.copy())
        _compare_steps(got, want, 1e-5, f"device step {t}")
        _compare_steps(got, x_t, 1e-4, f"device vs host step {t}")
        for i in range(b):
            if cands[i] and not ended[i]:
                h, dst, _ = cands[i][0]
                env.step_to(i, h, dst)
        if t == 1:
            ended[1] = True
        obs = env.observations()


def test_device_build_step_zero_candidates(cfgs):
    """An all-zero NMS map: the view-only panorama and masks on every
    path."""
    jcfg, tcfg = cfgs
    jagent, tagent = _agents(jcfg, tcfg)
    b, d = 2, jcfg.model.image_feat_size
    rng = np.random.default_rng(5)
    env = SyntheticContinuousEnv(num_envs=b, image_size=8, depth_size=256,
                                 seed=5)
    obs = env.reset()
    cap = jcfg.model.max_action_steps
    tpos = np.zeros((b, cap, 3), np.float32)
    for i, ob in enumerate(obs):
        tpos[i, 0] = [ob.position[0], 0.0, ob.position[1]]
    view_cls = rng.standard_normal((b, 12, d)).astype(np.float32)
    nms = np.zeros((b, 120, 12), np.float32)
    cands = [TA.CEAgent.candidates_from_nms(nms[i], obs[i].heading, 5)
             for i in range(b)]
    assert cands == [[], []]
    centers = np.asarray([19 + 36 * i for i in range(7)])
    x_t, _ = tagent._build_step(obs, cands, view_cls, centers,
                                np.ones(b, np.int32), 0)
    got, want = _device_step_both(
        jcfg, tcfg, nms, view_cls, None, np.stack([ob.depth for ob in obs]),
        obs, tpos, np.zeros((b, cap), np.float32), np.ones(b, np.int32), 0,
        None)
    _compare_steps(got, want, 1e-5, "device")
    _compare_steps(got, x_t, 1e-4, "device vs host")


# ------------------------------------------------------------ action head
def test_ce_action_logits_match_jax():
    rng = np.random.default_rng(6)
    b, g, v = 4, 16, 20
    glob = rng.standard_normal((b, g)).astype(np.float32)
    loc = rng.standard_normal((b, v)).astype(np.float32)
    loc[rng.random((b, v)) < 0.4] = -np.inf
    cand = rng.integers(-1, g, size=(b, v - 1)).astype(np.int32)
    got = TD.ce_action_logits(_t(glob), _t(loc), _t(cand))
    want = JD.ce_action_logits(jnp.asarray(glob), jnp.asarray(loc),
                               jnp.asarray(cand))
    assert_close(got, want, rtol=0, atol=0)


# ----------------------------------------------------------- the CE loss
def _episode_batch(jcfg, rng, b=2, s=3):
    """A TrajectoryBatch (numpy) of s host-assembled CE steps of the
    synthetic arena, with random CLIP tokens and teacher targets drawn from
    [stop] + each step's candidates."""
    jagent = JA.CEAgent(jcfg, None, None, None, None)
    env = SyntheticContinuousEnv(num_envs=b, image_size=8, depth_size=256,
                                 seed=7)
    obs = env.reset()
    centers = np.asarray([19 + 36 * i for i in range(7)])
    d = jcfg.model.image_feat_size
    steps = []
    for t in range(s):
        nms, _ = _nms_maps(rng, b)
        cands = [JA.CEAgent.candidates_from_nms(nms[i], obs[i].heading, 5)
                 for i in range(b)]
        x, _ = jagent._build_step(
            obs, cands, rng.standard_normal((b, 12, d)).astype(np.float32),
            centers, np.ones(b, np.int32), t)
        target = np.asarray([rng.integers(0, len(c) + 1) for c in cands],
                            np.int32)
        patch = (rng.standard_normal((b, jcfg.grid.points_per_step, d))
                 * 0.3).astype(np.float32)
        steps.append(x._replace(target=target, patch_fts=patch))
        for i in range(b):
            if cands[i]:
                env.step_to(i, *cands[i][0][:2])
        obs = env.observations()
    stacked = JS.StepInputs(*[np.stack([getattr(x, f) for x in steps])
                              for f in JS.StepInputs._fields])
    ids = np.stack([ob.instruction_ids for ob in obs])
    txt_ids = np.zeros((b, jcfg.shapes.max_txt_len), np.int32)
    txt_ids[:, :ids.shape[1]] = ids
    return JS.TrajectoryBatch(txt_ids, txt_ids > 0, stacked)


def _no_dropout(jcfg):
    return dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, feat_dropout=0.0))


def test_trajectory_loss_ce_head_matches_jax(cfgs):
    """loss_head='ce' (the CE trainer's head, per-action mean) on a
    recorded arena episode: loss within 1e-5 relative, every gradient leaf
    within 1e-4 of its max, against jax.grad. A leaf whose gradient is
    analytically zero (the global head's output bias, added to every valid
    column of the softmax alike) holds f32 noise of ~1e-8 on both sides:
    1e-7 absolute is the floor."""
    jcfg = _no_dropout(cfgs[0])
    assert jcfg.train.loss_head == "fused"   # the tiny TrainConfig default
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, loss_head="ce"))
    tcfg = port_config(jcfg)
    jmodel, params = jax_navigator(jcfg, seed=1)
    jbatch = _episode_batch(jcfg, np.random.default_rng(8))
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: JS.trajectory_loss(jmodel, jcfg, p, jax.tree.map(
            jnp.asarray, jbatch))))(params)
    tmodel = port_navigator(tcfg, params)
    batch = TS.batch_to_device(jbatch, "cpu")
    loss = TS.trajectory_loss(tmodel, tcfg, batch)
    loss.backward()
    loss = float(loss.detach())
    assert np.isfinite(loss)
    assert loss == pytest.approx(float(want_loss), rel=1e-5)
    grads = to_flax_tree({n: p.grad for n, p in tmodel.named_parameters()},
                         params)
    got = dict(jax.tree_util.tree_flatten_with_path(grads)[0])
    reached = 0
    for path, want in jax.tree_util.tree_flatten_with_path(want_grads)[0]:
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        reached += scale > 0
        assert np.abs(np.asarray(got[path]) - want).max() <= \
            1e-4 * scale + 1e-7, jax.tree_util.keystr(path)
    assert reached > 0.5 * len(got)

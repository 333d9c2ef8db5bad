"""Port vs JAX package on the CPU: the VLN-CE agent, trainer and CLI.

The tiny agent of the JAX factory, every weight carried into the port by
gridmm_tpu_torch.convert (tests/torch_parity.port_ce_agent), on the same
synthetic arena (the port keeps its own copy of the env): greedy rollouts
through the port's fused device step and its host path, with and without
the timm view tower, and teacher rollouts, must take the JAX agent's
actions (equal paths, bit for bit) and give its metrics; the inference
writer's files and a checkpoint-polling sweep; one schedule-sampled
`CETrainer.train_epoch` (dropout off, Adam eps 1e-2 as in
tests/test_torch_train.py) against JAX: loss within 1e-5 relative, the
updated parameters within 1e-5 of each leaf's max, as
tests/test_torch_train.py holds make_train_step; and the
`run_ce` CLI on the CPU, train then eval, and its parallel-layer flags
over a world of one.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import torch  # noqa: E402

import gridmm_tpu.ce.env as JENV  # noqa: E402
import gridmm_tpu_torch.ce.env as TENV  # noqa: E402
from gridmm_tpu.ce.factory import build_ce_agent as jax_build  # noqa: E402
from gridmm_tpu_torch.ce import trainer as TT  # noqa: E402
from gridmm_tpu_torch.cli import run_ce  # noqa: E402
from gridmm_tpu_torch.convert import to_flax_tree  # noqa: E402
from torch_parity import port_ce_agent, port_config  # noqa: E402


@pytest.fixture(scope="module")
def jax_agent():
    """The JAX tiny agent with the view tower (weights seed 1: its greedy
    policy moves on the arena)."""
    return jax_build(tiny=True, seed=1, view_tower=True)


def _pair(jax_agent, view_tower):
    """(jax cfg, JAX agent, port agent), with or without the view tower
    (the same weights; without it the view tokens are CLIP's cls)."""
    import gridmm_tpu.ce.agent as JA

    jcfg, jagent = jax_agent
    if not view_tower:
        jagent = JA.CEAgent(
            jcfg, jagent.navigator, jagent.nav_params, jagent.waypoint,
            jagent.wp_params, clip_model=jagent.clip,
            clip_params=jagent.clip_params, rgb_tower=jagent.rgb_tower,
            rgb_params=jagent.rgb_params, depth_tower=jagent.depth_tower,
            depth_params=jagent.depth_params)
    return jcfg, jagent, port_ce_agent(jagent)


@pytest.fixture(scope="module", params=[False, True],
                ids=["clip_cls", "view_tower"])
def agents(request, jax_agent):
    return _pair(jax_agent, request.param)


@pytest.fixture(scope="module")
def clip_agents(jax_agent):
    return _pair(jax_agent, False)


def _envs(seed, num_envs=2, num_episodes=None):
    kw = dict(num_envs=num_envs, image_size=56, depth_size=256, seed=seed,
              num_episodes=num_episodes)
    return JENV.SyntheticContinuousEnv(**kw), TENV.SyntheticContinuousEnv(**kw)


def _same_run(jm, jenv, tm, tenv):
    assert len(jenv.paths) == len(tenv.paths)
    for pj, pt in zip(jenv.paths, tenv.paths):
        np.testing.assert_array_equal(np.asarray(pt), np.asarray(pj))
    assert tm == jm


def test_greedy_rollouts_match_jax_fused_and_host(agents):
    """The JAX host-path rollout against the port's host path and its fused
    device step: the same actions, hence equal paths and metrics."""
    jcfg, jagent, tagent = agents
    jagent.fused_rollout = False
    jenv, _ = _envs(11)
    jm = jagent.rollout(jenv, max_steps=4, feedback="argmax")
    assert sum(len(p) for p in jenv.paths) > 2, "nobody moved"
    for fused in (False, True):
        tagent.fused_rollout = fused
        _, tenv = _envs(11)
        tm = tagent.rollout(tenv, max_steps=4, feedback="argmax")
        _same_run(jm, jenv, tm, tenv)


def test_fused_auto_selection_by_batch(agents):
    """fused_rollout="auto" fuses single-env greedy rollouts and takes the
    host path at B>1, the JAX package's rule."""
    from gridmm_tpu_torch.utils.logging import SectionTimer

    _, _, tagent = agents
    tagent.fused_rollout = "auto"

    def sections(num_envs):
        timer = SectionTimer()
        tagent.rollout(_envs(3, num_envs)[1], max_steps=2, timer=timer)
        return set(timer.totals)

    assert "fused_step" in sections(1)
    two = sections(2)
    assert "perception" in two and "fused_step" not in two


def test_teacher_rollout_matches_jax(agents):
    jcfg, jagent, tagent = agents
    jenv, tenv = _envs(7)
    jm = jagent.rollout(jenv, max_steps=4, feedback="teacher")
    tm = tagent.rollout(tenv, max_steps=4, feedback="teacher")
    _same_run(jm, jenv, tm, tenv)
    # the teacher moves toward the goal from the ~5 m start
    assert np.mean([m["ne"] for m in tm]) < 5.0


def test_inference_writer_matches_jax(clip_agents, tmp_path):
    """Both leaderboard formats over a finite 3-episode split: every episode
    predicted once, and the files equal to the JAX trainer's."""
    from gridmm_tpu.ce.trainer import CETrainer as JT

    jcfg, jagent, tagent = clip_agents
    jagent.fused_rollout = tagent.fused_rollout = False
    for fmt in ("r2r", "rxr"):
        jenv, tenv = _envs(0, num_episodes=3)
        jpath, tpath = tmp_path / f"j.{fmt}", tmp_path / f"t.{fmt}"
        nj = JT(jcfg, jagent).inference(jenv, str(jpath), fmt=fmt,
                                        max_steps=3)
        nt = TT.CETrainer(port_config(jcfg), tagent).inference(
            tenv, str(tpath), fmt=fmt, max_steps=3)
        assert nt == nj == 3
        assert tpath.read_text() == jpath.read_text()
    data = json.loads((tmp_path / "t.r2r").read_text())
    for infos in data.values():
        for rec in infos:
            assert len(rec["position"]) == 3 and rec["stop"] is False


def test_checkpoint_polling(clip_agents, tmp_path):
    """poll_checkpoint_dir orders by the trailing number and skips a write
    in flight ('<name>.tmp.<pid>' before its rename);
    evaluate_checkpoints_polling restores each one's 'params' and
    evaluates it."""
    jcfg, _, tagent = clip_agents
    trainer = TT.CETrainer(port_config(jcfg), tagent)
    ckpt_dir = tmp_path / "ckpts"
    ckpt_dir.mkdir()
    assert TT.poll_checkpoint_dir(str(ckpt_dir), -1) is None
    for i in (0, 1):
        trainer.save(str(ckpt_dir / f"ckpt.{i}"))
    trainer.flush()
    assert TT.poll_checkpoint_dir(str(ckpt_dir), -1).endswith("ckpt.0")
    assert TT.poll_checkpoint_dir(str(ckpt_dir), 0).endswith("ckpt.1")
    (ckpt_dir / "ckpt.2.tmp.12345").write_bytes(b"")
    (ckpt_dir / "latest").write_bytes(b"")
    assert TT.poll_checkpoint_dir(str(ckpt_dir), 1) is None
    assert TT.latest_checkpoint(str(ckpt_dir)).endswith("ckpt.1")
    results = TT.evaluate_checkpoints_polling(
        trainer, TENV.SyntheticContinuousEnv(
            num_envs=2, image_size=56, depth_size=256, seed=1),
        str(ckpt_dir), batches=1, max_steps=2)
    assert len(results) == 2
    assert all("sr" in r and "checkpoint" in r for r in results)
    assert trainer.restore(str(ckpt_dir / "ckpt.1")) == 0


def test_train_epoch_matches_jax(clip_agents):
    """One schedule-sampled epoch (one batch of 2 envs x 3 steps): the same
    sampled candidates, teacher and student actions, then one update."""
    from gridmm_tpu.ce.trainer import CETrainer as JT
    from gridmm_tpu.models.navigator import GridMMNavigator

    jcfg, jagent, _ = clip_agents
    jcfg = dataclasses.replace(
        jcfg,
        model=dataclasses.replace(jcfg.model, hidden_dropout_prob=0.0,
                                  attention_probs_dropout_prob=0.0,
                                  feat_dropout=0.0),
        train=dataclasses.replace(jcfg.train, adam_eps=1e-2))
    jagent.navigator = GridMMNavigator(jcfg.model)  # the loss's module
    tcfg = port_config(jcfg)
    tagent = port_ce_agent(jagent, tcfg)
    before = jax.tree.map(np.asarray, jagent.nav_params)
    jtrainer, ttrainer = JT(jcfg, jagent), TT.CETrainer(tcfg, tagent)
    jenv, tenv = _envs(4)
    js = jtrainer.train_epoch(jenv, 0, batches=1, max_steps=3, seed=0)
    ts = ttrainer.train_epoch(tenv, 0, batches=1, max_steps=3, seed=0)
    for pj, pt in zip(jenv.paths, tenv.paths):
        np.testing.assert_array_equal(np.asarray(pt), np.asarray(pj))
    assert ts["ss_ratio"] == js["ss_ratio"]
    assert ts["loss"] == pytest.approx(js["loss"], rel=1e-5)
    after = to_flax_tree(dict(tagent.navigator.named_parameters()), before)
    flat_b = dict(jax.tree_util.tree_flatten_with_path(before)[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path(after)[0])
    moved = 0
    for path, want in jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, jagent.nav_params))[0]:
        moved += bool((want != flat_b[path]).any())
        assert np.abs(flat_t[path] - want).max() <= \
            1e-5 * np.abs(want).max() + 1e-8, jax.tree_util.keystr(path)
    assert moved > 0.5 * len(flat_b)


# -------------------------------------------------------------------- CLI
def test_run_ce_cli_trains_then_evaluates(tmp_path):
    """`run_ce --device cpu`: one epoch of the tiny agent with a checkpoint,
    then `--run-type eval --poll_ckpt_dir` evaluates that checkpoint."""
    out = tmp_path / "ce"
    common = ["--device", "cpu", "--max_steps", "3", "--num_envs", "2",
              "--eval_batches", "1", "--output_dir", str(out)]
    metrics = run_ce.main(common + ["--epochs", "1",
                                    "--batches_per_epoch", "1"])
    assert np.isfinite(metrics["nDTW"]) and 0.0 <= metrics["sr"] <= 1.0
    ckpt = out / "checkpoints" / "ckpt.0"
    assert ckpt.exists()
    state = torch.load(ckpt, weights_only=True)
    assert set(state) >= {"params", "opt_state", "epoch"}
    polled = run_ce.main(common + ["--run-type", "eval", "--poll_ckpt_dir",
                                   str(out / "checkpoints")])
    assert polled["checkpoint"].endswith("ckpt.0")
    assert (out / "metrics.jsonl").exists()


@pytest.mark.parametrize("flags", [["--mesh", "auto"],
                                   ["--mesh", "auto", "--mp_size", "2"]],
                         ids=["mesh", "mp_size"])
def test_run_ce_parallel_flags_raise(flags, tmp_path):
    """The parallel layer is ported (parallel/): --mesh auto evaluates over
    a world of one through CETrainer(mesh=...); an --mp_size the world
    does not divide raises the JAX mesh error."""
    argv = ["--device", "cpu", "--run-type", "eval", "--eval_batches", "1",
            "--max_steps", "2", "--output_dir", str(tmp_path)] + flags
    if "--mp_size" in flags:
        with pytest.raises(ValueError, match=r"mesh 0x2 != 1 devices"):
            run_ce.main(argv)
    else:
        metrics = run_ce.main(argv)
        assert np.isfinite(metrics["nDTW"])


def test_run_ce_habitat_needs_habitat():
    """--env habitat raises where habitat is not installed, as the JAX CLI
    does."""
    from gridmm_tpu_torch.ce.habitat_env import HABITAT_AVAILABLE

    if HABITAT_AVAILABLE:
        pytest.skip("habitat is installed")
    with pytest.raises(ImportError, match="habitat"):
        run_ce.main(["--device", "cpu", "--env", "habitat",
                     "--habitat_config", "none.yaml"])


def test_run_ce_defaults_to_the_card():
    args = run_ce.parse_args([])
    assert args.device == "cuda"
    assert args.schedule_ratio == 0.5 and args.decay_time == 20
    assert run_ce.epochs_per_ratio(50, 20) == 3
    import inspect

    from gridmm_tpu_torch.ce.factory import build_ce_agent

    assert inspect.signature(build_ce_agent).parameters[
        "device"].default == "cuda"

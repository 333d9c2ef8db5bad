"""Port vs JAX package: the env/agent host layer, the rollout->replay loop
and the main_nav CLI on the CPU, at tiny width on the synthetic world.

Both agents get the same world, episodes and weights (carried by
gridmm_tpu_torch.convert): greedy and teacher rollouts must give identical
trajectories and the same recorded index maps; the evaluation metrics must
be equal.
"""

import ast
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import torch  # noqa: E402

import gridmm_tpu.config as JC  # noqa: E402
import gridmm_tpu.env.discrete as JD  # noqa: E402
import gridmm_tpu.env.world as JW  # noqa: E402
import gridmm_tpu.train.agent as JA  # noqa: E402
import gridmm_tpu_torch.env.discrete as TD  # noqa: E402
import gridmm_tpu_torch.env.world as TW  # noqa: E402
import gridmm_tpu_torch.train.agent as TA  # noqa: E402
import gridmm_tpu_torch.train.loop as TLOOP  # noqa: E402
import gridmm_tpu_torch.train.recollection as TR  # noqa: E402
import gridmm_tpu_torch.train.step as TS  # noqa: E402
from gridmm_tpu_torch.cli import main_nav as TCLI  # noqa: E402
from gridmm_tpu_torch.train.prefetch import device_prefetch  # noqa: E402
from gridmm_tpu_torch.train.synthetic import \
    synthetic_trajectory_batch  # noqa: E402
from gridmm_tpu_torch.utils.checkpoint import (AsyncSaver,  # noqa: E402
                                               restore_checkpoint,
                                               save_checkpoint)
from gridmm_tpu_torch.utils.logging import (MetricLogger,  # noqa: E402
                                            SectionTimer)
from torch_parity import (jax_navigator, port_config,  # noqa: E402
                          port_navigator)

ROOT = Path(__file__).resolve().parents[1]
BATCH = 3


def _env(world_mod, env_mod, seed=0, batch=BATCH, num=6):
    world = world_mod.SyntheticWorld(num_scans=2, nodes_per_scan=10,
                                     feat_dim=768, seed=seed)
    episodes = env_mod.synthetic_episodes(world, num=num, seed=seed,
                                          max_len=4)
    return env_mod.DiscreteNavEnv(world, world.graphs, episodes,
                                  batch_size=batch, seed=seed)


@pytest.fixture(scope="module")
def agents():
    """(jax agent, port agent) over equal worlds with equal weights."""
    jcfg = JC.tiny_config()
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, max_action_len=4))
    jmodel, params = jax_navigator(jcfg, seed=0)
    tcfg = port_config(jcfg)
    tmodel = port_navigator(tcfg, params)
    return (JA.NavAgent(jmodel, jcfg, _env(JW, JD), params),
            TA.NavAgent(tmodel, tcfg, _env(TW, TD)))


INT_FIELDS = ("nav_types", "view_mask", "gmap_step_ids", "gmap_mask",
              "gmap_visited_mask", "cur_node_idx", "cand_gmap_idx",
              "vp_nav_mask", "fused_add_idx", "cand_backtrack_mask", "target",
              "grid_target", "vp_obj_mask", "obj_target")


@pytest.mark.parametrize("feedback", ["argmax", "teacher"])
def test_rollouts_give_identical_trajectories(agents, feedback):
    """Two minibatches each: the same instr_ids, the same paths, and every
    integer and boolean field of the recorded TrajectoryBatch equal; the
    float fields (features, positions) within 1e-6."""
    jagent, tagent = agents
    for a in agents:
        a.env.reset_epoch(shuffle=False)
    for _ in range(2):
        jtraj, jbatch, jstats = jagent.rollout(feedback=feedback, record=True)
        ttraj, tbatch, tstats = tagent.rollout(feedback=feedback, record=True)
        assert jstats == tstats
        assert [t["instr_id"] for t in ttraj] == \
            [t["instr_id"] for t in jtraj]
        for got, want in zip(ttraj, jtraj):
            assert got["trajectory"] == want["trajectory"], got["instr_id"]
            assert list(got["stop_scores"]) == list(want["stop_scores"])
            np.testing.assert_allclose(list(got["stop_scores"].values()),
                                       list(want["stop_scores"].values()),
                                       atol=1e-5)
        np.testing.assert_array_equal(tbatch.txt_ids,
                                      np.asarray(jbatch.txt_ids))
        np.testing.assert_array_equal(tbatch.txt_mask,
                                      np.asarray(jbatch.txt_mask))
        for f in TS.StepInputs._fields:
            a, ref = np.asarray(getattr(tbatch.steps, f)), \
                np.asarray(getattr(jbatch.steps, f))
            if f in INT_FIELDS:
                np.testing.assert_array_equal(a, ref, err_msg=f)
            else:
                np.testing.assert_allclose(a, ref, rtol=0, atol=1e-6,
                                           err_msg=f)
    assert tagent.model.training is False


def test_sampled_rollout_uses_the_generator_passed_in(agents):
    """feedback='sample' and 'expl_sample' draw from the numpy generator
    they are given: the same seed gives the same trajectories twice, and
    the model's mode is restored afterwards."""
    _, tagent = agents
    tagent.model.train()
    runs = []
    for _ in range(2):
        tagent.env.reset_epoch(shuffle=False)
        rng = np.random.default_rng(5)
        runs.append([tagent.rollout(feedback=fb, rng=rng)[0]
                     for fb in ("sample", "expl_sample")])
    assert tagent.model.training is True
    tagent.model.eval()
    assert [[t["trajectory"] for t in r] for r in runs[0]] == \
        [[t["trajectory"] for t in r] for r in runs[1]]
    with pytest.raises(ValueError):
        tagent.rollout(feedback="greedy")


def test_evaluate_metrics_equal(agents):
    jagent, tagent = agents
    javg, jpreds = jagent.evaluate()
    tavg, tpreds = tagent.evaluate()
    # the split's order depends on how often each env wrapped around before
    got = {p["instr_id"]: p["trajectory"] for p in tpreds}
    want = {p["instr_id"]: p["trajectory"] for p in jpreds}
    assert got == want and len(got) == 6
    assert set(tavg) == set(javg)
    for k in javg:
        assert tavg[k] == pytest.approx(javg[k], rel=1e-9, abs=1e-9), k


def test_write_submission_matches_jax(agents, tmp_path):
    jagent, tagent = agents
    _, preds = tagent.evaluate(detailed_output=True)
    for fmt in ("auto", "triples", "soon", "reverie"):
        tagent.write_submission(preds, str(tmp_path / f"t_{fmt}.json"),
                                fmt=fmt)
        jagent.write_submission(preds, str(tmp_path / f"j_{fmt}.json"),
                                fmt=fmt)
        assert (tmp_path / f"t_{fmt}.json").read_text() == \
            (tmp_path / f"j_{fmt}.json").read_text()


def test_agent_rejects_a_buffer_too_small_for_the_episode():
    tcfg = port_config(JC.tiny_config())
    tcfg = dataclasses.replace(tcfg, train=dataclasses.replace(
        tcfg.train, max_action_len=99))
    with pytest.raises(ValueError, match="point buffer too small"):
        TA.NavAgent(None, tcfg, None)


# -------------------------------------------------- recollection, prefetch
def test_pad_to_steps_is_loss_neutral(agents, tmp_path):
    """Padding replays the last step with ignored targets: the loss of the
    padded batch equals the unpadded one's (1e-6 relative), for numpy and
    tensor batches; a saved batch loads back equal."""
    _, tagent = agents
    tagent.env.reset_epoch(shuffle=False)
    _, batch, _ = tagent.rollout(feedback="teacher", record=True)
    # the tiny point buffer holds 4 steps: keep 2 so that 2 more fit,
    # whatever episodes the shared environment dealt
    batch = TR.pad_to_steps(batch, min(batch.steps.target.shape[0], 2))
    s = batch.steps.target.shape[0]
    padded = TR.pad_to_steps(batch, s + 2, tagent.cfg.train.ignoreid)
    assert padded.steps.target.shape[0] == s + 2
    assert (padded.steps.target[s:] == tagent.cfg.train.ignoreid).all()
    np.testing.assert_array_equal(padded.steps.depth[s + 1],
                                  batch.steps.depth[s - 1])
    tens = TS.batch_to_device(batch, "cpu")
    padded_t = TR.pad_to_steps(tens, s + 2, tagent.cfg.train.ignoreid)
    with torch.no_grad():
        losses = [float(TS.trajectory_loss(tagent.model, tagent.cfg,
                                           TS.batch_to_device(b, "cpu")))
                  for b in (batch, padded, padded_t)]
    assert losses[1] == pytest.approx(losses[0], rel=1e-6)
    assert losses[2] == losses[1]
    cut = TR.pad_to_steps(batch, 1)
    assert cut.steps.target.shape[0] == 1

    store = TR.RecollectionStore(str(tmp_path / "rec"))
    TR.save_trajectory_batch(str(tmp_path / "rec" / "traj_000000.npz"), tens)
    assert len(store) == 1
    (loaded,) = list(store.batches(pad_steps=s + 1))
    assert loaded.steps.target.shape[0] == s + 1
    for f in TS.StepInputs._fields:
        np.testing.assert_array_equal(getattr(loaded.steps, f)[:s],
                                      getattr(batch.steps, f), err_msg=f)


def test_recollection_store_records_rollouts(agents, tmp_path):
    _, tagent = agents
    store = TR.RecollectionStore(str(tmp_path / "rec"))
    assert store.record(tagent, 2) == 2 and len(store) == 2
    batches = list(store.batches(epochs=2))
    assert len(batches) == 4
    assert batches[0].steps.target.shape[1] == BATCH


def test_device_prefetch_yields_in_order_and_raises_producer_errors():
    tcfg = port_config(JC.tiny_config())
    host = [synthetic_trajectory_batch(tcfg, 1, 2, seed=s, device="cpu")
            for s in range(3)]
    got = list(device_prefetch(iter(host), size=2, device="cpu"))
    assert len(got) == 3
    for a, ref in zip(got, host):
        assert isinstance(a, TS.TrajectoryBatch)
        assert torch.equal(a.steps.depth, ref.steps.depth)

    def broken():
        yield host[0]
        raise RuntimeError("loader failed")

    it = device_prefetch(broken(), device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="loader failed"):
        next(it)


# ------------------------------------------------------ checkpoint, logging
def test_checkpoint_round_trip_and_async_saver(tmp_path):
    tcfg = port_config(JC.tiny_config())
    from gridmm_tpu_torch.models.navigator import init_navigator

    model = init_navigator(tcfg.model, seed=1, device="cpu")
    path = str(tmp_path / "ckpts" / "latest")
    save_checkpoint(path, model.state_dict())
    other = init_navigator(tcfg.model, seed=2, device="cpu")
    restore_checkpoint(path, other)
    for (n, a), (_, b) in zip(model.state_dict().items(),
                              other.state_dict().items()):
        assert torch.equal(a, b), n

    with AsyncSaver() as saver:
        saver.save(path, model.state_dict())
        # the host copy is taken before save() returns: an update in place
        # right after it does not reach the file
        want = model.text_proj.weight.detach().clone()
        with torch.no_grad():
            model.text_proj.weight.zero_()
        saver.wait()
        assert torch.equal(restore_checkpoint(path)["text_proj.weight"], want)
        saver.save(str(tmp_path / "no_such_dir" / "x" / "latest"),
                   {"step": 3, "w": torch.ones(2)})
    assert restore_checkpoint(
        str(tmp_path / "no_such_dir" / "x" / "latest"))["step"] == 3
    assert not list((tmp_path / "ckpts").glob("*.tmp*"))

    saver = AsyncSaver()
    saver.save(str(tmp_path / "ckpts"), {"w": torch.ones(2)})  # a directory
    with pytest.raises(OSError):
        saver.close()


def test_metric_logger_and_section_timer(tmp_path):
    logger = MetricLogger(str(tmp_path / "logs"))
    logger.log(1, {"loss": torch.tensor(2.0)}, prefix="train/")
    logger.log(2, {"loss": 1.0}, prefix="train/")
    logger.close()
    lines = [json.loads(x) for x in
             (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert lines == [{"step": 1, "train/loss": 2.0},
                     {"step": 2, "train/loss": 1.0}]
    assert float(logger.meters["train/loss"]) == pytest.approx(1.99)
    timer = SectionTimer()
    for _ in range(2):
        with timer.section("a"):
            pass
    assert timer.counts["a"] == 2 and timer.summary()["a"] >= 0.0


# ------------------------------------------------------------------ the loop
class _ScriptedVal:
    """A val agent whose SPL follows a script; holds the trained module."""

    def __init__(self, model, spls):
        self.model, self.spls, self.calls = model, list(spls), 0

    def evaluate(self, num_batches=None):
        spl = self.spls[self.calls]
        self.calls += 1
        return {"spl": spl, "sr": spl}, []


def _loop_parts(seed=0):
    tcfg = port_config(JC.tiny_config())
    tcfg = dataclasses.replace(tcfg, train=dataclasses.replace(
        tcfg.train, max_action_len=3, scan_buckets=(2,)))
    from gridmm_tpu_torch.models.navigator import init_navigator

    model = init_navigator(tcfg.model, seed=seed, device="cpu")
    return tcfg, model, TA.NavAgent(model, tcfg, _env(TW, TD, batch=2))


def test_loop_keeps_the_latest_of_equal_best_spl(tmp_path):
    """>= in the best-SPL decision: of two evaluations with equal SPL the
    later one's weights are the saved best; a lower one does not replace
    them. Teacher and sample passes alternate; the module is updated in
    place and left in eval mode."""
    tcfg, model, agent = _loop_parts()
    val = _ScriptedVal(model, [10.0, 10.0, 5.0])
    before = model.text_proj.weight.detach().clone()
    seen = []
    orig = agent.rollout
    agent.rollout = lambda **kw: (seen.append(kw["feedback"]), orig(**kw))[1]
    snaps = []
    orig_eval = val.evaluate

    def evaluate(num_batches=None):
        snaps.append(model.text_proj.weight.detach().clone())
        return orig_eval(num_batches)

    val.evaluate = evaluate
    res = TLOOP.train_navigator(tcfg, model, agent, val, iters=3, log_every=1,
                                ckpt_dir=str(tmp_path / "ck"), seed=0)
    assert (res.best_spl, res.best_iter) == (10.0, 2)
    assert res.final_metrics["spl"] == 5.0
    assert seen == ["teacher", "sample", "teacher"]
    assert not torch.equal(model.text_proj.weight, before)
    assert model.training is False
    best = restore_checkpoint(str(tmp_path / "ck" / "best_spl"))
    latest = restore_checkpoint(str(tmp_path / "ck" / "latest"))
    assert torch.equal(best["text_proj.weight"], snaps[1])
    assert torch.equal(latest["text_proj.weight"], snaps[2])


def test_loop_saves_on_interrupt_and_resume_reads_it(tmp_path):
    """An interrupt inside an iteration parks a 'latest' checkpoint before
    it propagates; restore_checkpoint reads it back."""
    tcfg, model, agent = _loop_parts(seed=1)
    orig = agent.rollout
    calls = []

    def rollout(**kw):
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt
        return orig(**kw)

    agent.rollout = rollout
    with pytest.raises(KeyboardInterrupt):
        TLOOP.train_navigator(tcfg, model, agent, iters=3, log_every=100,
                              ckpt_dir=str(tmp_path / "ck"), seed=0)
    saved = restore_checkpoint(str(tmp_path / "ck" / "latest"))
    for n, p in model.state_dict().items():
        assert torch.equal(saved[n], p), n


def test_loop_dagger_sum_and_guards(tmp_path):
    tcfg, model, agent = _loop_parts(seed=2)
    cfg = dataclasses.replace(tcfg, train=dataclasses.replace(
        tcfg.train, dagger_sum=True))
    logger = MetricLogger(str(tmp_path / "logs"))
    TLOOP.train_navigator(cfg, model, agent, iters=1, log_every=1,
                          logger=logger, seed=0)
    logger.close()
    rec = json.loads((tmp_path / "logs" / "metrics.jsonl").read_text()
                     .splitlines()[0])
    assert rec["train/loss"] == pytest.approx(
        rec["train/loss_teacher"] + rec["train/loss_sample"], rel=1e-6)
    # mesh= (parallel/mesh.py) over a world of one: the update runs on
    # sharded parameters and the module comes back with plain ones
    import torch.distributed as dist

    from gridmm_tpu_torch.config import MeshConfig
    from gridmm_tpu_torch.parallel.mesh import init_world, make_mesh

    created = init_world("cpu")
    try:
        TLOOP.train_navigator(tcfg, model, agent, iters=1,
                              mesh=make_mesh(MeshConfig(), "cpu"))
    finally:
        if created:
            dist.destroy_process_group()
    assert all(type(p) is torch.nn.Parameter for p in model.parameters())
    assert not any("tp" in vars(m) for m in model.modules())
    from gridmm_tpu_torch.models.navigator import init_navigator

    other = TA.NavAgent(init_navigator(tcfg.model, seed=9, device="cpu"),
                        tcfg, agent.env)
    with pytest.raises(ValueError, match="module being trained"):
        TLOOP.train_navigator(tcfg, model, agent, val_agent=other, iters=1)


# -------------------------------------------------------------------- the CLI
def test_main_nav_cli_trains_evaluates_and_resumes(tmp_path, capsys):
    out = tmp_path / "run"
    res = TCLI.main(["--world", "synthetic", "--tiny", "--device", "cpu",
                     "--iters", "2", "--log_every", "1", "--eval",
                     "--batch_size", "2", "--output_dir", str(out),
                     "--submit", str(tmp_path / "sub.json")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["best_iter"] in (1, 2) and line["best_spl"] == res.best_spl
    assert 0.0 <= line["final_spl"] <= 100.0 and "final_nDTW" in line
    assert len(json.loads((tmp_path / "sub.json").read_text())) == 12
    assert (out / "ckpts" / "latest").exists()
    assert (out / "ckpts" / "best_spl").exists()
    TCLI.main(["--world", "synthetic", "--device", "cpu", "--iters", "1",
               "--batch_size", "2", "--output_dir", str(tmp_path / "run2"),
               "--resume", str(out / "ckpts" / "latest"), "--dagger_sum",
               "--scan_buckets", "3,6"])
    assert "best_spl" in capsys.readouterr().out


@pytest.mark.parametrize("argv,item", [
    (["--mesh", "auto"], "mesh: data=1 model=1"),
    (["--multihost"], None),
    (["--scene_shard"], None),
    (["--mesh", "auto", "--mp_size", "2"], "not divisible by --mp_size 2")])
def test_main_nav_cli_names_what_is_not_ported(argv, item, tmp_path, capsys,
                                               monkeypatch):
    """The parallel layer's flags are ported (parallel/): each runs one
    iteration over a world of one (--multihost joins the one torchrun's
    environment describes), and --mp_size that does not divide the world
    raises the JAX error."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
                 "WORLD_SIZE": "1", "RANK": "0"}.items():
        monkeypatch.setenv(k, v)
    argv = argv + ["--device", "cpu", "--iters", "1", "--batch_size", "2",
                   "--output_dir", str(tmp_path)]
    if item and "divisible" in item:
        with pytest.raises(ValueError, match=item):
            TCLI.main(argv)
    else:
        res = TCLI.main(argv)
        out = capsys.readouterr().out
        assert "best_spl" in out and res.best_iter == -1
        assert item is None or item in out
    assert TCLI.parse_args([]).device == "cuda"


def test_main_nav_cli_detailed_output_needs_submit():
    with pytest.raises(ValueError, match="--submit"):
        TCLI.main(["--detailed_output", "--device", "cpu"])


# ------------------------------------------------- the port stands on its own
def test_port_sources_import_nothing_of_jax():
    """No file of the port, nor chip_smoke.py or chip_profile.py, has an
    import statement of jax, flax, optax or the JAX package."""
    banned = {"jax", "flax", "optax", "gridmm_tpu", "orbax"}
    files = sorted((ROOT / "gridmm_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "chip_profile.py"]
    assert len(files) > 40
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, (str(path), name)

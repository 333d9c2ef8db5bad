"""The port's benchmark and episode entry points on the CPU: each runs with
`--device cpu` at tiny width and prints its lines; the episode runs against
gridmm_tpu on the same numpy inputs with weights carried by
gridmm_tpu_torch/convert.py.

  * cli/bench.py prints one JSON line with bench.py's keys, `vs_baseline`
    null, and raises without a card unless `--device cpu` is given;
  * cli/bench_latency.py, bench_pool_bwd.py, bench_train_update.py (a
    failing point prints FAILED and sets the exit code) and
    bench_ce_step.py (fused and --legacy) print their lines;
  * cli/drive_episode.py's steps equal the JAX steps of
    scripts/drive_episode.py on JAX-carried tiny weights: cell ids and
    -inf masks bit for bit, logits within 1e-5;
  * cli/run_synthetic_eval.py's trajectories and metrics, greedy and
    --teacher, equal those of scripts/run_synthetic_eval.py's two branches
    on its builder (tests/test_agent_e2e.build_all, seed 1) with the JAX
    weights carried over;
  * entry.entry()'s fn equals the JAX entry's language + navigation forward
    within 1e-5 at tiny_config() width, and its torch.export runs."""

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
from gridmm_tpu_torch import entry as TE  # noqa: E402
from gridmm_tpu_torch.cli import bench as TB  # noqa: E402
from gridmm_tpu_torch.cli import bench_ce_step as TBC  # noqa: E402
from gridmm_tpu_torch.cli import bench_latency as TBL  # noqa: E402
from gridmm_tpu_torch.cli import bench_pool_bwd as TBP  # noqa: E402
from gridmm_tpu_torch.cli import bench_train_update as TBU  # noqa: E402
from gridmm_tpu_torch.cli import drive_episode as TDE  # noqa: E402
from gridmm_tpu_torch.cli import run_synthetic_eval as TSE  # noqa: E402
from torch_parity import (assert_close, jax_navigator,  # noqa: E402
                          port_config, port_navigator)

BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "backend"}


def _lines(capsys):
    return capsys.readouterr().out.strip().splitlines()


# ------------------------------------------------------------ the benches
def test_bench_prints_one_json_line_with_bench_py_keys(capsys):
    record = TB.main(["--device", "cpu", "--tiny"])
    lines = _lines(capsys)
    assert len(lines) == 1 and json.loads(lines[0]) == record
    assert BENCH_KEYS <= set(record)
    assert record["metric"] == "panorama_views_per_sec_per_chip"
    assert record["unit"] == "views/s" and record["vs_baseline"] is None
    assert record["backend"] == "cpu" and record["device"] == "cpu"
    assert record["value"] > 0


def test_bench_without_a_card_raises_and_does_not_fall_back(monkeypatch,
                                                            capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TB.main(["--tiny"])
    assert capsys.readouterr().out == ""


def test_bench_latency_prints_eager_and_engine_percentiles(capsys):
    out = TBL.run(device="cpu", tiny=True, steps=3)
    lines = _lines(capsys)
    assert sorted(out) == [1, 4] and len(lines) == 2
    for b, line in zip((1, 4), lines):
        assert line.startswith(f"batch={b}: p50=") and "engine" in line
        for kind in ("eager", "engine"):
            p50, p90 = out[b][kind]
            assert 0 < p50 <= p90


def test_bench_latency_int8(capsys):
    out = TBL.run(device="cpu", int8=True, tiny=True, batches=(2,),
                  steps=2)
    assert _lines(capsys)[0] == "int8 trunk matmuls ON" and list(out) == [2]


def test_bench_pool_bwd_prints_times_and_the_gradient_difference(capsys):
    out = TBP.main(["--device", "cpu", "--tiny"])
    lines = _lines(capsys)
    assert lines[0] == "device: cpu" and lines[1].startswith("B=2 N=588:")
    r = out[(2, 588)]
    assert all(r[k] > 0 for k in ("fwd_plain", "fwd_kernel", "fwdbwd_plain",
                                  "fwdbwd_kernel"))
    # analytic backward against autograd of the plain forward (both plain
    # on the CPU): the sums differ in order only
    assert r["rel_grad_err"]["d_fts"] < 1e-5
    assert r["rel_grad_err"]["d_weights"] < 1e-4


def test_bench_train_update_prints_and_reports_a_failed_point(capsys,
                                                              monkeypatch):
    real = TBU.run_one

    def small(b, dtype, steps, iters, *args):
        # the CLI's sizes are the JAX script's; the test runs fewer
        assert (steps, iters) == (15, 10)
        if b == 3:
            raise RuntimeError("out of memory (simulated)")
        return real(b, dtype, 2, 1, *args)

    monkeypatch.setattr(TBU, "run_one", small)
    argv = ["--device", "cpu", "--tiny", "--batches"]
    assert TBU.main(argv + ["2"]) == 0
    line, = _lines(capsys)
    assert line.startswith("dtype=float32 B=2: ") and "eps/s" in line
    assert TBU.main(argv + ["3", "2"]) == 1
    captured = capsys.readouterr()
    assert "dtype=float32 B=3: FAILED" in captured.out
    assert "out of memory (simulated)" in captured.err
    assert "dtype=float32 B=2: " in captured.out


@pytest.mark.parametrize("legacy", [False, True], ids=["fused", "legacy"])
def test_bench_ce_step_prints_the_p50_step(capsys, legacy):
    argv = ["--device", "cpu", "--tiny", "--batches", "2", "--steps", "2",
            "--rounds", "1", "--breakdown"] + (["--legacy"] if legacy else [])
    out = TBC.main(argv)
    lines = _lines(capsys)
    assert lines[0].startswith("batch=2: p50 step=")
    assert ("host path" in lines[0]) == legacy
    assert out[2]["p50_ms"] > 0 and out[2]["breakdown"]


# ------------------------------------------------------------ the episodes
def _jax_episode(jmodel, params, jcfg):
    """scripts/drive_episode.py's steps on the port's inputs
    (drive_episode.episode_inputs)."""
    import gridmm_tpu.ops.geometry as JG

    txt_ids, txt_mask, rows = TDE.episode_inputs(jcfg)
    b, g, v = TDE.B, TDE.GMAP, TDE.VIEWS
    h = jcfg.model.hidden_size
    apply = jax.jit(jmodel.apply, static_argnums=(1,))
    txt = apply(params, "language", {"txt_ids": jnp.asarray(txt_ids),
                                     "txt_mask": jnp.asarray(txt_mask)})
    state = JG.PointCloudState.create(b, jcfg.grid, jcfg.shapes.max_points)
    out = []
    for r in rows:
        state = JG.append_panorama(state, jnp.asarray(r["depth"]),
                                   jnp.asarray(r["patch_fts"]),
                                   jnp.asarray(r["pos"]), jcfg.grid)
        cells, _, grid_pos = JG.egocentric_grid_assignment(
            state, jnp.asarray(r["pos"]), jnp.asarray(r["heading"]),
            jcfg.grid)
        pano, _ = apply(params, "panorama", {
            "view_img_fts": jnp.asarray(r["view_img_fts"]),
            "loc_fts": jnp.asarray(r["loc_fts"]),
            "nav_types": jnp.asarray(r["nav_types"]),
            "view_mask": jnp.ones((b, v), bool)})
        nav = apply(params, "navigation", {
            "txt_embeds": txt, "txt_mask": jnp.asarray(txt_mask),
            "gmap_img_embeds": jnp.asarray(r["gmap_img_embeds"]),
            "gmap_step_ids": jnp.asarray(r["gmap_step_ids"]),
            "gmap_pos_fts": jnp.asarray(r["gmap_pos_fts"]),
            "gmap_mask": jnp.broadcast_to(jnp.arange(g)[None] < 6, (b, g)),
            "gmap_visited_mask": jnp.broadcast_to(jnp.arange(g)[None] < 2,
                                                  (b, g)),
            "vp_img_embeds": jnp.concatenate([jnp.zeros((b, 1, h)), pano],
                                             1),
            "vp_pos_fts": jnp.asarray(r["vp_pos_fts"]),
            "vp_mask": jnp.ones((b, v + 1), bool),
            "vp_nav_mask": jnp.broadcast_to(jnp.arange(v + 1)[None] < 8,
                                            (b, v + 1)),
            "grid_fts": state.features, "grid_cells": cells,
            "gridmap_pos_fts": grid_pos,
            "fused_add_idx": jnp.full((b, g), -2, jnp.int32),
            "cand_backtrack_mask": jnp.zeros((b, v + 1), bool)})
        out.append({"cells": np.asarray(cells), "points":
                    int(state.count[0]),
                    **{f: np.asarray(getattr(nav, f)) for f in
                       ("fused_logits", "global_logits", "local_logits")}})
    return out


@pytest.fixture(scope="module")
def tiny_pair():
    jcfg = JC.tiny_config()
    jmodel, params = jax_navigator(jcfg, seed=0)
    tcfg = port_config(jcfg)
    return jcfg, jmodel, params, tcfg, port_navigator(tcfg, params)


def test_drive_episode_matches_the_jax_steps(tiny_pair, capsys):
    jcfg, jmodel, params, tcfg, tmodel = tiny_pair
    got = TDE.run(model=tmodel, cfg=tcfg, device="cpu")
    lines = _lines(capsys)
    assert lines[-1] == "EPISODE OK" and "EMPTY-GRID PROBE OK" in lines
    assert lines[1] == (f"navigator params: "
                        f"{sum(x.size for x in jax.tree.leaves(params)) / 1e6:.1f}M")
    want = _jax_episode(jmodel, params, jcfg)
    assert len(got["steps"]) == len(want) == TDE.STEPS
    for t, (g, w) in enumerate(zip(got["steps"], want)):
        assert g["points"] == w["points"] == 588 * (t + 1)
        np.testing.assert_array_equal(g["cells"], w["cells"])
        for f in ("fused_logits", "global_logits", "local_logits"):
            assert_close(g[f], w[f], msg=f"step {t} {f}")


def test_drive_episode_cli_at_tiny_width(capsys):
    TDE.main(["--device", "cpu", "--tiny"])
    lines = _lines(capsys)
    assert lines[-1] == "EPISODE OK"
    assert [ln.split(":")[0] for ln in lines if ln.startswith("step ")] == \
        ["step 0", "step 1", "step 2"]


def _jax_synthetic_eval(teacher):
    """scripts/run_synthetic_eval.py's two branches on its own builder
    (tests/test_agent_e2e.build_all, seed 1): (metrics, predictions,
    params)."""
    from test_agent_e2e import build_all as jax_build_all

    _, env, _, params, agent = jax_build_all(seed=1)
    if not teacher:
        avg, preds = agent.evaluate(num_batches=3)
        return avg, preds, params
    env.reset_epoch(shuffle=False)
    seen = {}
    for _ in range(3):
        traj, _, _ = agent.rollout(feedback="teacher")
        for item in traj:
            seen.setdefault(item["instr_id"], {
                "instr_id": item["instr_id"],
                "trajectory": item["trajectory"]})
    avg, _ = env.eval_metrics(list(seen.values()))
    return avg, list(seen.values()), params


@pytest.mark.parametrize("teacher", [False, True], ids=["argmax", "teacher"])
def test_run_synthetic_eval_matches_a_direct_evaluate(capsys, teacher):
    """The port's world, episodes, batch size and (with --teacher) its
    teacher loop against the JAX script's on the JAX weights carried
    over: the same trajectories and metrics."""
    want, want_preds, params = _jax_synthetic_eval(teacher)
    model = port_navigator(port_config(JC.tiny_config()), params)
    avg, preds = TSE.run(device="cpu", teacher=teacher, model=model)
    lines = _lines(capsys)
    assert lines[0].startswith(f"policy={'teacher' if teacher else 'argmax'}"
                               "  episodes=9")
    assert [ln.split(":")[0].strip() for ln in lines[1:]] == \
        list(TSE.METRICS)
    assert [(p["instr_id"], p["trajectory"]) for p in preds] == \
        [(p["instr_id"], p["trajectory"]) for p in want_preds]
    for k in TSE.METRICS:
        assert np.isfinite(avg[k])
        assert avg[k] == pytest.approx(want[k], rel=1e-9, abs=1e-9), k
    if teacher:
        # the teacher walks through every goal
        assert avg["oracle_sr"] == 100.0


def test_entry_fn_matches_the_jax_entry_and_exports(tiny_pair):
    from gridmm_tpu.models.navigator import dummy_batches as jdummy

    jcfg, jmodel, params, tcfg, tmodel = tiny_pair
    fn, (ids, mask, nav) = TE.entry(device="cpu", cfg=tcfg, model=tmodel)
    jids, jmask, _, jnav = jdummy(jcfg.shapes, jcfg.model, batch=2)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert sorted(nav) == sorted(jnav)
    for k, v in jnav.items():
        np.testing.assert_array_equal(nav[k].numpy(), np.asarray(v))

    def jfn(params, txt_ids, txt_mask, nav_batch):
        txt = jmodel.apply(params, "language",
                           {"txt_ids": txt_ids, "txt_mask": txt_mask})
        return jmodel.apply(params, "navigation", dict(
            nav_batch, txt_embeds=txt, txt_mask=txt_mask)).fused_logits

    want = np.asarray(jax.jit(jfn)(params, jids, jmask, jnav))
    with torch.no_grad():
        got = fn(ids, mask, nav)
        program = TE.compile_check(fn, (ids, mask, nav))
        exported = program.module()(ids, mask, nav)
    assert tuple(got.shape) == want.shape == (2, jcfg.shapes.max_gmap_len)
    scale = np.abs(want[np.isfinite(want)]).max()
    assert_close(got, want, rtol=0, atol=1e-5 * scale)
    assert torch.equal(exported, got)
    assert any(n.target is torch.ops.gridmm.grid_pool_fwd.default
               for n in program.graph.nodes if n.op == "call_function")

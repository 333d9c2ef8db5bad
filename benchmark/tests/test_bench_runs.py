"""Whole runs of each cell at tiny widths on the CPU (run.run_cell skips the
look for a card): the result line, the traced line, the control and the
faults that each cell can have, each of which must come out not correct."""

import json

import pytest

from benchmark import faults, harness
from benchmark import run as bench_run
from benchmark.tests.conftest import full_cell, tiny_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
CELLS = ["r2r.serve", "r2r.train"]


def run(workload, trace=0, hooks=None, seed=2 ** 31 + 12345):
    # serving judges the episodes that finish in the window: give a loaded
    # CPU time to finish some
    seconds = 3.0 if workload.endswith(".serve") else 0.5
    return bench_run.run_cell(tiny_cell(workload), seed, seconds, trace,
                              "cpu", hooks=hooks)


@pytest.mark.parametrize("workload", CELLS)
def test_result_line_has_the_keys_it_must(workload):
    res = run(workload)
    assert list(res) == KEYS  # `checks` last
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    cell = full_cell(workload)
    assert set(res["metrics"]) == {m["name"] for m in cell["end_to_end"]}
    assert all(set(v) == {"value", "unit"} for v in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for v in res["checks"].values():
        assert set(v) == {"value", "limit"}
    json.loads(json.dumps(res))


@pytest.mark.parametrize("workload", CELLS)
def test_traced_line(workload):
    res = run(workload, trace=1)
    assert list(res) == KEYS[:5] + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    names = {m["name"] for m in full_cell(workload)["per_layer"]}
    # the CPU has no device trace: only the host's readings are there
    assert set(res["metrics"]) <= names and res["metrics"]


def control(workload):
    cell = tiny_cell(workload)
    if workload == "r2r.train":
        # TF32's rounding grows with the width: at 128 the control's gaps
        # sit at the limits, at 384 they clear them
        cell["config"]["model"].update(hidden_size=384,
                                       num_attention_heads=6,
                                       intermediate_size=1536,
                                       image_feat_size=384)
        cell["config"]["grid"]["feature_dim"] = 384
    seconds = 3.0 if cell["traffic"]["loop"] == "serve" else 0.5
    ctx = bench_run.context(cell, 99, seconds, False, "cpu", None,
                            {"control": True})
    out = harness.loop(cell["traffic"]["loop"]).run(ctx)
    over = {k for k, lim in cell["limits"].items()
            if out["readings"][f"control.{k}"] > lim}
    return out, over


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_the_program_passes(workload):
    out, over = control(workload)
    assert all(v["value"] <= v["limit"] for v in out["checks"].values())
    assert over, "the control read under every limit"


# --------------------------------------------------------------- faults
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_faults_are_not_correct(workload, fault):
    kind = tiny_cell(workload)["traffic"]["loop"]
    hooks = faults.FAULTS[kind][fault]
    assert run(workload, hooks=hooks)["correct"] is False

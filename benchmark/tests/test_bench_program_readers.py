"""The per-layer metrics read from the program's own recorder
(gridmm_tpu_torch/utils/logging.py): nothing on an empty record or from a
program without the recorder, the host-side values on a traced tiny CPU run,
no device time on the CPU."""

import importlib.util

import pytest

from benchmark import harness
from benchmark import run as bench_run
from benchmark.tests.conftest import tiny_cell

SERVE = ["admit_device_ms.serve", "admit_used_pct.serve",
         "assemble_ms.serve", "h2d_mb.serve", "replay_device_ms.serve"]
TRAIN = ["forward_ms.train", "backward_ms.train"]
DEVICE = ["admit_device_ms.serve", "replay_device_ms.serve"]


def reader(name):
    spec = importlib.util.spec_from_file_location(
        f"reader_{name.replace('.', '_')}",
        harness.HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def traced(workload):
    seconds = 3.0 if workload.endswith(".serve") else 0.5
    return bench_run.run_cell(tiny_cell(workload), 2 ** 31 + 777, seconds, 1,
                              "cpu")


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_reader_finds_nothing_on_an_empty_record(name):
    assert reader(name)({}) is None


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_reader_finds_nothing_without_the_recorder(name, monkeypatch):
    from gridmm_tpu_torch.utils import logging as L

    monkeypatch.delattr(L, "profiled_stretch")
    assert reader(name)({"trace": {"busy_s": 0.0}}) is None


def test_serving_readers_on_a_traced_cpu_run():
    from gridmm_tpu_torch.serve.engine import serving_cfg
    from gridmm_tpu_torch.utils.export import zero_step_inputs
    from gridmm_tpu_torch.utils.logging import profiled_stretch

    from benchmark.loops import nav

    cell = tiny_cell("r2r.serve")
    res = traced("r2r.serve")
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert not set(DEVICE) & set(got)
    st = profiled_stretch()
    steps = st.named("serve.step")
    assert len(steps) == cell["traffic"]["trace_steps"]
    cfg = serving_cfg(nav.port_config(cell["config"]))
    slots = cell["traffic"]["slots"]
    per_step = sum(a.nbytes for a in zero_step_inputs(cfg, slots, "cpu"))
    assert got["h2d_mb.serve"] == pytest.approx(per_step / 1e6)
    assemble = st.named("serve.step.assemble")
    assert got["assemble_ms.serve"] == pytest.approx(
        1e3 * sum(s.seconds for s in assemble) / len(assemble))
    c = st.counters
    assert c["serve.admit.rows_encoded"] == slots * len(
        st.named("serve.admit"))
    assert got["admit_used_pct.serve"] == pytest.approx(
        100.0 * c["serve.admit.rows_admitted"] / c["serve.admit.rows_encoded"])
    assert 0 < got["admit_used_pct.serve"] <= 100


def test_training_readers_on_a_traced_cpu_run():
    from gridmm_tpu_torch.utils.logging import profiled_stretch

    res = traced("r2r.train")
    got = {k: v["value"] for k, v in res["metrics"].items()}
    st = profiled_stretch()
    n = tiny_cell("r2r.train")["traffic"]["trace_updates"]
    for name, span in (("forward_ms.train", "train.forward"),
                       ("backward_ms.train", "train.backward")):
        spans = st.named(span)
        assert len(spans) == n
        assert got[name] == pytest.approx(
            1e3 * sum(s.seconds for s in spans) / n)
        assert all(s.parent.name == "train.update" for s in spans)

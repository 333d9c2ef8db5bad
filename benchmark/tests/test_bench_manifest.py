"""BENCHMARK.json against the rules a benchmark manifest keeps, and the
files it names."""

import re

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_manifest_keys_names_and_units():
    b = harness.manifest()
    assert set(b) == TOP
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    assert 1 <= len(b["configs"]) <= 24 and 1 <= len(b["workloads"]) <= 24
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("benchmark/") and not c["reduced"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and line(w["why"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert line(m["layer"])


def test_every_cell_reports_what_it_must():
    b = harness.manifest()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in b["workloads"]:
        c = harness.cell(b, w["name"])
        mine = {m["name"] for m in c["end_to_end"]}
        assert "setup_s" in mine and len(mine) >= 2
        assert c["per_layer"]
        for m in c["per_layer"]:
            assert m["moves"] in mine
            assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()
        assert (harness.HERE / "loops"
                / f"{c['traffic']['loop']}.py").exists()
        assert c["limits"]


def test_run_seconds_fit_the_check_with_24_cells():
    b = harness.manifest()
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_every_layer_is_named_in_perf_md():
    text = (harness.ROOT / "PERF.md").read_text()
    for m in harness.manifest()["per_layer"]:
        assert f"`{m['layer']}`" in text, m["layer"]


def test_navigator_configs_are_the_presets():
    from gridmm_tpu_torch.config import r2r_config

    from benchmark.loops import nav

    conf = harness.read_json(harness.HERE / "configs" / "r2r.json")
    assert nav.port_config(conf) == r2r_config()

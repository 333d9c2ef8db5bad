"""CPU tests of the benchmark: tiny cells built from the real files."""

import copy
import dataclasses
import json

import pytest

from benchmark import harness


def tiny_nav_conf(name: str) -> dict:
    from gridmm_tpu_torch.config import tiny_config

    conf = copy.deepcopy(harness.read_json(
        harness.HERE / "configs" / f"{name}.json"))
    d = dataclasses.asdict(tiny_config())
    d.pop("mesh")
    conf.update(d)
    conf["assumed"]["episode_steps"] = [
        {"share": 0.85, "min": 3, "max": 3}, {"share": 0.15, "min": 4,
                                               "max": 4}]
    conf["assumed"]["instruction_tokens"] = {"min": 5, "max": 20}
    return conf


def full_cell(workload: str) -> dict:
    """The cell as run.py finds it."""
    return harness.cell(harness.manifest(), workload)


def tiny_cell(workload: str) -> dict:
    """The cell with its configuration and traffic cut to a size the CPU
    runs in seconds (widths and lengths of tiny_config())."""
    cell = copy.deepcopy(full_cell(workload))
    t = cell["traffic"]
    cell["config"] = tiny_nav_conf(cell["workload"]["config"])
    if t["loop"] == "serve":
        t.update(slots=4, episode_pool=24, check_episodes=100, trace_steps=3)
    else:
        t.update(batch=3, steps=4, trace_updates=1)
    return cell


@pytest.fixture
def cell_of():
    return tiny_cell


def dumps(x) -> str:
    return json.dumps(x)

"""What every cell's run shares: the manifest and the data files it names,
weights made on the device from the seed, spans, the profiled stretch, the
device record, the module check and the result line.

Nothing here knows a cell. `run.py` finds the cell's configuration, traffic
and limits files by the names in BENCHMARK.json, the traffic file names its
loop (`loops/<loop>.py`), and each per-layer metric is read by
`metrics/<metric>.py`.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gridmm_tpu")


class Refused(Exception):
    """A run that cannot give a result (no card, missing files)."""


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def cell(bench: dict, workload: str) -> dict:
    """The workload entry with its configuration entry and the parsed
    configuration, traffic and limits files."""
    for w in bench["workloads"]:
        if w["name"] == workload:
            break
    else:
        raise Refused(f"no workload named {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    return {"workload": w, "config_entry": conf,
            "config": read_json(ROOT / conf["file"]),
            "traffic": read_json(HERE / "traffic" / f"{w['traffic']}.json"),
            "limits": read_json(HERE / "limits" / f"{w['name']}.json"),
            "end_to_end": [m for m in bench["end_to_end"]
                           if workload in m.get("workloads", [workload])],
            "per_layer": [m for m in bench["per_layer"]
                          if workload in m.get("workloads", [workload])]}


def peaks() -> dict:
    return read_json(HERE / "peaks.json")


def forbidden_loaded() -> List[str]:
    """Top-level names of loaded modules that the measured process must not
    hold, compared whole (the port's own name begins with one of them)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)
                   if n.split(".")[0] in FORBIDDEN})


# ------------------------------------------------------------ weights
def seeded_weights(model, seed: int, device, init: Callable):
    """A state dict for `model` (built on the meta device) made on `device`
    from `seed`: one normal draw from a generator on the device for every
    random tensor, then 1s and 0s. `init(name, tensor)` gives ("normal",
    std), ("ones",) or ("zeros",) for each entry. All entries are views of
    one float32 buffer."""
    import torch

    entries = list(model.state_dict().items())
    kinds = [init(n, t) for n, t in entries]
    order = sorted(range(len(entries)),
                   key=lambda i: ("normal", "ones", "zeros").index(kinds[i][0]))
    total = sum(entries[i][1].numel() for i in order)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    n_normal = sum(entries[i][1].numel() for i in order
                   if kinds[i][0] == "normal")
    flat[:n_normal].normal_(0.0, 1.0, generator=gen)
    out, off = {}, 0
    for i in order:
        name, t = entries[i]
        view = flat[off:off + t.numel()].view(t.shape)
        kind = kinds[i]
        if kind[0] == "normal":
            view.mul_(kind[1])
        elif kind[0] == "ones":
            view.fill_(1.0)
        else:
            view.zero_()
        out[name] = view
        off += t.numel()
    return {n: out[n] for n, _ in entries}


class Window:
    """The timed window: the garbage collector collects before it and not
    during it (a full collection over the run's bookkeeping would land in
    one step's latency)."""

    def __enter__(self):
        gc.collect()
        gc.disable()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        gc.enable()


# --------------------------------------------------------------- spans
class Spans:
    """Host-clock spans recorded by the benchmark around its calls into the
    program (in traced runs only); each is also a profiler annotation, so
    that an idle gap on the device can be named by the span it fell in."""

    def __init__(self, on: bool, sync: Callable = lambda: None):
        self.on = on
        self.sync = sync
        self.durations: Dict[str, List[float]] = {}

    def run(self, name: str, fn, *args, sync: bool = False):
        if not self.on:
            return fn(*args)
        import torch

        with torch.profiler.record_function(f"bench:{name}"):
            t0 = time.perf_counter()
            out = fn(*args)
            if sync:
                self.sync()
            self.durations.setdefault(name, []).append(
                time.perf_counter() - t0)
        return out


# ------------------------------------------------------ profiled stretch
def profile(fn: Callable[[], None], device) -> dict:
    """Run `fn` (a bounded stretch of the window) under torch.profiler and
    reduce the trace: device time by kernel name, the union of the device's
    busy intervals, the stretch's length, the longest idle gaps named by the
    benchmark's span the host was in, and the host spans' durations."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    on_card = torch.device(device).type == "cuda"
    if on_card:
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if on_card:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    dev_events, spans = [], []
    for e in prof.events():
        kind = str(e.device_type)
        if "CUDA" in kind and not getattr(e, "is_user_annotation", False):
            dev_events.append((e.time_range.start, e.time_range.end, e.name))
        elif "CPU" in kind and e.name.startswith("bench:"):
            spans.append((e.time_range.start, e.time_range.end, e.name[6:]))
        elif "CPU" in kind and e.name.startswith("Optimizer.step"):
            spans.append((e.time_range.start, e.time_range.end,
                          "Optimizer.step"))
    return reduce_trace(dev_events, spans, window_s)


def reduce_trace(dev_events, spans, window_s: float) -> dict:
    """Device intervals (start_us, end_us, name) and host spans -> the trace
    record the metric readers take."""
    by_kernel: Dict[str, List[float]] = {}
    for s, e, name in dev_events:
        k = by_kernel.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (e - s) * 1e-6
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e, _ in sorted(dev_events):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                gaps.append((cur_e, s))
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    named = []
    for gs, ge in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        inside = [sp for sp in spans if sp[0] <= gs < sp[1]]
        label = (min(inside, key=lambda sp: sp[1] - sp[0])[2]
                 if inside else "outside the benchmark's spans")
        named.append([label, (ge - gs) * 1e-6])
    span_s: Dict[str, List[float]] = {}
    for s, e, name in spans:
        span_s.setdefault(name, []).append((e - s) * 1e-6)
    return {"kernels": by_kernel, "busy_s": busy * 1e-6,
            "window_s": window_s, "idle_gaps": named, "spans": span_s}


def breakdown(trace: dict) -> dict:
    top = sorted(trace["kernels"].items(), key=lambda kv: -kv[1][1])[:10]
    return {"device_ops": [[name[:160], v[1]] for name, v in top],
            "idle_gaps": trace["idle_gaps"]}


def kernel_time(trace: dict, fragment: str):
    """(launches, seconds) of the kernels whose name holds `fragment`."""
    hits = [v for k, v in trace["kernels"].items() if fragment in k]
    return sum(v[0] for v in hits), sum(v[1] for v in hits)


# ---------------------------------------------------------- per-layer
def read_metrics(names: List[str], record: dict) -> Dict[str, float]:
    """Each per-layer metric by its own reader, metrics/<name>.py; a reader
    that finds nothing to read returns None and the metric is left out."""
    out = {}
    for name in names:
        path = HERE / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"benchmark_metric_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(record)
        if value is not None and math.isfinite(value):
            out[name] = value
    return out


def loop(name: str):
    return importlib.import_module(f"benchmark.loops.{name}")


def device_record(device, chips: int) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


def limited(readings: dict, limits: dict) -> dict:
    """The readings that the cell's limits file names, each beside its
    limit."""
    return {k: {"value": readings[k], "limit": v} for k, v in limits.items()}


def check_lines(checks: Dict[str, dict]) -> List[str]:
    return [f"check {k}: {v['value']!r} limit {v['limit']!r}"
            for k, v in checks.items()]


def judged(checks: Dict[str, dict]) -> bool:
    """Every compared number at or under its limit (a NaN fails)."""
    return all(v["value"] <= v["limit"] for v in checks.values())

"""Model FLOPs of the admissions and steps completed in the traced window,
from shapes (costs/navigator.py), over the window, as a share of the
configuration's published peak."""

from benchmark import harness
from benchmark.costs import navigator


def read(record):
    conf, b = record["config"], record["slots"]
    if not record.get("window_s") or not record.get("steps"):
        return None
    flops = (record["steps"] * navigator.serve_step(conf, b)
             + record["admit_calls"] * navigator.language(conf, b))
    peak = harness.peaks()["flops_per_s"][conf["peak"]]
    return 100.0 * flops / record["window_s"] / peak

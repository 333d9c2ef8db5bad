"""Model FLOPs of the updates completed in the traced window (three times
the forward's, costs/navigator.py), over the time up to the last update's
sync, as a share of the configuration's published peak."""

from benchmark import harness
from benchmark.costs import navigator


def read(record):
    if not record.get("window_s") or not record.get("updates"):
        return None
    conf = record["config"]
    flops = 3 * navigator.train_forward(conf, record["batch"],
                                        record["steps"]) * record["updates"]
    peak = harness.peaks()["flops_per_s"][conf["peak"]]
    return 100.0 * flops / record["window_s"] / peak

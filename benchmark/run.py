"""One run of one benchmark cell.

    python3 benchmark/run.py --workload r2r.serve --seed 7 --seconds 30 --trace 0

Set-up (weights made on the card from the seed, the cell's traffic, the
warm-up of every shape the cell uses), then a window of `--seconds`, then
the comparison with the plain reference that decides `correct`. The last
line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer metrics), `device`, with `--trace 1` `breakdown`, and last
`checks`, each compared number beside its limit (also the last lines of
standard error). Exits 2 without a result where there is no card, too few
cards, or no program to measure, and 3 where a JAX module was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache the run may write sits at a fixed path inside the checkout
CACHE = ROOT / "benchmark" / "cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"
# one process with few threads: the host's share of the work is the
# program's Python and numpy, and idle pool threads only add jitter
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != Path(__file__).resolve().parent]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def context(cell, seed, seconds, trace, device, t0=None, hooks=None):
    """What a loop's `run` takes. `hooks` lets a test break the timed path
    underneath, and the calibration ask for the control (see the
    loops)."""
    return SimpleNamespace(cell=cell, seed=seed, seconds=seconds,
                           trace=bool(trace), device=device,
                           t0=time.perf_counter() if t0 is None else t0,
                           chips=cell["workload"]["chips"], hooks=hooks or {})


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device="cuda", t0: float = None, hooks: dict = None) -> dict:
    """One run of `cell` (harness.cell's dict) on `device`; returns the
    result record, `checks` last."""
    ctx = context(cell, seed, seconds, trace, device, t0, hooks)
    out = harness.loop(cell["traffic"]["loop"]).run(ctx)
    units = {m["name"]: m["unit"] for m in
             cell["end_to_end"] + cell["per_layer"]}
    if trace:
        values = harness.read_metrics([m["name"] for m in cell["per_layer"]],
                                      out["record"])
    else:
        values = {m["name"]: out["end_to_end"][m["name"]]
                  for m in cell["end_to_end"]}
    device_rec = dict(out["device"])
    if trace:
        device_rec["busy_s"] = out["record"]["trace"]["busy_s"]
        device_rec["window_s"] = out["record"]["trace"]["window_s"]
    result = {"correct": harness.judged(out["checks"]),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": {k: {"value": v, "unit": units[k]}
                          for k, v in values.items()},
              "device": device_rec}
    if trace:
        result["breakdown"] = harness.breakdown(out["record"]["trace"])
    result["checks"] = out["checks"]
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        cell = harness.cell(harness.manifest(), args.workload)
    except (OSError, KeyError, StopIteration, harness.Refused) as e:
        print(f"no such cell: {e}", file=sys.stderr)
        return 2
    import torch

    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import gridmm_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program under test is not here: {e}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, args.trace, "cuda", T0)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"the measured process loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    for line in harness.check_lines(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

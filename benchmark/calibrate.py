"""Readings for the limits: a cell's program on many seeds and its control
(the reference in the next precision down put in the program's place), in
one process, each run as `run.py` makes it but with a window of
`--seconds`.

    python3 benchmark/calibrate.py --workload r2r.serve --seconds 8 \\
        --seeds 11 12 13 --control-seeds 11 12 13

Prints one JSON line per run (`seed`, `control`, every reading) and writes
them to benchmark/out/calibrate_<workload>_<first seed>.jsonl. A limit is set between the
largest program reading over a dozen seeds or more and the smallest control
reading (benchmark/README.md).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != Path(__file__).resolve().parent]
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import run as bench_run  # noqa: E402  (sets the cache dirs)
from benchmark import faults, harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault", default=None,
                   help="plant this fault (faults.py) in every run")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.cell(harness.manifest(), args.workload)
    out_dir = harness.HERE / "out"
    out_dir.mkdir(exist_ok=True)
    first = (args.seeds + args.control_seeds)[0]
    path = out_dir / f"calibrate_{args.workload}_{first}.jsonl"
    drv = harness.loop(cell["traffic"]["loop"])
    runs = ([(s, False) for s in args.seeds if s not in args.control_seeds]
            + [(s, True) for s in args.control_seeds])
    with open(path, "a") as f:
        for seed, control in runs:
            t0 = time.perf_counter()
            hooks = dict(faults.FAULTS[cell["traffic"]["loop"]]
                         [args.fault]) if args.fault else {}
            hooks["control"] = control
            ctx = bench_run.context(cell, seed, args.seconds, False, "cuda",
                                    t0, hooks)
            res = drv.run(ctx)
            line = {"workload": args.workload, "seed": seed,
                    "control": control, "fault": args.fault,
                    "seconds": args.seconds,
                    "run_s": time.perf_counter() - t0,
                    "end_to_end": res["end_to_end"],
                    "readings": res["readings"]}
            print(json.dumps(line), flush=True)
            f.write(json.dumps(line) + "\n")
            del res
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

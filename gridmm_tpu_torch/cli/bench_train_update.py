"""The training update (replay forward and backward, the clipped AdamW
step) in ms per update and episodes/s (twin of
scripts/bench_train_update.py).

    python -m gridmm_tpu_torch.cli.bench_train_update [--batches 8 16 32]
        [--dtypes float32 bfloat16]
    python -m gridmm_tpu_torch.cli.bench_train_update --device cpu --tiny

For each compute dtype and batch: `train/step.make_train_step` on a
navigator at `r2r_config()` width (seed 0, dropout on) over one
synthetic teacher-forced batch of 15 steps, one warm-up update, then 10
updates timed together and synchronised once by reading the loss (K1 twice
a step, K5a and K5b once a step on the card).

The JAX script's `--pallas` and `--no-donate` have no counterpart: on the
card the pool always runs its kernels, and torch updates the parameters
in place. A batch that fails prints FAILED with its traceback and the run
goes on to the next; the exit code is then 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
import traceback


def run_one(b: int, compute_dtype: str = "float32", steps: int = 15,
            iters: int = 10, device: str = "cuda", tiny: bool = False,
            seed: int = 0) -> dict:
    """One (dtype, batch) point: {"ms", "eps_per_s", "loss"}."""
    from gridmm_tpu_torch.config import r2r_config, tiny_config
    from gridmm_tpu_torch.models.navigator import init_navigator
    from gridmm_tpu_torch.train.step import (create_train_state,
                                             make_train_step)
    from gridmm_tpu_torch.train.synthetic import synthetic_trajectory_batch
    from gridmm_tpu_torch.utils import device as D

    dev = D.resolve(device)
    cfg = tiny_config() if tiny else r2r_config()
    cfg = dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, compute_dtype=compute_dtype),
        train=dataclasses.replace(cfg.train, batch_size=b,
                                  max_action_len=steps))
    model = init_navigator(cfg.model, seed=seed, device=dev).train()
    state = create_train_state(cfg, model)
    batch = synthetic_trajectory_batch(cfg, batch=b, num_steps=steps,
                                       device=dev)
    step = make_train_step(cfg)
    m = step(state, batch, seed=1)
    _ = float(m["loss"])
    t0 = time.perf_counter()
    for _ in range(iters):
        m = step(state, batch, seed=1)
    loss = float(m["loss"])  # one hard sync after the queue drains
    dt = (time.perf_counter() - t0) / iters
    print(f"dtype={compute_dtype} B={b}: {dt * 1e3:.1f} ms/update  "
          f"{b / dt:.1f} eps/s  [{D.name(dev)}]", flush=True)
    return {"ms": dt * 1e3, "eps_per_s": b / dt, "loss": loss}


def run(device: str = "cuda", batches=(8, 16, 32), dtypes=("float32",),
        steps: int = 15, iters: int = 10, tiny: bool = False) -> dict:
    """{(dtype, batch): run_one's result, or None where it failed}."""
    out = {}
    for dtype in dtypes:
        for b in batches:
            try:
                out[(dtype, b)] = run_one(b, dtype, steps, iters, device,
                                          tiny)
            except Exception:  # report it and go on to the next point
                print(f"dtype={dtype} B={b}: FAILED", flush=True)
                traceback.print_exc()
                out[(dtype, b)] = None
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtypes", nargs="+", default=["float32"],
                   choices=["float32", "bfloat16"])
    p.add_argument("--batches", type=int, nargs="+", default=[8, 16, 32])
    p.add_argument("--tiny", action="store_true",
                   help="tiny_config() widths (the CPU tests)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    out = run(args.device, args.batches, args.dtypes, tiny=args.tiny)
    return 1 if any(r is None for r in out.values()) else 0


if __name__ == "__main__":
    sys.exit(main())

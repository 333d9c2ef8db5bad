"""p50 and p90 per-step action latency of the navigation step (twin of
scripts/bench_latency.py; BASELINE.md tracks it, the reference publishes
no number).

    python -m gridmm_tpu_torch.cli.bench_latency [--int8]
    python -m gridmm_tpu_torch.cli.bench_latency --device cpu --tiny

At `r2r_config()` with `max_txt_len` 80 and seeded random weights, for
batch 1 (evaluation) and 4, it times the full per-step graph
(train/step.nav_device_step: panorama encode, point append, grid
assignment, node aggregation, navigation forward, K1), 20 steps after a
warm-up step, each ended by reading one logit on the host (a hard sync).
The eager step carries its point buffer from one step to the next, as an
episode does (the JAX step is given the same carry each call; XLA copies
the buffer where the port appends in place).

Beside it, the serving engine's step at the same batch
(serve/engine.NavServingEngine.create, captured in a CUDA graph on the
card; eager on the CPU), which adds the host-to-device copy of the step's
inputs. `--int8` takes the int8 trunk (ModelConfig.int8_matmuls) for both.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

BATCHES = (1, 4)


def _percentiles(lats_s):
    ms = np.asarray(lats_s) * 1e3
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 90))


def run(device: str = "cuda", int8: bool = False, tiny: bool = False,
        batches=BATCHES, steps: int = 20, seed: int = 0) -> dict:
    """{batch: {"eager": (p50, p90) ms, "engine": (p50, p90) ms}} and the
    lines printed; see the module docstring."""
    from gridmm_tpu_torch.config import r2r_config, tiny_config
    from gridmm_tpu_torch.models.navigator import init_navigator
    from gridmm_tpu_torch.serve.engine import NavServingEngine
    from gridmm_tpu_torch.train.step import (StepInputs, init_carry,
                                             nav_device_step)
    from gridmm_tpu_torch.train.synthetic import synthetic_trajectory_batch
    from gridmm_tpu_torch.utils import device as D

    dev = D.resolve(device)
    cfg = tiny_config() if tiny else r2r_config()
    cfg = dataclasses.replace(
        cfg, shapes=dataclasses.replace(
            cfg.shapes, max_txt_len=min(80, cfg.shapes.max_txt_len)))
    if int8:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, int8_matmuls=True))
        print("int8 trunk matmuls ON", flush=True)
    model = init_navigator(cfg.model, seed=seed, device=dev)
    engine_kind = ("engine (CUDA-graphed)" if dev.type == "cuda"
                   else "engine (eager)")
    out = {}
    for b in batches:
        batch = synthetic_trajectory_batch(cfg, batch=b, num_steps=2,
                                           device="cpu")
        x = StepInputs(*(a[0].to(dev) for a in batch.steps))
        mask = batch.txt_mask.to(dev)
        txt = torch.zeros((b, cfg.shapes.max_txt_len, cfg.model.hidden_size),
                          device=dev)
        lats = []
        with torch.inference_mode():
            carry = init_carry(cfg, b, device=dev)
            carry, o = nav_device_step(model, cfg, txt, mask, carry, x)
            D.sync(dev)
            for _ in range(steps):
                t0 = time.perf_counter()
                carry, o = nav_device_step(model, cfg, txt, mask, carry, x)
                _ = float(o.fused_logits[0, 0])  # hard sync
                lats.append(time.perf_counter() - t0)
        eager = _percentiles(lats)

        eng = NavServingEngine.create(model, cfg, b, device=dev)
        for r in range(b):
            eng.submit(r, batch.txt_ids[r].numpy(), batch.txt_mask[r].numpy())
        eng.admit()
        rows = {r: StepInputs(*(a[0, r:r + 1].numpy() for a in batch.steps))
                for r in range(b)}
        _ = float(eng.step(rows).fused_logits[0, 0])
        lats = []
        for _ in range(steps):
            t0 = time.perf_counter()
            _ = float(eng.step(rows).fused_logits[0, 0])
            lats.append(time.perf_counter() - t0)
        engine = _percentiles(lats)
        del eng
        out[b] = {"eager": eager, "engine": engine}
        print(f"batch={b}: p50={eager[0]:.2f} ms  p90={eager[1]:.2f} ms "
              f"(eager step)  |  {engine_kind}: p50={engine[0]:.2f} ms  "
              f"p90={engine[1]:.2f} ms  [{D.name(dev)}]", flush=True)
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--device", default="cuda")
    p.add_argument("--int8", action="store_true",
                   help="int8 trunk matmuls (ModelConfig.int8_matmuls)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny_config() widths (the CPU tests)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    return run(args.device, args.int8, args.tiny)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Where the serving step's time goes on the card (gridmm_tpu_torch).

    python3 chip_profile.py [--steps 5]

Builds the full-width R2R navigator (seeded random weights), fills a 4-slot
serving engine's point buffers with 15 steps, then:

  * times 10 more steps with the host clock (synchronised);
  * traces `--steps` steps with torch.profiler and prints the device-busy
    share of the window, kernel launches per step and the top device-time
    operators;
  * traces 20 calls of the dispatching grid pool at the same shapes and
    prints each operator's device and host time;
  * builds the clip_b32 tower (bf16, seeded random weights), fills a
    16-panorama pipeline buffer with 15 encode_and_pool iterations, then
    traces 3 encodes of 192 views and 3 pipeline iterations.

Needs one NVIDIA card; writes the tables to chiprun_out/chip_profile.txt.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import (PIPE_PANOS, SERVE_SLOTS, card, pipeline_inputs,
                        request_text, step_row)
from gridmm_tpu_torch.config import r2r_config
from gridmm_tpu_torch.data.preprocess import ClipFeatureExtractor
from gridmm_tpu_torch.models.clip_vit import clip_b32
from gridmm_tpu_torch.pipeline import encode_and_pool
from gridmm_tpu_torch.models.navigator import init_navigator
from gridmm_tpu_torch.ops import geometry as G
from gridmm_tpu_torch.ops import grid_pool as GP
from gridmm_tpu_torch.serve.engine import NavServingEngine

ROOT = Path(__file__).resolve().parent


def device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", 0.0) or 0.0)


def summarize(prof, wall_s, per, label, out, top=15):
    """Device-busy share, launches per call and the top operators."""
    events = prof.key_averages()
    # device-side events only (kernels, memcpy, memset): the operator rows
    # above them report the same device time again
    kernels = [e for e in events if "CUDA" in str(e.device_type)]
    busy_us = sum(device_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    lines = [f"== {label}: window {wall_s * 1e3:.3f} ms host clock, device "
             f"busy {busy_us / 1e3:.3f} ms ({100 * busy_us / 1e3 / (wall_s * 1e3):.1f}%), "
             f"{launches / per:.1f} kernel launches and "
             f"{busy_us / 1e3 / per:.3f} ms device time per call"]
    if busy_us == 0:
        lines.append("   device time: not measured (the trace holds no "
                     "device events)")
    lines.append(events.table(sort_by="self_device_time_total",
                              row_limit=top, max_name_column_width=60))
    text = "\n".join(lines)
    print(text)
    out.append(text)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev_name = card()
    print(f"card: {dev_name}")
    cfg = r2r_config()
    rng = np.random.default_rng(0)
    model = init_navigator(cfg.model, seed=0, device="cuda")
    eng = NavServingEngine.create(model, cfg, SERVE_SLOTS)
    for r in range(SERVE_SLOTS):
        eng.submit(r, *request_text(cfg, rng))
    eng.admit()
    for t in range(15):
        eng.step({s: step_row(cfg, rng, t) for s in range(SERVE_SLOTS)})
    rows = {s: step_row(cfg, rng, 15) for s in range(SERVE_SLOTS)}
    torch.cuda.synchronize()
    out = [f"card: {dev_name}"]

    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        eng.step(rows)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    line = (f"serving step, {SERVE_SLOTS} slots, full buffer: median "
            f"{np.median(times):.3f} ms over 10 steps [{dev_name}]")
    print(line)
    out.append(line)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            eng.step(rows)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summarize(prof, wall, args.steps, f"serving step x{args.steps}", out)

    ps = eng._carry.point_state
    pos = torch.as_tensor(np.concatenate([rows[0].pos_xy] * SERVE_SLOTS),
                          device="cuda")
    head = torch.as_tensor(np.concatenate([rows[0].heading] * SERVE_SLOTS),
                           device="cuda")
    cells, _, _ = G.egocentric_grid_assignment(ps, pos, head, cfg.grid)
    for _ in range(3):
        GP.grid_pool_raw(ps.features, cells, ps.weights)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(20):
            GP.grid_pool_raw(ps.features, cells, ps.weights)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summarize(prof, wall, 20, "grid_pool_raw x20 (B=4 N=8832 D=768 f32)",
              out)
    del eng, model

    ex = ClipFeatureExtractor(clip_b32(), device="cuda")
    images, steps, heads, state = pipeline_inputs(cfg, PIPE_PANOS,
                                                  torch.bfloat16)

    def iteration(state, depth, pos, heading):
        return encode_and_pool(ex.model, images, state, depth, pos, heading,
                               heads["txt"], heads["text_proj"],
                               heads["grid_proj"], cfg.grid).state

    for depth, pos, heading in steps:          # fill the buffer
        state = iteration(state, depth, pos, heading)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            ex.encode(images)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summarize(prof, wall, 3, "encode x3 (clip_b32 bf16, 192 views)", out)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            state = iteration(state, *steps[-1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summarize(prof, wall, 3, f"encode_and_pool x3 ({PIPE_PANOS} panoramas, "
              "full bf16 buffer)", out)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_profile.txt").write_text("\n".join(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

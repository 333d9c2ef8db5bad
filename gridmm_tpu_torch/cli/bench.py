"""Headline benchmark of the port: panorama views/s on one card (twin of
bench.py:25-148).

    python -m gridmm_tpu_torch.cli.bench                     # the card
    python -m gridmm_tpu_torch.cli.bench --device cpu --tiny # a CPU dry run

Each iteration takes B = 16 panoramas through the pipeline that fills and
reads the grid memory (gridmm_tpu_torch/pipeline.encode_and_pool):

  12 views x 224 x 224 uint8 -> CLIP normalization -> clip_b32() tower (all
  50 tokens; K2, K3) -> text projection, relevance and grid projection of
  the 588 new points -> append_panorama -> egocentric_grid_assignment over
  the full 8832-point r2r buffer (bf16) -> relevance pool into 196 cells
  (K1).

The buffer is filled first (`max_steps - 1` iterations), then 20 timed
iterations keep appending to the full buffer (the write offset clamps),
each chained to the last through the state, with one synchronisation at
the end.

The tower is bf16 with `attn_scores_f32=False`, where bench.py takes the
int8 tower: on the H100 the int8 clip_b32 tower reached 0.22x the bf16
tower's views/s (6,643.9 against 29,676.3, PERF.md section 2), because
each int8 projection adds quantize kernels to a product the tensor cores
already run in bf16. The kernels keep scores in f32 either way.

Prints ONE JSON line with bench.py's keys: `metric`, `value`, `unit`,
`vs_baseline` and `backend`, plus `device` (the card's name).
`vs_baseline` is null: bench.py's divisor, BASELINE.md's 5,000 views/s,
is a target set for a TPU, and the port carries no TPU number. Without a
card the run raises unless `--device cpu` is given; it never degrades to
the CPU by itself.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

# panoramas per iteration, instruction tokens (bench.py:57-59)
PANOS, TXT_LEN = 16, 48


def bench_inputs(b: int, views: int, d: int, patches: int, device,
                 seed: int = 0):
    """bench.py's inputs from numpy seed `seed`: uint8 views, text
    embeddings, the (D, D) text and grid projections (x @ W layout), raw
    depth patches, positions and headings, on `device`."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b * views, 224, 224, 3)).astype(np.uint8)
    txt = rng.standard_normal((b, TXT_LEN, d)).astype(np.float32) * 0.3
    wt = rng.standard_normal((d, d)).astype(np.float32) * 0.02
    wg = rng.standard_normal((d, d)).astype(np.float32) * 0.02
    depth = rng.integers(0, 18000, (b, views, patches)).astype(np.float32)
    pos = rng.uniform(-4, 4, (b, 2)).astype(np.float32)
    heading = rng.uniform(-3, 3, (b,)).astype(np.float32)

    def put(a):
        return torch.from_numpy(a).to(device)

    zeros = torch.zeros((d,), device=device)
    return dict(images=put(images), txt=put(txt),
                text_proj=(put(wt), zeros), grid_proj=(put(wg), zeros),
                depth=put(depth), pos=put(pos), heading=put(heading))


def run(device: str = "cuda", tiny: bool = False, iters: int = None,
        seed: int = 0) -> dict:
    """The benchmark; returns the record `main` prints. tiny: a 2-layer
    tower 64 wide, f32, B = 2 on a 2-step buffer, 3 timed iterations (the
    CPU tests); otherwise bench.py's sizes."""
    from gridmm_tpu_torch.config import r2r_config
    from gridmm_tpu_torch.models.clip_vit import clip_b32, init_clip_vision
    from gridmm_tpu_torch.ops import geometry as G
    from gridmm_tpu_torch.pipeline import encode_and_pool
    from gridmm_tpu_torch.utils import device as D

    dev = D.resolve(device)
    cfg = r2r_config()
    gc = cfg.grid
    if tiny:
        ccfg = dataclasses.replace(clip_b32(), width=64, layers=2, heads=4,
                                   compute_dtype="float32")
        gc = dataclasses.replace(gc, feature_dim=ccfg.width, max_steps=2)
        b, max_points, buf_dtype = 2, gc.max_points, torch.float32
        iters = iters or 3
    else:
        ccfg = dataclasses.replace(clip_b32(), attn_scores_f32=False)
        b, max_points, buf_dtype = PANOS, cfg.shapes.max_points, torch.bfloat16
        iters = iters or 20
    views, d = gc.num_views, ccfg.width
    model = init_clip_vision(ccfg, seed=seed, device=dev)
    x = bench_inputs(b, views, d, gc.patches_per_view, dev, seed)
    state = G.PointCloudState.create(b, gc, max_points,
                                     feature_dtype=buf_dtype, device=dev)

    def step(state):
        return encode_and_pool(model, x["images"], state, x["depth"],
                               x["pos"], x["heading"], x["txt"],
                               x["text_proj"], x["grid_proj"], gc).state

    # fill the buffer, so that assignment and pool run at capacity
    for _ in range(gc.max_steps - 1):
        state = step(state)
    D.sync(dev)
    start = time.perf_counter()
    for _ in range(iters):
        state = step(state)
    D.sync(dev)
    elapsed = time.perf_counter() - start
    views_per_sec = b * views * iters / elapsed
    return {"metric": "panorama_views_per_sec_per_chip",
            "value": round(views_per_sec, 2), "unit": "views/s",
            "vs_baseline": None, "backend": dev.type,
            "device": D.name(dev)}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no card and no --device cpu "
                        "raises")
    p.add_argument("--tiny", action="store_true",
                   help="a 2-layer tower 64 wide, B = 2, 3 timed iterations")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    record = run(args.device, args.tiny)
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()

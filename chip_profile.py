#!/usr/bin/env python3
"""Where the serving step's, the encoder's, the train update's and the
pretraining update's time goes on the card (gridmm_tpu_torch).

    python3 chip_profile.py [--steps 5]
    python3 chip_profile.py --ab OTHER_TREE [--only pool layernorm attention
                                             pool_bwd]
    python3 chip_profile.py --changing-ops
    python3 chip_profile.py --k1-shapes
    python3 chip_profile.py --k2-builds
    python3 chip_profile.py --k4-builds

Builds the full-width R2R navigator (seeded random weights) and, for an
eager 4-slot serving engine and then one whose step is a CUDA graph, fills
the point buffers with 15 steps, then:

  * times 10 more steps with the host clock (synchronised);
  * traces `--steps` steps with torch.profiler and prints the device-busy
    share of the window, kernel launches per step, the top device-time
    operators and K1's launches per step;
  * runs one eager step of a `create` engine and of a `from_bundle` engine
    exported from the same weights, and prints the device kernels whose
    launch counts differ between the two and how far their logits part;
  * traces 20 calls of the dispatching grid pool at the same shapes and
    prints each operator's device and host time;
  * builds the clip_b32 tower (bf16, seeded random weights), fills a
    16-panorama pipeline buffer with 15 encode_and_pool iterations, then
    traces 3 encodes of 192 views and 3 pipeline iterations;
  * makes one make_train_step update of the full-width navigator on a
    synthetic batch of cfg.train.batch_size trajectories x 15 steps as
    warm-up, then traces one more: launches, device time by operator and
    the device-busy share of the update;
  * does the same for one pretraining update of each task (mlm, mrc, sap)
    at r2r width on the 12,416-point buffer, 8 trajectories x 21 steps;
  * builds the full VLN-CE agent (r2r_ce_config() navigator, ResNet50 and
    ddppo towers, clip_b32 and the ViT-B/16 view tower) and traces one
    fused CE step for 4 envs (perception, candidates, step assembly,
    navigation) after a warm-up, then one CE update on a recorded batch
    of 4 envs x 20 steps after a warm-up update.

The encode's and the pipeline's tables are followed by LayerNorm's launches
and device time per launch.

With --ab, it only times the pool forward (K1), LayerNorm (K3), the
packed-qkv and per-head attention (K2, K4) and the pool backward's two
passes (K5a, K5b) as built from this tree's csrc/ and from OTHER_TREE's (a
checkout of another commit, for example the parent unpacked with `git
archive`) in one process, on the same inputs, in turns (other, this, this,
other), at the main paths' shapes, reading from device memory; a shape a
tree's kernel refuses is timed for the other tree only. `--only` names the
kernels to time (pool: K1; layernorm: K3; attention: K2 and K4; pool_bwd:
K5a and K5b); without it, all. K1 runs on each main path's own
inputs (every K1 launch of one run of the path, recorded: serving,
pipeline, train, pretrain, CE), on the last serving step's buffer, and on
random cells at the five paths' shapes and a skewed serving buffer. The
pool kernels' C entry points differ between trees whose K1 splits a row
over a cluster and the trees before them (K1 takes its row split and
chunk, K5a its scratch and tile count); each tree is called with its own.

With --k1-shapes, it only times the pool forward over its launch shapes
(blocks a row is dealt to x cells a block) on each main path's own inputs
and on an even and a skewed buffer at the serving shape, and then builds
of K1 that differ in one place each (K1_VARIANTS: the register caps, a
cluster of one block for unsplit rows) on the paths' inputs: the tables
the wrapper's choice (`fwd_launch_shape`) and the caps were made from.
--k1-shapes and --ab may be given together; the paths then run once.

With --k2-builds, it only times builds of the packed-qkv attention (K2)
that differ in one place each (ATTENTION_BUILDS["k2"]: a third slot in
the ring, four-warp blocks, no register cap) at its main paths' shapes
and at L = 1025 and 2048, bf16, in turns: the table its ring and block
were chosen from. With --k4-builds, the same for the per-head attention
(K4; ATTENTION_BUILDS["k4"]: the bf16 body streaming every slice's tiles)
at its main paths' shapes and a few others: the table its bodies were
chosen from.

With --changing-ops, it only runs one train loss and its backward three
times on the same inputs and names the operators whose outputs change from
run to run on the same inputs (`changing_ops`).

Needs one NVIDIA card; writes the tables to chiprun_out/chip_profile.txt
(chip_profile_ab.json with --ab, chip_profile_changing_ops.json with
--changing-ops, chip_profile_k1_shapes.json with --k1-shapes,
chip_profile_k2_builds.json and chip_profile_k4_builds.json with
--k2-builds and --k4-builds).
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import (CE_ENVS, CE_N, CE_SEED, CE_STEPS, CLIP_BATCH,
                        FIRST_STEPS, LATER_STEPS, PIPE_PANOS, PRETRAIN_B,
                        PRETRAIN_N, PRETRAIN_S, SERVE_SLOTS, TRAIN_STEPS,
                        VIEWS, ce_env, run_engine,
                        attn_atol, bwd_inputs, card, copies_for, cuda_ms,
                        pipeline_inputs, pool_case, request_text, require,
                        rotating_ms, step_row)
from gridmm_tpu_torch.ce.factory import build_ce_agent
from gridmm_tpu_torch.ce.trainer import CETrainer
from gridmm_tpu_torch.config import r2r_config
from gridmm_tpu_torch.data.preprocess import ClipFeatureExtractor
from gridmm_tpu_torch.models.clip_vit import clip_b32
from gridmm_tpu_torch.pipeline import encode_and_pool
from gridmm_tpu_torch.models.navigator import init_navigator
from gridmm_tpu_torch.ops import geometry as G
from gridmm_tpu_torch.ops import grid_pool as GP
from gridmm_tpu_torch.ops import attention as ATT
from gridmm_tpu_torch.ops.cuda import build
from gridmm_tpu_torch.ops.cuda.attention import (ATTENTION_FWD,
                                                 ATTENTION_QKV_FWD)
from gridmm_tpu_torch.ops.cuda.grid_pool import (GRID_POOL_BWD1,
                                                 GRID_POOL_BWD2,
                                                 GRID_POOL_FWD, GridPoolFwd,
                                                 SOURCE,
                                                 MAX_CHUNK, SOURCE_BWD,
                                                 bwd_tiles, fwd_launch_shape)
from gridmm_tpu_torch.ops.cuda.layernorm import LAYERNORM_FWD
from gridmm_tpu_torch.serve.engine import NavServingEngine
from gridmm_tpu_torch.utils.export import (export_navigator_serving,
                                           save_serving_bundle)
from gridmm_tpu_torch.cli import pretrain as pretrain_cli
from gridmm_tpu_torch.train.pretrain import (init_pretrain_params,
                                             make_pretrain_step)
from gridmm_tpu_torch.train.step import (batch_to_device, create_train_state,
                                         init_carry, make_train_step)
from gridmm_tpu_torch.train.synthetic import (synthetic_pretrain_batch,
                                              synthetic_trajectory_batch)

ROOT = Path(__file__).resolve().parent


def device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", 0.0) or 0.0)


def summarize(prof, wall_s, per, label, out, top=15, watch=()):
    """Device-busy share, launches per call and the top operators; for each
    name fragment in `watch`, the launches per call and the device time per
    launch of the kernels whose name holds it."""
    events = prof.key_averages()
    # device-side events only (kernels, memcpy, memset): the operator rows
    # above them report the same device time again, and so does the span of
    # a user annotation (torch wraps Optimizer.step in one)
    kernels = [e for e in events if "CUDA" in str(e.device_type)
               and not getattr(e, "is_user_annotation", False)]
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
    for frag in watch:
        hits = [e for e in kernels if frag in e.key]
        n = sum(e.count for e in hits)
        us = sum(device_us(e) for e in hits)
        lines.append(f"   {frag}: {n / per:.1f} launches per call, "
                     f"{us / max(n, 1):.3f} us device time per launch, "
                     f"{100 * us / max(busy_us, 1e-9):.1f}% of the device "
                     f"time")
    text = "\n".join(lines)
    print(text)
    out.append(text)


def kernel_diff(model, cfg, dev_name, out):
    """One eager step of a `create` engine and of a `from_bundle` engine
    (the bundle exported from the same weights, chiprun_out/profile_bundle)
    on the same buffers and rows: the device kernels whose launch count
    differs between the two, which is where their logits may part."""
    bundle = ROOT / "chiprun_out" / "profile_bundle"
    save_serving_bundle(
        export_navigator_serving(model, cfg, model.state_dict(),
                                 batch=SERVE_SLOTS, device="cuda"),
        str(bundle), cfg=cfg, extra_manifest={"batch": SERVE_SLOTS})
    names = {}
    logits = {}
    for label, make in (
            ("create", lambda: NavServingEngine.create(
                model, cfg, SERVE_SLOTS, cuda_graph=False)),
            ("from_bundle", lambda: NavServingEngine.from_bundle(
                str(bundle), cfg, dict(model.state_dict()), SERVE_SLOTS,
                cuda_graph=False))):
        eng = make()
        rng = np.random.default_rng(0)
        for r in range(SERVE_SLOTS):
            eng.submit(r, *request_text(cfg, rng))
        eng.admit()
        for t in range(3):
            eng.step({s: step_row(cfg, rng, t) for s in range(SERVE_SLOTS)})
        rows = {s: step_row(cfg, rng, 3) for s in range(SERVE_SLOTS)}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            res = eng.step(rows)
            torch.cuda.synchronize()
        logits[label] = res.fused_logits.cpu()
        names[label] = {e.key: e.count for e in prof.key_averages()
                        if "CUDA" in str(e.device_type)}
    for p in bundle.glob("*.pt2"):
        p.unlink()
    a, b = logits["create"], logits["from_bundle"]
    fin = torch.isfinite(a)
    lines = [f"== eager step, create vs from_bundle (same weights, 4 steps "
             f"in): fused logits max|diff| "
             f"{(a[fin] - b[fin]).abs().max().item():.3e}, equal bits "
             f"{torch.equal(a, b)}; kernels whose launches differ "
             f"(create, from_bundle) [{dev_name}]:"]
    for key in sorted(set(names["create"]) | set(names["from_bundle"])):
        n_a, n_b = names["create"].get(key, 0), names["from_bundle"].get(
            key, 0)
        if n_a != n_b:
            lines.append(f"   {n_a:4d} {n_b:4d}  {key[:110]}")
    text = "\n".join(lines)
    print(text)
    out.append(text)


def recorded_pool_inputs(run) -> list:
    """Runs `run()` and returns the inputs of every K1 launch it made, in
    order: (features, cell ids, weights, num_cells), cloned."""
    got = []

    def launch(g, cells, w, pooled, mask, denom, cmax, shape=None):
        got.append((g.clone(), cells.clone(), w.clone(), cmax.shape[1]))
        GridPoolFwd.launch(GRID_POOL_FWD, g, cells, w, pooled, mask, denom,
                           cmax, shape=shape)

    GRID_POOL_FWD.launch = launch
    try:
        run()
        torch.cuda.synchronize()
    finally:
        del GRID_POOL_FWD.launch
    return got


def main_path_pool_inputs(dev_name: str) -> dict:
    """{path: the inputs of every K1 launch of one run of it}, each path run
    as chip_smoke.py drives it, on seeded random weights: serving (a 4-slot
    eager engine at r2r_config() width, 6 requests x 18 steps), pipeline
    (clip_b32 bf16, encode_and_pool over 16 panoramas x 15 iterations),
    train (one make_train_step update, 16 x 15, f32), pretrain (one update
    of each task, 8 x 21, the 12,416-point buffer) and CE (a recorded batch
    of 4 envs x 20 steps and one CE update, r2r_ce width with the view
    tower). Their cells come from the grid assignment of each step's depth
    and pose, but pretraining's, which its synthetic batch draws at
    random."""
    cfg = r2r_config()
    paths = {}
    rng = np.random.default_rng(0)
    n_req = SERVE_SLOTS + 2
    texts = [request_text(cfg, rng) for _ in range(n_req)]
    rows = [[step_row(cfg, rng, t) for t in range(FIRST_STEPS + LATER_STEPS)]
            for _ in range(n_req)]
    model = init_navigator(cfg.model, seed=0, device="cuda")
    paths["serving"] = recorded_pool_inputs(
        lambda: run_engine(model, cfg, rows, texts, cuda_graph=False))
    del model

    ex = ClipFeatureExtractor(clip_b32(), device="cuda")
    images, steps, heads, state = pipeline_inputs(cfg, PIPE_PANOS,
                                                  torch.bfloat16)

    def pipeline(state=state):
        for depth, pos, heading in steps:
            state = encode_and_pool(ex.model, images, state, depth, pos,
                                    heading, heads["txt"], heads["text_proj"],
                                    heads["grid_proj"], cfg.grid).state

    paths["pipeline"] = recorded_pool_inputs(pipeline)
    del ex, images, steps, heads, state

    model = init_navigator(cfg.model, seed=1, device="cuda")
    model.eval()
    train_state = create_train_state(cfg, model)
    batch = synthetic_trajectory_batch(cfg, cfg.train.batch_size,
                                       TRAIN_STEPS, seed=0, device="cuda")
    paths["train"] = recorded_pool_inputs(
        lambda: make_train_step(cfg)(train_state, batch, seed=0))
    del model, train_state, batch

    pcfg = pretrain_cli._resolve_config(
        pretrain_cli.parse_args(["--preset", "r2r"]))
    model = init_pretrain_params(pcfg.model, seed=1, device="cuda")
    model.eval()
    state = create_train_state(pcfg, model)
    batch = synthetic_pretrain_batch(pcfg, PRETRAIN_B, PRETRAIN_S, seed=0,
                                     device="cuda")
    paths["pretrain"] = recorded_pool_inputs(lambda: [
        make_pretrain_step(pcfg, task)(state, batch)
        for task in ("mlm", "mrc", "sap")])
    del model, state, batch

    cfg, agent = build_ce_agent(tiny=False, view_tower=True, seed=CE_SEED,
                                device="cuda")
    trainer = CETrainer(cfg, agent)

    def ce():
        with agent.inference():
            raw = trainer.record_batch(ce_env(6), CE_STEPS,
                                       np.random.default_rng(0),
                                       trainer.ss_ratio(0))
        batch = batch_to_device(raw, "cuda")
        batch = batch._replace(steps=batch.steps._replace(
            patch_fts=batch.steps.patch_fts.clone()))
        trainer.update(batch, seed=0, dropout=False)

    paths["CE"] = recorded_pool_inputs(ce)
    del cfg, agent, trainer
    torch.cuda.empty_cache()
    for label, caps in paths.items():
        g, cells, _, nc = caps[-1]
        filled = [int((c >= 0).sum()) for _, c, _, _ in caps]
        print(f"  K1 inputs of the {label} path: {len(caps)} launches at "
              f"{tuple(g.shape)} {str(g.dtype)[6:]}, {nc} cells, valid "
              f"points a launch {min(filled)}-{max(filled)} [{dev_name}]")
    return paths


def k1_outputs(caps) -> dict:
    """Output tensors for each (B, num_cells, D) among `caps`."""
    outs = {}
    for g, _, _, nc in caps:
        b, _, d = g.shape
        if (b, nc, d) not in outs:
            outs[b, nc, d] = (
                torch.empty((b, nc, d), device="cuda"),
                torch.empty((b, nc), dtype=torch.bool, device="cuda"),
                torch.empty((b, 256), device="cuda"),
                torch.empty((b, nc), device="cuda"))
    return outs


def k1_launch(fn, g, cells, w, nc, outs, shape):
    """One launch of a build of K1 (its C function `fn`); `shape` is the
    tail of its arguments before the stream: (group, row_split, chunk), or
    (group,) for a build before the row split."""
    b, n, d = g.shape
    err = fn(g.data_ptr(), 0 if g.dtype == torch.float32 else 1,
             cells.data_ptr(), w.data_ptr(),
             *(t.data_ptr() for t in outs[b, nc, d]), b, n, d, nc, *shape,
             torch.cuda.current_stream().cuda_stream)
    require(err == 0, f"grid_pool_fwd launch failed: cudaError {err}")


def synthetic_pool_inputs() -> dict:
    """Buffers no path makes, at the serving shape (B=4, N=8832, D=768
    f32): cells drawn evenly, and 90% of row 0 in one cell."""
    return {name: [pool_case(kind, SERVE_SLOTS, torch.float32, seed=5)
                   + (196,)]
            for name, kind in (("serving shape, cells even", "random"),
                               ("serving shape, 90% of row 0 in one cell",
                                "skew"))}


def attn_args(tensors, code, bh, length, hd):
    """The C arguments of gridmm_attention_fwd but the stream."""
    q, k, v, o = tensors
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), code, o.data_ptr(), bh,
            length, hd, 1.0 / hd ** 0.5)


AB_KERNELS = ("pool", "layernorm", "attention", "pool_bwd")


def ptxas_summary(log: str) -> str:
    """`kernel<template arg>: registers [spills]` for each entry function
    in an nvcc -Xptxas -v log."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            name = mangled[:mangled.find("_kernel") + len("_kernel")]
            name = name[name.rfind("attention_"):]
            arg = re.search(r"ILi(\d+)E", mangled)
            if arg:
                name += f"<{arg.group(1)}>"
            spill = ""
        elif "spill stores" in line and not line.strip().startswith(
                "0 bytes stack"):
            spill = f" [{line.strip()}]"
        elif "registers" in line and name:
            regs = line.split("Used ")[1].split(" registers")[0]
            out.append(f"{name}: {regs}{spill}")
    return "; ".join(out) or "not rebuilt"


def ab_kernels(other_root: Path, dev_name: str, paths: dict,
               only=AB_KERNELS) -> dict:
    """K1, K3, K2 and K4, K5a and K5b (those `only` names) from this tree's
    csrc/ and from `other_root`'s, on the same inputs, timed in turns
    (other, this, this, other). Both trees must export the same C entry
    points (the pool kernels' of either generation). Returns {case: {tree:
    [ms, ms]}}."""
    trees = {"other": other_root / "gridmm_tpu_torch" / "csrc",
             "this": build.SRC_DIR}
    # a tree whose K1 splits rows: K1 takes (group, row_split, chunk), K5a its
    # partials, its row counts and its tile count
    split_rows = {tree: "row_split" in (src / f"{SOURCE}.cu").read_text()
                  for tree, src in trees.items()}
    fns = {}
    for tree, src in trees.items():
        logs = build.build_all([SOURCE, "layernorm_fwd", SOURCE_BWD,
                                "attention_fwd", "attention_qkv_fwd"], src)
        for name in ("attention_qkv_fwd", "attention_fwd"):
            print(f"  {tree} {name}: {ptxas_summary(logs.get(name, ''))}")
        fwd_args = GRID_POOL_FWD.argtypes
        if not split_rows[tree]:     # (..., group, stream)
            fwd_args = fwd_args[:-3] + fwd_args[-1:]
        bwd1_args = GRID_POOL_BWD1.argtypes
        if not split_rows[tree]:     # (..., S, b, n, d, cells, blocks, stream)
            bwd1_args = bwd1_args[:10] + bwd1_args[12:]
        fns[tree] = {
            "fwd": build.function(SOURCE, GRID_POOL_FWD.symbol, fwd_args,
                                  src),
            "attn": build.function("attention_fwd", ATTENTION_FWD.symbol,
                                   ATTENTION_FWD.argtypes, src),
            "qkv": build.function("attention_qkv_fwd",
                                  ATTENTION_QKV_FWD.symbol,
                                  ATTENTION_QKV_FWD.argtypes, src),
            "ln": build.function("layernorm_fwd", LAYERNORM_FWD.symbol,
                                 LAYERNORM_FWD.argtypes, src),
            "bwd1": build.function(SOURCE_BWD, GRID_POOL_BWD1.symbol,
                                   bwd1_args, src),
            "bwd2": build.function(SOURCE_BWD, GRID_POOL_BWD2.symbol,
                                   GRID_POOL_BWD2.argtypes, src)}
    stream = torch.cuda.current_stream().cuda_stream
    result = {}

    def run(fn, *args):
        err = fn(*args, stream)
        require(err == 0, f"launch failed: cudaError {err}")

    def turns(case, timer):
        got = {"other": [], "this": []}
        for tree in ("other", "this", "this", "other"):
            got[tree].append(timer(tree))
        result[case] = got
        print(f"  {case}: other {got['other'][0]:.5f} / "
              f"{got['other'][1]:.5f} ms, this {got['this'][0]:.5f} / "
              f"{got['this'][1]:.5f} ms [{dev_name}]")

    if "pool" in only:
        pool_forward_ab(paths, split_rows, fns, turns)
    if "layernorm" in only:
        layernorm_ab(fns, turns, run, result)
    if "attention" in only:
        attention_ab(fns, turns, run, result, stream, dev_name)
    if "pool_bwd" in only:
        pool_backward_ab(trees, split_rows, fns, turns, run)
    one = torch.ones(1, device="cuda")
    result["launch floor (a one-element torch.add)"] = cuda_ms(
        lambda: torch.add(one, one, out=one), iters=30)
    print(f"  launch floor (a one-element torch.add): "
          f"{result['launch floor (a one-element torch.add)']:.5f} ms "
          f"[{dev_name}]")
    return result


def pool_forward_ab(paths, split_rows, fns, turns):
    """K1 of both trees on the main paths' own inputs (a run of each path:
    every launch in turn), on the last serving step's buffer, and on
    synthetic buffers at the main paths' shapes, each tree with its own
    launch shape (the parent's: `group` cells a block, a block a row)."""
    trees = ("other", "this")
    cases = {f"{label} path, its {len(caps)} launches": caps
             for label, caps in paths.items()}
    cases["serving, the last step's buffer"] = paths["serving"][-1:]
    for label, b, n, dtype, filled in (
            ("serving shape, cells even", SERVE_SLOTS, 8832, torch.float32,
             8832),
            ("pipeline shape", PIPE_PANOS, 8832, torch.bfloat16, 8832),
            ("train shape", 16, TRAIN_STEPS * 588, torch.float32, 8820),
            ("pretrain shape", PRETRAIN_B, PRETRAIN_N, torch.float32,
             PRETRAIN_S * 588),
            ("CE shape", CE_ENVS, CE_N, torch.float32, CE_STEPS * 588),
            ("serving shape, 90% of row 0 in one cell", SERVE_SLOTS, 8832,
             torch.float32, 8832)):
        g, cells, w = pool_case("skew" if "90%" in label else "random", b,
                                dtype, seed=5, n=n)
        cells[:, filled:] = -1
        cases[f"{label}, random cells"] = [(g, cells, w, 196)]
    for label, caps in cases.items():
        outs = k1_outputs(caps)

        def fwd(tree, caps=caps, outs=outs):
            for g, cells, w, nc in caps:
                b, n, _ = g.shape
                if split_rows[tree]:
                    shape = fwd_launch_shape(b, n, nc)
                else:
                    shape = (max(1, min(4, -(-b * nc // 1024))),)
                k1_launch(fns[tree]["fwd"], g, cells, w, nc, outs, shape)

        pooled = {}
        for tree in trees:
            fwd(tree)
            pooled[tree] = next(iter(outs.values()))[0].clone()
        torch.testing.assert_close(pooled["this"], pooled["other"],
                                   rtol=1e-5, atol=1e-5 * pooled[
                                       "other"].abs().max().item())
        g = caps[0][0]
        turns(f"grid_pool_fwd {label} {tuple(g.shape)} {str(g.dtype)[6:]}",
              lambda tree: cuda_ms(lambda: fwd(tree),
                                   iters=max(3, 25 // len(caps)),
                                   warmup=1))
        del outs, pooled


def layernorm_ab(fns, turns, run, result):
    """K3 of both trees at the towers' shapes, beside a copy_ of the same
    bytes."""
    trees = ("other", "this")
    rng = np.random.default_rng(5)
    for rows, c, dtype in ((9600, 768, torch.bfloat16),
                           (9600, 768, torch.float32),
                           (2400, 64, torch.bfloat16),
                           (2400, 64, torch.float32)):
        size = 2 if dtype == torch.bfloat16 else 4
        code = 0 if dtype == torch.float32 else 1
        sets = []
        for _ in range(copies_for(2 * rows * c * size)):
            x = torch.from_numpy(rng.standard_normal((rows, c)).astype(
                np.float32)).to("cuda", dtype)
            sets.append((x, torch.rand(c, device="cuda") + 0.5,
                         torch.randn(c, device="cuda"), torch.empty_like(x)))

        def ln(tree, x, w, b, y):
            run(fns[tree]["ln"], x.data_ptr(), code, w.data_ptr(),
                b.data_ptr(), y.data_ptr(), rows, c, 1e-5)

        ys = {}
        for tree in trees:
            ln(tree, *sets[0])
            ys[tree] = sets[0][3].float()
        torch.testing.assert_close(ys["this"], ys["other"], rtol=2.0 ** -7,
                                   atol=1e-5)
        case = f"layernorm_fwd ({rows}, {c}) {str(dtype)[6:]}"
        turns(case, lambda tree: rotating_ms(lambda *a: ln(tree, *a), sets))
        # a practical ceiling: PyTorch's copy of the same bytes
        result[case]["copy_ms"] = rotating_ms(
            lambda x, w, b, y: y.copy_(x), sets)
        print(f"    copy_ of the same bytes: {result[case]['copy_ms']:.5f} ms")
        del sets, ys


def timed_where_taken(case, takes, timer, turns, result, dev_name):
    """Both trees in turns where both take the shape, else the tree that
    does, twice."""
    if all(takes.values()):
        turns(case, timer)
        return
    tree = "this" if takes["this"] else "other"
    result[case] = {t: None for t in takes}
    result[case][tree] = [timer(tree) for _ in range(2)]
    print(f"  {case}: only {tree} takes it, {result[case][tree][0]:.5f} / "
          f"{result[case][tree][1]:.5f} ms [{dev_name}]")


def attention_ab(fns, turns, run, result, stream, dev_name):
    """K2 at its main paths' shapes (clip_b32's (192, 50), the CE view
    tower's (48, 197), B/16's (192, 197)) and at L = 1025, bf16; K4 at the
    tiny tower's, B/16's and ViT-H/14's shapes and at long L and hd 320.
    Each call on its own input and output."""
    trees = ("other", "this")
    gen = torch.Generator(device="cuda").manual_seed(6)
    for b, length in ((CLIP_BATCH * VIEWS, 50), (48, 197),
                      (CLIP_BATCH * VIEWS, 197), (4, 1025)):
        sets = [(torch.randn((b, length, 2304), generator=gen,
                             device="cuda").to(torch.bfloat16),
                 torch.empty((b, length, 768), device="cuda",
                             dtype=torch.bfloat16))
                for _ in range(copies_for(b * length * 3072 * 2))]

        def qkv_args(x, o, b=b, length=length):
            return (x.data_ptr(), 1, o.data_ptr(), b, length, 12, 0.125)

        x, o = sets[0]
        want = ATT.attention_qkv_plain(x, 12).float()
        takes = {}
        for tree in trees:
            o.zero_()
            takes[tree] = fns[tree]["qkv"](*qkv_args(x, o), stream) == 0
            if takes[tree]:
                torch.testing.assert_close(o.float(), want, rtol=0.0,
                                           atol=attn_atol(x.dtype,
                                                          x[..., 1536:]))
        require(takes["this"], f"attention_qkv_fwd refused L = {length}")
        timed_where_taken(
            f"attention_qkv_fwd ({b}, {length}, 2304) bfloat16", takes,
            lambda tree: rotating_ms(
                lambda *a: run(fns[tree]["qkv"], *qkv_args(*a)), sets),
            turns, result, dev_name)
        del sets, x, o, want

    # K4, each call on its own q, k, v and o
    for bh, length, hd, dtype in (
            (4 * VIEWS * 4, 50, 16, torch.float32),
            (CLIP_BATCH * VIEWS * 12, 197, 64, torch.bfloat16),
            (CLIP_BATCH * VIEWS * 16, 257, 80, torch.bfloat16),
            (64, 1025, 80, torch.bfloat16),
            (16, 600, 320, torch.bfloat16),
            (16, 600, 320, torch.float32)):
        code = 0 if dtype == torch.float32 else 1
        size = 2 if dtype == torch.bfloat16 else 4
        sets = [tuple(torch.randn((bh, length, hd), generator=gen,
                                  device="cuda").to(dtype) for _ in range(4))
                for _ in range(copies_for(4 * bh * length * hd * size))]

        def attn(tree, *tensors):
            run(fns[tree]["attn"], *attn_args(tensors, code, bh, length, hd))

        q, k, v, o = sets[0]
        want = ATT.attention_plain(q, k, v).float()
        takes = {}
        for tree in trees:
            o.zero_()
            takes[tree] = fns[tree]["attn"](
                *attn_args(sets[0], code, bh, length, hd), stream) == 0
            if takes[tree]:
                torch.testing.assert_close(o.float(), want, rtol=0.0,
                                           atol=attn_atol(dtype, v))
        require(takes["this"], f"attention_fwd refused hd {hd}")
        timed_where_taken(
            f"attention_fwd ({bh}, {length}, {hd}) {str(dtype)[6:]}", takes,
            lambda tree: rotating_ms(lambda *a: attn(tree, *a), sets),
            turns, result, dev_name)
        del sets, q, k, v, o, want


def pool_backward_ab(trees, split_rows, fns, turns, run):
    """K5a and K5b of both trees at the train shape."""
    # the pool backward at the train shape: B=16, N=8820, D=768 f32
    g, cells, w = pool_case("random", 16, torch.float32, seed=6, n=8820)
    b, n, d = g.shape
    cmax, denom, cot = bwd_inputs(g, cells, w, seed=1)
    dg = torch.empty_like(g)
    s_pt = torch.empty((b, n), device="cuda")
    big_s = torch.zeros((b, 256), device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiles = bwd_tiles(b, n, sms)
    partial = torch.empty((b * tiles, 256), device="cuda")
    done = torch.zeros((b,), dtype=torch.int32, device="cuda")

    def pass1(tree):
        head = (g.data_ptr(), 0, cells.data_ptr(), w.data_ptr(),
                cmax.data_ptr(), denom.data_ptr(), cot.data_ptr(),
                dg.data_ptr(), s_pt.data_ptr(), big_s.data_ptr())
        if split_rows[tree]:     # S written in full; the row counts zeroed
            done.zero_()
            run(fns[tree]["bwd1"], *head, partial.data_ptr(),
                done.data_ptr(), b, n, d, 196, tiles)
        else:                    # S zero-filled, atomics; a grid of blocks
            big_s.zero_()
            run(fns[tree]["bwd1"], *head, b, n, d, 196, sms * 32)

    def pass2(tree, cells, w, cmax, denom, big_s, s_pt, dw):
        run(fns[tree]["bwd2"], cells.data_ptr(), w.data_ptr(),
            cmax.data_ptr(), denom.data_ptr(), big_s.data_ptr(),
            s_pt.data_ptr(), dw.data_ptr(), b, n, 196)

    pass1("this")
    sets2 = [tuple(t.clone() for t in (cells, w, cmax, denom, big_s, s_pt))
             + (torch.empty((b, n), device="cuda"),)
             for _ in range(copies_for(b * n * 16))]
    dws = {}
    for tree in trees:
        pass2(tree, *sets2[0])
        dws[tree] = sets2[0][6].clone()
    torch.testing.assert_close(dws["this"], dws["other"], rtol=0,
                               atol=1e-5 * dws["other"].abs().max().item())
    label = f"B={b} N={n} D={d} f32"
    turns(f"grid_pool_bwd1 {label}",
          lambda tree: cuda_ms(lambda: pass1(tree), iters=10, warmup=2))
    turns(f"grid_pool_bwd2 {label}",
          lambda tree: rotating_ms(lambda *a: pass2(tree, *a), sets2,
                                   iters=len(sets2)))
    turns(f"grid_pool_bwd2 {label}, from L2",
          lambda tree: cuda_ms(lambda: pass2(tree, *sets2[0]), iters=30))
    turns(f"both passes {label}",
          lambda tree: cuda_ms(lambda: (pass1(tree), pass2(tree, *sets2[0])),
                               iters=10, warmup=2))


def checksums(tree):
    """Order-free checksums of the bits of every CUDA tensor in `tree`: the
    sum of its 32-bit words (bytes where a word does not fit)."""
    from torch.utils._pytree import tree_leaves

    out = []
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor) and t.is_cuda and t.numel():
            t = t.detach().contiguous()
            if t.element_size() == 4:
                t = t.view(torch.int32)
            elif t.dtype != torch.int64:
                t = t.view(torch.uint8)
            out.append(int(t.sum(dtype=torch.int64).item()))
    return tuple(out)


def changing_ops(dev_name: str, runs: int = 3) -> dict:
    """Which operators of one train loss and its backward (r2r width, 8
    trajectories x 15 steps, chip_smoke's GRAD_SEED weights, dropout off)
    give other bits from run to run: the loss runs `runs` times under a
    dispatch mode that checksums every operator's inputs and outputs, and an
    operator counts where run 1 and a later run fed it the same inputs and
    got other outputs (allocations, whose contents are undefined, aside).
    Returns {operator: {"calls": n, "shapes": input shapes}}."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from chip_smoke import GRAD_SEED, loss_and_grads

    class Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.log = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            before = checksums((args, kwargs))
            out = func(*args, **kwargs)
            shapes = [tuple(t.shape) for t in tree_leaves(args)
                      if isinstance(t, torch.Tensor)]
            self.log.append((str(func), before, checksums(out), shapes))
            return out

    cfg = r2r_config()
    model = init_navigator(cfg.model, seed=GRAD_SEED, device="cuda")
    model.eval()
    batch = synthetic_trajectory_batch(cfg, 8, TRAIN_STEPS, seed=0,
                                       device="cuda")
    logs = []
    for _ in range(runs):
        with Recorder() as rec:
            loss_and_grads(model, cfg, batch)
        logs.append(rec.log)
    found = {}
    for other in logs[1:]:
        for (name, before, after, shapes), (name2, before2, after2, _) in zip(
                logs[0], other):
            require(name == name2, "the runs dispatched other operators")
            if ("empty" in name or before != before2 or after == after2):
                continue
            entry = found.setdefault(name, {"calls": 0, "shapes": shapes})
            entry["calls"] += 1
    print(f"  operators of a train loss and its backward whose outputs change "
          f"from run to run on the same inputs ({runs} runs, "
          f"{len(logs[0])} operator calls a run): {found} [{dev_name}]")
    return found


def k1_launch_shapes(dev_name: str, paths: dict) -> dict:
    """K1 over launch shapes (row_split x group, a block's share in one
    chunk) on each main path's own inputs (a run of the path: every launch
    in turn) and on the synthetic buffers at the serving shape;
    `fwd_launch_shape`'s choice marked. Returns {case: {"rs/group": ms}}."""
    out = {}
    for label, caps in {**paths, **synthetic_pool_inputs()}.items():
        outs = k1_outputs(caps)
        g0, _, _, nc0 = caps[0]
        chosen = fwd_launch_shape(g0.shape[0], g0.shape[1], nc0)
        row = {}
        for rs in (1, 2, 3, 4, 6, 8):
            for group in (1, 2, 4):
                def run(rs=rs, group=group):
                    for g, cells, w, nc in caps:
                        n = g.shape[1]
                        share = -(-n // 32 // rs) * 32 if rs > 1 else n
                        k1_launch(GRID_POOL_FWD._function(), g, cells, w,
                                  nc, outs, (group, rs,
                                             min(MAX_CHUNK, share)))
                mark = "*" if (group, rs) == chosen[:2] else ""
                row[f"{rs}/{group}{mark}"] = cuda_ms(
                    run, iters=max(3, 25 // len(caps)), warmup=1)
        out[label] = row
        best = min(row, key=row.get)
        print(f"  K1 {label}, {len(caps)} launches at {tuple(g0.shape)} "
              f"{str(g0.dtype)[6:]}, ms by row_split/group (* the wrapper's "
              f"choice {chosen}; fastest {best}): "
              + ", ".join(f"{k} {v:.4f}" for k, v in row.items())
              + f" [{dev_name}]")
    return out


# builds of K1 that differ from this tree's in one place each: the
# register cap of a lone block (the blocks an SM must hold: 3 or 2 where
# this tree takes 3 only where the shared memory lets an SM hold three) and
# of a cluster's (2 where this tree takes 3), and the cluster path taking
# unsplit rows too (a cluster of one block: one finishing path)
_LONE_CAP = ("  if (kSmemPerSm / (fwd_smem<T, kVec>(d, group, chunk) + kStaticSmem "
             "+\n                    kSmemPerBlock) >= 3) {")
_SPLIT_ONLY = ("  if (rsplit > 1) {\n    return launch_kernel<T, kVec, true, "
               "kClusterMinBlocks>(")
K1_VARIANTS = {
    "as built": (),
    "lone block min blocks 3": ((_LONE_CAP, "  if (true) {"),),
    "lone block min blocks 2": ((_LONE_CAP, "  if (false) {"),),
    "cluster min blocks 2": ((
        "constexpr int kClusterMinBlocks = 3;",
        "constexpr int kClusterMinBlocks = 2;"),),
    "cluster of 1 for unsplit rows": ((
        _SPLIT_ONLY, _SPLIT_ONLY.replace("rsplit > 1", "rsplit >= 1")),),
}


def k1_variants(dev_name: str, paths: dict) -> dict:
    """Each build of K1_VARIANTS (its source written under the git-ignored
    build directory) on each main path's own inputs, at the wrapper's
    launch shape and unsplit with 1, 2 and 4 cells a block, builds in
    turns. Returns {case: {shape: {variant: ms}}}."""
    from concurrent.futures import ThreadPoolExecutor

    text = (build.SRC_DIR / f"{SOURCE}.cu").read_text()
    dirs = {}
    for i, (name, edits) in enumerate(K1_VARIANTS.items()):
        src = text
        for old, new in edits:
            require(old in src, f"variant {name}: {old!r} not in the source")
            src = src.replace(old, new)
        dirs[name] = build.BUILD_DIR / "variants" / f"v{i}"
        dirs[name].mkdir(parents=True, exist_ok=True)
        (dirs[name] / f"{SOURCE}.cu").write_text(src)
    with ThreadPoolExecutor(len(dirs)) as pool:
        list(pool.map(lambda d: build.build_all([SOURCE], d), dirs.values()))
    fns = {name: build.function(SOURCE, GRID_POOL_FWD.symbol,
                                GRID_POOL_FWD.argtypes, d)
           for name, d in dirs.items()}
    out = {}
    for label, caps in paths.items():
        outs = k1_outputs(caps)
        g0, _, _, nc0 = caps[0]
        b, n, _ = g0.shape
        shapes = {"wrapper's": fwd_launch_shape(b, n, nc0)}
        for group in (1, 2, 4):
            shapes[f"1/{group}"] = (group, 1, min(MAX_CHUNK, n))
        out[label] = {}
        for sname, shape in shapes.items():
            def run(fn, shape=shape):
                for g, cells, w, nc in caps:
                    k1_launch(fn, g, cells, w, nc, outs, shape)

            got = {}
            for name, fn in fns.items():
                run(fn)
                got[name] = next(iter(outs.values()))[0].clone()
            for name in fns:
                torch.testing.assert_close(got[name], got["as built"],
                                           rtol=1e-5, atol=1e-6)
            ms = {name: [] for name in fns}
            for order in (list(fns), list(fns)[::-1]):
                for name in order:
                    ms[name].append(cuda_ms(lambda: run(fns[name]),
                                            iters=max(3, 25 // len(caps)),
                                            warmup=1))
            out[label][f"{sname} {shape}"] = ms
            print(f"  K1 {label}, {len(caps)} launches, shape {sname} "
                  f"{shape}, ms by build (two turns): "
                  + ", ".join(f"{k} {v[0]:.4f}/{v[1]:.4f}"
                              for k, v in ms.items()) + f" [{dev_name}]")
    return out


# Builds of K2 and K4 that differ in one place each: {kernel: (source,
# {variant: ((file, old text, new text), ...)})}. The tables the rings,
# blocks and bodies were chosen from.
ATTENTION_BUILDS = {
    "k2": ("attention_qkv_fwd", {
        "as built": (),
        "three slots": (("attention_qkv_mma.cuh",
                         "constexpr int kStages = 2;",
                         "constexpr int kStages = 3;"),),
        "four-warp blocks": (("attention_qkv_mma.cuh",
                              "constexpr int kMaxWarps = 8;",
                              "constexpr int kMaxWarps = 4;"),),
        "no register cap": (("attention_qkv_mma.cuh",
                             "__launch_bounds__(kMaxThreads, 2)",
                             "__launch_bounds__(kMaxThreads)"),),
    }),
    "k4": ("attention_fwd", {
        "as built": (),
        # bf16: every item's tiles stream, as those of a slice that
        # outgrows the ring do
        "streamed only": (
            ("attention_head_mma.cuh", "const bool resident = tiles <= slots;",
             "const bool resident = false;"),
            ("attention_fwd.cu",
             "const long long units = tiles <= hm::ring_slots(kHdP)",
             "const long long units = false")),
    }),
}


def build_variants(kernel: str) -> dict:
    """Each build of ATTENTION_BUILDS[kernel] (the sources written under the
    git-ignored build directory, all compiled at once): {variant: its C
    function}."""
    from concurrent.futures import ThreadPoolExecutor

    source, variants = ATTENTION_BUILDS[kernel]
    dirs = {}
    for i, (name, edits) in enumerate(variants.items()):
        d = build.BUILD_DIR / "variants" / f"{kernel}_v{i}"
        d.mkdir(parents=True, exist_ok=True)
        texts = {src.name: src.read_text()
                 for src in [build.SRC_DIR / f"{source}.cu",
                             *build.SRC_DIR.glob("*.cuh")]}
        for file, old, new in edits:
            require(old in texts[file],
                    f"variant {name}: {old!r} not in {file}")
            texts[file] = texts[file].replace(old, new)
        for file, text in texts.items():
            (d / file).write_text(text)
        dirs[name] = d
    with ThreadPoolExecutor(len(dirs)) as pool:
        logs = dict(zip(dirs, pool.map(
            lambda d: build.build_all([source], d), dirs.values())))
    for name, log in logs.items():
        print(f"  {name}: {ptxas_summary(log.get(source, ''))}")
    launcher = ATTENTION_QKV_FWD if kernel == "k2" else ATTENTION_FWD
    return {name: build.function(source, launcher.symbol, launcher.argtypes,
                                 d)
            for name, d in dirs.items()}


def attention_variants(kernel: str, dev_name: str) -> dict:
    """Each build of ATTENTION_BUILDS[kernel], each build's output held to
    the plain version once, builds timed in turns (forward, then backward).
    K2 at its main paths' shapes ((192, 50), (48, 197), (192, 197)) and at
    L = 1025 and 2048, bf16; K4 at its main paths' (the tiny tower's (192,
    50, 16) f32 and the tiny CE agent's (96, 50, 16) f32, ViT-H/14's (3072,
    257, 80) bf16), at (2304, 197, 64) bf16, at the tiny tower's shape in
    bf16 and at (64, 1025, 80) bf16. Returns {shape: {variant: [ms, ms]}}."""
    fns = build_variants(kernel)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(8)
    cases = []
    if kernel == "k2":
        for b, length in ((CLIP_BATCH * VIEWS, 50), (48, 197),
                          (CLIP_BATCH * VIEWS, 197), (4, 1025), (2, 2048)):
            sets = [(torch.randn((b, length, 2304), generator=gen,
                                 device="cuda").to(torch.bfloat16),
                     torch.empty((b, length, 768), device="cuda",
                                 dtype=torch.bfloat16))
                    for _ in range(copies_for(b * length * 3072 * 2))]

            def args(x, o, b=b, length=length):
                return (x.data_ptr(), 1, o.data_ptr(), b, length, 12, 0.125)

            x, o = sets[0]
            cases.append((f"attention_qkv_fwd ({b}, {length}, 2304) bf16",
                          sets, args, o, ATT.attention_qkv_plain(x, 12),
                          attn_atol(x.dtype, x[..., 1536:])))
    else:
        for bh, length, hd, dtype in (
                (4 * VIEWS * 4, 50, 16, torch.float32),
                (2 * VIEWS * 4, 50, 16, torch.float32),
                (CLIP_BATCH * VIEWS * 16, 257, 80, torch.bfloat16),
                (CLIP_BATCH * VIEWS * 12, 197, 64, torch.bfloat16),
                (4 * VIEWS * 4, 50, 16, torch.bfloat16),
                (64, 1025, 80, torch.bfloat16)):
            code = 0 if dtype == torch.float32 else 1
            size = 2 if dtype == torch.bfloat16 else 4
            sets = [tuple(torch.randn((bh, length, hd), generator=gen,
                                      device="cuda").to(dtype)
                          for _ in range(4))
                    for _ in range(copies_for(4 * bh * length * hd * size))]

            def args(*t, code=code, bh=bh, length=length, hd=hd):
                return attn_args(t, code, bh, length, hd)

            q, k, v, o = sets[0]
            cases.append((f"attention_fwd ({bh}, {length}, {hd}) "
                          f"{str(dtype)[6:]}", sets, args, o,
                          ATT.attention_plain(q, k, v), attn_atol(dtype, v)))
    out = {}
    for case, sets, args, o, want, atol in cases:
        def call(fn, *a, args=args):
            err = fn(*args(*a), stream)
            require(err == 0, f"{case}: launch failed: cudaError {err}")

        for name, fn in fns.items():
            o.zero_()
            call(fn, *sets[0])
            torch.testing.assert_close(o.float(), want.float(), rtol=0.0,
                                       atol=atol)
        got = {name: [] for name in fns}
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                got[name].append(rotating_ms(
                    lambda *a, fn=fns[name]: call(fn, *a), sets))
        out[case] = got
        print(f"  {case}: " + ", ".join(f"{n} {v[0]:.5f} / {v[1]:.5f}"
                                        for n, v in got.items())
              + f" ms [{dev_name}]")
    return out


def ce_profile(out):
    """One fused CE step (4 envs, full width, view tower) and one CE update
    (4 envs x 20 steps, dropout off), each traced after a warm-up."""
    cfg, agent = build_ce_agent(tiny=False, view_tower=True, seed=CE_SEED,
                                device="cuda")
    env = ce_env(5)
    dev = agent.device
    with agent.inference():
        obs = env.reset()
        b, cap = env.num_envs, cfg.model.max_action_steps
        ids, mask = agent.language_batch(obs)
        mask = torch.from_numpy(mask).to(dev)
        txt = agent.language(torch.from_numpy(ids).to(dev), mask)
        rgb, depth = agent.observation_tensors(obs)
        pos = torch.from_numpy(np.stack([ob.position for ob in obs]).astype(
            np.float32)).to(dev)
        heading = torch.tensor([ob.heading for ob in obs],
                               dtype=torch.float32, device=dev)
        traj_pos = torch.zeros((b, cap, 3), device=dev)
        traj_pos[:, 0, 0], traj_pos[:, 0, 2] = pos[:, 0], pos[:, 1]
        traj_dist = torch.zeros((b, cap), device=dev)
        traj_len = torch.ones((b,), dtype=torch.int32, device=dev)
        t = torch.zeros((), dtype=torch.int64, device=dev)
        ended = torch.zeros((b,), dtype=torch.bool, device=dev)

        def step():
            carry = init_carry(cfg, b, device=dev)
            _, logits, cand = agent.full_step(
                txt, mask, carry, rgb, depth, pos, heading, traj_pos,
                traj_dist, traj_len, t, ended)
            return logits.cpu(), cand.ang_bins.cpu()

        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    summarize(prof, wall, 1, f"fused CE step x1 ({b} envs, r2r_ce width, "
              f"ResNet50/ddppo f32, clip_b32 + ViT-B/16 bf16)", out, top=20,
              watch=("grid_pool_fwd", "attention_qkv", "layernorm"))
    trainer = CETrainer(cfg, agent)
    with agent.inference():
        raw = trainer.record_batch(ce_env(6), CE_STEPS,
                                   np.random.default_rng(0),
                                   trainer.ss_ratio(0))
    batch = batch_to_device(raw, "cuda")
    batch = batch._replace(steps=batch.steps._replace(
        patch_fts=batch.steps.patch_fts.clone()))
    trainer.update(batch, seed=0, dropout=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.update(batch, seed=0, dropout=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summarize(prof, wall, 1, f"CE update x1 ({b} envs x {CE_STEPS} steps, "
              f"r2r_ce_config() f32, remat_steps="
              f"{cfg.train.remat_steps})", out, top=20,
              watch=("grid_pool_fwd", "grid_pool_bwd"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--k1-shapes", action="store_true",
                    help="only time K1 over its launch shapes and builds "
                         "on the main paths' inputs")
    ap.add_argument("--k2-builds", action="store_true",
                    help="only time builds of K2 that differ in one place")
    ap.add_argument("--k4-builds", action="store_true",
                    help="only time builds of K4 that differ in one place")
    ap.add_argument("--changing-ops", action="store_true",
                    help="only name the operators of a train loss whose "
                         "outputs change from run to run")
    ap.add_argument("--ab", type=Path, default=None, metavar="OTHER_TREE",
                    help="only time K1, K2, K3, K4, K5a and K5b against "
                         "OTHER_TREE's sources")
    ap.add_argument("--only", nargs="+", choices=AB_KERNELS,
                    default=list(AB_KERNELS),
                    help="with --ab: the kernels to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev_name = card()
    print(f"card: {dev_name}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    if args.k2_builds or args.k4_builds:
        for kernel in ("k2", "k4"):
            if getattr(args, f"{kernel}_builds"):
                found = attention_variants(kernel, dev_name)
                (out_dir / f"chip_profile_{kernel}_builds.json").write_text(
                    json.dumps({"card": dev_name, "ms": found}, indent=1))
        return 0
    if args.changing_ops:
        found = changing_ops(dev_name)
        (out_dir / "chip_profile_changing_ops.json").write_text(json.dumps(
            {"card": dev_name, "operators": found}, indent=1))
        return 0
    if args.k1_shapes or args.ab is not None:
        paths = (main_path_pool_inputs(dev_name)
                 if args.k1_shapes or "pool" in args.only else {})
        if args.k1_shapes:
            found = {"shapes": k1_launch_shapes(dev_name, paths),
                     "builds": k1_variants(dev_name, paths)}
            (out_dir / "chip_profile_k1_shapes.json").write_text(json.dumps(
                {"card": dev_name, "ms": found}, indent=1))
        if args.ab is not None:
            result = ab_kernels(args.ab.resolve(), dev_name, paths,
                                args.only)
            (out_dir / "chip_profile_ab.json").write_text(json.dumps(
                {"card": dev_name, "other": str(args.ab), "ms": result},
                indent=1))
        return 0
    cfg = r2r_config()
    model = init_navigator(cfg.model, seed=0, device="cuda")
    out = [f"card: {dev_name}"]
    for label, graphed in (("eager", False), ("CUDA-graphed", True)):
        eng = NavServingEngine.create(model, cfg, SERVE_SLOTS,
                                      cuda_graph=graphed)
        rng = np.random.default_rng(0)
        for r in range(SERVE_SLOTS):
            eng.submit(r, *request_text(cfg, rng))
        eng.admit()
        for t in range(15):
            eng.step({s: step_row(cfg, rng, t) for s in range(SERVE_SLOTS)})
        rows = {s: step_row(cfg, rng, 15) for s in range(SERVE_SLOTS)}
        torch.cuda.synchronize()

        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            eng.step(rows)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        line = (f"serving step ({label}), {SERVE_SLOTS} slots, full buffer: "
                f"median {np.median(times):.3f} ms over 10 steps "
                f"[{dev_name}]")
        print(line)
        out.append(line)

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                eng.step(rows)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        summarize(prof, wall, args.steps,
                  f"serving step ({label}) x{args.steps}", out,
                  watch=("grid_pool_fwd",))

    kernel_diff(model, cfg, dev_name, out)

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
    summarize(prof, wall, 3, "encode x3 (clip_b32 bf16, 192 views)", out,
              watch=("layernorm",))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            state = iteration(state, *steps[-1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summarize(prof, wall, 3, f"encode_and_pool x3 ({PIPE_PANOS} panoramas, "
              "full bf16 buffer)", out, watch=("layernorm",))
    del ex, images, steps, heads, state

    model = init_navigator(cfg.model, seed=1, device="cuda")
    model.eval()               # dropout off, as in chip_smoke.py's updates
    train_state = create_train_state(cfg, model)
    train_step = make_train_step(cfg)
    b, s = cfg.train.batch_size, cfg.train.max_action_len
    batch = synthetic_trajectory_batch(cfg, b, s, seed=0, device="cuda")
    train_step(train_state, batch, seed=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(train_state, batch, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summarize(prof, wall, 1,
              f"train update x1 ({b} trajectories x {s} steps, "
              f"r2r_config() f32, remat_steps={cfg.train.remat_steps})", out,
              top=25)
    del model, train_state, batch

    # one pretraining update of each task at r2r width on the 12,416-point
    # buffer (8 trajectories x 21 steps), as chip_smoke.py times them
    pcfg = pretrain_cli._resolve_config(
        pretrain_cli.parse_args(["--preset", "r2r"]))
    model = init_pretrain_params(pcfg.model, seed=1, device="cuda")
    model.eval()
    state = create_train_state(pcfg, model)
    batch = synthetic_pretrain_batch(pcfg, 8, 21, seed=0, device="cuda")
    for task in ("mlm", "mrc", "sap"):
        step = make_pretrain_step(pcfg, task)
        step(state, batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        summarize(prof, wall, 1, f"pretrain update x1, {task} (8 x 21, "
                  f"{pcfg.shapes.max_points}-point buffer, r2r width, f32)",
                  out, top=20)
    del model, state, batch
    ce_profile(out)
    (out_dir / "chip_profile.txt").write_text("\n".join(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Integration check of the PyTorch/CUDA port (gridmm_tpu_torch) on one card.

    python3 chip_smoke.py

Needs one NVIDIA Hopper card and the CUDA toolkit; imports nothing of JAX.
It drives the port's paths end to end on the card and holds them to their
plain versions, to the CPU and to each other. Each kernel against its plain
version is tests/test_torch_cuda.py's job, speed is benchmark/run.py's,
and profiles and kernel A/B timings are chip_profile.py's. Phases, in
order (any failure raises and the exit code is not 0):

  (a) device: require CUDA, print the card's name and power limit, TF32 off;
  (b) build every kernel of the main paths from csrc/ (one nvcc per source,
      all at once);
  (d) the main paths, each driven with every launch count set to 0 just
      before it and read just after:
      - the serving engine at full R2R width (r2r_config(), seeded random
        weights; its step captured in a CUDA graph) answers 6 requests over
        4 slots; logits are checked and the same steps rerun with the plain
        ops must agree; then a tiny-width step on the card must agree with
        the same step on the CPU. K1's launches on a graphed path count the
        warm-up step's call and one per replay (path_launches; the call
        made during capture only records the launch), which torch.profiler
        checks once over two replays;
      - ClipFeatureExtractor.run at clip_b32() width over 32 synthetic
        panoramas (batch 16), bf16, rerun with the plain ops; the same in
        f32 over 4 panoramas;
      - encode_and_pool, 16 panoramas x 12 views, iterated until the point
        buffer fills (15 x 588 of 8832 points), bf16 buffer, rerun with the
        plain ops; the same in f32 for 3 iterations;
      - the --tiny preprocess tower (head_dim 16: the per-head kernel) on the
        card against the same tower on the CPU;
      - a tower at ViT-H/14's widths (1280 wide, 16 heads: head_dim 80, 257
        tokens; depth cut to 2 layers) through the extractor over 2
        panoramas: f32 card against CPU, bf16 kernels against plain ops;
      - training at full R2R width: train_navigator over the synthetic
        world (one teacher and one sample iteration, with evaluation), then
        on freshly seeded weights three make_train_step updates on one
        synthetic batch of cfg.train.batch_size trajectories x 15 steps; the
        loss must fall, the backward kernels must launch once per step and
        update, the same loss and gradients through the plain ops (run
        reproducibly) must agree, and a tiny update on the card must agree
        with the same on the CPU;
      - real data: a one-scan R2R world written to disk at the real feature
        widths as gmmstore files, then `main_nav --world r2r
        --feature_backend gmmstore --iters 2 --batch_size 4 --eval` at
        r2r_config() width; GmmStoreWorld must serve (native and Python
        readers byte-equal on every key where the native library builds),
        K1, K5a and K5b must launch, the metrics must be finite;
      - the serving bundle: language and nav_step exported with torch.export
        at r2r_config() width and 4 slots (from seed-0 weights), saved,
        loaded and served through NavServingEngine.from_bundle with seed-11
        weights over the same 6 requests x 18 steps; logits against a
        create engine on those weights (equal bits expected; 1e-5 x
        max|logit| at most), the graphed create engine against an eager
        one the same way; last of all (after phase f), a step that waits on
        the host must make the capture raise, and dropout on the card must
        still draw after it;
      - pretraining at r2r width: cli/pretrain.main --preset r2r --device
        cuda (the 12,416-point buffer; synthetic batches of 8 trajectories
        x 21 steps fill 12,348 points a row), 3 updates of the tasks
        mlm, mrc, sap and a validation, then one --accum_steps 2 window;
        K1 once per update and validated task, K5a and K5b once per
        update (per microbatch in the window); then 3 updates of each
        task on one fixed batch (the loss must fall, K1/K5a/K5b once an
        update), the first update's loss and gradients through the plain
        ops under the reproducible reference (GRAD_SEED weights), and a
        tiny update of each of the four tasks (OG with object tokens) card
        vs CPU;
      - released-checkpoint import at r2r width: a reference-layout
        navigator state dict synthesized from seed 11 and nested as
        grid_map.pt is ('module.vln_bert.' keys), imported with
        import_torch_navigator and served by the graphed create engine
        against one loaded with the same weights directly (no transpose:
        a reference Linear weight is the port's layout); export_serving
        --navigator_ckpt on that file, served through from_bundle with the
        shipped navigator.pt; a pretrain-layout dict through
        remap_pretrain_to_navigator served the same way (1e-5 x
        max|logit|);
      - VLN-CE at r2r_ce_config() width: `run_ce --full --view_tower` over
        the synthetic arena (224 px RGB, 256 px depth; 4 envs x 20 steps,
        2 schedule-sampled train batches with their updates, one greedy
        eval batch): finite losses and metrics, K1, K2, K3, K5a and K5b
        launched; then, on freshly seeded weights, a greedy rollout
        through the fused device step and one through the host path must
        act identically (and step 0's device assembly match the host's),
        the same rollout with f32 towers and the plain ops under the
        reproducible reference within LOGIT_TOL (or the step where the
        actions part, with its logit gap), the bf16 towers' first step
        within BF16_REL_TOL; one recorded batch's loss and gradients
        against the plain ops on CE_GRAD_SEED weights and three updates
        with a falling loss; the tiny CE agent (head_dim 16: K4) card vs
        CPU, one rollout and one update;
      - int8 serving at r2r_config() width (PR 10): a graphed create engine
        with int8_matmuls serves the same 6 requests x 18 steps on the
        f32 engine's weights; finite patterns equal to the f32 engine's,
        cosine > 0.99 and max|diff| / spread < 0.2 at every step (the JAX
        test's gates); the int8 GEMM on identical operands at the step's
        shapes card vs CPU (equal int32 sums); an int8 first step at tiny
        width card vs CPU within 2e-3 of the spread (the CPU parity test's
        tolerance at that width), at r2r width within 5e-2 beside its
        witness (the CPU's own int8 step with the image features one ulp
        off);
        `export_serving --int8` served by from_bundle against it (1e-5 x
        max|logit|); K1 once per step as in f32;
      - the int8 clip_b32 tower over 192 views: bf16 tokens, per-token
        cosine > 0.98 against the bf16 tower on the same weights, K2 12
        and K3 26 launches;
      - the parallel layer (PR 10), a mesh of one rank over NCCL in this
        process: train_navigator(mesh=...) at r2r width for 2 iterations,
        `pretrain --mesh auto --preset r2r` for one update and `run_ce
        --mesh auto --full` for one batch, each against the same run
        without a mesh on the same seed within 1e-6 relative
        (train_navigator: its losses, the first update's gradients and
        every leaf's weights after; a mesh of one rank runs no gradient
        collective; the loss's global counts and the
        stray-key max are NCCL all-reduces over the group of one); then two
        ranks on the one card over gloo (spawned; NCCL refuses two ranks on
        one device): one make_train_step update at r2r width, 16
        trajectories split 8 + 8 with uneven action counts and the clip
        active, against one process on all 16: the same loss, every leaf
        within 1e-5 of its max, K1, K5a and K5b launched on each rank;
  (f) the entry points, each through its module function at full width
      with the launch counts set to 0 before it and read after it:
      cli/bench.run (its JSON line; K1 once, K2 12 and K3 26 times an
      iteration), cli/bench_latency.run (eager and CUDA-graphed steps at
      batch 1 and 4), cli/bench_pool_bwd.run (the gradients within the card
      tests' K5 tolerances), cli/bench_train_update.run_one (batch 16 f32,
      a warm-up and 3 updates: K5a and K5b once a step, K1 twice),
      cli/bench_ce_step.run (4 envs with the view tower, fused and
      --legacy), cli/drive_episode.run (EPISODE OK), cli/
      run_synthetic_eval.run (finite metrics) and entry.entry() (its
      torch.export program against eager fn); then a backward through
      each of K2, K3 and K4's custom ops must raise, the clip_b32 and
      --tiny towers go through torch.export with the eager bits, and
      `export_serving --int8 --mesh auto` over a world of one (NCCL)
      serves the bits of phase d's unsharded --int8 bundle (r2r width);
  (h) the result line, last.

`python3 chip_smoke.py --ce-only` runs (a), (b) and the VLN-CE phases
alone and prints no result line; `--entry-only` runs (a), (b) and (f).

The checks' readings and each phase's seconds go to
chiprun_out/chip_smoke_report.json (chip_smoke_ce_report.json,
chip_smoke_entry_report.json).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from gridmm_tpu_torch import pipeline as pipe_mod
from gridmm_tpu_torch.config import r2r_config, tiny_config
from gridmm_tpu_torch.data.preprocess import (ClipFeatureExtractor,
                                              synthetic_renderer)
from gridmm_tpu_torch.models import clip_vit as clip_mod
from gridmm_tpu_torch.models import navigator as nav_mod
from gridmm_tpu_torch.models.clip_vit import (ClipVisionConfig, clip_b32,
                                              init_clip_vision)
from gridmm_tpu_torch.models.navigator import init_navigator
from gridmm_tpu_torch.ops import attention as ATT
from gridmm_tpu_torch.ops import geometry as G
from gridmm_tpu_torch.ops import grid_pool as GP
from gridmm_tpu_torch.ops import layernorm as LN
from gridmm_tpu_torch.ops.cuda import build
from gridmm_tpu_torch.ops.cuda.attention import (ATTENTION_FWD,
                                                 ATTENTION_QKV_FWD)
from gridmm_tpu_torch.ops.cuda.grid_pool import (GRID_POOL_BWD1,
                                                 GRID_POOL_BWD2,
                                                 GRID_POOL_FWD)
from gridmm_tpu_torch.ops.cuda.layernorm import LAYERNORM_FWD
from gridmm_tpu_torch.pipeline import encode_and_pool
from gridmm_tpu_torch.serve.engine import NavServingEngine
from gridmm_tpu_torch.env.discrete import DiscreteNavEnv, synthetic_episodes
from gridmm_tpu_torch.env.world import SyntheticWorld
from gridmm_tpu_torch.train.agent import NavAgent
from gridmm_tpu_torch.train.loop import train_navigator
from gridmm_tpu_torch.ce.agent import step_to_device
from gridmm_tpu_torch.train.step import (NavCarry, StepInputs,
                                         batch_to_device,
                                         create_train_state,
                                         init_carry, make_train_step,
                                         nav_device_step, trajectory_loss)
from gridmm_tpu_torch.train.synthetic import (synthetic_pretrain_batch,
                                              synthetic_trajectory_batch)
from gridmm_tpu_torch.ce import device_step as ce_device_step
from gridmm_tpu_torch.ce.env import SyntheticContinuousEnv
from gridmm_tpu_torch.ce.factory import build_ce_agent
from gridmm_tpu_torch.ce.trainer import CETrainer
from gridmm_tpu_torch.cli import export_serving as export_cli_mod
from gridmm_tpu_torch.cli import run_ce as run_ce_mod
from gridmm_tpu_torch.cli import parity_eval as parity_eval_mod
from gridmm_tpu_torch.cli import pretrain as pretrain_cli_mod
from gridmm_tpu_torch.convert import torch_name
from gridmm_tpu_torch.models.pretrain import GridMMPretrain
from gridmm_tpu_torch.train.pretrain import (PretrainBatch,
                                             init_pretrain_params,
                                             make_pretrain_step, task_loss)
from gridmm_tpu_torch.utils import checkpoint as CK

ROOT = Path(__file__).resolve().parent
KERNELS = [GRID_POOL_FWD, ATTENTION_QKV_FWD, LAYERNORM_FWD, ATTENTION_FWD,
           GRID_POOL_BWD1, GRID_POOL_BWD2]
SOURCES = ["grid_pool_fwd", "layernorm_fwd", "attention_qkv_fwd",
           "attention_fwd", "grid_pool_bwd"]
CLIP_PANOS, CLIP_BATCH = 32, 16         # extractor run
PIPE_PANOS, VIEWS, PIPE_TXT = 16, 12, 48  # pipeline run (bench.py's sizes)
# bf16 tower or pipeline, kernels vs plain ops: the plain attention rounds
# its probabilities to bf16 before PV where the kernel keeps them in f32
# (2^-8 relative per value), and 12 residual blocks with random weights
# carry such differences to the output; a relative Frobenius error
# ||a - b|| / ||b|| of 2^-5 is the bound.
BF16_REL_TOL = 2.0 ** -5
# f32 tower or pipeline, kernels vs plain ops (TF32 off): summation order
# and the online softmax only
F32_TOL = 1e-4
# f32 tower, card vs CPU (TF32 off), as the CPU parity tests hold towers
TOWER_F32_TOL = 2e-4
VIT_H_LAYERS = 2               # ViT-H/14 widths, depth cut from 32
SERVE_SLOTS, FIRST_STEPS, LATER_STEPS = 4, 15, 3
# fused logits, kernel pool vs plain pool through the full-width navigator
# in f32 (TF32 off): the pools differ only in summation order (~1e-6
# relative), which 13 transformer layers may amplify to ~1e-5
LOGIT_TOL = 1e-4
# the same kernels in the same order (CUDA graph vs eager, exported program
# vs live module): equal bits are expected; any difference must stay below
# 1e-5 of the largest logit
LOGIT_BITS_TOL = 1e-5
INT8_BUNDLE = ROOT / "runs" / "chip_smoke" / "int8_bundle"
BUNDLE_SEED = 11               # weights the bundle serves (exported: seed 0)
TRAIN_STEPS = 15               # cfg.train.max_action_len: 15 x 588 = 8820
LOOP_BATCH, LOOP_ITERS = 4, 2  # train_navigator: one teacher, one sample
UPDATES = 3                    # make_train_step on one synthetic batch
# Seed of the weights on which the kernels' loss and gradients are held
# against the plain ops'. The two paths' pooled cells differ in their last
# bits (~2e-6 of a gradient leaf's max where nothing else happens). A ReLU
# unit of the navigator's heads whose input lies between the two paths'
# values is on in one and off in the other, which moves that unit's row of
# the gradient by up to 1e-2 of the leaf's max and the leaves upstream by
# ~1e-3: a property of the model's kinks, not of a kernel. Both paths give
# the same bits on every run (reproducible_reference), so for given weights
# the comparison is one number; with this seed no unit switches.
GRAD_SEED = 4
# pretraining at r2r width: 8 trajectories x 21 steps fill 21 x 588 =
# 12,348 points of the 12,416-point buffer (cli/pretrain._resolve_config)
PRETRAIN_B, PRETRAIN_S, PRETRAIN_N = 8, 21, 12416
PRETRAIN_TASKS = ("mlm", "mrc", "sap")
PRETRAIN_UPDATES = 3
IMPORT_SEED = 11               # the reference-layout state dicts' draws
# VLN-CE at r2r_ce_config() width: run_ce --num_envs 4 --max_steps 20 (the
# reference's IL.max_traj_len) fills 20 x 588 of the 11,776-point buffer
CE_ENVS, CE_STEPS, CE_BATCHES, CE_N = 4, 20, 2, 11776
CE_SEED = 3                    # the fresh weights of the rollout checks
# the weights of the CE loss and gradient check, chosen as GRAD_SEED was:
# with them no ReLU unit of the navigator switches between the kernels'
# and the plain ops' last bits
CE_GRAD_SEED = 4
CE_UPDATES = 3
CE_PATH_KERNELS = ("grid_pool_fwd", "attention_qkv_fwd", "layernorm_fwd",
                   "grid_pool_bwd1", "grid_pool_bwd2")


def require(cond, msg: str) -> None:
    """A check that stays under `python -O`."""
    if not cond:
        raise AssertionError(msg)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def path_launches(counted, engines):
    """Kernel launches of a path that ran CUDA-graphed serving engines. A
    wrapper counts each call of its kernel; the call made while a graph is
    captured only records the launch, which every replay then makes, so
    each engine adds (replays - 1) x the launches its capture recorded
    (NavServingEngine.graph_launches). torch.profiler checks this once
    (check_graph_launches)."""
    out = dict(counted)
    for eng in engines:
        for name, n in eng.graph_launches.items():
            out[name] += n * (eng.replays - 1)
    return out


def reset_counts():
    for k in KERNELS:
        k.launches = 0


def counts():
    return {k.name: k.launches for k in KERNELS}


@contextlib.contextmanager
def plain_ops():
    """Swap every dispatching op of the main paths for its plain version
    (the kernels' oracles), and check that no kernel launched meanwhile."""
    saved = (clip_mod.layernorm, clip_mod.attention_qkv, pipe_mod.grid_pool,
             nav_mod.grid_pool)
    clip_mod.layernorm = LN.layernorm_plain
    clip_mod.attention_qkv = ATT.attention_qkv_plain
    pipe_mod.grid_pool = GP.grid_scatter_pool
    nav_mod.grid_pool = GP.grid_scatter_pool
    before = counts()
    try:
        yield
    finally:
        (clip_mod.layernorm, clip_mod.attention_qkv, pipe_mod.grid_pool,
         nav_mod.grid_pool) = saved
    require(counts() == before, "a kernel launched on the plain path")


@contextlib.contextmanager
def reproducible_reference():
    """PyTorch's own scatter_add and index_add_ kernels, which the plain pool
    runs on the card, add with atomics in an order that changes from run to
    run. The last bits of the pooled cells change with it, and a ReLU unit
    of the navigator's heads whose input sits within those bits of zero
    then switches, which moves single gradient elements by up to 1e-2 of
    their leaf's max. Under PyTorch's deterministic algorithms the reference
    gives the same bits on every run, as the kernels do, so the comparison
    of the two is one number and not a draw."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def rel_err(a, b) -> float:
    """||a - b|| / ||b|| over float32 copies."""
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


# ------------------------------------------------------------------ inputs
def step_row(cfg, rng, t) -> StepInputs:
    """One synthetic StepInputs row (numpy, b=1) for step t of an episode:
    slot t+1 is the current node, slots 1..t+1 visited, three frontier
    slots after it (one per candidate view), one backtrack candidate;
    depth in MatterSim counts with ~10% zero (invalid) patches."""
    m, sh, gc = cfg.model, cfg.shapes, cfg.grid
    g, v, a, d = sh.max_gmap_len, sh.max_vp_len, m.angle_feat_size, \
        m.image_feat_size
    f32, i32 = np.float32, np.int32
    cur = min(t + 1, g - 4)
    n_front = 3
    gmap_mask = (np.arange(g) < cur + 1 + n_front)[None]
    visited = ((np.arange(g) >= 1) & (np.arange(g) <= cur))[None]
    cand = np.full((1, v - 1), -1, i32)
    cand[0, :n_front] = np.arange(cur + 1, cur + 1 + n_front)
    cand[0, n_front] = cur - 1 if cur > 1 else -1
    vp_nav = np.zeros((1, v), bool)
    vp_nav[0, :2 + n_front] = True
    fused_add = np.full((1, g), -2, i32)
    fused_add[0, cur + 1:cur + 1 + n_front] = np.arange(1, 1 + n_front)
    backtrack = np.zeros((1, v), bool)
    backtrack[0, 1 + n_front] = cur > 1
    depth = rng.uniform(2000, 20000, size=(1, gc.num_views,
                                           gc.patches_per_view)).astype(f32)
    depth[rng.random(depth.shape) < 0.1] = 0.0
    n_view = int(rng.integers(8, v))
    return StepInputs(
        view_img_fts=rng.standard_normal((1, v - 1, d)).astype(f32),
        loc_fts=rng.standard_normal((1, v - 1, a + 3)).astype(f32),
        nav_types=rng.integers(0, 3, size=(1, v - 1)).astype(i32),
        view_mask=(np.arange(v - 1) < n_view)[None],
        depth=depth,
        patch_fts=rng.standard_normal((1, gc.points_per_step, d)
                                      ).astype(f32),
        pos_xy=(rng.uniform(-1, 1, size=(1, 2)) + 0.5 * t).astype(f32),
        heading=rng.uniform(-np.pi, np.pi, size=(1,)).astype(f32),
        gmap_step_ids=np.minimum(np.arange(g), t + 1)[None].astype(i32),
        gmap_pos_fts=rng.standard_normal((1, g, a + 3)).astype(f32),
        gmap_mask=gmap_mask, gmap_visited_mask=visited,
        cur_node_idx=np.array([cur], i32), cand_gmap_idx=cand,
        vp_pos_fts=rng.standard_normal((1, v, 2 * a + 6)).astype(f32),
        vp_nav_mask=vp_nav, fused_add_idx=fused_add,
        cand_backtrack_mask=backtrack,
        target=np.zeros((1,), i32), grid_target=np.zeros((1,), i32),
        vp_obj_mask=np.zeros((1, v), bool), obj_target=np.zeros((1,), i32))


def request_text(cfg, rng):
    t = cfg.shapes.max_txt_len
    return (rng.integers(1000, cfg.model.vocab_size, size=t).astype(np.int32),
            np.arange(t) < int(rng.integers(20, t)))


# ----------------------------------------------------------------- phases
def run_engine(model, cfg, rows, texts, make=None, cuda_graph=True):
    """Drive a 4-slot engine through the request schedule, checking every
    step. The engine is `make()`, or a `create` engine over `model` (CUDA-
    graphed unless cuda_graph=False). Returns (per-step fused logits on the
    host, the engine)."""
    eng = make() if make is not None else NavServingEngine.create(
        model, cfg, SERVE_SLOTS, cuda_graph=cuda_graph)
    for r, (ids, mask) in enumerate(texts):
        eng.submit(r, ids, mask)
    eng.admit()
    done = {r: 0 for r in range(len(texts))}
    fused_all = []
    for phase_steps in (FIRST_STEPS, LATER_STEPS):
        for _ in range(phase_steps):
            active = eng.active()
            step_rows = {slot: rows[r][done[r]] for r, slot in active.items()}
            out = eng.step(step_rows)
            check_outputs(out, step_rows)
            fused_all.append(out.fused_logits.cpu())
            for r in active:
                done[r] += 1
        if phase_steps == FIRST_STEPS:
            eng.finish(0)
            eng.finish(1)
            admitted = eng.admit()
            require(sorted(admitted) == [4, 5], f"admitted {admitted}")
    return fused_all, eng


def check_outputs(out, step_rows):
    """Finite logits exactly where mask_logits left a slot open, -inf
    elsewhere, no NaN anywhere."""
    for f in out._fields:
        t = getattr(out, f)
        require(t is None or not torch.isnan(t).any(), f"NaN in {f}")
    for slot, x in step_rows.items():
        open_g = torch.as_tensor(x.gmap_mask[0] & ~x.gmap_visited_mask[0])
        open_v = torch.as_tensor(x.vp_nav_mask[0])
        for f, m in (("global_logits", open_g), ("grid_logits", open_g),
                     ("fused_logits", open_g), ("local_logits", open_v)):
            t = getattr(out, f)[slot].cpu()
            require(torch.equal(torch.isfinite(t), m),
                    f"{f} slot {slot}: finite set differs from the open slots")
            require((t[~m] == float("-inf")).all(),
                    f"{f} slot {slot}: masked not -inf")


def main_path(report):
    """(d) full-width serving on the card through the kernel, then the same
    steps through the plain pool; returns the config, the requests' step
    rows and texts, and the kernel run's fused logits."""
    cfg = r2r_config()
    rng = np.random.default_rng(0)
    n_req = SERVE_SLOTS + 2
    texts = [request_text(cfg, rng) for _ in range(n_req)]
    steps_needed = FIRST_STEPS + LATER_STEPS
    rows = [[step_row(cfg, rng, t) for t in range(steps_needed)]
            for _ in range(n_req)]
    t0 = time.time()
    model = init_navigator(cfg.model, seed=0, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  navigator: {n_params} parameters, hidden "
          f"{cfg.model.hidden_size}, layers {cfg.model.num_l_layers}/"
          f"{cfg.model.num_x_layers}/{cfg.model.num_pano_layers}, "
          f"max_points {cfg.shapes.max_points} "
          f"(init {time.time() - t0:.1f}s)")

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    fused_kernel, eng = run_engine(model, cfg, rows, texts)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = path_launches(counts(), [eng])
    n_steps = FIRST_STEPS + LATER_STEPS
    print(f"  served {n_req} requests over {SERVE_SLOTS} slots in {n_steps} "
          f"steps, CUDA-graphed ({wall:.2f}s with first-call overheads and "
          f"the capture); buffer count "
          f"{eng._carry.point_state.count.tolist()}")
    print(f"  launches during the serving path (one warm-up step before "
          f"the capture, then one replay a step; the capture recorded "
          f"{eng.graph_launches}): {launches}")
    require(eng.replays == n_steps and eng.graph_launches == {
        "grid_pool_fwd": 1}, f"{eng.replays} replays, captured "
        f"{eng.graph_launches}")
    require(launches["grid_pool_fwd"] == n_steps + 1,
            f"grid_pool_fwd launched {launches['grid_pool_fwd']} times in "
            f"{n_steps} steps and a warm-up")

    # the same steps with the plain pool on the card
    with plain_ops():
        fused_plain, _ = run_engine(model, cfg, rows, texts)
    worst = 0.0
    for s, (a, b) in enumerate(zip(fused_kernel, fused_plain)):
        fin = torch.isfinite(b)
        require(torch.equal(torch.isfinite(a), fin),
                f"step {s}: finite sets differ")
        torch.testing.assert_close(a[fin], b[fin], rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)
        worst = max(worst, (a[fin] - b[fin]).abs().max().item())
    print(f"  fused_logits, kernel pool vs plain pool, {n_steps} steps: "
          f"max|diff| {worst:.3e} (tolerance {LOGIT_TOL})")
    report["main_path"] = {"requests": n_req, "slots": SERVE_SLOTS,
                           "steps": n_steps, "launches": launches,
                           "fused_logits_max_abs_diff_vs_plain": worst,
                           "parameters": n_params}
    return cfg, rows, texts, fused_kernel


def tiny_cpu_reference():
    """A tiny-width step on the card (kernel) against the same step on the
    CPU (plain pool): fused logits within 1e-4."""
    cfg = tiny_config()
    rng = np.random.default_rng(1)
    model_gpu = init_navigator(cfg.model, seed=3, device="cuda")
    model_cpu = init_navigator(cfg.model, seed=3, device="cpu")
    b, t = 2, cfg.shapes.max_txt_len
    ids = torch.from_numpy(rng.integers(1000, 5000, size=(b, t)
                                        ).astype(np.int32))
    mask = torch.arange(t)[None] < torch.tensor([[10], [t]])
    carries = {d: init_carry(cfg, b, device=d) for d in ("cpu", "cuda")}
    models = {"cpu": model_cpu, "cuda": model_gpu}
    worst = 0.0
    with torch.inference_mode():
        txt = {d: models[d]("language", {"txt_ids": ids.to(d),
                                         "txt_mask": mask.to(d)})
               for d in models}
        for step in range(4):
            rows = [step_row(cfg, rng, step) for _ in range(b)]
            x = StepInputs(*(np.concatenate([getattr(r, f) for r in rows])
                             for f in StepInputs._fields))
            outs = {}
            for d in models:
                xd = StepInputs(*(torch.as_tensor(a, device=d) for a in x))
                carries[d], outs[d] = nav_device_step(
                    models[d], cfg, txt[d], mask.to(d), carries[d], xd)
            a, ref = outs["cuda"].fused_logits.cpu(), outs["cpu"].fused_logits
            fin = torch.isfinite(ref)
            require(torch.equal(torch.isfinite(a), fin),
                    "tiny step: finite sets differ")
            torch.testing.assert_close(a[fin], ref[fin], rtol=1e-4,
                                       atol=1e-4)
            worst = max(worst, (a[fin] - ref[fin]).abs().max().item())
    print(f"  tiny config, 4 steps, card (kernel) vs CPU (plain): fused "
          f"max|diff| {worst:.3e} (tolerance 1e-4)")
    return worst


# ---------------------------------------- (d) real data and serving bundle
def write_r2r_world(root: Path, seed: int = 0) -> Path:
    """One scan of 6 viewpoints in the reference layout
    ROOT/R2R/{features,connectivity,annotations}, at the real feature
    widths: views (36, 768) f32, clip_p32 grid tokens (12, 50, 768) f16 and
    depth already sliced to (12, 49) uint16 patch centers, as
    `convert_store --slice-depth-patches` writes it. The stores are written
    with the port's write_store (the card's machine has no h5py)."""
    from gridmm_tpu_torch.data.preprocess import extract_viewpoint_info
    from gridmm_tpu_torch.data.store import write_store

    r2r = root / "R2R"
    feat, conn, anno = (r2r / "features", r2r / "connectivity",
                        r2r / "annotations")
    for p in (feat, conn, anno):
        p.mkdir(parents=True, exist_ok=True)
    world = SyntheticWorld(num_scans=1, nodes_per_scan=6, feat_dim=768,
                           seed=seed)
    scan = world.scans()[0]
    g = world.graphs[scan]
    rng = np.random.default_rng(seed)
    views, depth, grid = {}, {}, {}
    for vp in g.positions:
        key = f"{scan}_{vp}"
        views[key] = world.view_features(scan, vp).astype(np.float32)
        d = rng.integers(2000, 20000, size=(12, 49)).astype(np.uint16)
        d[rng.random(d.shape) < 0.1] = 0
        depth[key] = d
        grid[key] = rng.standard_normal((12, 50, 768)).astype(np.float16)
    for name, recs in (("pth_vit_base_patch16_224_imagenet", views),
                       ("depth", depth), ("clip_p32", grid)):
        write_store(str(feat / f"{name}.gmm"), recs)
    (feat / "viewpoint_info.json").write_text(
        json.dumps(extract_viewpoint_info(world.graphs)))
    vps = list(g.positions)
    items = []
    for vp in vps:
        pose = [0.0] * 16
        pose[3], pose[7], pose[11] = g.positions[vp]
        items.append({"image_id": vp, "included": True,
                      "unobstructed": [n in g.neighbors(vp) for n in vps],
                      "pose": pose, "height": 1.5})
    (conn / f"{scan}_connectivity.json").write_text(json.dumps(items))
    eps = synthetic_episodes(world, num=8, seed=seed, max_len=4)
    (anno / "R2R_train_enc.json").write_text(json.dumps(eps))
    (anno / "R2R_val_unseen_enc.json").write_text(json.dumps(eps[:4]))
    return root


def real_data_path(report):
    """(d) main_nav --world r2r at r2r_config() width on an on-disk world
    of gmmstore files: two training iterations and an evaluation; K1, K5a
    and K5b must launch, GmmStoreWorld must serve, and where the native
    reader builds it must give the Python reader's bytes on every key."""
    from gridmm_tpu_torch.cli import main_nav as cli
    from gridmm_tpu_torch.data.store import (NativeStoreReader,
                                             PyStoreReader, _native_lib)

    runs = ROOT / "runs" / "chip_smoke"
    shutil.rmtree(runs, ignore_errors=True)
    root = write_r2r_world(runs / "world")
    argv = ["--world", "r2r", "--root_dir", str(root), "--feature_backend",
            "gmmstore", "--iters", "2", "--log_every", "1", "--batch_size",
            "4", "--eval", "--output_dir", str(runs / "main_nav")]
    train_env, _, _ = cli.build_real(cli.parse_args(argv), r2r_config())
    world = train_env.world
    reader = type(world._view).__name__
    require(type(world).__name__ == "GmmStoreWorld",
            f"main_nav built {type(world).__name__}")
    world.close()
    print(f"  world: {type(world).__name__}, {len(train_env.data)} train "
          f"episodes, stores read by {reader}")
    native = "not built (no C++ compiler)"
    if _native_lib() is not None:
        for store in sorted((root / "R2R" / "features").glob("*.gmm")):
            nat, py = NativeStoreReader(str(store)), PyStoreReader(str(store))
            require(len(nat) == len(py) and nat.dtype == py.dtype
                    and nat.shape == py.shape, f"{store.name}: headers")
            for k in py.keys():
                require(nat.get(k).tobytes() == py.get(k).tobytes(),
                        f"{store.name} {k}: readers differ")
            nat.close()
            py.close()
        native = "native and Python readers byte-equal on every key"
    print(f"  native reader: {native}")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    result = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = counts()
    print(f"  main_nav --world r2r, r2r_config() width, 2 iterations + "
          f"evaluation: {wall:.1f}s; best_spl {result.best_spl}; launches "
          f"{launches}")
    require(all(math.isfinite(float(v)) for v in
                result.final_metrics.values()), "non-finite metrics")
    for name in ("grid_pool_fwd", "grid_pool_bwd1", "grid_pool_bwd2"):
        require(launches[name] > 0, f"{name} never launched in main_nav")
    report["real_data"] = {"seconds": wall, "reader": reader,
                           "native_check": native, "launches": launches,
                           "best_spl": result.best_spl,
                           "final_metrics": result.final_metrics}
    shutil.rmtree(runs, ignore_errors=True)


def compare_logits(got, want, what):
    """Every step's fused logits: -inf at the same places, the rest within
    LOGIT_BITS_TOL x max|logit| (equal bits expected). Returns (max|diff|,
    bits equal)."""
    worst, equal = 0.0, True
    for s, (a, b) in enumerate(zip(got, want)):
        fin = torch.isfinite(b)
        require(torch.equal(torch.isfinite(a), fin),
                f"{what}, step {s}: finite sets differ")
        diff = (a[fin] - b[fin]).abs().max().item() if fin.any() else 0.0
        scale = b[fin].abs().max().item() if fin.any() else 0.0
        require(diff <= LOGIT_BITS_TOL * scale,
                f"{what}, step {s}: max|diff| {diff:.3e} > "
                f"{LOGIT_BITS_TOL} x {scale:.3e}")
        worst = max(worst, diff)
        equal = equal and torch.equal(a, b)
    return worst, equal


def check_graph_launches(eng, step_rows_, dev_name):
    """torch.profiler over two replays: the trace's K1 launches must equal
    the capture's count x 2 (path_launches' rule). Returns what was seen."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            eng.step(step_rows_)
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if "CUDA" in str(e.device_type)]
    k1 = sum(e.count for e in dev if "grid_pool_fwd" in e.key)
    kernels = sum(e.count for e in dev)
    if kernels == 0:
        print("  profiler: the trace holds no device events; launches in "
              "the graph not measured by it")
        return None
    want = 2 * eng.graph_launches["grid_pool_fwd"]
    print(f"  profiler, 2 replays: {k1} grid_pool_fwd launches (capture "
          f"count x replays = {want}), {kernels / 2:.1f} device events a "
          f"step [{dev_name}]")
    if k1 == 0:
        print("  profiler: no kernel launched inside the graph is in the "
              "trace; the count rule is not checked by it")
        return None
    require(k1 == want, f"profiler saw {k1} K1 launches in 2 replays")
    return {"k1_in_two_replays": k1, "device_events_per_step": kernels / 2}


def bundle_path(report, cfg, rows, texts, dev_name):
    """(d) the serving bundle at r2r_config() width: exported on the card,
    saved, loaded and served through from_bundle (CUDA-graphed) with other
    weights than it was exported with, against a create engine on those
    weights (graphed) and an eager one."""
    from gridmm_tpu_torch.utils.export import (export_navigator_serving,
                                               save_serving_bundle)

    out_dir = ROOT / "chiprun_out" / "smoke_bundle"
    shutil.rmtree(out_dir, ignore_errors=True)
    src = init_navigator(cfg.model, seed=0, device="cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    exports = export_navigator_serving(src, cfg, src.state_dict(),
                                       batch=SERVE_SLOTS, device="cuda")
    manifest = save_serving_bundle(
        exports, str(out_dir), cfg=cfg,
        extra_manifest={"batch": SERVE_SLOTS, "config": "r2r",
                        "int8": False})
    export_s = time.time() - t0
    del src, exports
    sizes = {p.name: p.stat().st_size for p in out_dir.glob("*.pt2")}
    print(f"  exported language + nav_step at r2r width, batch "
          f"{SERVE_SLOTS}, in {export_s:.1f}s; files {sizes} bytes "
          f"(no weights); platforms "
          f"{manifest['artifacts']['nav_step']['platforms']}")
    weights = init_navigator(cfg.model, seed=BUNDLE_SEED, device="cuda")
    n_steps = FIRST_STEPS + LATER_STEPS
    torch.cuda.synchronize()
    reset_counts()
    served_logits, served = run_engine(
        None, cfg, rows, texts, make=lambda: NavServingEngine.from_bundle(
            str(out_dir), cfg, dict(weights.state_dict()), SERVE_SLOTS))
    torch.cuda.synchronize()
    launches = path_launches(counts(), [served])
    print(f"  from_bundle engine: {n_steps} steps, launches {launches} "
          f"(captured {served.graph_launches}, {served.replays} replays)")
    require(launches["grid_pool_fwd"] == n_steps + 1,
            f"bundle path: K1 launched {launches['grid_pool_fwd']} times")
    live_logits, live = run_engine(weights, cfg, rows, texts)
    eager_logits, _ = run_engine(weights, cfg, rows, texts,
                                 cuda_graph=False)
    bundle_diff, bundle_bits = compare_logits(
        served_logits, live_logits, "from_bundle vs create")
    graph_diff, graph_bits = compare_logits(
        live_logits, eager_logits, "graphed vs eager")
    print(f"  fused logits, {n_steps} steps, weights seed {BUNDLE_SEED} "
          f"(the bundle was exported from seed 0): from_bundle vs create "
          f"max|diff| {bundle_diff:.3e} (equal bits: {bundle_bits}); "
          f"graphed vs eager {graph_diff:.3e} (equal bits: {graph_bits}); "
          f"tolerance {LOGIT_BITS_TOL} x max|logit|")
    seen = check_graph_launches(
        live, {s: rows[s][-1] for s in range(SERVE_SLOTS)}, dev_name)

    torch.cuda.synchronize()
    for p in out_dir.glob("*.pt2"):
        p.unlink()   # the manifest stays
    report["bundle"] = {
        "export_s": export_s, "pt2_bytes": sizes, "launches": launches,
        "from_bundle_vs_create_max_abs_diff": bundle_diff,
        "from_bundle_vs_create_equal_bits": bundle_bits,
        "graphed_vs_eager_max_abs_diff": graph_diff,
        "graphed_vs_eager_equal_bits": graph_bits,
        "profiler": seen, "weights_seed": BUNDLE_SEED}


def check_failed_capture(cfg):
    """(d) a serving step that waits on the host cannot be captured: the
    engine must raise, and afterwards dropout on the card must still draw
    (the engine puts CUDA's default generator back out of its capture
    state). Run last: before the engine did so, a failed capture made
    every later dropout on the card raise."""
    from gridmm_tpu_torch.train.step import nav_device_step as step_fn

    weights = init_navigator(cfg.model, seed=BUNDLE_SEED, device="cuda")

    def syncing_step(txt, mask, carry, x):
        carry, out = step_fn(weights, cfg, txt, mask, carry, x)
        out.fused_logits.sum().item()   # a host wait: not capturable
        return carry, out

    try:
        NavServingEngine(cfg, SERVE_SLOTS, lang_fn=lambda i, m: weights(
            "language", {"txt_ids": i, "txt_mask": m}), step_fn=syncing_step)
    except RuntimeError as e:
        require("capture" in str(e), f"unexpected error: {e}")
        msg = str(e).splitlines()[0][:70]
    else:
        raise AssertionError("capture of a syncing step did not raise")
    kept = F.dropout(torch.ones(1 << 16, device="cuda"), 0.5, True)
    share = (kept > 0).float().mean().item()
    require(0.45 < share < 0.55, f"dropout after the failed capture kept "
            f"{share:.3f}")
    print(f"  a step that waits on the host: the engine raised ({msg}...); "
          f"dropout on the card afterwards kept {share:.4f} of 65,536")
    return {"raised": msg, "dropout_kept_share": share}


# ------------------------------------------------ (d) the encoder's paths
def pano_ids(n, scan="smoke"):
    return [(scan, f"vp{i:03d}") for i in range(n)]


def run_extractor(ex, n_panos, seed=0):
    """All sink outputs of one run, in order: [(vp, tokens, depth)]."""
    rows = []
    done = ex.run(synthetic_renderer(pano_ids(n_panos), seed=seed),
                  lambda s, v, t, d: rows.append((v, t, d)))
    require(done == n_panos, f"extractor encoded {done} of {n_panos}")
    return rows


def stack_tokens(rows):
    return torch.from_numpy(np.stack([t for _, t, _ in rows]))


def extractor_path(report):
    """(d) ClipFeatureExtractor.run at clip_b32() width, bf16: K2 12 and K3
    26 launches per forward; the same panoramas through the plain ops; then
    f32 over 4 panoramas, kernels vs plain within F32_TOL."""
    cfg = clip_b32()
    ex = ClipFeatureExtractor(cfg, batch_panos=CLIP_BATCH, device="cuda")
    run_extractor(ex, CLIP_BATCH)          # first-call overheads
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rows = run_extractor(ex, CLIP_PANOS)
    wall = time.perf_counter() - t0
    launches = counts()
    forwards = -(-CLIP_PANOS // CLIP_BATCH)
    print(f"  extractor, clip_b32 bf16, {CLIP_PANOS} panoramas in batches of "
          f"{CLIP_BATCH}: {wall:.3f}s host clock "
          f"({CLIP_PANOS * VIEWS / wall:.1f} views/s with rendering); "
          f"launches {launches}")
    require(launches["attention_qkv_fwd"] == 12 * forwards,
            f"attention_qkv_fwd: {launches['attention_qkv_fwd']} launches "
            f"in {forwards} forwards, want 12 each")
    require(launches["layernorm_fwd"] == 26 * forwards,
            f"layernorm_fwd: {launches['layernorm_fwd']} launches in "
            f"{forwards} forwards, want 26 each")
    require([v for v, _, _ in rows] == [v for _, v in pano_ids(CLIP_PANOS)],
            "extractor changed the panorama order")
    tokens = stack_tokens(rows)
    require(tuple(tokens.shape) == (CLIP_PANOS, VIEWS, 50, 768)
            and tokens.dtype == torch.float32, f"tokens {tokens.shape}")
    require(torch.isfinite(tokens).all().item(), "non-finite tokens")
    require(all(d.shape == (12, 128, 128) and d.dtype == np.uint16
                for _, _, d in rows), "depth shape or type")
    with plain_ops():
        plain = stack_tokens(run_extractor(ex, CLIP_PANOS))
    err_bf16 = rel_err(tokens, plain)
    print(f"  tokens, kernels vs plain ops (bf16): relative error "
          f"{err_bf16:.3e} (bound {BF16_REL_TOL:.3e}), max|diff| "
          f"{(tokens - plain).abs().max().item():.3e} of max|tokens| "
          f"{plain.abs().max().item():.3e}")
    require(err_bf16 <= BF16_REL_TOL, "bf16 tokens differ from plain ops")

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    ex32 = ClipFeatureExtractor(cfg32, batch_panos=4, device="cuda")
    got = stack_tokens(run_extractor(ex32, 4, seed=1))
    with plain_ops():
        want = stack_tokens(run_extractor(ex32, 4, seed=1))
    torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
    err_f32 = (got - want).abs().max().item()
    print(f"  tokens, kernels vs plain ops (f32, 4 panoramas): max|diff| "
          f"{err_f32:.3e} (tolerance {F32_TOL})")
    report["extractor"] = {
        "panoramas": CLIP_PANOS, "batch_panos": CLIP_BATCH,
        "launches": launches, "wall_s": wall,
        "views_per_s_with_rendering": CLIP_PANOS * VIEWS / wall,
        "bf16_rel_err_vs_plain": err_bf16, "f32_max_abs_diff_vs_plain":
            err_f32}


def pipeline_inputs(cfg, b, dtype, seed=0, iters=None):
    """bench.py's pipeline inputs on the card: uint8 frames (the same every
    iteration, as there), per-iteration depth, pose, text and projections."""
    gc = cfg.grid
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    images = torch.randint(0, 256, (b * VIEWS, 224, 224, 3), generator=gen,
                           device="cuda", dtype=torch.uint8)
    steps = []
    for _ in range(iters or gc.max_steps):
        depth = torch.randint(0, 18000, (b, VIEWS, gc.patches_per_view),
                              generator=gen, device="cuda").float()
        pos = torch.rand((b, 2), generator=gen, device="cuda") * 8.0 - 4.0
        heading = torch.rand((b,), generator=gen, device="cuda") * 6.0 - 3.0
        steps.append((depth, pos, heading))
    d = gc.feature_dim
    heads = dict(txt=randn(b, PIPE_TXT, d, scale=0.3),
                 text_proj=(randn(d, d, scale=0.02),
                            torch.zeros(d, device="cuda")),
                 grid_proj=(randn(d, d, scale=0.02),
                            torch.zeros(d, device="cuda")))
    state = G.PointCloudState.create(b, gc, cfg.shapes.max_points,
                                     feature_dtype=dtype, device="cuda")
    return images, steps, heads, state


def run_pipeline(model, cfg, b, dtype, seed=0, iters=None):
    """encode_and_pool over the inputs' steps; returns the per-step outputs
    (cells, pooled, mask on the card) and the final state."""
    images, steps, heads, state = pipeline_inputs(cfg, b, dtype, seed, iters)
    outs = []
    for depth, pos, heading in steps:
        out = encode_and_pool(model, images, state, depth, pos, heading,
                              heads["txt"], heads["text_proj"],
                              heads["grid_proj"], cfg.grid)
        state = out.state
        outs.append((out.cells, out.pooled, out.cell_mask))
    return outs, state


def compare_pipelines(got, want, tol_f32: bool):
    """Cells and masks equal; pooled within F32_TOL (f32) or BF16_REL_TOL
    relative (bf16). Returns the worst pooled difference measure."""
    worst = 0.0
    for i, ((c, p, m), (wc, wp, wm)) in enumerate(zip(got, want)):
        require(torch.equal(c, wc), f"iteration {i}: cell ids differ")
        require(torch.equal(m, wm), f"iteration {i}: cell masks differ")
        if tol_f32:
            torch.testing.assert_close(p, wp, rtol=F32_TOL, atol=F32_TOL)
            worst = max(worst, (p - wp).abs().max().item())
        else:
            err = rel_err(p, wp)
            require(err <= BF16_REL_TOL, f"iteration {i}: pooled relative "
                    f"error {err:.3e} above {BF16_REL_TOL:.3e}")
            worst = max(worst, err)
    return worst


def pipeline_path(report):
    """(d) encode_and_pool at bench.py's sizes (16 panoramas x 12 views,
    clip_b32 bf16, bf16 buffer) until the buffer fills: K1 once, K2 12 and
    K3 26 times per iteration; then the same inputs with the plain ops; then
    f32 (tower and buffer) for 3 iterations against the plain ops."""
    cfg = r2r_config()
    iters = cfg.grid.max_steps
    model = init_clip_vision(clip_b32(), seed=0, device="cuda")
    run_pipeline(model, cfg, PIPE_PANOS, torch.bfloat16, iters=1)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()   # earlier phases' models included
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    reset_counts()
    t0 = time.perf_counter()
    outs, state = run_pipeline(model, cfg, PIPE_PANOS, torch.bfloat16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"  pipeline, {PIPE_PANOS} panoramas x {VIEWS} views, {iters} "
          f"iterations (buffer {state.count.tolist()[0]} of "
          f"{cfg.shapes.max_points} points): {wall:.3f}s host clock; "
          f"launches {launches}")
    print(f"  device memory: peak {peak / 2**30:.3f} GiB allocated, of which "
          f"{held / 2**30:.3f} GiB were held before the run (the tower's f32 "
          f"weights {weights / 2**30:.3f} GiB and earlier phases' models); "
          f"the pipeline's own peak {(peak - held) / 2**30:.3f} GiB")
    require(launches["grid_pool_fwd"] == iters,
            f"grid_pool_fwd launched {launches['grid_pool_fwd']} times in "
            f"{iters} iterations")
    require(launches["attention_qkv_fwd"] == 12 * iters,
            f"attention_qkv_fwd launched {launches['attention_qkv_fwd']}")
    require(launches["layernorm_fwd"] == 26 * iters,
            f"layernorm_fwd launched {launches['layernorm_fwd']}")
    require(int(state.count[0]) == iters * cfg.grid.points_per_step,
            "buffer count")
    cells, pooled, mask = outs[-1]
    require(tuple(pooled.shape) == (PIPE_PANOS, 196, 768)
            and torch.isfinite(pooled).all().item(), "pooled shape or NaN")
    require(((cells >= -1) & (cells < 196)).all().item()
            and mask.any(dim=1).all().item(), "cell ids or masks")
    with plain_ops():
        plain, _ = run_pipeline(model, cfg, PIPE_PANOS, torch.bfloat16)
    err_bf16 = compare_pipelines(outs, plain, tol_f32=False)
    print(f"  pooled, kernels vs plain ops (bf16, {iters} iterations): cells "
          f"and masks equal, worst relative error {err_bf16:.3e} (bound "
          f"{BF16_REL_TOL:.3e})")
    del outs, plain, state

    model32 = init_clip_vision(
        dataclasses.replace(clip_b32(), compute_dtype="float32"), seed=0,
        device="cuda")
    got, _ = run_pipeline(model32, cfg, PIPE_PANOS, torch.float32, seed=1,
                          iters=3)
    with plain_ops():
        want, _ = run_pipeline(model32, cfg, PIPE_PANOS, torch.float32,
                               seed=1, iters=3)
    err_f32 = compare_pipelines(got, want, tol_f32=True)
    print(f"  pooled, kernels vs plain ops (f32, 3 iterations): cells and "
          f"masks equal, max|diff| {err_f32:.3e} (tolerance {F32_TOL})")
    report["pipeline"] = {
        "panoramas": PIPE_PANOS, "views": VIEWS, "iterations": iters,
        "launches": launches, "wall_s_first_fill": wall,
        "peak_device_bytes": peak, "held_before_bytes": held,
        "tower_weight_bytes": weights,
        "pipeline_peak_bytes": peak - held, "bf16_rel_err_vs_plain": err_bf16,
        "f32_max_abs_diff_vs_plain": err_f32}


def tiny_tower_path(report):
    """(d) the --tiny preprocess tower (width 64, 4 heads: head_dim 16, so
    the per-head kernel) through the extractor on the card against the same
    tower on the CPU, f32, within F32_TOL."""
    cfg = ClipVisionConfig(input_resolution=224, patch_size=32, width=64,
                           layers=1, heads=4, compute_dtype="float32")
    models = {d: init_clip_vision(cfg, seed=5, device=d)
              for d in ("cuda", "cpu")}
    exs = {d: ClipFeatureExtractor(cfg, models[d], batch_panos=2, device=d)
           for d in models}
    torch.cuda.synchronize()
    reset_counts()
    got = stack_tokens(run_extractor(exs["cuda"], 4, seed=2))
    torch.cuda.synchronize()
    launches = counts()
    want = stack_tokens(run_extractor(exs["cpu"], 4, seed=2))
    print(f"  tiny tower (hd 16), 4 panoramas, card vs CPU: launches "
          f"{launches}")
    require(launches["attention_fwd"] == 2,
            f"attention_fwd launched {launches['attention_fwd']} times in "
            "2 one-layer forwards")
    require(launches["attention_qkv_fwd"] == 0, "hd 16 took the qkv kernel")
    torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
    err = (got - want).abs().max().item()
    print(f"  tokens, card (kernels) vs CPU (plain): max|diff| {err:.3e} "
          f"(tolerance {F32_TOL})")
    report["tiny_tower"] = {"launches": launches,
                            "card_vs_cpu_max_abs_diff": err}


def vit_h14_config(dtype):
    """ViT-H/14's widths (OpenCLIP ViT-H-14 vision tower: width 1280, 16
    heads, so head_dim 80, patch 14 at 224 px: 257 tokens), depth cut from
    32 layers to 2."""
    return ClipVisionConfig(input_resolution=224, patch_size=14, width=1280,
                            layers=VIT_H_LAYERS, heads=16,
                            compute_dtype=dtype)


def vit_h14_tower_path(report):
    """(d) a tower at ViT-H/14's widths (head_dim 80: the per-head kernel
    at 257 tokens) through the extractor over 2 panoramas: f32 on the card
    against the same tower on the CPU within TOWER_F32_TOL, then bf16 on the
    card, kernels against plain ops, within BF16_REL_TOL. K4 launches once
    per layer and forward, K2 never."""
    cfg = vit_h14_config("float32")
    models = {d: init_clip_vision(cfg, seed=6, device=d)
              for d in ("cuda", "cpu")}
    exs = {d: ClipFeatureExtractor(cfg, models[d], batch_panos=2, device=d)
           for d in models}
    torch.cuda.synchronize()
    reset_counts()
    got = stack_tokens(run_extractor(exs["cuda"], 2, seed=3))
    torch.cuda.synchronize()
    launches = counts()
    print(f"  ViT-H/14 widths (1280 wide, 16 heads, hd 80, 257 tokens, "
          f"depth cut to {VIT_H_LAYERS}), f32, 2 panoramas: launches "
          f"{launches}")
    require(launches["attention_fwd"] == VIT_H_LAYERS,
            f"attention_fwd launched {launches['attention_fwd']} times in "
            f"one {VIT_H_LAYERS}-layer forward")
    require(launches["attention_qkv_fwd"] == 0, "hd 80 took the qkv kernel")
    want = stack_tokens(run_extractor(exs["cpu"], 2, seed=3))
    require(tuple(got.shape) == (2, VIEWS, 257, 1280)
            and torch.isfinite(got).all().item(), f"tokens {got.shape}")
    torch.testing.assert_close(got, want, rtol=TOWER_F32_TOL,
                               atol=TOWER_F32_TOL)
    err_f32 = (got - want).abs().max().item()
    print(f"  tokens, card (kernels) vs CPU (plain), f32: max|diff| "
          f"{err_f32:.3e} (tolerance {TOWER_F32_TOL})")
    del models, exs, got, want

    cfg16 = vit_h14_config("bfloat16")
    ex16 = ClipFeatureExtractor(cfg16, batch_panos=2, device="cuda", seed=6)
    torch.cuda.synchronize()
    reset_counts()
    got = stack_tokens(run_extractor(ex16, 2, seed=3))
    torch.cuda.synchronize()
    launches16 = counts()
    require(launches16["attention_fwd"] == VIT_H_LAYERS
            and launches16["attention_qkv_fwd"] == 0,
            f"bf16 launches {launches16}")
    with plain_ops():
        plain = stack_tokens(run_extractor(ex16, 2, seed=3))
    err_bf16 = rel_err(got, plain)
    print(f"  tokens, kernels vs plain ops, bf16: relative error "
          f"{err_bf16:.3e} (bound {BF16_REL_TOL:.3e}); launches {launches16}")
    require(torch.isfinite(got).all().item() and err_bf16 <= BF16_REL_TOL,
            "bf16 ViT-H/14-width tokens differ from plain ops")
    report["vit_h14_tower"] = {
        "layers": VIT_H_LAYERS, "reduced": "depth 32 -> 2 layers",
        "launches_f32": launches, "launches_bf16": launches16,
        "f32_card_vs_cpu_max_abs_diff": err_f32,
        "bf16_rel_err_vs_plain": err_bf16}


# ------------------------------------------------ (d) the training path
def synthetic_agents(model, cfg, batch, seed=0):
    """Train and val agents over the synthetic world (768-wide features),
    both holding `model`."""
    world = SyntheticWorld(num_scans=2, nodes_per_scan=10, feat_dim=768,
                           seed=seed)
    envs = [DiscreteNavEnv(world, world.graphs,
                           synthetic_episodes(world, num=n, seed=seed + i),
                           batch_size=batch, seed=seed, name=name)
            for i, (n, name) in enumerate(((24, "train"), (8, "val")))]
    return [NavAgent(model, cfg, env) for env in envs]


def loss_and_grads(model, cfg, batch):
    """One teacher-forced loss and its gradients, no update; dropout off."""
    model.zero_grad(set_to_none=True)
    loss = trajectory_loss(model, cfg, batch)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def compare_grads(got, want, rel, what):
    """Every leaf within `rel` of the leaf's max, plus 1e-6 of the largest
    leaf's max (a gradient that is zero analytically, such as that of a bias
    added to every logit of a softmax, holds rounding noise only). Returns
    the worst max|diff| / max|leaf| over the leaves above that floor."""
    require(set(got) == set(want), f"{what}: gradient leaves differ")
    floor = 1e-6 * max(ref.abs().max().item() for ref in want.values())
    worst = 0.0
    for name, ref in want.items():
        scale = ref.abs().max().item()
        err = (got[name].to(ref.device) - ref).abs().max().item()
        require(err <= rel * scale + floor,
                f"{what}: {name} differs by {err:.3e} of max {scale:.3e}")
        if scale > floor:
            worst = max(worst, err / scale)
    return worst


@contextlib.contextmanager
def recorded_grads(model):
    """Yields a list to which every optimizer step appends, before it
    updates, {name: full f32 gradient} of `model`'s parameters (a DTensor
    gradient is gathered; a parameter without one, which the loss does not
    reach, has a gradient of zeros: the sharded update fills those in)."""
    from torch.distributed.tensor import DTensor
    from torch.optim.optimizer import register_optimizer_step_pre_hook

    seen = []

    def hook(optimizer, args, kwargs):
        snap = {}
        for name, p in model.named_parameters():
            g = p.grad
            if g is None:
                local = p.to_local() if isinstance(p, DTensor) else p
                snap[name] = torch.zeros(p.shape, device=local.device)
                continue
            g = g.detach()
            if isinstance(g, DTensor):
                g = g.full_tensor()
            snap[name] = g.float().clone()
        seen.append(snap)

    handle = register_optimizer_step_pre_hook(hook)
    try:
        yield seen
    finally:
        handle.remove()


def largest_batch(model, cfg, want):
    """cfg.train.batch_size trajectories, or the largest power of two below
    it whose update fits the card."""
    b = want
    while True:
        batch = synthetic_trajectory_batch(cfg, b, TRAIN_STEPS, seed=0,
                                           device="cuda")
        try:
            loss_and_grads(model, cfg, batch)
            return b, batch
        except torch.cuda.OutOfMemoryError:
            require(b > 1, "one trajectory does not fit the card")
            del batch
            model.zero_grad(set_to_none=True)
            torch.cuda.empty_cache()
            b = 1 << ((b - 1).bit_length() - 1)
            print(f"  batch does not fit: trying {b}")


def training_path(report):
    """(d) training at r2r_config() width, f32: the rollout->replay loop on
    the synthetic world, then make_train_step updates on one synthetic
    batch, each with the launch counts reset before and read after."""
    cfg = r2r_config()
    require(cfg.train.max_action_len == TRAIN_STEPS
            and TRAIN_STEPS * cfg.grid.points_per_step == 8820,
            "the stacked buffer is not 15 x 588 points")
    model = init_navigator(cfg.model, seed=1, device="cuda")
    remat = cfg.train.remat_steps
    k1_per_update = TRAIN_STEPS * (2 if remat else 1)

    # the loop: rollout (teacher, then sample) -> pad to 15 steps -> update,
    # with an evaluation after each iteration; dropout on in the updates
    loop_cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=LOOP_BATCH))
    agent, val_agent = synthetic_agents(model, loop_cfg, LOOP_BATCH)
    before = model.text_proj.weight.detach().clone()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    result = train_navigator(loop_cfg, model, agent, val_agent,
                             iters=LOOP_ITERS, log_every=1, eval_batches=1,
                             seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    print(f"  train_navigator, synthetic world, batch {LOOP_BATCH}, "
          f"{LOOP_ITERS} iterations (teacher, sample) with evaluation: "
          f"{wall:.2f}s; best SPL {result.best_spl:.2f} at iteration "
          f"{result.best_iter}; launches {launches}")
    require(launches["grid_pool_bwd1"] == LOOP_ITERS * TRAIN_STEPS
            and launches["grid_pool_bwd2"] == LOOP_ITERS * TRAIN_STEPS,
            "backward kernels: not one launch per step and update")
    require(launches["grid_pool_fwd"] > LOOP_ITERS * k1_per_update,
            "forward kernel: the rollouts did not launch it")
    require(result.best_iter in (1, 2) and 0.0 <= result.best_spl <= 100.0
            and np.isfinite(list(result.final_metrics.values())).all(),
            f"loop result {result}")
    require(not torch.equal(model.text_proj.weight, before)
            and all(torch.isfinite(p).all().item()
                    for p in model.parameters()),
            "the loop left the weights unchanged or not finite")
    report["train_loop"] = {"batch": LOOP_BATCH, "iterations": LOOP_ITERS,
                            "wall_s": wall, "launches": launches,
                            "best_spl": result.best_spl}
    del agent, val_agent, model

    # the comparison with the plain ops and the updates run on freshly seeded
    # weights, dropout off: the weights the loop leaves differ in their last
    # bits from run to run (its backward adds with atomics), and with them
    # which ReLU units switch between the two paths (see GRAD_SEED)
    model = init_navigator(cfg.model, seed=GRAD_SEED, device="cuda")
    model.eval()
    b, batch = largest_batch(model, cfg, cfg.train.batch_size)
    print(f"  train update batch: {b} trajectories x {TRAIN_STEPS} steps"
          + ("" if b == cfg.train.batch_size else
             f" (cfg.train.batch_size {cfg.train.batch_size} does not fit)"))
    loss_k, grads_k = loss_and_grads(model, cfg, batch)
    with plain_ops(), reproducible_reference():
        loss_p, grads_p = loss_and_grads(model, cfg, batch)
    require(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p),
            f"loss, kernels {loss_k} vs plain ops {loss_p}")
    worst = compare_grads(grads_k, grads_p, 1e-3, "kernels vs plain ops")
    print(f"  loss and gradients, kernels vs plain ops: loss {loss_k:.6f} vs "
          f"{loss_p:.6f} (1e-5 relative); {len(grads_p)} gradient leaves, "
          f"worst max|diff| / max|leaf| {worst:.3e} (bound 1e-3)")
    del grads_k, grads_p

    state = create_train_state(cfg, model)
    step = make_train_step(cfg)
    torch.cuda.synchronize()
    reset_counts()
    metrics = []
    for _ in range(UPDATES):
        m = step(state, batch, seed=0)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    torch.cuda.synchronize()
    launches = counts()
    print(f"  {UPDATES} make_train_step updates (AdamW, clip "
          f"{cfg.train.grad_norm_clip}): (loss, grad norm) "
          f"{[(round(a, 5), round(g, 4)) for a, g in metrics]}; launches "
          f"{launches}")
    require(np.isfinite(metrics).all(), "loss or grad norm not finite")
    require(all(a > c for (a, _), (c, _) in zip(metrics, metrics[1:])),
            "the loss did not fall over the updates on one batch")
    require(launches["grid_pool_bwd1"] == UPDATES * TRAIN_STEPS
            and launches["grid_pool_bwd2"] == UPDATES * TRAIN_STEPS,
            "backward kernels: not one launch per step and update")
    require(launches["grid_pool_fwd"] == UPDATES * k1_per_update,
            f"forward kernel: {launches['grid_pool_fwd']} launches, want "
            f"{k1_per_update} per update (remat_steps={remat})")
    report["train_updates"] = {
        "batch": b, "steps": TRAIN_STEPS, "updates": UPDATES,
        "loss_grad_norm": metrics, "launches": launches,
        "loss_kernels": loss_k, "loss_plain_ops": loss_p,
        "worst_grad_diff_vs_plain": worst, "remat_steps": remat}


def tiny_update_cpu_reference():
    """A tiny-config update on the card (kernels) against the same update on
    the CPU (plain versions): loss and grad norm within 1e-4 relative,
    gradients within 1e-3 of each leaf's max."""
    cfg = tiny_config()
    out = {}
    for dev in ("cpu", "cuda"):
        model = init_navigator(cfg.model, seed=4, device=dev)
        batch = synthetic_trajectory_batch(cfg, 2, 3, seed=2, device=dev)
        m = make_train_step(cfg)(create_train_state(cfg, model), batch,
                                 seed=0)
        out[dev] = (m["loss"].item(), m["grad_norm"].item(),
                    {n: p.grad.cpu() for n, p in model.named_parameters()
                     if p.grad is not None})
    for i, name in enumerate(("loss", "grad norm")):
        require(abs(out["cuda"][i] - out["cpu"][i])
                <= 1e-4 * abs(out["cpu"][i]),
                f"tiny update {name}: {out['cuda'][i]} vs {out['cpu'][i]}")
    worst = compare_grads(out["cuda"][2], out["cpu"][2], 1e-3,
                          "tiny update, card vs CPU")
    print(f"  tiny config update, card (kernels) vs CPU (plain): loss "
          f"{out['cuda'][0]:.6f} vs {out['cpu'][0]:.6f}, worst gradient "
          f"max|diff| / max|leaf| {worst:.3e} (bound 1e-3)")
    return worst


# ------------------------------------- (d) pretraining, checkpoint import
def pretrain_cli(extra, out_dir):
    """cli/pretrain.main at r2r width on the card, synthetic batches of
    PRETRAIN_B trajectories x PRETRAIN_S steps; returns its TrainState."""
    argv = ["--preset", "r2r", "--device", "cuda", "--batch_size",
            str(PRETRAIN_B), "--num_traj_steps", str(PRETRAIN_S),
            "--output_dir", str(out_dir)] + extra
    return pretrain_cli_mod.main(argv)


def pretrain_loss_and_grads(model, batch, task):
    """One task loss and its gradients, no update."""
    model.zero_grad(set_to_none=True)
    loss = task_loss(model, batch, task)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def with_objects(batch):
    """A tiny synthetic pretraining batch (2 items) with object tokens at vp
    positions 2..4 and an OG label on each item (tests/test_torch_pretrain
    does the same)."""
    b = PretrainBatch(*(t.clone() for t in batch))
    b.traj_nav_types[:, :, 1:4] = 2
    b.vp_obj_mask[:, 2:5] = True
    b.obj_labels.copy_(torch.tensor([3, 2], dtype=torch.int32))
    return b


def pretraining_path(report):
    """(d) pretraining at r2r width through cli/pretrain.main (the 12,416-
    point buffer, 8 x 21 trajectories): a 3-update multi-task run and a
    --accum_steps 2 window, each with the launch counts reset before and
    read after; then 3 updates of each task on one fixed batch (the loss
    must fall), the first update's loss and gradients against the plain
    ops, and a tiny update of each of the four tasks card vs CPU."""
    cfg = pretrain_cli_mod._resolve_config(
        pretrain_cli_mod.parse_args(["--preset", "r2r"]))
    ppstep = cfg.grid.points_per_step
    require(cfg.shapes.max_points == PRETRAIN_N
            and PRETRAIN_S * ppstep == 12348,
            "the pretraining buffer is not 21 x 588 of 12,416 points")
    out_dir = ROOT / "runs" / "chip_smoke" / "pretrain"
    shutil.rmtree(out_dir, ignore_errors=True)
    res = {}
    # the multi-task run: 3 updates, then the validation of 3 tasks
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    state = pretrain_cli(["--tasks", ",".join(PRETRAIN_TASKS),
                          "--mix_ratio", "1,1,1", "--steps",
                          str(PRETRAIN_UPDATES), "--valid_every",
                          str(PRETRAIN_UPDATES)], out_dir / "run")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = counts()
    print(f"  cli/pretrain.main --preset r2r --device cuda, {PRETRAIN_B} x "
          f"{PRETRAIN_S}, {PRETRAIN_UPDATES} updates of tasks "
          f"{PRETRAIN_TASKS} and one validation: {wall:.1f}s; launches "
          f"{launches}")
    n_val = len(PRETRAIN_TASKS)
    require(state.step == PRETRAIN_UPDATES
            and launches["grid_pool_fwd"] == PRETRAIN_UPDATES + n_val
            and launches["grid_pool_bwd1"] == PRETRAIN_UPDATES
            and launches["grid_pool_bwd2"] == PRETRAIN_UPDATES,
            "pretrain CLI: K1 not once per update and validated task, or "
            "K5a/K5b not once per update")
    require((out_dir / "run" / "ckpts" / "navigator_latest").exists(),
            "pretrain CLI wrote no navigator checkpoint")
    res["cli"] = {"wall_s": wall, "launches": launches,
                  "updates": PRETRAIN_UPDATES}

    # one accumulation window of 2 microbatches
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    acc_state = pretrain_cli(["--tasks", "sap", "--mix_ratio", "1",
                              "--steps", "1", "--accum_steps", "2",
                              "--valid_every", "1"], out_dir / "accum")
    torch.cuda.synchronize()
    launches = counts()
    print(f"  cli/pretrain.main --accum_steps 2, one window of sap: "
          f"{time.time() - t0:.1f}s; launches {launches}")
    require(acc_state.step == 1 and acc_state.optimizer.count == 1
            and launches["grid_pool_fwd"] == 3
            and launches["grid_pool_bwd1"] == 2
            and launches["grid_pool_bwd2"] == 2,
            "accumulation window: not one update over two microbatches")
    res["accum_window"] = {"launches": launches}
    del acc_state

    # 3 updates of each task on one fixed batch, dropout off
    batch = synthetic_pretrain_batch(cfg, PRETRAIN_B, PRETRAIN_S, seed=0,
                                     device="cuda")
    state.model.eval()
    res["fixed_batch"] = {}
    for task in PRETRAIN_TASKS:
        step = make_pretrain_step(cfg, task)
        torch.cuda.synchronize()
        reset_counts()
        losses = [step(state, batch)[f"loss_{task}"].item()
                  for _ in range(PRETRAIN_UPDATES)]
        torch.cuda.synchronize()
        launches = counts()
        print(f"  {task}: {PRETRAIN_UPDATES} updates on one batch, losses "
              f"{[round(x, 6) for x in losses]}; launches {launches}")
        require(np.isfinite(losses).all(), f"{task}: loss not finite")
        require(all(a > b for a, b in zip(losses, losses[1:])),
                f"{task}: the loss did not fall on one batch")
        require(all(launches[k] == PRETRAIN_UPDATES for k in (
            "grid_pool_fwd", "grid_pool_bwd1", "grid_pool_bwd2")),
            f"{task}: K1, K5a, K5b not once per update")
        res["fixed_batch"][task] = {"losses": losses, "launches": launches}

    # the first update's loss and gradients, kernels vs plain ops, on
    # freshly seeded weights (see GRAD_SEED), dropout off
    model = init_pretrain_params(cfg.model, seed=GRAD_SEED, device="cuda")
    res["vs_plain"] = {}
    for task in PRETRAIN_TASKS:
        loss_k, grads_k = pretrain_loss_and_grads(model, batch, task)
        with plain_ops(), reproducible_reference():
            loss_p, grads_p = pretrain_loss_and_grads(model, batch, task)
        require(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p),
                f"{task} loss, kernels {loss_k} vs plain ops {loss_p}")
        worst = compare_grads(grads_k, grads_p, 1e-3,
                              f"pretrain {task}, kernels vs plain ops")
        print(f"  {task}, kernels vs plain ops: loss {loss_k:.6f} vs "
              f"{loss_p:.6f} (1e-5 relative); {len(grads_p)} gradient "
              f"leaves, worst max|diff| / max|leaf| {worst:.3e} (bound "
              f"1e-3)")
        res["vs_plain"][task] = {"loss_kernels": loss_k,
                                 "loss_plain_ops": loss_p,
                                 "worst_grad_diff": worst}
        del grads_k, grads_p
    del model
    res["tiny_card_vs_cpu"] = tiny_pretrain_cpu_reference()
    report["pretrain"] = res


def tiny_pretrain_cpu_reference():
    """One update of each of the four tasks at tiny width (OG with object
    tokens) on the card (kernels) against the same update on the CPU
    (plain versions): loss and grad norm within 1e-4 relative, gradients
    within 1e-3 of each leaf's max. Returns the worst ratio per task."""
    tcfg = tiny_config()
    cfg = dataclasses.replace(tcfg, model=dataclasses.replace(
        tcfg.model, image_prob_size=32,
        obj_feat_size=tcfg.model.image_feat_size))
    base = with_objects(synthetic_pretrain_batch(cfg, 2, 3, seed=2,
                                                 device="cpu"))
    worst = {}
    for task in ("mlm", "mrc", "sap", "og"):
        out = {}
        for dev in ("cpu", "cuda"):
            model = init_pretrain_params(cfg.model, seed=4, device=dev)
            state = create_train_state(cfg, model)
            m = make_pretrain_step(cfg, task)(
                state, PretrainBatch(*(t.to(dev) for t in base)))
            out[dev] = (m[f"loss_{task}"].item(), m["grad_norm"].item(),
                        {n: p.grad.cpu() for n, p in model.named_parameters()
                         if p.grad is not None})
        for i, name in enumerate(("loss", "grad norm")):
            require(abs(out["cuda"][i] - out["cpu"][i])
                    <= 1e-4 * abs(out["cpu"][i]),
                    f"tiny {task} {name}: {out['cuda'][i]} vs "
                    f"{out['cpu'][i]}")
        worst[task] = compare_grads(out["cuda"][2], out["cpu"][2], 1e-3,
                                    f"tiny {task}, card vs CPU")
    print(f"  tiny pretrain updates (OG with objects), card (kernels) vs "
          f"CPU (plain): worst gradient max|diff| / max|leaf| "
          f"{ {k: float(f'{v:.3e}') for k, v in worst.items()} } (bound "
          f"1e-3)")
    return worst


def direct_state(sd, rules, keys):
    """A reference-layout state dict put straight onto the port's keys,
    without the importer: a reference nn.Linear weight is (out, in), as the
    port's is, so nothing is transposed; an in_proj weight's row blocks
    are q, k and v. The yardstick for import_torch_navigator, whose rules
    go through the flax layout and back."""
    out = {}
    for src, dst, tf in rules:
        key = torch_name(dst.split("/"))
        if src not in sd or key not in keys:
            continue
        v = torch.as_tensor(np.asarray(sd[src], np.float32))
        if tf in ("Q", "K", "V", "Qb", "Kb", "Vb"):
            v = v.chunk(3, dim=0)["QKV".index(tf[0])]
        out[key] = v.clone()
    return out


def checkpoint_import_path(report, cfg, rows, texts, dev_name):
    """(d) released-checkpoint import at r2r width: a reference-layout
    navigator state dict synthesized from seed 11, nested as grid_map.pt
    is, imported (import_torch_navigator) and served by the graphed create
    engine against an engine loaded with the same weights directly;
    export_serving --navigator_ckpt on that file, served from the bundle;
    a pretrain-layout dict through remap_pretrain_to_navigator, served the
    same way. Logits within 1e-5 x max|logit|."""
    m = cfg.model
    kw = dict(num_l_layers=m.num_l_layers, num_x_layers=m.num_x_layers,
              num_pano_layers=m.num_pano_layers, has_obj=m.obj_feat_size > 0)
    rules = CK.navigator_rules(**kw)
    with torch.device("meta"):      # shapes only
        shapes = nav_mod.GridMMNavigator(m)
        pre_shapes = GridMMPretrain(m)
    keys = set(shapes.state_dict())
    sd = CK.synthesize_torch_state_dict(rules, shapes, seed=IMPORT_SEED)
    work = ROOT / "runs" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    path = work / "grid_map.pt"
    torch.save({"vln_bert": {"epoch": 0, "optimizer": {}, "state_dict": {
        "module.vln_bert." + k: torch.from_numpy(v) for k, v in sd.items()}},
        "critic": {"state_dict": {}}}, str(path))
    res = {}

    def serve_pair(what, imported, direct):
        torch.cuda.synchronize()
        reset_counts()
        got, eng = run_engine(imported, cfg, rows, texts)
        torch.cuda.synchronize()
        launches = path_launches(counts(), [eng])
        want, _ = run_engine(direct, cfg, rows, texts)
        diff, bits = compare_logits(got, want, what)
        print(f"  {what}: imported vs loaded directly, graphed create "
              f"engines, {len(got)} steps: max|diff| {diff:.3e} (equal "
              f"bits: {bits}; tolerance {LOGIT_BITS_TOL} x max|logit|); "
              f"launches {launches}")
        require(launches["grid_pool_fwd"] == FIRST_STEPS + LATER_STEPS + 1,
                f"{what}: K1 launched {launches['grid_pool_fwd']} times")
        return got, {"max_abs_diff": diff, "equal_bits": bits,
                     "launches": launches}

    imported = init_navigator(m, seed=5, device="cuda")
    t0 = time.time()
    parity_eval_mod.import_navigator_checkpoint(str(path), imported, cfg,
                                                "finetune")
    import_s = time.time() - t0
    direct = init_navigator(m, seed=6, device="cuda")
    direct.load_state_dict(direct_state(sd, rules, keys), strict=True)
    live_logits, res["finetune"] = serve_pair(
        "grid_map.pt (module.vln_bert.)", imported, direct)
    res["finetune"]["import_s"] = import_s
    del direct

    # export_serving --navigator_ckpt on the same file, then from_bundle
    out_dir = ROOT / "chiprun_out" / "smoke_import_bundle"
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.time()
    man = export_cli_mod.main(["--config", "r2r", "--batch",
                               str(SERVE_SLOTS), "--navigator_ckpt",
                               str(path), "--out_dir", str(out_dir),
                               "--device", "cuda"])
    export_s = time.time() - t0
    require(man["weights"] == "navigator.pt", f"manifest {man}")
    shipped = {k: v.to("cuda") for k, v in CK.restore_checkpoint(
        str(out_dir / man["weights"])).items()}
    require(all(torch.equal(shipped[k], v)
                for k, v in imported.state_dict().items()),
            "the bundle's navigator.pt differs from the import")
    torch.cuda.synchronize()
    reset_counts()
    served, eng = run_engine(
        None, cfg, rows, texts, make=lambda: NavServingEngine.from_bundle(
            str(out_dir), cfg, shipped, SERVE_SLOTS))
    torch.cuda.synchronize()
    launches = path_launches(counts(), [eng])
    diff, bits = compare_logits(served, live_logits,
                                "from_bundle vs create, imported weights")
    print(f"  export_serving --navigator_ckpt ({export_s:.1f}s, "
          f"manifest weights {man['weights']}) -> from_bundle vs create: "
          f"max|diff| {diff:.3e} (equal bits: {bits}); launches {launches}")
    require(launches["grid_pool_fwd"] == FIRST_STEPS + LATER_STEPS + 1,
            f"bundle: K1 launched {launches['grid_pool_fwd']} times")
    res["bundle"] = {"export_s": export_s, "max_abs_diff": diff,
                     "equal_bits": bits, "launches": launches}
    for p in out_dir.glob("*.pt*"):
        p.unlink()   # the manifest stays
    del eng, shipped, imported

    # a pretrain-layout dict (model_step_N.pt) through
    # remap_pretrain_to_navigator
    psd = CK.synthesize_torch_state_dict(CK.pretrain_rules(**kw), pre_shapes,
                                         seed=IMPORT_SEED)
    remapped = CK.remap_pretrain_to_navigator(
        {"module." + k: v for k, v in psd.items()})
    imported = init_navigator(m, seed=7, device="cuda")
    out, rep = CK.import_torch_navigator(remapped, imported, **kw)
    CK.require_navigator_coverage(rep, what="pretrain navigator")
    imported.load_state_dict(out, strict=True)
    direct = init_navigator(m, seed=8, device="cuda")
    direct.load_state_dict(direct_state(remapped, rules, keys), strict=True)
    _, res["pretrain_layout"] = serve_pair(
        "model_step_N.pt (bert.) via remap_pretrain_to_navigator",
        imported, direct)
    path.unlink()
    report["checkpoint_import"] = res
    del imported, direct


# ------------------------------------------------------ (d) the VLN-CE path
def ce_env(seed, num_envs=CE_ENVS):
    return SyntheticContinuousEnv(num_envs=num_envs, image_size=224,
                                  depth_size=256, seed=seed)


def ce_rollout(agent, fused, seed, trace=None, steps=CE_STEPS):
    """One greedy rollout on a fresh arena; returns (metrics, paths)."""
    agent.fused_rollout = fused
    env = ce_env(seed)
    m = agent.rollout(env, max_steps=steps, feedback="argmax", trace=trace)
    return m, [np.asarray(p) for p in env.paths]


def same_paths(a, b):
    return len(a) == len(b) and all(
        x.shape == y.shape and np.array_equal(x, y) for x, y in zip(a, b))


def ce_cli_path(report):
    """run_ce --full --view_tower on the synthetic arena at r2r_ce width:
    two schedule-sampled batches of 4 envs x 20 steps with their updates,
    then one greedy eval batch; K1, K2, K3, K5a and K5b must launch."""
    out_dir = ROOT / "runs" / "chip_smoke" / "ce"
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["--full", "--view_tower", "--num_envs", str(CE_ENVS),
            "--epochs", "1", "--batches_per_epoch", str(CE_BATCHES),
            "--eval_batches", "1", "--max_steps", str(CE_STEPS),
            "--device", "cuda", "--seed", "0", "--output_dir",
            str(out_dir)]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    metrics = run_ce_mod.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    losses = [rec["ce_train/loss"] for rec in map(
        json.loads, (out_dir / "metrics.jsonl").read_text().splitlines())
        if "ce_train/loss" in rec]
    print(f"  run_ce --full --view_tower, {CE_ENVS} envs x {CE_STEPS} "
          f"steps, {CE_BATCHES} train batches and one eval batch: "
          f"{wall:.1f}s; losses {losses}; eval {metrics}; launches "
          f"{launches}")
    require(len(losses) == CE_BATCHES and np.isfinite(losses).all(),
            f"CE train losses {losses}")
    require(np.isfinite(list(metrics.values())).all()
            and 0.0 <= metrics["sr"] <= 1.0, f"CE eval metrics {metrics}")
    for name in CE_PATH_KERNELS:
        require(launches[name] > 0, f"{name} did not launch on the CE path")
    require(launches["attention_fwd"] == 0,
            "the per-head kernel launched on the hd-64 towers")
    require((out_dir / "checkpoints" / "ckpt.0").exists(),
            "run_ce wrote no checkpoint")
    report["ce"] = {"cli": {"argv": argv, "wall_s": wall, "losses": losses,
                            "eval": metrics, "launches": launches}}


def f32_tower(tower):
    """The same tower computing in f32 (its weights are f32 already)."""
    m = clip_mod.ClipVisionTransformer(dataclasses.replace(
        tower.cfg, compute_dtype="float32")).to("cuda").eval()
    m.load_state_dict(tower.state_dict())
    return m


def compare_ce_traces(got, want, what):
    """Step by step while both runs took the same actions: -inf at the same
    places and the rest within LOGIT_TOL. Returns (max|diff|, the first
    step whose actions part or None, the kernel run's gap between its two
    best logits there)."""
    worst = 0.0
    for t, (a, b) in enumerate(zip(got, want)):
        fin = np.isfinite(b)
        require(np.array_equal(np.isfinite(a), fin),
                f"{what}, step {t}: finite sets differ")
        torch.testing.assert_close(torch.from_numpy(a[fin]),
                                   torch.from_numpy(b[fin]), rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)
        worst = max(worst, float(np.abs(a[fin] - b[fin]).max()))
        if not np.array_equal(a.argmax(-1), b.argmax(-1)):
            top = np.sort(np.where(np.isfinite(a), a, -np.inf), axis=-1)
            return worst, t, float((top[:, -1] - top[:, -2]).min())
    return worst, None, None


def trace_gap(got, want):
    """(max|diff|, max|logit|) over the finite logits of two traces."""
    worst = scale = 0.0
    for a, b in zip(got, want):
        fin = np.isfinite(a) & np.isfinite(b)
        worst = max(worst, float(np.abs(a[fin] - b[fin]).max()))
        scale = max(scale, float(np.abs(b[fin]).max()))
    return worst, scale


def ce_assembly_walk(agent, seed, steps=CE_STEPS):
    """A greedy rollout on the card that assembles every step twice, on the
    device (device_build_step) and on the host (_build_step), from the same
    perception: integer and boolean fields must be equal and floats within
    1e-4, as the CPU tests hold them. Each assembly then runs the
    navigation step from a copy of the same carry, and the walk follows
    the device assembly's actions. Returns (each float field's max|diff|,
    each step's logit max|diff| and max|logit|, the count of position
    features left out where a node is coincident in f32 and ~1e-9 m away
    in f64)."""
    cfg = agent.cfg
    env = ce_env(seed)
    b, cap = env.num_envs, cfg.model.max_action_steps
    centers = np.asarray([19 + 36 * i for i in range(7)])
    diffs, gaps, revisits = {}, [], 0
    with agent.inference():
        obs = env.reset()
        ids, mask = agent.language_batch(obs)
        mask = torch.from_numpy(mask).cuda()
        txt = agent.language(torch.from_numpy(ids).cuda(), mask)
        carry = init_carry(cfg, b, device="cuda")
        tpos = np.zeros((b, cap, 3), np.float32)
        tdist = np.zeros((b, cap), np.float32)
        ended = np.zeros(b, bool)
        for t in range(steps):
            for i, ob in enumerate(obs):
                p3 = np.array([ob.position[0], ob.height, ob.position[1]],
                              np.float32)
                tdist[i, t] = 0.0 if t == 0 else float(
                    np.linalg.norm(p3 - tpos[i, t - 1]))
                tpos[i, t] = p3
            rgb, depth = agent.observation_tensors(obs)
            nms, _, patch, view_cls, view_feats = agent.perception(rgb, depth)
            nms_h = nms.cpu().numpy()
            cands = [agent.candidates_from_nms(nms_h[i], obs[i].heading,
                                               agent.max_candidates)
                     for i in range(b)]
            x_host, _ = agent._build_step(
                obs, cands, view_cls.cpu().numpy(), centers,
                np.ones(b, np.int32), t,
                view_feats=view_feats.float().cpu().numpy(), ended=ended)
            host = (np.stack([ob.position for ob in obs]).astype(np.float32),
                    np.asarray([ob.heading for ob in obs], np.float32), tpos,
                    tdist, np.full(b, t + 1, np.int32), ended)
            pos, hd, tp, td, tl, en = (torch.from_numpy(np.array(a)).cuda()
                                       for a in host)
            cand = ce_device_step.device_candidates(nms, agent.max_candidates)
            x_dev = ce_device_step.device_build_step(
                cfg, cand, view_cls, depth, pos, hd, tp, td, tl,
                torch.full((), t, dtype=torch.int64, device="cuda"),
                view_feats=view_feats, ended=en)
            for f in StepInputs._fields:
                if f == "patch_fts":
                    continue
                a = getattr(x_dev, f).cpu().numpy()
                h = np.asarray(getattr(x_host, f))
                require(a.shape == h.shape, f"step {t} assembly: {f} shape")
                if np.issubdtype(h.dtype, np.floating):
                    if f in ("gmap_pos_fts", "vp_pos_fts"):
                        # a node within ~1e-9 m of the current one: the
                        # host's f64 positions give that offset an angle,
                        # the device's f32 ones find the node coincident
                        # (the JAX twins part the same way); the arena
                        # keeps positions in f64, so a loop back to an
                        # earlier node lands there
                        af = cfg.model.angle_feat_size
                        near = (np.abs(h[..., af]) < 1e-6) & (
                            h[..., :af] != a[..., :af]).any(-1)
                        revisits += int(near.sum())
                        a = a.copy()
                        a[..., :af + 3][near] = h[..., :af + 3][near]
                    diffs[f] = max(diffs.get(f, 0.0),
                                   float(np.abs(a - h).max()))
                    if diffs[f] > 1e-4:
                        at = np.unravel_index(np.abs(a - h).argmax(),
                                              a.shape)
                        i = at[0]
                        raise AssertionError(
                            f"step {t} assembly: {f} differs by "
                            f"{diffs[f]} at {at}: device {a[at[:-1]]}, "
                            f"host {h[at[:-1]]}; env {i} ended "
                            f"{ended[i]}, device trajectory "
                            f"{tpos[i, :t + 1].tolist()}, host "
                            f"{[p.tolist() for p in agent._traj_pos[i]]}, "
                            f"heading {obs[i].heading!r}")
                else:
                    require(np.array_equal(a, h),
                            f"step {t} assembly: {f} differs")
            logits = []
            for x in (x_dev, step_to_device(x_host, "cuda")):
                c = NavCarry(G.PointCloudState(*(u.clone() for u in
                                                 carry.point_state)),
                             carry.gmap_sum.clone(), carry.gmap_cnt.clone())
                c, out = nav_device_step(agent.navigator, cfg, txt, mask, c,
                                         x._replace(patch_fts=patch))
                logits.append((c, ce_device_step.ce_action_logits(
                    out.global_logits, out.local_logits,
                    x.cand_gmap_idx).double().cpu().numpy()))
            (carry, ld), (_, lh) = logits
            fin = np.isfinite(ld) & np.isfinite(lh)
            gaps.append((float(np.abs(ld[fin] - lh[fin]).max()),
                         float(np.abs(lh[fin]).max())))
            a_t = ld.argmax(-1)
            ang = cand.ang_bins.cpu().numpy()
            dbin = cand.dist_bins.cpu().numpy()
            n_c = cand.mask.sum(-1).cpu().numpy()
            for i in range(b):
                if ended[i]:
                    continue
                if a_t[i] == 0 or t == steps - 1 or a_t[i] > n_c[i]:
                    ended[i] = True
                    continue
                j = int(a_t[i]) - 1
                env.step_to(i, obs[i].heading + ang[i, j] * (
                    2 * math.pi / 120), (dbin[i, j] + 1) * 0.25)
            obs = env.observations()
            if ended.all():
                break
    return diffs, gaps, revisits


def ce_rollout_checks(report):
    """Fresh full-width weights: a greedy rollout through the fused device
    step and one through the host path must act identically; the rollout
    with the plain ops (f32 towers, so that LOGIT_TOL applies) against the
    kernels."""
    t0 = time.time()
    cfg, agent = build_ce_agent(tiny=False, view_tower=True, seed=CE_SEED,
                                device="cuda")
    print(f"  full CE agent (navigator, ResNet50 + ddppo towers, clip_b32, "
          f"ViT-B/16 view tower), seed {CE_SEED}: {time.time() - t0:.1f}s")
    fused_trace, host_trace = [], []
    reset_counts()
    _, p_fused = ce_rollout(agent, True, 5, trace=fused_trace)
    _, p_host = ce_rollout(agent, False, 5, trace=host_trace)
    launches = counts()
    require(same_paths(p_fused, p_host),
            "the fused and host-path rollouts acted differently")
    gap, scale = trace_gap(fused_trace, host_trace)
    again = []
    _, p_again = ce_rollout(agent, True, 5, trace=again)
    require(same_paths(p_fused, p_again), "two fused rollouts differ")
    rerun_gap, _ = trace_gap(again, fused_trace)
    step_diffs, step_gaps, revisits = ce_assembly_walk(agent, 5)
    print(f"  greedy rollouts, {CE_ENVS} envs x {len(fused_trace)} steps, "
          f"fused device step vs host path: identical actions (path "
          f"lengths {[len(p) for p in p_fused]}), logits max|diff| "
          f"{gap:.3e} of max|logit| {scale:.3e} (a second fused run: "
          f"{rerun_gap:.3e}); launches {launches}")
    print(f"  the same walk with both assemblies each step: device vs host "
          f"float fields max|diff| {max(step_diffs.values()):.3e} "
          f"({max(step_diffs, key=step_diffs.get)}), {revisits} position "
          f"rows left out (a node coincident in f32, ~1e-9 m away in "
          f"f64); logits from each, same carry, max|diff| per step "
          f"{[float(f'{g:.2e}') for g, _ in step_gaps]}")

    # kernels against the plain ops: f32 towers, reproducible reference
    agent32 = type(agent)(cfg, agent.navigator, agent.waypoint,
                          f32_tower(agent.clip), agent.rgb_tower,
                          agent.depth_tower, f32_tower(agent.view_encoder))
    k_trace, p_trace = [], []
    _, pk = ce_rollout(agent32, True, 5, trace=k_trace)
    with plain_ops(), reproducible_reference():
        _, pp = ce_rollout(agent32, True, 5, trace=p_trace)
    worst, part, part_gap = compare_ce_traces(k_trace, p_trace,
                                              "CE rollout, kernels vs plain")
    require(part is not None or same_paths(pk, pp),
            "the kernel and plain runs moved differently with equal actions")
    print(f"  the same rollout with f32 towers, kernels vs plain ops: "
          f"logits max|diff| {worst:.3e} (tolerance {LOGIT_TOL}); "
          + ("identical actions" if part is None else
             f"actions part at step {part}, where the kernel run's two best "
             f"logits are {part_gap:.3e} apart"))
    # bf16 towers: the first step's logits (same observations) within the
    # bf16 bound of phase d
    b_trace = []
    with plain_ops(), reproducible_reference():
        ce_rollout(agent, True, 5, trace=b_trace, steps=1)
    a, b = fused_trace[0], b_trace[0]
    fin = np.isfinite(b)
    bf16_err = rel_err(torch.from_numpy(a[fin]), torch.from_numpy(b[fin]))
    require(bf16_err <= BF16_REL_TOL,
            f"bf16 towers: first-step logits {bf16_err:.3e} apart")
    print(f"  bf16 towers, first step, kernels vs plain ops: relative "
          f"error {bf16_err:.3e} (bound {BF16_REL_TOL})")
    report["ce"]["rollouts"] = {
        "seed": CE_SEED, "launches_two_rollouts": launches,
        "fused_vs_host_logit_max_abs_diff": gap, "max_abs_logit": scale,
        "fused_rerun_logit_max_abs_diff": rerun_gap,
        "assembly_max_abs_diff": step_diffs,
        "assembly_logit_gaps": step_gaps,
        "assembly_revisit_rows": revisits,
        "f32_kernels_vs_plain_logit_max_abs_diff": worst,
        "f32_actions_part_at_step": part, "part_gap": part_gap,
        "bf16_first_step_rel_err": bf16_err}
    del agent, agent32


def ce_update_checks(report):
    """Fresh full-width weights (CE_GRAD_SEED): one schedule-sampled batch
    of 4 envs x 20 steps recorded, its loss and gradients against the plain
    ops, three updates (dropout off) with a falling loss."""
    cfg, agent = build_ce_agent(tiny=False, view_tower=True,
                                seed=CE_GRAD_SEED, device="cuda")
    trainer = CETrainer(cfg, agent)
    with agent.inference():
        raw = trainer.record_batch(ce_env(6), CE_STEPS,
                                   np.random.default_rng(0),
                                   trainer.ss_ratio(0))
    batch = batch_to_device(raw, "cuda")
    batch = batch._replace(steps=batch.steps._replace(
        patch_fts=batch.steps.patch_fts.clone()))
    nav = agent.navigator
    nav.eval()
    tcfg = trainer.cfg
    loss_k, grads_k = loss_and_grads(nav, tcfg, batch)
    with plain_ops(), reproducible_reference():
        loss_p, grads_p = loss_and_grads(nav, tcfg, batch)
    require(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p),
            f"CE loss, kernels {loss_k} vs plain ops {loss_p}")
    worst = compare_grads(grads_k, grads_p, 1e-3, "CE, kernels vs plain ops")
    print(f"  CE loss and gradients ({CE_ENVS} x {CE_STEPS}, seed "
          f"{CE_GRAD_SEED}), kernels vs plain ops: loss {loss_k:.6f} vs "
          f"{loss_p:.6f} (1e-5 relative); {len(grads_p)} leaves, worst "
          f"max|diff| / max|leaf| {worst:.3e} (bound 1e-3)")
    del grads_k, grads_p
    remat = tcfg.train.remat_steps
    torch.cuda.synchronize()
    reset_counts()
    losses = [trainer.update(batch, seed=0, dropout=False)["loss"].item()
              for _ in range(CE_UPDATES)]
    torch.cuda.synchronize()
    launches = counts()
    print(f"  {CE_UPDATES} CE updates on one batch (dropout off): losses "
          f"{[round(x, 5) for x in losses]}; launches {launches}")
    require(np.isfinite(losses).all()
            and all(a > b for a, b in zip(losses, losses[1:])),
            "the CE loss did not fall over the updates on one batch")
    k1 = CE_STEPS * (2 if remat else 1)
    require(launches["grid_pool_fwd"] == CE_UPDATES * k1
            and launches["grid_pool_bwd1"] == CE_UPDATES * CE_STEPS
            and launches["grid_pool_bwd2"] == CE_UPDATES * CE_STEPS,
            f"CE update launches {launches}")
    report["ce"]["updates"] = {
        "seed": CE_GRAD_SEED, "loss_kernels": loss_k, "loss_plain": loss_p,
        "worst_grad_diff_vs_plain": worst, "losses": losses,
        "launches": launches}


def tiny_ce_cpu_reference(report):
    """The tiny CE agent (CLIP width 64, 4 heads: head_dim 16, so K4) on the
    card against the same agent on the CPU: one greedy rollout through the
    fused step (equal paths, logits within 1e-4) and one update (loss
    within 1e-4 relative, gradients within 1e-3 of each leaf's max)."""
    out = {}
    for dev in ("cpu", "cuda"):
        cfg, agent = build_ce_agent(tiny=True, seed=2, device=dev)
        agent.fused_rollout = True
        trace = []
        env = SyntheticContinuousEnv(num_envs=2, image_size=56,
                                     depth_size=256, seed=3)
        reset_counts()
        agent.rollout(env, max_steps=4, trace=trace)
        out[dev] = {"agent": agent, "trace": trace,
                    "paths": [np.asarray(p) for p in env.paths],
                    "k4": counts()["attention_fwd"]}
    require(same_paths(out["cuda"]["paths"], out["cpu"]["paths"]),
            "tiny CE rollout: card and CPU acted differently")
    worst = 0.0
    for a, b in zip(out["cuda"]["trace"], out["cpu"]["trace"]):
        fin = np.isfinite(b)
        require(np.array_equal(np.isfinite(a), fin), "tiny CE: finite sets")
        worst = max(worst, float(np.abs(a[fin] - b[fin]).max()))
    require(worst <= 1e-4, f"tiny CE logits, card vs CPU: {worst:.3e}")
    require(out["cuda"]["k4"] > 0, "the tiny CE rollout did not launch K4")
    trainer = CETrainer(cfg, out["cpu"]["agent"])
    with out["cpu"]["agent"].inference():
        raw = trainer.record_batch(
            SyntheticContinuousEnv(num_envs=2, image_size=56, depth_size=256,
                                   seed=4), 4, np.random.default_rng(0),
            trainer.ss_ratio(0))
    res = {}
    for dev in ("cpu", "cuda"):
        nav = out[dev]["agent"].navigator.eval()
        res[dev] = loss_and_grads(nav, trainer.cfg, batch_to_device(raw, dev))
    require(abs(res["cuda"][0] - res["cpu"][0]) <= 1e-4 * abs(res["cpu"][0]),
            f"tiny CE loss: {res['cuda'][0]} vs {res['cpu'][0]}")
    gworst = compare_grads(res["cuda"][1], res["cpu"][1], 1e-3,
                           "tiny CE update, card vs CPU")
    print(f"  tiny CE agent, card vs CPU: rollout paths equal, logits "
          f"max|diff| {worst:.3e} (1e-4), K4 launches "
          f"{out['cuda']['k4']}; loss {res['cuda'][0]:.6f} vs "
          f"{res['cpu'][0]:.6f}, worst gradient max|diff| / max|leaf| "
          f"{gworst:.3e} (1e-3)")
    report["ce"]["tiny"] = {"logit_max_abs_diff": worst,
                            "k4_launches": out["cuda"]["k4"],
                            "worst_grad_diff": gworst}


def ce_phases(report, phase_s):
    """(d) the VLN-CE path."""
    t_phase = time.time()
    print("(d) main path: VLN-CE at r2r_ce_config() width (run_ce --full "
          "--view_tower), fused vs host path, kernels vs plain ops, "
          "updates, the tiny agent card vs CPU")
    ce_cli_path(report)
    ce_rollout_checks(report)
    ce_update_checks(report)
    tiny_ce_cpu_reference(report)
    phase_s["d_ce"] = time.time() - t_phase
    print(f"    phase (d), VLN-CE: {phase_s['d_ce']:.1f}s")


# ------------------------------------- (d) int8 serving, the parallel layer
# the int8 navigator card vs CPU at tiny_config() width:
# tests/test_torch_quant.py's tolerance at that width (one quantization
# step, relative to the logits' spread)
INT8_STEP_TOL = 2e-3
# the same at r2r_config() width: the card's and the CPU's f32 activations
# differ in their last bits, an activation on a rounding boundary moves one
# int8 step, and 13 layers carry it on; image features one ulp off move the
# CPU's own int8 logits by as much (the witness printed beside it). Read
# 2.1e-2 on an NVIDIA H100 80GB HBM3 at 700 W
INT8_R2R_TOL = 5e-2
# int8 against f32 on the same weights: tests/test_int8_nav.py's gates, and
# test_misc.py's token cosine for the tower
INT8_COS, INT8_SPREAD, CLIP_INT8_COS = 0.99, 0.2, 0.98
# a mesh of one rank against the run without it: the same kernels on the
# same seeds, every sum in a fixed order (the pool's kernels; the fused
# logits' gather and the embeddings' backward, models/layers.py), so the
# bits should agree; the tolerance is what the check held before they did
MESH_REL_TOL = 1e-6
# the two-rank update: dropout off (the ranks draw different masks), Adam
# eps 1e-2 (a zero gradient's rounding noise would decide a whole +-lr at
# 1e-6, as the CPU tests note), a clip the gradient norm exceeds, and the
# VLN-CE norm, whose per-rank action counts differ
DP_CLIP, DP_EPS, DP_B = 1.0, 1e-2, 16
# run_ce under a mesh: the depth of its episodes (CE_STEPS cut to half)
MESH_CE_STEPS = 10


def int8_cfg(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, int8_matmuls=True))


def int8_gemm_card_vs_cpu():
    """The int8 product (ops/quant._int_mm: cuBLASLt on the card, its rows
    padded where m <= 16) against the CPU's on identical int8 operands at
    the serving step's shapes: the int32 sums must be equal; and
    int8_dense on identical float inputs within 1e-6 of the output's
    max."""
    from gridmm_tpu_torch.ops import quant as Q

    gen = torch.Generator().manual_seed(0)
    shapes = [(4, 768, 768), (17, 768, 768), (4 * 40, 768, 3072),
              (4 * 200, 3072, 768), (4 * 64, 768, 2304)]
    worst = 0.0
    for m, k, n in shapes:
        xq = torch.randint(-127, 128, (m, k), generator=gen,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (n, k), generator=gen,
                           dtype=torch.int8)
        got = Q._int_mm(xq.cuda(), wq.cuda().t()).cpu()
        require(torch.equal(got, Q._int_mm(xq, wq.t())),
                f"int8 GEMM card vs CPU at {(m, k, n)}: int32 sums differ")
        x = torch.randn(m, k, generator=gen)
        w = torch.randn(n, k, generator=gen) * 0.02
        b = torch.randn(n, generator=gen)
        y = Q.int8_dense(x.cuda(), w.cuda(), b.cuda()).cpu()
        ref = Q.int8_dense(x, w, b)
        err = ((y - ref).abs().max() / ref.abs().max()).item()
        require(err <= 1e-6, f"int8_dense card vs CPU at {(m, k, n)}: "
                f"{err:.3e} of the max")
        worst = max(worst, err)
    print(f"  int8 GEMM card vs CPU at {shapes}: equal int32 sums; "
          f"int8_dense within {worst:.2e} of the output's max")
    return {"shapes": shapes, "int8_dense_worst_rel": worst}


def int8_step_card_vs_cpu(cfg8, rows, texts, model=None, witness=False):
    """The first step of 4 slots, int8, on the card against the CPU (the
    same seed-0 weights); max|diff| over the CPU logits' spread. Rows and
    texts are made for cfg8 where none are given. With `witness`, also the
    same measure between the CPU's step and the CPU's step again with every
    image feature moved one ulp up or down at random: how far the int8
    logits move where the f32 inputs differ in their last bits; else
    None."""
    if rows is None:
        rng = np.random.default_rng(2)
        texts = [request_text(cfg8, rng) for _ in range(SERVE_SLOTS)]
        rows = [[step_row(cfg8, rng, 0)] for _ in range(SERVE_SLOTS)]
    model = model or init_navigator(cfg8.model, seed=0, device="cuda")
    card = first_step(model, cfg8, rows, texts, "cuda")
    cpu_model = init_navigator(cfg8.model, seed=0, device="cpu")
    cpu = first_step(cpu_model, cfg8, rows, texts, "cpu")

    def over_spread(a, b, what):
        fin = torch.isfinite(b)
        require(torch.equal(torch.isfinite(a), fin),
                f"int8 {what}: finite patterns differ")
        return float((a[fin] - b[fin]).abs().max()
                     / (b[fin].max() - b[fin].min()))

    err = over_spread(card, cpu, "card vs CPU")
    if not witness:
        return err, None
    rng = np.random.default_rng(3)
    up, down = np.float32(np.inf), np.float32(-np.inf)
    nudged = []
    for r in rows:
        f = r[0].view_img_fts
        to = np.where(rng.random(f.shape) < 0.5, down, up).astype(np.float32)
        nudged.append([r[0]._replace(view_img_fts=np.nextafter(f, to))])
    cpu_nudged = first_step(cpu_model, cfg8, nudged, texts, "cpu")
    return err, over_spread(cpu_nudged, cpu, "CPU vs CPU one ulp off")


def first_step(model, cfg, rows, texts, device):
    """The fused logits of the first 4 requests' first step, through a
    `create` engine on `device` (eager)."""
    eng = NavServingEngine.create(model, cfg, SERVE_SLOTS, device=device,
                                  cuda_graph=False)
    for r in range(SERVE_SLOTS):
        eng.submit(r, *texts[r])
    eng.admit()
    out = eng.step({r: rows[r][0] for r in range(SERVE_SLOTS)})
    return out.fused_logits.float().cpu()


def int8_serving_path(report, cfg, rows, texts, fused_f32):
    """(d) int8 serving at r2r_config() width: a graphed create engine with
    int8_matmuls serves the main path's 6 requests x 18 steps on the same
    seed-0 weights; its logits against the f32 engine's (the JAX test's
    gates), its first step against the same int8 step on the CPU, and the
    --int8 bundle against it."""
    cfg8 = int8_cfg(cfg)
    model8 = init_navigator(cfg8.model, seed=0, device="cuda")
    n_steps = FIRST_STEPS + LATER_STEPS
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    fused8, eng8 = run_engine(model8, cfg8, rows, texts)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = path_launches(counts(), [eng8])
    require(launches["grid_pool_fwd"] == n_steps + 1,
            f"int8 serving: K1 launched {launches['grid_pool_fwd']} times")
    worst_cos, worst_spread = 1.0, 0.0
    for s, (a, b) in enumerate(zip(fused8, fused_f32)):
        fin = torch.isfinite(b)
        require(torch.equal(torch.isfinite(a), fin),
                f"int8 step {s}: finite pattern differs from f32")
        x, y = a[fin].double(), b[fin].double()
        cos = float(x @ y / (x.norm() * y.norm() + 1e-12))
        spread = float((x - y).abs().max() / (y.max() - y.min() + 1e-9))
        worst_cos, worst_spread = min(worst_cos, cos), max(worst_spread,
                                                           spread)
    require(worst_cos > INT8_COS and worst_spread < INT8_SPREAD,
            f"int8 vs f32: cosine {worst_cos:.5f}, max|diff|/spread "
            f"{worst_spread:.4f}")
    print(f"  int8 engine, {n_steps} steps over {SERVE_SLOTS} slots, "
          f"CUDA-graphed ({wall:.2f}s); launches {launches}; against the "
          f"f32 engine: finite patterns equal, cosine >= {worst_cos:.6f} "
          f"(gate {INT8_COS}), max|diff|/spread <= {worst_spread:.5f} "
          f"(gate {INT8_SPREAD})")

    # the int8 step on the card against the port's int8 step on the CPU:
    # the GEMM on identical int8 operands at the step's shapes (equal int32
    # sums), then the step at tiny_config() width, where the parity test's
    # tolerance was measured, and at r2r width beside its witness
    gemm = int8_gemm_card_vs_cpu()
    step_err, _ = int8_step_card_vs_cpu(int8_cfg(tiny_config()), rows=None,
                                        texts=None)
    require(step_err < INT8_STEP_TOL, f"int8 card vs CPU, tiny width: "
            f"{step_err:.3e} of the spread > {INT8_STEP_TOL}")
    r2r_err, r2r_ulp = int8_step_card_vs_cpu(cfg8, rows, texts, model8,
                                             witness=True)
    require(r2r_err < INT8_R2R_TOL, f"int8 card vs CPU, r2r width: "
            f"{r2r_err:.3e} of the spread > {INT8_R2R_TOL}")
    print(f"  int8 step card vs CPU, first step of 4 slots: tiny width "
          f"{step_err:.3e} of the logits' spread (tolerance "
          f"{INT8_STEP_TOL}); r2r width {r2r_err:.3e} (tolerance "
          f"{INT8_R2R_TOL}); witness: the CPU's int8 step with the image "
          f"features one ulp off moves {r2r_ulp:.3e}")

    # the --int8 bundle: its programs quantize the weights they are given;
    # phase f holds the sharded --int8 bundle against them, then deletes them
    out_dir = INT8_BUNDLE
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.time()
    manifest = export_cli_mod.main(["--config", "r2r", "--int8", "--batch",
                                    str(SERVE_SLOTS), "--device", "cuda",
                                    "--out_dir", str(out_dir)])
    export_s = time.time() - t0
    require(manifest["int8"] is True, "the --int8 manifest says int8 false")
    served8_logits, _ = run_engine(
        None, cfg8, rows, texts, make=lambda: NavServingEngine.from_bundle(
            str(out_dir), cfg8, dict(model8.state_dict()), SERVE_SLOTS))
    bundle_diff, bundle_bits = compare_logits(served8_logits, fused8,
                                              "int8 bundle vs int8 create")
    print(f"  export_serving --int8 at r2r width in {export_s:.1f}s; "
          f"from_bundle vs create, {n_steps} steps: max|diff| "
          f"{bundle_diff:.3e} (equal bits: {bundle_bits})")
    report["int8_serving"] = {
        "steps": n_steps, "launches": launches, "wall_s": wall,
        "cosine_vs_f32_min": worst_cos,
        "max_diff_over_spread_vs_f32": worst_spread, "gemm": gemm,
        "card_vs_cpu_over_spread_tiny": step_err,
        "card_vs_cpu_over_spread_r2r": r2r_err,
        "cpu_one_ulp_over_spread_r2r": r2r_ulp, "export_s": export_s,
        "bundle_vs_create_max_abs_diff": bundle_diff,
        "bundle_vs_create_equal_bits": bundle_bits}


def int8_clip_path(report, dev_name):
    """(d) int8 CLIP at clip_b32() width: the int8 tower's tokens against
    the bf16 tower's on the same weights (cosine per token > 0.98), K2 and
    K3 counted, and views/s of both on 192 views."""
    ex = ClipFeatureExtractor(clip_b32(), device="cuda")
    ex8 = ClipFeatureExtractor(int8_cfg_clip(), device="cuda")
    ex8.model.load_state_dict(ex.model.state_dict())
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randint(0, 256, (PIPE_PANOS * VIEWS, 224, 224, 3),
                           generator=gen, device="cuda", dtype=torch.uint8)
    torch.cuda.synchronize()
    reset_counts()
    tokens8 = ex8.encode(images)
    torch.cuda.synchronize()
    launches = counts()
    require(launches["attention_qkv_fwd"] == 12
            and launches["layernorm_fwd"] == 26,
            f"int8 tower launches {launches}")
    tokens = ex.encode(images)
    require(tokens8.dtype == torch.bfloat16 and tokens8.shape == tokens.shape
            and torch.isfinite(tokens8).all().item(),
            "int8 tower: not finite bf16 tokens of the bf16 tower's shape")
    a = tokens8.float().reshape(-1, tokens.shape[-1])
    b = tokens.float().reshape(-1, tokens.shape[-1])
    cos = (F.cosine_similarity(a, b, dim=-1)).min().item()
    require(cos > CLIP_INT8_COS, f"int8 tower tokens: min cosine {cos:.4f}")
    views = images.shape[0]
    res = {"launches": launches, "min_token_cosine_vs_bf16": cos}
    for label, e in (("int8", ex8), ("bf16", ex)):
        for _ in range(3):
            e.encode(images)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            e.encode(images)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / 10
        res[f"{label}_views_per_s"] = views / sec
    print(f"  int8 clip_b32 tower, {views} views: launches {launches}; "
          f"min token cosine vs bf16 {cos:.5f} (gate {CLIP_INT8_COS}); "
          f"int8 {res['int8_views_per_s']:.1f} views/s, bf16 "
          f"{res['bf16_views_per_s']:.1f} views/s, host clock over 10 "
          f"[{dev_name}]")
    report["int8_clip"] = res


def int8_cfg_clip():
    return dataclasses.replace(clip_b32(), int8_matmuls=True)


def rel_close(a, b, tol):
    return abs(a - b) <= tol * max(abs(b), 1e-30)


def metrics_lines(path, key):
    return [rec[key] for rec in map(json.loads, Path(path).read_text()
                                    .splitlines()) if key in rec]


def mesh_train_navigator(out):
    """train_navigator(mesh=...) over NCCL at world size 1, r2r width, 2
    iterations (teacher, sample) with evaluation, against the same run
    without a mesh on the same seed: the losses, the best SPL, the first
    update's gradients and the weights after, MESH_REL_TOL relative.
    Returns the meshed run's launches."""
    import torch.distributed as dist

    from gridmm_tpu_torch.config import MeshConfig
    from gridmm_tpu_torch.parallel.mesh import init_world, make_mesh
    from gridmm_tpu_torch.utils.logging import MetricLogger

    cfg = dataclasses.replace(r2r_config(), train=dataclasses.replace(
        r2r_config().train, batch_size=LOOP_BATCH))
    runs = {}
    for meshed in (False, True):
        model = init_navigator(cfg.model, seed=1, device="cuda")
        agent, val_agent = synthetic_agents(model, cfg, LOOP_BATCH)
        log_dir = ROOT / "runs" / "chip_smoke" / f"mesh_loop_{meshed}"
        shutil.rmtree(log_dir, ignore_errors=True)
        logger = MetricLogger(str(log_dir))
        created = init_world("cuda") if meshed else False
        try:
            mesh = make_mesh(MeshConfig(), "cuda") if meshed else None
            if meshed:
                # the loss's global counts and the stray-key max run as
                # all-reduces over the data group of one
                backend = dist.get_backend(mesh.get_group(0))
                require(backend == "nccl", f"the mesh's data group runs "
                        f"{backend}, not NCCL")
            reset_counts()
            t0 = time.perf_counter()
            with recorded_grads(model) as grads:
                res = train_navigator(cfg, model, agent, val_agent,
                                      iters=LOOP_ITERS, log_every=1,
                                      eval_batches=1, seed=0, logger=logger,
                                      mesh=mesh)
            torch.cuda.synchronize()
            out[f"train_navigator_s_{'mesh' if meshed else 'plain'}"] = (
                time.perf_counter() - t0)
            if meshed:
                launches = counts()
        finally:
            logger.close()
            if created:
                dist.destroy_process_group()
        runs[meshed] = (metrics_lines(log_dir / "metrics.jsonl",
                                      "train/loss"), res, model.state_dict(),
                        grads)
        del agent, val_agent
    (l0, r0, s0, g0), (l1, r1, s1, g1) = runs[False], runs[True]
    require(len(l0) == LOOP_ITERS and all(rel_close(a, b, MESH_REL_TOL)
                                          for a, b in zip(l1, l0)),
            f"train_navigator with a mesh: losses {l1} against {l0}")
    require(r1.best_spl == r0.best_spl, f"best SPL {r1.best_spl} against "
            f"{r0.best_spl}")
    require(len(g0) == len(g1) == LOOP_ITERS,
            f"{len(g1)} and {len(g0)} optimizer steps, not {LOOP_ITERS}")
    # the first update's gradients: every leaf within MESH_REL_TOL of its
    # max, over a floor of 1e-6 of the largest leaf's max. Its forward is
    # the same in both runs (the losses agree to the bit); the second's
    # runs on weights that differ by rounding, so a ReLU input at zero may
    # switch and add one term to a gradient: its loss and the weights after
    # hold it
    grad_worst = compare_grads(g1[0], g0[0], MESH_REL_TOL,
                               "train_navigator with a mesh: gradients of "
                               "the first update")
    # the weights after the two updates of every leaf, likewise, those
    # whose gradient is rounding noise too (the key biases, and the biases
    # of the global action head's last two layers, which add the same to
    # every logit of its softmax; Adam steps them by up to ~lr on the
    # noise's sign): every operator of the update sums in a fixed order
    # (the pool's kernels, the fused logits' gather and the embeddings'
    # backward, models/layers.py; chip_profile.py --changing-ops names
    # none), so the two runs' noise is the same
    # how many leaves the two runs give different bits, update by update
    bits_apart = [sum(not torch.equal(a[k], b[k]) for k in b)
                  for a, b in zip(g1, g0)]
    weights_apart = sum(not torch.equal(s1[k], s0[k]) for k in s0)
    worst = compare_grads(s1, s0, MESH_REL_TOL,
                          "train_navigator with a mesh: weights")
    for n in ("grid_pool_fwd", "grid_pool_bwd1", "grid_pool_bwd2"):
        require(launches[n] > 0, f"{n} did not launch under the mesh")
    print(f"  train_navigator(mesh=(1, 1) over NCCL), r2r width, "
          f"{LOOP_ITERS} iterations: losses {l1} against {l0} without; "
          f"every leaf of the first update's gradients and of the weights "
          f"after within {MESH_REL_TOL} of its max plus 1e-6 of the largest "
          f"leaf's max (worst ratio over the leaves above that floor: "
          f"gradients {grad_worst:.2e}, weights {worst:.2e}); leaves whose "
          f"gradients differ in bits, by update: {bits_apart}, weights "
          f"after: {weights_apart}; "
          f"launches "
          f"{launches}; {out['train_navigator_s_mesh']:.2f}s against "
          f"{out['train_navigator_s_plain']:.2f}s without")
    out["train_navigator_launches"] = launches
    out["train_navigator"] = {"losses": l1, "plain_losses": l0,
                              "grads_worst_rel": grad_worst,
                              "weights_worst_rel": worst,
                              "grad_leaves_apart": bits_apart,
                              "weight_leaves_apart": weights_apart}
    return launches


def mesh_world1_path(report):
    """(d) the parallel layer at world size 1 over NCCL, in this process:
    train_navigator(mesh=...) at r2r width for 2 iterations, `pretrain
    --mesh auto --preset r2r` for one update and `run_ce --mesh auto
    --full` for one epoch, each against the same run without a mesh on
    the same seed (MESH_REL_TOL relative)."""
    out = {}
    total = {k.name: 0 for k in KERNELS}

    def add(c):
        for k, v in c.items():
            total[k] += v

    add(mesh_train_navigator(out))

    # pretrain --mesh auto --preset r2r, one update and its validation
    runs = {}
    for meshed in (False, True):
        d = ROOT / "runs" / "chip_smoke" / f"mesh_pretrain_{meshed}"
        shutil.rmtree(d, ignore_errors=True)
        reset_counts()
        t0 = time.perf_counter()
        pretrain_cli(["--steps", "1", "--valid_every", "1", "--tasks",
                      "mlm,sap", "--mix_ratio", "1,1"]
                     + (["--mesh", "auto", "--mp_size", "1"] if meshed
                        else []), d)
        torch.cuda.synchronize()
        out[f"pretrain_s_{'mesh' if meshed else 'plain'}"] = (
            time.perf_counter() - t0)
        if meshed:
            add(counts())
            out["pretrain_launches"] = counts()
        recs = [json.loads(x) for x in (d / "metrics.jsonl").read_text()
                .splitlines()]
        runs[meshed] = [(k, v) for r in recs for k, v in sorted(r.items())
                        if k != "step"]
    require([k for k, _ in runs[True]] == [k for k, _ in runs[False]]
            and all(rel_close(a, b, MESH_REL_TOL) for (_, a), (_, b)
                    in zip(runs[True], runs[False])),
            f"pretrain with a mesh: {runs[True]} against {runs[False]}")
    print(f"  pretrain --mesh auto --preset r2r, one update: {runs[True]} "
          f"against {runs[False]} without; launches "
          f"{out['pretrain_launches']}; {out['pretrain_s_mesh']:.2f}s "
          f"against {out['pretrain_s_plain']:.2f}s without (the CLI's "
          f"whole run)")
    out["pretrain"] = {"meshed": runs[True], "plain": runs[False]}

    # run_ce --mesh auto --full, one epoch of one batch and one eval batch
    runs = {}
    for meshed in (False, True):
        d = ROOT / "runs" / "chip_smoke" / f"mesh_ce_{meshed}"
        shutil.rmtree(d, ignore_errors=True)
        argv = ["--full", "--num_envs", str(CE_ENVS), "--epochs", "1",
                "--batches_per_epoch", "1", "--eval_batches", "1",
                "--max_steps", str(MESH_CE_STEPS), "--device", "cuda",
                "--seed", "0", "--output_dir", str(d)]
        reset_counts()
        t0 = time.perf_counter()
        metrics = run_ce_mod.main(argv + (["--mesh", "auto"] if meshed
                                          else []))
        torch.cuda.synchronize()
        out[f"run_ce_s_{'mesh' if meshed else 'plain'}"] = (
            time.perf_counter() - t0)
        if meshed:
            add(counts())
            out["run_ce_launches"] = counts()
        runs[meshed] = (metrics_lines(d / "metrics.jsonl", "ce_train/loss"),
                        metrics)
    (l0, m0), (l1, m1) = runs[False], runs[True]
    require(len(l1) == 1 and rel_close(l1[0], l0[0], MESH_REL_TOL)
            and m1.keys() == m0.keys()
            and all(rel_close(m1[k], m0[k], MESH_REL_TOL) for k in m0),
            f"run_ce with a mesh: loss {l1}, eval {m1} against {l0}, {m0}")
    print(f"  run_ce --mesh auto --full, one batch of {CE_ENVS} envs x "
          f"{MESH_CE_STEPS} steps and an eval batch: loss {l1} against "
          f"{l0}; eval equal; launches {out['run_ce_launches']}; "
          f"{out['run_ce_s_mesh']:.2f}s against {out['run_ce_s_plain']:.2f}s "
          f"without")
    out["run_ce"] = {"loss": l1, "plain_loss": l0, "eval": m1}
    out["launches"] = total
    report["mesh_world1"] = out


def dp_config():
    cfg = r2r_config()
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, hidden_dropout_prob=0.0,
                                  attention_probs_dropout_prob=0.0,
                                  feat_dropout=0.0),
        train=dataclasses.replace(cfg.train, grad_norm_clip=DP_CLIP,
                                  adam_eps=DP_EPS, loss_norm="actions"))


def dp_batch(cfg):
    """DP_B trajectories x 15 steps; the second half's targets ignored
    after step 4, so the two ranks' halves count 120 and 40 actions."""
    batch = synthetic_trajectory_batch(cfg, DP_B, TRAIN_STEPS, seed=0,
                                       device="cuda")
    target = batch.steps.target.clone()
    target[4:, DP_B // 2:] = cfg.train.ignoreid
    return batch._replace(steps=batch.steps._replace(target=target))


def dp_rank_update(rank, world, ref_path):
    """One rank of the two-rank update on the card (gloo): the rank's 8
    trajectories, one make_train_step update; rank 0 holds the updated
    weights against one process's (ref_path)."""
    from gridmm_tpu_torch.config import MeshConfig
    from gridmm_tpu_torch.parallel.mesh import (ShardedParams, data_rank,
                                                make_mesh,
                                                shard_trajectory_batch)

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dp_config()
    mesh = make_mesh(MeshConfig(), "cuda")
    model = init_navigator(cfg.model, seed=GRAD_SEED, device="cuda").train()
    sharded = ShardedParams(model, mesh)
    state = create_train_state(cfg, model, sharded=sharded)
    local = shard_trajectory_batch(dp_batch(cfg), data_rank(mesh), world)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    metrics = make_train_step(cfg)(state, local, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"loss": float(metrics["loss"]),
           "grad_norm": float(metrics["grad_norm"]),
           "launches": counts(), "update_s": wall,
           "local_batch": int(local.txt_ids.shape[0])}
    if rank == 0:
        # every leaf within 1e-5 of its max (compare_grads' floor covers
        # the key biases' rounding noise)
        ref = torch.load(ref_path, map_location="cuda", weights_only=True)
        out["weights_worst_rel"] = compare_grads(
            sharded.full_state_dict(), ref, 1e-5, "two ranks: weights")
    return out


def two_rank_dp_path(report):
    """(d) two ranks on the one card over gloo (NCCL refuses two ranks on
    one device; gloo takes CUDA tensors for all_reduce): one
    make_train_step update at r2r width, 16 trajectories split 8 + 8 with
    uneven action counts and the clip active, against one process on all
    16: the same loss and grad norm, each leaf within 1e-5 of its max; K1,
    K5a and K5b launch on each rank."""
    from gridmm_tpu_torch.parallel.dryrun import spawn_ranks

    cfg = dp_config()
    model = init_navigator(cfg.model, seed=GRAD_SEED, device="cuda").train()
    state = create_train_state(cfg, model)
    t0 = time.perf_counter()
    want = make_train_step(cfg)(state, dp_batch(cfg), seed=0)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    want = {k: float(v) for k, v in want.items()}
    require(want["grad_norm"] > DP_CLIP, f"the clip is not active: grad "
            f"norm {want['grad_norm']:.4f}")
    ref_path = ROOT / "runs" / "chip_smoke" / "dp_reference.pt"
    ref_path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(model.state_dict(), ref_path)
    del model, state
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_ranks(dp_rank_update, 2, str(ref_path), timeout=400)
    wall = time.perf_counter() - t0
    ref_path.unlink()
    for r, got in enumerate(ranks):
        require(got["local_batch"] == DP_B // 2, f"rank {r}'s batch")
        require(rel_close(got["loss"], want["loss"], 1e-6)
                and rel_close(got["grad_norm"], want["grad_norm"], 1e-5),
                f"rank {r}: loss {got['loss']} grad norm {got['grad_norm']}"
                f" against one process's {want}")
        for n in ("grid_pool_fwd", "grid_pool_bwd1", "grid_pool_bwd2"):
            require(got["launches"][n] > 0, f"rank {r}: {n} did not launch")
    print(f"  two ranks on one card over gloo, r2r width, {DP_B} "
          f"trajectories split 8 + 8 (120 and 40 actions), clip "
          f"{DP_CLIP} < grad norm {want['grad_norm']:.4f}: loss "
          f"{ranks[0]['loss']:.7f} against one process's "
          f"{want['loss']:.7f}; weights within "
          f"{ranks[0]['weights_worst_rel']:.2e} of each leaf's max; "
          f"launches per rank {[g['launches'] for g in ranks]}; update "
          f"{ranks[0]['update_s']:.2f}s a rank against {one_s:.2f}s in one "
          f"process; {wall:.1f}s with the ranks' start")
    report["two_rank_dp"] = {"ranks": ranks, "one_process": want,
                             "one_process_update_s": one_s, "wall_s": wall}


# ------------------------------------------------- (f) the entry points
# the K5 tolerances of tests/test_torch_cuda.py, relative to each gradient's
# max: K5a's d_fts (one product per element) and K5b's d_weights (S summed
# in another order than the plain version's)
POOL_BWD_DG_TOL, POOL_BWD_DW_TOL = 1e-5, 1e-4
ENTRY_UPDATES = 3                 # bench_train_update's timed updates here
ENTRY_CE_ROUNDS, ENTRY_CE_STEPS = 2, 6
ENTRY_LATENCY_STEPS = 20
ENTRY_POOL_ITERS = 10             # bench_pool_bwd's timed calls here (30)


def entry_point_run(report, name, fn, dev_name):
    """Launch counts set to 0, fn() run, the counts read: (fn's result,
    the launches, seconds)."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    res = fn()
    torch.cuda.synchronize()
    launches = counts()
    wall = time.time() - t0
    print(f"  {name}: {wall:.1f}s, launches {launches} [{dev_name}]")
    report["entry_points"][name] = {"launches": launches, "s": wall}
    return res, launches


def require_launched(launches, names, what):
    for n in names:
        require(launches[n] > 0, f"{what}: {n} did not launch")


def encoder_ops_refuse_backward(report):
    """The encoder kernels' ops on the card: each of K2, K3 and K4 through
    its dispatching function with inputs that need a gradient gives an
    output with a grad_fn, whose backward raises naming the op."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def t(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=dtype).requires_grad_(True)

    cases = (("attention_qkv_fwd", lambda: ATT.attention_qkv(
                 t(4, 50, 2304), 12)),
             ("attention_fwd", lambda: ATT.attention(
                 *(t(16, 50, 16, dtype=torch.float32) for _ in range(3)))),
             ("layernorm_fwd", lambda: LN.layernorm(
                 t(200, 768), t(768, dtype=torch.float32),
                 t(768, dtype=torch.float32))))
    out = {}
    for name, call in cases:
        before = counts()[name]
        y = call()
        require(counts()[name] == before + 1, f"{name} did not launch")
        require(y.grad_fn is not None, f"{name}: no grad_fn on the card")
        try:
            y.float().sum().backward()
        except RuntimeError as e:
            require(f"gridmm.{name}" in str(e), f"{name}: {e}")
            out[name] = str(e).splitlines()[0]
        else:
            raise AssertionError(f"a backward through {name} did not raise")
    print(f"  a backward through each encoder op raises: {out}")
    report["entry_points"]["backward_raises"] = out


def export_tower(tower, x, kernels):
    """torch.export of a tower on the card, its program run on x against
    the eager tower: (equal bits, the program's launches of `kernels`)."""
    with torch.no_grad():
        eager = tower(x)
        program = torch.export.export(tower, (x,))
        torch.cuda.synchronize()
        before = counts()
        got = program.module()(x)
        torch.cuda.synchronize()
    after = counts()
    targets = {str(n.target) for n in program.graph.nodes
               if n.op == "call_function"}
    for k in kernels:
        require(f"gridmm.{k}.default" in targets,
                f"the exported tower does not call gridmm::{k}")
    return torch.equal(got, eager), {k: after[k] - before[k]
                                     for k in kernels}


def exported_towers(report):
    """The encoder towers exported on the card: the clip_b32 tower (bf16;
    K2, K3) and the --tiny tower (head_dim 16; K4, K3) through
    torch.export; each program gives the eager tower's bits, one launch
    per layer and op."""
    clip = init_clip_vision(clip_b32(), seed=0, device="cuda")
    rng = np.random.default_rng(0)
    u8 = torch.from_numpy(rng.integers(0, 256, (PIPE_PANOS * VIEWS, 224,
                                               224, 3)).astype(np.uint8))
    x = clip_mod.normalize_images(u8.cuda())
    bits, launches = export_tower(clip, x, ("attention_qkv_fwd",
                                            "layernorm_fwd"))
    require(bits, "the exported clip_b32 tower's tokens differ from eager")
    require(launches == {"attention_qkv_fwd": 12, "layernorm_fwd": 26},
            f"exported clip_b32 tower launches {launches}")
    tiny = ClipVisionConfig(input_resolution=224, patch_size=32, width=64,
                            layers=1, heads=4, compute_dtype="float32")
    bits_t, launches_t = export_tower(init_clip_vision(tiny, seed=5,
                                                       device="cuda"),
                                      x[:24], ("attention_fwd",
                                               "layernorm_fwd"))
    require(bits_t, "the exported tiny tower's tokens differ from eager")
    require(launches_t["attention_fwd"] == 1,
            f"exported tiny tower launches {launches_t}")
    print(f"  torch.export on the card: clip_b32 bf16 over "
          f"{PIPE_PANOS * VIEWS} views, launches {launches}, equal bits; "
          f"tiny tower over 24 views, launches {launches_t}, equal bits")
    report["entry_points"]["exported_towers"] = {
        "clip_b32": launches, "tiny": launches_t}


def int8_mesh_bundle(report):
    """int8 serving over a mesh on the card: `export_serving --int8 --mesh
    auto` over a world of one (NCCL) at r2r width and 4 slots, against the
    unsharded `--int8` bundle that phase (d) exported (exported here where
    phase d did not run, as under --entry-only). Both are served by
    from_bundle on the same seeded weights, the sharded one on that world,
    eager both (the absmax MAXes are NCCL all-reduces over the groups of
    one): equal bits over 3 steps."""
    import io

    import torch.distributed as dist

    from gridmm_tpu_torch.config import MeshConfig
    from gridmm_tpu_torch.parallel.mesh import init_world, make_mesh

    cfg8 = int8_cfg(r2r_config())
    root = ROOT / "runs" / "chip_smoke" / "int8_mesh"
    shutil.rmtree(root, ignore_errors=True)
    common = ["--config", "r2r", "--int8", "--batch", str(SERVE_SLOTS),
              "--device", "cuda"]
    t0 = time.time()
    # the CLI prints its manifest, every parameter's placement included
    with contextlib.redirect_stdout(io.StringIO()):
        if not any(INT8_BUNDLE.glob("*.pt2")):
            shutil.rmtree(INT8_BUNDLE, ignore_errors=True)
            export_cli_mod.main(common + ["--out_dir", str(INT8_BUNDLE)])
        man = export_cli_mod.main(common + ["--mesh", "auto", "--out_dir",
                                            str(root)])
    export_s = time.time() - t0
    require(man["int8"] is True and man["mesh"]["data"] == 1,
            f"the sharded int8 manifest: {man.get('mesh')}")
    sd = dict(init_navigator(cfg8.model, seed=BUNDLE_SEED,
                             device="cuda").state_dict())
    rng = np.random.default_rng(4)
    steps = [{s: step_row(cfg8, rng, t) for s in range(SERVE_SLOTS)}
             for t in range(3)]
    texts = [request_text(cfg8, rng) for _ in range(SERVE_SLOTS)]

    def serve(d):
        eng = NavServingEngine.from_bundle(str(d), cfg8, sd, SERVE_SLOTS,
                                           cuda_graph=False)
        for r, (ids, m) in enumerate(texts):
            eng.submit(r, ids, m)
        eng.admit()
        return [eng.step(x).fused_logits for x in steps]

    one = serve(INT8_BUNDLE)
    require(init_world("cuda"), "a process group was already up")
    try:
        mesh = make_mesh(MeshConfig(), "cuda")
        backend = dist.get_backend(mesh.get_group(0))
        require(backend == "nccl", f"the mesh runs {backend}, not NCCL")
        meshed = serve(root)
    finally:
        dist.destroy_process_group()
    diff, bits = compare_logits(meshed, one, "int8 sharded vs unsharded")
    require(bits, f"int8 bundle over a mesh of one: max|diff| {diff:.3e}, "
            f"not the unsharded bundle's bits")
    for d in (root, INT8_BUNDLE):
        for p in d.rglob("*.pt2"):
            p.unlink()
    print(f"  export_serving --int8 --mesh auto (world of one, NCCL), r2r "
          f"width, {SERVE_SLOTS} slots: serves the unsharded --int8 "
          f"bundle's bits over 3 steps (export {export_s:.1f}s)")
    report["entry_points"]["int8_mesh"] = {"equal_bits": bits,
                                           "export_s": export_s}


def entry_points_phase(report, dev_name):
    """(f) each entry point of the port on the card at full width through
    its module function, with the launch counts set to 0 before it and
    read after it; then the encoder kernels' ops and int8 serving over a
    mesh."""
    from gridmm_tpu_torch import entry as entry_mod
    from gridmm_tpu_torch.cli import bench as bench_mod
    from gridmm_tpu_torch.cli import bench_ce_step as bench_ce_mod
    from gridmm_tpu_torch.cli import bench_latency as latency_mod
    from gridmm_tpu_torch.cli import bench_pool_bwd as pool_bwd_mod
    from gridmm_tpu_torch.cli import bench_train_update as update_mod
    from gridmm_tpu_torch.cli import drive_episode as drive_mod
    from gridmm_tpu_torch.cli import run_synthetic_eval as eval_mod

    report["entry_points"] = {}
    rec, la = entry_point_run(report, "bench", bench_mod.run, dev_name)
    print(f"  {json.dumps(rec)}")
    require(rec["value"] > 0 and rec["vs_baseline"] is None
            and rec["backend"] == "cuda", f"bench: {rec}")
    fills = r2r_config().grid.max_steps - 1 + 20
    require(la["grid_pool_fwd"] == fills
            and la["attention_qkv_fwd"] == 12 * fills
            and la["layernorm_fwd"] == 26 * fills,
            f"bench: launches {la} in {fills} iterations")
    report["entry_points"]["bench"]["record"] = rec

    lat, la = entry_point_run(report, "bench_latency", lambda: latency_mod.run(
        steps=ENTRY_LATENCY_STEPS), dev_name)
    require_launched(la, ("grid_pool_fwd",), "bench_latency")
    report["entry_points"]["bench_latency"]["p50_p90_ms"] = {
        str(b): v for b, v in lat.items()}

    pool, la = entry_point_run(report, "bench_pool_bwd", lambda:
                               pool_bwd_mod.run(iters=ENTRY_POOL_ITERS),
                               dev_name)
    require_launched(la, ("grid_pool_fwd", "grid_pool_bwd1",
                          "grid_pool_bwd2"), "bench_pool_bwd")
    for shape, r in pool.items():
        require(r["rel_grad_err"]["d_fts"] < POOL_BWD_DG_TOL
                and r["rel_grad_err"]["d_weights"] < POOL_BWD_DW_TOL,
                f"bench_pool_bwd {shape}: gradients {r['rel_grad_err']}")
    report["entry_points"]["bench_pool_bwd"]["results"] = {
        str(k): v for k, v in pool.items()}

    upd, la = entry_point_run(
        report, "bench_train_update", lambda: update_mod.run_one(
            16, "float32", iters=ENTRY_UPDATES, device="cuda"), dev_name)
    n = (ENTRY_UPDATES + 1) * TRAIN_STEPS
    require(la["grid_pool_bwd1"] == la["grid_pool_bwd2"] == n
            and la["grid_pool_fwd"] == 2 * n,
            f"bench_train_update: launches {la} in {ENTRY_UPDATES + 1} "
            f"updates of {TRAIN_STEPS} steps")
    require(math.isfinite(upd["loss"]), f"bench_train_update: {upd}")
    report["entry_points"]["bench_train_update"]["result"] = upd

    # one full CE agent with the view tower for both paths (the first run
    # builds it)
    agent = [None]

    def ce_run(legacy):
        if agent[0] is None:
            agent[0] = build_ce_agent(img=224, tiny=False, view_tower=True,
                                      device="cuda")[1]
        return bench_ce_mod.run(batches=(CE_ENVS,), steps=ENTRY_CE_STEPS,
                                rounds=ENTRY_CE_ROUNDS, legacy=legacy,
                                agent=agent[0])

    for legacy in (False, True):
        name = "bench_ce_step" + (" --legacy" if legacy else "")
        ce, la = entry_point_run(report, name, lambda: ce_run(legacy),
                                 dev_name)
        require_launched(la, ("grid_pool_fwd", "attention_qkv_fwd",
                              "layernorm_fwd"), name)
        report["entry_points"][name]["result"] = ce[CE_ENVS]
    del agent

    ep, la = entry_point_run(report, "drive_episode", drive_mod.run,
                             dev_name)
    require(la["grid_pool_fwd"] == 4 and len(ep["steps"]) == 3,
            f"drive_episode: launches {la}")

    (avg, preds), la = entry_point_run(
        report, "run_synthetic_eval", eval_mod.run, dev_name)
    require(all(math.isfinite(avg[k]) for k in eval_mod.METRICS)
            and len(preds) == 9, f"run_synthetic_eval: {avg}")
    require_launched(la, ("grid_pool_fwd",), "run_synthetic_eval")
    report["entry_points"]["run_synthetic_eval"]["metrics"] = {
        k: avg[k] for k in eval_mod.METRICS}

    def entry_check():
        fn, args = entry_mod.entry("cuda")
        with torch.no_grad():
            eager = fn(*args)
            got = entry_mod.compile_check(fn, args).module()(*args)
        return eager, got

    (eager, got), la = entry_point_run(report, "entry", entry_check,
                                       dev_name)
    diff, bits = compare_logits([got], [eager], "entry() exported vs eager")
    require(la["grid_pool_fwd"] == 2, f"entry(): launches {la}")
    print(f"  entry(): fused_logits {tuple(eager.shape)}, the exported "
          f"program against eager fn max|diff| {diff:.3e} (equal bits: "
          f"{bits})")
    report["entry_points"]["entry"].update(max_abs_diff=diff,
                                           equal_bits=bits)
    for check in (encoder_ops_refuse_backward, exported_towers,
                  int8_mesh_bundle):
        t0 = time.time()
        check(report)
        print(f"    {check.__name__}: {time.time() - t0:.1f}s")


def write_report(report, name):
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / name).write_text(json.dumps(report, indent=1, default=str))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    # --ce-only: (a), (b) and the VLN-CE phases alone, for iterating on
    # that path; it prints no result line
    ce_only = argv == ["--ce-only"]
    # --entry-only: (a), (b) and the entry points' phase (f) alone, for
    # iterating on that phase; it prints no result line
    entry_only = argv == ["--entry-only"]
    require(not argv or ce_only or entry_only, f"unknown arguments {argv}")
    # (a) device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev_name = card()
    print(f"(a) card: {dev_name}")
    print(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    report = {"card": dev_name}

    # (b) build
    t0 = time.time()
    logs = build.build_all(SOURCES)
    build_s = time.time() - t0
    print(f"(b) built {sorted(logs) or 'nothing (current)'} in "
          f"{build_s:.1f}s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")
    report["build_s"] = build_s
    phase_s = {"b": build_s}
    report["phase_s"] = phase_s
    if ce_only:
        ce_phases(report, phase_s)
        write_report(report, "chip_smoke_ce_report.json")
        print(f"card: {dev_name}")
        return 0
    if entry_only:
        t_phase = time.time()
        print("(f) the entry points")
        entry_points_phase(report, dev_name)
        phase_s["f"] = time.time() - t_phase
        print(f"    phase (f): {phase_s['f']:.1f}s")
        write_report(report, "chip_smoke_entry_report.json")
        print(f"card: {dev_name}")
        return 0

    # (d) main paths
    t_phase = time.time()
    print("(d) main path: serving engine, r2r_config() width")
    cfg, rows, texts, fused_f32 = main_path(report)
    report["tiny_cpu_vs_card_max_abs_diff"] = tiny_cpu_reference()
    print("(d) main path: CLIP extractor and encode_and_pool, clip_b32() "
          "width")
    extractor_path(report)
    pipeline_path(report)
    print("(d) per-head attention paths: the --tiny tower and a tower at "
          "ViT-H/14 widths")
    tiny_tower_path(report)
    vit_h14_tower_path(report)
    print("(d) main path: training, r2r_config() width")
    training_path(report)
    report["tiny_update_cpu_vs_card_worst_grad_ratio"] = \
        tiny_update_cpu_reference()
    phase_s["d_before_real_data"] = time.time() - t_phase
    t_phase = time.time()
    print("(d) main path: real data (main_nav --world r2r on gmmstore "
          "files) and the serving bundle, r2r_config() width")
    real_data_path(report)
    bundle_path(report, cfg, rows, texts, dev_name)
    phase_s["d_real_data_and_bundle"] = time.time() - t_phase
    t_phase = time.time()
    print("(d) main path: pretraining at r2r width (cli/pretrain.main, "
          "12,416-point buffer) and released-checkpoint import")
    pretraining_path(report)
    checkpoint_import_path(report, cfg, rows, texts, dev_name)
    phase_s["d_pretrain_and_import"] = time.time() - t_phase
    print(f"    phase (d): {phase_s['d_before_real_data']:.1f}s, then "
          f"{phase_s['d_real_data_and_bundle']:.1f}s for real data and the "
          f"bundle, {phase_s['d_pretrain_and_import']:.1f}s for "
          f"pretraining and the import")
    ce_phases(report, phase_s)
    t_phase = time.time()
    print("(d) int8 serving at r2r_config() width and the int8 clip_b32 "
          "tower")
    int8_serving_path(report, cfg, rows, texts, fused_f32)
    int8_clip_path(report, dev_name)
    phase_s["d_int8"] = time.time() - t_phase
    t_phase = time.time()
    print("(d) the parallel layer: a mesh of one rank over NCCL, then two "
          "ranks on the one card over gloo")
    mesh_world1_path(report)
    two_rank_dp_path(report)
    phase_s["d_parallel"] = time.time() - t_phase
    print(f"    int8 {phase_s['d_int8']:.1f}s, parallel layer "
          f"{phase_s['d_parallel']:.1f}s")

    # (f) the entry points
    torch.cuda.empty_cache()
    t_phase = time.time()
    print("(f) the entry points: bench, bench_latency, bench_pool_bwd, "
          "bench_train_update, bench_ce_step, drive_episode, "
          "run_synthetic_eval, entry(); the encoder kernels' ops; int8 "
          "over a mesh")
    entry_points_phase(report, dev_name)
    phase_s["f"] = time.time() - t_phase
    print(f"    phase (f): {phase_s['f']:.1f}s")
    print("(d, last) a serving step that cannot be captured")
    report["bundle"]["failed_capture"] = check_failed_capture(cfg)
    write_report(report, "chip_smoke_report.json")

    # (h) result line
    print(f"card: {dev_name}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (gridmm_tpu_torch) on one card.

    python3 chip_smoke.py

Needs one NVIDIA Hopper card and the CUDA toolkit; imports nothing of JAX.
Phases, in order (any failure raises and the exit code is not 0):

  (a) device: require CUDA, print the card's name and power limit, TF32 off;
  (b) build every kernel of the main paths from csrc/ (one nvcc per source,
      all at once);
  (c) each kernel against its plain PyTorch version on the card, f32 and
      bf16: the grid pool (K1: pooled, mask, denominator and cell max, with
      an all-invalid row, a row whose points sit 90% in one cell, and two
      runs that must give equal bits), LayerNorm (K3), packed-qkv attention
      (K2: bf16 on the tensor cores, also at L = 1, 17 and 64; f32 on the
      CUDA cores), per-head attention (K4) and the two passes of the pool's
      backward (K5a, K5b);
  (d) the main paths, each driven with every launch count set to 0 just
      before it and read just after:
      - the serving engine at full R2R width (r2r_config(), seeded random
        weights) answers 6 requests over 4 slots; logits are checked and the
        same steps rerun with the plain ops must agree; then a tiny-width
        step on the card must agree with the same step on the CPU;
      - ClipFeatureExtractor.run at clip_b32() width over 32 synthetic
        panoramas (batch 16), bf16, rerun with the plain ops; the same in
        f32 over 4 panoramas;
      - encode_and_pool, 16 panoramas x 12 views, iterated until the point
        buffer fills (15 x 588 of 8832 points), bf16 buffer, rerun with the
        plain ops; the same in f32 for 3 iterations;
      - the --tiny preprocess tower (head_dim 16: the per-head kernel) on the
        card against the same tower on the CPU;
      - training at full R2R width: train_navigator over the synthetic
        world (one teacher and one sample iteration, with evaluation), then
        on freshly seeded weights three make_train_step updates on one
        synthetic batch of cfg.train.batch_size trajectories x 15 steps; the
        loss must fall, the backward kernels must launch once per step and
        update, the same loss and gradients through the plain ops (run
        reproducibly) must agree, and a tiny update on the card must agree
        with the same on the CPU;
  (e) times with CUDA events (kernel, plain version, library yardstick,
      bound; the pool at the serving, pipeline and train shapes), encode
      and pipeline views/s, the pipeline's peak device memory,
      the serving step time, and the train update's time and peak memory,
      each beside the card;
  (f) the kernels line; (g) the result line, last.

A longer report goes to chiprun_out/chip_smoke_report.json.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
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
                                                 GRID_POOL_FWD, grid_pool_bwd)
from gridmm_tpu_torch.ops.cuda.layernorm import LAYERNORM_FWD
from gridmm_tpu_torch.pipeline import encode_and_pool
from gridmm_tpu_torch.serve.engine import NavServingEngine
from gridmm_tpu_torch.env.discrete import DiscreteNavEnv, synthetic_episodes
from gridmm_tpu_torch.env.world import SyntheticWorld
from gridmm_tpu_torch.train.agent import NavAgent
from gridmm_tpu_torch.train.loop import train_navigator
from gridmm_tpu_torch.train.step import (StepInputs, create_train_state,
                                         init_carry, make_train_step,
                                         nav_device_step, trajectory_loss)
from gridmm_tpu_torch.train.synthetic import synthetic_trajectory_batch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
# peak operation rates by input type (H100 SXM data sheet): bf16 products on
# the tensor cores; f32 at full precision outside them
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
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
POOL_B, POOL_N, POOL_D = 8, 8832, 768
SERVE_SLOTS, FIRST_STEPS, LATER_STEPS = 4, 15, 3
# fused logits, kernel pool vs plain pool through the full-width navigator
# in f32 (TF32 off): the pools differ only in summation order (~1e-6
# relative), which 13 transformer layers may amplify to ~1e-5
LOGIT_TOL = 1e-4
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


def cuda_ms(fn, iters=25, warmup=5) -> float:
    """Mean device ms per call over `iters` calls, CUDA events, after
    warm-up. The stream is held by a spin kernel while the host enqueues the
    calls, so the events time them back to back on the device and a call
    shorter than its Python wrapper is not timed at the host's pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # twice the measured enqueue time at <= 2 GHz, plus 2 ms
    torch.cuda._sleep(int((2.0 * enqueue_s + 2e-3) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ inputs
def pool_case(kind, b, dtype, seed=0, n=POOL_N, d=POOL_D):
    """Pool inputs: random cells with ~5% invalid; "edges" adds an
    all-invalid row, a one-point cell (2, 7) and empty cells (row 3 < 50);
    "skew" a row where cell 17 holds 90% of the points and an all-invalid
    row."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((b, n, d)).astype(np.float32)
    cells = rng.integers(0, 196, size=(b, n)).astype(np.int32)
    cells[rng.random((b, n)) < 0.05] = -1
    w = (rng.standard_normal((b, n)) * 3.0).astype(np.float32)
    if kind == "edges":
        cells[1] = -1
        cells[2][cells[2] == 7] = 8
        cells[2, 100] = 7
        cells[3][cells[3] < 50] = 60
    if kind == "skew":
        cells[0][rng.random(n) < 0.9] = 17
        cells[1] = -1
    return (torch.from_numpy(g).to("cuda", dtype),
            torch.from_numpy(cells).cuda(), torch.from_numpy(w).cuda())


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
def check_pool_kernel(report):
    """(c) kernel vs plain on the card: mask exact; cell max equal to
    `cell_max` (-inf for empty cells); pooled within 1e-5 x max|pooled|
    (f32) or one bf16 ulp of the inputs, 2^-8 x max|g| (bf16); denominator
    within 1e-5 relative, its padding 0; a second run on the same inputs
    gives the same bits in every output."""
    worst = 0.0
    for b in (POOL_B, SERVE_SLOTS):
        for dtype in (torch.float32, torch.bfloat16):
            for kind in ("random", "edges", "skew"):
                g, cells, w = pool_case(kind, b, dtype)
                got = GRID_POOL_FWD(g, cells, w)
                again = GRID_POOL_FWD(g, cells, w)
                got_p, got_m, got_d, got_x = got
                want_p, want_m, want_d = GP.grid_scatter_pool_raw(g, cells, w)
                torch.cuda.synchronize()
                require(all(torch.equal(x, y) for x, y in zip(got, again)),
                        f"two runs differ in bits ({b}, {dtype}, {kind})")
                require(got_m.dtype == torch.bool
                        and torch.equal(got_m, want_m),
                        f"cell mask differs ({b}, {dtype}, {kind})")
                require(torch.equal(got_x, GP.cell_max(cells, w)),
                        f"cell max differs ({b}, {dtype}, {kind})")
                atol = (1e-5 * want_p.abs().max().item()
                        if dtype == torch.float32
                        else 2.0 ** -8 * g.float().abs().max().item())
                torch.testing.assert_close(got_p, want_p, rtol=1e-5,
                                           atol=atol)
                torch.testing.assert_close(got_d, want_d, rtol=1e-5, atol=0)
                require((got_d[:, 196:] == 0).all().item(),
                        "denominator padding is not 0")
                if kind != "random":
                    require(not got_m[1].any() and (got_p[1] == 0).all()
                            and (got_d[1] == 0).all()
                            and (got_x[1] == float("-inf")).all(),
                            "all-invalid row is not empty")
                if kind == "edges":
                    require(got_m[2, 7] and not got_m[3, :50].any(),
                            "one-point or empty cells wrong")
                err = (got_p - want_p).abs().max().item()
                worst = max(worst, err)
                print(f"  grid_pool_fwd B={b} {str(dtype)[6:]:8s} {kind:6s}: "
                      f"max|pooled diff| {err:.3e} (atol {atol:.3e}), "
                      f"max|denom diff| "
                      f"{(got_d - want_d).abs().max().item():.3e}, two runs "
                      f"equal bit for bit")
                del g, cells, w, got, again, want_p
    report["grid_pool_fwd"]["max_abs_err"] = worst


def bwd_inputs(g, cells, w, seed):
    """The forward's residuals (kernel) and a random cotangent for (g, cells,
    w) on the card."""
    b, _, d = g.shape
    _, _, denom, cmax = GRID_POOL_FWD(g, cells, w)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cot = torch.randn((b, 196, d), generator=gen, device="cuda")
    return cmax, denom, cot


def check_pool_bwd_kernels(report):
    """(c) K5a and K5b against grid_pool_bwd_terms on the card, B = 4 and
    16, N = 8820 (the stacked buffer: 15 x 588, not a multiple of 512) and
    8832, D = 768, f32 and bf16 features, random and edges.
      dg: f32 within 1e-5 x max|dg| (one product on each side); bf16 within
          one bf16 ulp of each value (2^-7 relative: both sides round the
          same f32 product, which may sit on a rounding boundary);
      s:  within 1e-5 x max|s| (a 768-term f32 dot product, other order);
      S, dw: within 1e-4 x their max (S adds ~45 terms per cell with f32
          atomics in an order that varies from run to run)."""
    worst = {"grid_pool_bwd1": 0.0, "grid_pool_bwd2": 0.0}
    for kind in ("random", "edges"):
        base = pool_case(kind, 16, torch.float32, seed=3)
        for b in (4, 16):
            for n in (8820, 8832):
                for dtype in (torch.float32, torch.bfloat16):
                    g, cells, w = (base[0][:b, :n].to(dtype).contiguous(),
                                   base[1][:b, :n].contiguous(),
                                   base[2][:b, :n].contiguous())
                    cmax, denom, cot = bwd_inputs(g, cells, w, seed=b + n)
                    got = grid_pool_bwd(g, cells, w, cmax, denom, cot)
                    want = GP.grid_pool_bwd_terms(g, cells, w, denom, cot)
                    torch.cuda.synchronize()
                    require(got[0].dtype == dtype
                            and got[1].dtype == torch.float32,
                            "gradient dtypes")
                    dg, want_dg = got[0].float(), want[0].float()
                    if dtype == torch.float32:
                        torch.testing.assert_close(
                            dg, want_dg, rtol=0,
                            atol=1e-5 * want_dg.abs().max().item())
                    else:
                        torch.testing.assert_close(dg, want_dg,
                                                   rtol=2.0 ** -7, atol=1e-30)
                    errs = {"dg": (dg - want_dg).abs().max().item()}
                    for name, a, ref, tol in (("dw", got[1], want[1], 1e-4),
                                              ("s", got[2], want[2], 1e-5),
                                              ("S", got[3], want[3], 1e-4)):
                        torch.testing.assert_close(
                            a, ref, rtol=0,
                            atol=tol * ref.abs().max().item(),
                            msg=lambda m, name=name: f"{name}: {m}")
                        errs[name] = (a - ref).abs().max().item()
                    if kind == "edges":
                        invalid = cells < 0
                        require((dg[1] == 0).all() and (got[1][1] == 0).all()
                                and (dg[invalid] == 0).all()
                                and (got[1][invalid] == 0).all(),
                                "invalid points have a gradient")
                        require(got[1][2, 100].abs().item() <= 1e-6,
                                "one-point cell: dw is not 0")
                    worst["grid_pool_bwd1"] = max(worst["grid_pool_bwd1"],
                                                  errs["dg"], errs["s"])
                    worst["grid_pool_bwd2"] = max(worst["grid_pool_bwd2"],
                                                  errs["dw"])
                    print(f"  grid_pool_bwd B={b} N={n} {str(dtype)[6:]:8s} "
                          f"{kind:6s}: max|diff| dg {errs['dg']:.3e} s "
                          f"{errs['s']:.3e} S {errs['S']:.3e} dw "
                          f"{errs['dw']:.3e} (max|dw| "
                          f"{want[1].abs().max().item():.3e})")
                    del g, cells, w, cmax, denom, cot, got, want, dg, want_dg
        del base
    for name, err in worst.items():
        report[name]["max_abs_err"] = err


def run_engine(model, cfg, rows, texts):
    """Drive a 4-slot engine through the request schedule, checking every
    step. Returns (per-step fused logits on the host, the engine)."""
    eng = NavServingEngine.create(model, cfg, SERVE_SLOTS)
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
    steps through the plain pool; returns the warm engine and its config."""
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
    launches = counts()
    n_steps = FIRST_STEPS + LATER_STEPS
    print(f"  served {n_req} requests over {SERVE_SLOTS} slots in {n_steps} "
          f"steps ({wall:.2f}s with first-call overheads); buffer count "
          f"{eng._carry.point_state.count.tolist()}")
    print(f"  launches during the serving path: {launches}")
    require(launches["grid_pool_fwd"] == n_steps,
            f"grid_pool_fwd launched {launches['grid_pool_fwd']} times in "
            f"{n_steps} steps")
    report["grid_pool_fwd"]["launches"] = launches["grid_pool_fwd"]

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
    return eng, cfg, rows


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


def pool_bytes(g, cells):
    """Bytes the pool must move for these inputs: the features of valid
    points, every cell id and weight, and the outputs (pooled f32, mask,
    denominator, cell max)."""
    b, n, d = g.shape
    valid = int(((cells >= 0) & (cells < 196)).sum())
    return (valid * d * g.element_size() + b * n * 8
            + b * 196 * d * 4 + b * 196 + b * 256 * 4 + b * 196 * 4)


def time_pool(g, cells, w, label, dev_name):
    """(e) times of one pool configuration; returns a dict of ms. `ms` is
    the dispatching pool as the main paths call it (allocations and the one
    launch), `kernel_only_ms` the bare launch into preallocated outputs."""
    b, n, d = g.shape
    outs = GRID_POOL_FWD(g, cells, w)
    cmax = outs[3]
    # yardstick: index_add_ of the pre-weighted features into (B*256, D)
    # rows (invalid points go to each row's unused cell 255)
    valid = (cells >= 0) & (cells < 196)
    cidx = torch.where(valid, cells, torch.zeros_like(cells)).long()
    e = torch.exp(w - cmax.gather(1, cidx)).masked_fill(~valid, 0.0)
    src = (e[..., None] * g.float()).reshape(-1, d)
    rows = (torch.arange(b, device="cuda")[:, None] * 256
            + torch.where(valid, cidx, torch.full_like(cidx, 255))
            ).reshape(-1)
    flat = torch.zeros((b * 256, d), device="cuda")
    before = GRID_POOL_FWD.launches
    times = {
        "ms": cuda_ms(lambda: GP.grid_pool_raw(g, cells, w)),
        "kernel_only_ms": cuda_ms(lambda: GRID_POOL_FWD.launch(
            g, cells, w, *outs)),
        "plain_ms": cuda_ms(lambda: GP.grid_scatter_pool_raw(g, cells, w),
                            iters=10, warmup=2),
        "library_ms": cuda_ms(lambda: flat.index_add_(0, rows, src),
                              iters=10, warmup=2),
    }
    require(GRID_POOL_FWD.launches > before, "timed pool did not launch")
    times["bound_ms"] = pool_bytes(g, cells) / HBM_BYTES_PER_S * 1e3
    times["bound_by"] = "bytes"
    times["shape"] = label
    # how the points spread over the cells: one block owns a whole cell, so
    # a cell that holds much of a row sets the kernel's time
    per_cell = torch.zeros((b, 256), device="cuda").scatter_add_(
        1, cidx, valid.float())
    times["valid_fraction"] = valid.float().mean().item()
    times["largest_cell_share"] = (
        per_cell.amax(dim=1) / per_cell.sum(dim=1).clamp_min(1)).max().item()
    print(f"  grid_pool_fwd {label}: pool {times['ms']:.4f} ms (kernel alone "
          f"{times['kernel_only_ms']:.4f}), plain {times['plain_ms']:.4f}, "
          f"index_add_ {times['library_ms']:.4f}, byte bound "
          f"{times['bound_ms']:.4f} ms; {100 * times['valid_fraction']:.1f}% "
          f"of the points valid, the fullest cell holds "
          f"{100 * times['largest_cell_share']:.1f}% of its row's "
          f"[{dev_name}]")
    return times


# ------------------------------------------------ (c) the encoder's kernels
def check_layernorm_kernel(report):
    """(c) K3 vs plain at the tower's rows (192 images x 50 tokens, C=768)
    and at C=64 (the tiny tower): f32 within 1e-5 (summation order), bf16
    within one bf16 ulp (2^-7 relative: both round nearly one f32 value)."""
    worst = 0.0
    rng = np.random.default_rng(11)
    for rows, c in ((9600, 768), (2400, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy((rng.standard_normal((rows, c)) * 2.0 + 0.5
                                  ).astype(np.float32)).to("cuda", dtype)
            w = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(
                np.float32)).cuda()
            b = torch.from_numpy((rng.standard_normal(c) * 0.1).astype(
                np.float32)).cuda()
            got = LAYERNORM_FWD(x, w, b)
            want = LN.layernorm_plain(x, w, b)
            torch.cuda.synchronize()
            rtol, atol = ((1e-5, 1e-5) if dtype == torch.float32
                          else (2.0 ** -7, 1e-5))
            torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                       atol=atol)
            err = (got.float() - want.float()).abs().max().item()
            worst = max(worst, err)
            print(f"  layernorm_fwd ({rows}, {c}) {str(dtype)[6:]:8s}: "
                  f"max|diff| {err:.3e} (rtol {rtol:.1e})")
    report["layernorm_fwd"]["max_abs_err"] = worst


def attn_atol(dtype, v):
    """f32: 2e-5 (summation order, online softmax); bf16: the plain version
    rounds the probabilities to bf16 before PV and both round the output,
    each within 2^-8 relative, so 2^-6 x max|v| bounds the difference."""
    if dtype == torch.float32:
        return 2e-5
    return 2.0 ** -6 * v.float().abs().max().item()


def check_attention_kernels(report):
    """(c) K2 at clip_b32 (192, 50, 2304) and B/16 (32, 197, 2304), and in
    bf16 (the tensor-core body) at L = 1, 17 and 64, the edges of its
    16-key and 64-query tiles; K4 at hd 16, 64 and 128 with L = 50 and 197;
    both dtypes. Inputs at scale 2.0 give peaked softmaxes, so a fragment
    read from the wrong lane shows."""
    rng = np.random.default_rng(12)
    worst = {"attention_qkv_fwd": 0.0, "attention_fwd": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        edges = ((8, 1), (8, 17), (8, 64)) if dtype == torch.bfloat16 else ()
        for b, length in ((192, 50), (32, 197)) + edges:
            qkv = torch.from_numpy((rng.standard_normal((b, length, 2304))
                                    * 2.0).astype(np.float32)).to("cuda",
                                                                  dtype)
            got = ATTENTION_QKV_FWD(qkv, 12)
            want = ATT.attention_qkv_plain(qkv, 12)
            torch.cuda.synchronize()
            atol = attn_atol(dtype, qkv[..., 1536:])
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=2e-5 if atol == 2e-5 else 0.0,
                                       atol=atol)
            require(got.shape == want.shape and got.dtype == dtype,
                    "attention_qkv_fwd: output shape or type")
            err = (got.float() - want.float()).abs().max().item()
            worst["attention_qkv_fwd"] = max(worst["attention_qkv_fwd"], err)
            print(f"  attention_qkv_fwd ({b}, {length}, 2304) "
                  f"{str(dtype)[6:]:8s}: max|diff| {err:.3e} "
                  f"(atol {atol:.3e})")
        for hd in (16, 64, 128):
            for length in (50, 197):
                q, k, v = (torch.from_numpy((rng.standard_normal(
                    (768, length, hd)) * 2.0).astype(np.float32)).to(
                        "cuda", dtype) for _ in range(3))
                got = ATTENTION_FWD(q, k, v)
                want = ATT.attention_plain(q, k, v)
                torch.cuda.synchronize()
                atol = attn_atol(dtype, v)
                torch.testing.assert_close(
                    got.float(), want.float(),
                    rtol=2e-5 if atol == 2e-5 else 0.0, atol=atol)
                err = (got.float() - want.float()).abs().max().item()
                worst["attention_fwd"] = max(worst["attention_fwd"], err)
                print(f"  attention_fwd (768, {length}, {hd}) "
                      f"{str(dtype)[6:]:8s}: max|diff| {err:.3e} "
                      f"(atol {atol:.3e})")
    for name, err in worst.items():
        report[name]["max_abs_err"] = err


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
    return ex


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
    return model, cfg


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
    return launches["attention_fwd"]


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
    for k in (GRID_POOL_BWD1, GRID_POOL_BWD2):
        report[k.name]["launches"] = launches[k.name]
    return state, step, batch, cfg


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


# --------------------------------------------------- (e) training times
def bwd_bytes(g, cells):
    """Bytes pass 1 must move: the features of valid points, every gradient
    row, the cotangent, ids and weights, s, and the per-cell residuals."""
    b, n, d = g.shape
    valid = int(((cells >= 0) & (cells < 196)).sum())
    return (valid * d * g.element_size() + b * n * d * g.element_size()
            + b * 196 * d * 4 + b * n * 12 + b * (196 + 2 * 256) * 4)


def time_pool_bwd(g, cells, w, label, dev_name):
    """(e) K5a and K5b at one shape: each kernel alone, the plain version
    (grid_pool_bwd_terms, both passes; pass 2 alone for K5b) and the
    library yardstick (autograd through the index_add_ formulation of the
    forward, which covers both passes, so it stands in K5a's row only)."""
    b, n, d = g.shape
    cmax, denom, cot = bwd_inputs(g, cells, w, seed=1)
    d_fts, d_w, s, big_s = grid_pool_bwd(g, cells, w, cmax, denom, cot)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    code = 0 if g.dtype == torch.float32 else 1

    def pass1():
        big_s.zero_()
        GRID_POOL_BWD1.launch(
            g.device, g.data_ptr(), code, cells.data_ptr(), w.data_ptr(),
            cmax.data_ptr(), denom.data_ptr(), cot.data_ptr(),
            d_fts.data_ptr(), s.data_ptr(), big_s.data_ptr(), b, n, d, 196,
            sms * 32)

    def pass2(cells, w, cmax, denom, big_s, s, d_w, valid, idx):
        GRID_POOL_BWD2.launch(
            cells.device, cells.data_ptr(), w.data_ptr(), cmax.data_ptr(),
            denom.data_ptr(), big_s.data_ptr(), s.data_ptr(),
            d_w.data_ptr(), b, n, 196)

    valid = (cells >= 0) & (cells < 196)
    idx = torch.where(valid, cells, torch.zeros_like(cells)).long()

    def plain_pass2(cells, w, cmax, denom, big_s, s, d_w, valid, idx):
        den = denom[:, :196].gather(1, idx)
        p = (torch.exp(w - cmax.gather(1, idx)) / den.clamp_min(1e-30)
             ).masked_fill(~valid, 0.0)
        return p * (s - big_s.gather(1, idx))

    gg = g.detach().requires_grad_()
    ww = w.detach().requires_grad_()

    pooled = GP.grid_scatter_pool_raw(gg, cells, ww)[0]

    def library():
        torch.autograd.grad(pooled, (gg, ww), cot, retain_graph=True)

    t1 = {"ms": cuda_ms(pass1, iters=10, warmup=2),
          "plain_ms": cuda_ms(lambda: GP.grid_pool_bwd_terms(
              g, cells, w, denom, cot), iters=5, warmup=1),
          "library_ms": cuda_ms(library, iters=5, warmup=1)}
    del pooled
    pass1()
    # pass 2 reads 16 bytes per point and per-cell tables: cycle through
    # copies so that it reads them from device memory, not from the L2
    bytes2 = b * n * 16 + b * (196 + 2 * 256) * 4
    sets2 = [tuple(t.clone() for t in (cells, w, cmax, denom, big_s, s, d_w,
                                       valid, idx))
             for _ in range(copies_for(bytes2))]
    t2 = {"ms": rotating_ms(pass2, sets2, iters=len(sets2)),
          "plain_ms": rotating_ms(plain_pass2, sets2, iters=len(sets2)),
          "library_ms": None}
    del sets2
    flops = 4.0 * int(valid.sum()) * d
    t1["bound_ms"], t1["bound_by"] = bound(bwd_bytes(g, cells), flops,
                                           torch.float32)
    t2["bound_ms"], t2["bound_by"] = bound(
        bytes2, 6.0 * b * n, torch.float32)
    t1["both_passes_ms"] = cuda_ms(
        lambda: grid_pool_bwd(g, cells, w, cmax, denom, cot), iters=10,
        warmup=2)
    for t in (t1, t2):
        t["shape"] = label
    print(f"  grid_pool_bwd1 {label}: kernel {t1['ms']:.4f} ms, plain (both "
          f"passes) {t1['plain_ms']:.4f}, autograd of the index_add_ "
          f"forward {t1['library_ms']:.4f}, bound {t1['bound_ms']:.4f} ms "
          f"({t1['bound_by']}) [{dev_name}]")
    print(f"  grid_pool_bwd2 {label}: kernel {t2['ms']:.5f} ms, plain "
          f"{t2['plain_ms']:.5f}, bound {t2['bound_ms']:.5f} ms "
          f"({t2['bound_by']}); both passes through the wrapper "
          f"{t1['both_passes_ms']:.4f} ms [{dev_name}]")
    return t1, t2


def time_train_update(state, step, batch, dev_name):
    """(e) ms per train update (host clock around synchronised updates, and
    CUDA-event time on the stream) and the update's peak device memory."""
    step(state, batch, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    host_ms, event_ms = [], []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        step(state, batch, seed=0)
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        event_ms.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()
    b, s = batch.steps.target.shape[1], batch.steps.target.shape[0]
    res = {"batch": b, "steps": s, "host_ms": host_ms, "event_ms": event_ms,
           "host_ms_median": float(np.median(host_ms)),
           "event_ms_median": float(np.median(event_ms)),
           "peak_device_bytes": peak, "held_before_bytes": held}
    print(f"  train update, {b} trajectories x {s} steps, r2r_config() f32: "
          f"host clock {[round(x, 1) for x in host_ms]} ms, CUDA events "
          f"{[round(x, 1) for x in event_ms]} ms; peak device memory "
          f"{peak / 2**30:.3f} GiB, of which {held / 2**30:.3f} GiB were "
          f"held before the update (weights, AdamW moments, the batch and "
          f"earlier phases' models) [{dev_name}]")
    return res


# ------------------------------------------------------- (e) encoder times
def rotating_ms(fn, arg_sets, iters=30):
    """cuda_ms over calls that cycle through `arg_sets`, so that a kernel
    whose inputs fit in the 50 MB L2 still reads them from device memory."""
    i = [0]

    def call():
        fn(*arg_sets[i[0] % len(arg_sets)])
        i[0] += 1
    return cuda_ms(call, iters=iters)


def copies_for(nbytes):
    """Input sets needed to spread the reads over more than twice the L2."""
    return max(1, math.ceil(100e6 / nbytes))


def bound(nbytes, ops, dtype):
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return max(byte_ms, op_ms), "bytes" if byte_ms >= op_ms else "operations"


def time_kernel(label, kernel, call, plain, library, arg_sets, nbytes, ops,
                dtype, dev_name):
    """Kernel, plain and library times at one shape; returns a dict."""
    before = kernel.launches
    t = {"ms": rotating_ms(call, arg_sets),
         "plain_ms": rotating_ms(plain, arg_sets),
         "library_ms": rotating_ms(library, arg_sets)}
    require(kernel.launches > before, f"timed {kernel.name} did not launch")
    t["bound_ms"], t["bound_by"] = bound(nbytes, ops, dtype)
    t["shape"] = label
    print(f"  {kernel.name} {label}: kernel {t['ms']:.5f} ms, plain "
          f"{t['plain_ms']:.5f}, library {t['library_ms']:.5f}, bound "
          f"{t['bound_ms']:.5f} ms ({t['bound_by']}) [{dev_name}]")
    return t


def time_encoder_kernels(dev_name):
    """(e) K3 at the tower's LayerNorm shape, K2 at clip_b32 and at B/16,
    K4 at the tiny tower's shape and at B/16 width; the yardsticks are
    F.layer_norm and F.scaled_dot_product_attention on the split heads."""
    out = {}
    rng = np.random.default_rng(21)

    def cuda(shape, dtype, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to("cuda", dtype)

    bf16, f32 = torch.bfloat16, torch.float32
    rows, c = CLIP_BATCH * VIEWS * 50, 768
    nbytes = 2 * rows * c * 2 + 2 * c * 4
    sets = [(cuda((rows, c), bf16), cuda((c,), f32) + 1.0, cuda((c,), f32))
            for _ in range(copies_for(nbytes))]
    out["layernorm_fwd"] = time_kernel(
        f"({rows}, {c}) bf16", LAYERNORM_FWD, LAYERNORM_FWD,
        LN.layernorm_plain,
        lambda x, w, b: F.layer_norm(x, (c,), w.to(bf16), b.to(bf16), 1e-5),
        sets, nbytes, 8 * rows * c, f32, dev_name)

    def sdpa_packed(qkv, heads=12):
        b, length, _ = qkv.shape
        q, k, v = qkv.view(b, length, 3, heads, 64).permute(2, 0, 3, 1, 4)
        return F.scaled_dot_product_attention(q, k, v)

    for b, length, key in ((CLIP_BATCH * VIEWS, 50, "attention_qkv_fwd"),
                           (CLIP_BATCH * VIEWS, 197, "attention_qkv_fwd_p16")):
        nbytes = b * length * 2304 * 2 + b * length * 768 * 2
        sets = [(cuda((b, length, 2304), bf16),)
                for _ in range(copies_for(nbytes))]
        out[key] = time_kernel(
            f"({b}, {length}, 2304) bf16", ATTENTION_QKV_FWD,
            lambda x: ATTENTION_QKV_FWD(x, 12),
            lambda x: ATT.attention_qkv_plain(x, 12), sdpa_packed, sets,
            nbytes, 4 * b * 12 * length * length * 64, bf16, dev_name)

    for bh, length, hd, dtype, key in (
            (4 * VIEWS * 4, 50, 16, f32, "attention_fwd"),
            (CLIP_BATCH * VIEWS * 12, 197, 64, bf16, "attention_fwd_p16")):
        size = 2 if dtype == bf16 else 4
        nbytes = 4 * bh * length * hd * size
        sets = [tuple(cuda((bh, length, hd), dtype) for _ in range(3))
                for _ in range(copies_for(nbytes))]
        out[key] = time_kernel(
            f"({bh}, {length}, {hd}) {str(dtype)[6:]}", ATTENTION_FWD,
            ATTENTION_FWD, ATT.attention_plain,
            F.scaled_dot_product_attention, sets, nbytes,
            4 * bh * length * length * hd, dtype, dev_name)
    return out


def time_encode_and_pipeline(ex, model, cfg, dev_name):
    """(e) encode views/s (clip_b32 bf16 forward of 192 uint8 views already
    on the card) and pipeline views/s with the buffer full, host clock
    around synchronised runs of 10."""
    images, steps, heads, state = pipeline_inputs(cfg, PIPE_PANOS,
                                                  torch.bfloat16)
    for _ in range(3):
        ex.encode(images)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        ex.encode(images)
    torch.cuda.synchronize()
    encode_s = (time.perf_counter() - t0) / 10
    for depth, pos, heading in steps:          # fill the buffer
        state = encode_and_pool(model, images, state, depth, pos, heading,
                                heads["txt"], heads["text_proj"],
                                heads["grid_proj"], cfg.grid).state
    torch.cuda.synchronize()
    depth, pos, heading = steps[-1]
    t0 = time.perf_counter()
    for _ in range(10):
        state = encode_and_pool(model, images, state, depth, pos, heading,
                                heads["txt"], heads["text_proj"],
                                heads["grid_proj"], cfg.grid).state
    torch.cuda.synchronize()
    pipe_s = (time.perf_counter() - t0) / 10
    views = PIPE_PANOS * VIEWS
    res = {"encode_ms_per_192_views": encode_s * 1e3,
           "encode_views_per_s": views / encode_s,
           "pipeline_ms_per_iteration": pipe_s * 1e3,
           "pipeline_views_per_s": views / pipe_s}
    print(f"  encode, clip_b32 bf16, {views} views: {encode_s * 1e3:.3f} ms "
          f"({views / encode_s:.1f} views/s); pipeline, full buffer: "
          f"{pipe_s * 1e3:.3f} ms per iteration ({views / pipe_s:.1f} "
          f"views/s) [{dev_name}]")
    return res


def main() -> int:
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
    for k in KERNELS:
        report[k.name] = {"name": k.name, "route": "cuda",
                          "source": k.source, "replaces": k.replaces}

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

    # (c) kernels vs plain versions
    print("(c) kernels against their plain versions")
    check_pool_kernel(report)
    check_layernorm_kernel(report)
    check_attention_kernels(report)
    check_pool_bwd_kernels(report)

    # (d) main paths
    print("(d) main path: serving engine, r2r_config() width")
    eng, cfg, rows = main_path(report)
    report["tiny_cpu_vs_card_max_abs_diff"] = tiny_cpu_reference()
    print("(d) main path: CLIP extractor and encode_and_pool, clip_b32() "
          "width")
    ex = extractor_path(report)
    clip_model, pipe_cfg = pipeline_path(report)
    report["attention_fwd"]["launches"] = tiny_tower_path(report)
    print("(d) main path: training, r2r_config() width")
    train_state, train_step, train_batch, train_cfg = training_path(report)
    report["tiny_update_cpu_vs_card_worst_grad_ratio"] = \
        tiny_update_cpu_reference()
    for name in ("attention_qkv_fwd", "layernorm_fwd"):
        report[name]["launches"] = report["pipeline"]["launches"][name]

    # (e) times
    print("(e) times")
    last = rows[2][-1]
    ps = eng._carry.point_state
    pos = torch.as_tensor(np.concatenate([last.pos_xy] * SERVE_SLOTS),
                          device="cuda")
    head = torch.as_tensor(np.concatenate([last.heading] * SERVE_SLOTS),
                           device="cuda")
    cells, _, _ = G.egocentric_grid_assignment(ps, pos, head, cfg.grid)
    timing = {"main_path_B4_f32": time_pool(
        ps.features, cells, ps.weights, "main path B=4 N=8832 D=768 f32",
        dev_name)}
    # the serving shape again with the points spread evenly over the cells,
    # and with 90% of one row in one cell: a block streams a cell alone, so
    # the spread sets the kernel's time
    for kind, key in (("random", "serving_B4_f32_uniform"),
                      ("skew", "serving_B4_f32_skew")):
        g, c, w = pool_case(kind, SERVE_SLOTS, torch.float32, seed=5)
        timing[key] = time_pool(
            g, c, w, f"B={SERVE_SLOTS} N=8832 D=768 f32 ({kind} cells)",
            dev_name)
        del g, c, w
    # the pipeline's shape: 16 panoramas, full bf16 buffer
    g, c, w = pool_case("random", PIPE_PANOS, torch.bfloat16, seed=5)
    timing["pipeline_B16_bf16"] = time_pool(
        g, c, w, f"pipeline B={PIPE_PANOS} N=8832 D=768 bf16 (5% invalid)",
        dev_name)
    del g, c, w
    timing.update(time_encoder_kernels(dev_name))
    # the training shape, forward and backward: the stacked buffer of a full
    # batch
    g, c, w = pool_case("random", train_batch.steps.target.shape[1],
                        torch.float32, seed=6, n=TRAIN_STEPS * 588)
    label = f"B={g.shape[0]} N={g.shape[1]} D=768 f32 (5% invalid)"
    timing["train_B16_f32"] = time_pool(g, c, w, "train " + label, dev_name)
    timing["grid_pool_bwd1"], timing["grid_pool_bwd2"] = time_pool_bwd(
        g, c, w, label, dev_name)
    del g, c, w
    timing["train_update"] = time_train_update(train_state, train_step,
                                               train_batch, dev_name)
    report["timing"] = timing
    for name, key in (("grid_pool_fwd", "main_path_B4_f32"),
                      ("layernorm_fwd", "layernorm_fwd"),
                      ("attention_qkv_fwd", "attention_qkv_fwd"),
                      ("attention_fwd", "attention_fwd"),
                      ("grid_pool_bwd1", "grid_pool_bwd1"),
                      ("grid_pool_bwd2", "grid_pool_bwd2")):
        for field in ("ms", "plain_ms", "bound_ms", "bound_by",
                      "library_ms"):
            report[name][field] = timing[key][field]
    report["throughput"] = time_encode_and_pipeline(ex, clip_model,
                                                    pipe_cfg, dev_name)

    rng = np.random.default_rng(9)
    step_rows = {slot: step_row(cfg, rng, 5) for slot in range(SERVE_SLOTS)}
    for _ in range(3):
        eng.step(step_rows)
    torch.cuda.synchronize()
    step_ms = []
    for _ in range(25):
        t0 = time.perf_counter()
        eng.step(step_rows)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    report["serving_step_ms"] = {"median": float(np.median(step_ms)),
                                 "min": min(step_ms), "max": max(step_ms),
                                 "slots": SERVE_SLOTS, "iters": 25}
    print(f"  serving step, {SERVE_SLOTS} slots, full buffer: median "
          f"{np.median(step_ms):.3f} ms (min {min(step_ms):.3f}, max "
          f"{max(step_ms):.3f}) over 25 steps, host clock [{dev_name}]")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_report.json").write_text(
        json.dumps(report, indent=1))

    # (f) kernels line, (g) result line
    print(f"card: {dev_name}")
    print(json.dumps({"kernels": [
        {key: report[k.name][key] for key in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

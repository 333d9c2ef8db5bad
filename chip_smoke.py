#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (gridmm_tpu_torch) on one card.

    python3 chip_smoke.py

Needs one NVIDIA Hopper card and the CUDA toolkit; imports nothing of JAX.
Phases, in order (any failure raises and the exit code is not 0):

  (a) device: require CUDA, print the card's name and power limit, TF32 off;
  (b) build every kernel of the main path from csrc/ (one nvcc per source,
      all at once);
  (c) each kernel against its plain PyTorch version on the card;
  (d) the main path: the serving engine at full R2R width (r2r_config(),
      seeded random weights) answers 6 requests over 4 slots; logits are
      checked, the kernel launch counts read, and the same steps rerun with
      the plain pool must agree; then a tiny-width step on the card must
      agree with the same step on the CPU;
  (e) times with CUDA events (kernel, plain version, library yardstick,
      byte bound) and the serving step time, each beside the card;
  (f) the kernels line; (g) the result line, last.

A longer report goes to chiprun_out/chip_smoke_report.json.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from gridmm_tpu_torch.config import r2r_config, tiny_config
from gridmm_tpu_torch.models import navigator as nav_mod
from gridmm_tpu_torch.models.navigator import init_navigator
from gridmm_tpu_torch.ops import geometry as G
from gridmm_tpu_torch.ops import grid_pool as GP
from gridmm_tpu_torch.ops.cuda import build
from gridmm_tpu_torch.ops.cuda.grid_pool import GRID_POOL_FWD, cell_max
from gridmm_tpu_torch.serve.engine import NavServingEngine
from gridmm_tpu_torch.train.step import StepInputs, init_carry, nav_device_step

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
KERNELS = [GRID_POOL_FWD]
POOL_B, POOL_N, POOL_D = 8, 8832, 768
SERVE_SLOTS, FIRST_STEPS, LATER_STEPS = 4, 15, 3
# fused logits, kernel pool vs plain pool through the full-width navigator
# in f32 (TF32 off): the pools differ only in summation order (~1e-6
# relative), which 13 transformer layers may amplify to ~1e-5
LOGIT_TOL = 1e-4


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


def cuda_ms(fn, iters=25, warmup=5) -> float:
    """Mean ms per call over `iters` calls, CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ inputs
def pool_case(kind, b, dtype, seed=0, n=POOL_N, d=POOL_D):
    """Pool inputs: random cells with ~5% invalid; "edges" adds an
    all-invalid row, a one-point cell (2, 7) and empty cells (row 3 < 50)."""
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
    """(c) kernel vs plain on the card: mask exact; pooled within 1e-5 x
    max|pooled| (f32) or one bf16 ulp of the inputs, 2^-8 x max|g| (bf16);
    denominator within 1e-5 relative."""
    worst = 0.0
    for b in (POOL_B, SERVE_SLOTS):
        for dtype in (torch.float32, torch.bfloat16):
            for kind in ("random", "edges"):
                g, cells, w = pool_case(kind, b, dtype)
                numer, denom = GRID_POOL_FWD(g, cells, w)
                got_p, got_m, got_d = GP._finalize(numer, denom, 196)
                want_p, want_m, want_d = GP.grid_scatter_pool_raw(g, cells, w)
                torch.cuda.synchronize()
                require(torch.equal(got_m, want_m),
                        f"cell mask differs ({b}, {dtype}, {kind})")
                atol = (1e-5 * want_p.abs().max().item()
                        if dtype == torch.float32
                        else 2.0 ** -8 * g.float().abs().max().item())
                torch.testing.assert_close(got_p, want_p, rtol=1e-5,
                                           atol=atol)
                torch.testing.assert_close(got_d, want_d, rtol=1e-5, atol=0)
                if kind == "edges":
                    require(not got_m[1].any() and (got_p[1] == 0).all(),
                            "all-invalid row is not empty")
                    require(got_m[2, 7] and not got_m[3, :50].any(),
                            "one-point or empty cells wrong")
                err = (got_p - want_p).abs().max().item()
                worst = max(worst, err)
                print(f"  grid_pool_fwd B={b} {str(dtype)[6:]:8s} {kind:6s}: "
                      f"max|pooled diff| {err:.3e} (atol {atol:.3e}), "
                      f"max|denom diff| "
                      f"{(got_d - want_d).abs().max().item():.3e}")
                del g, cells, w, numer, denom, want_p
    report["grid_pool_fwd"]["max_abs_err"] = worst


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

    for k in KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    fused_kernel, eng = run_engine(model, cfg, rows, texts)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k.name: k.launches for k in KERNELS}
    n_steps = FIRST_STEPS + LATER_STEPS
    print(f"  served {n_req} requests over {SERVE_SLOTS} slots in {n_steps} "
          f"steps ({wall:.2f}s with first-call overheads); buffer count "
          f"{eng._carry.point_state.count.tolist()}")
    print(f"  launches during the main path: {launches}")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} never launched on the path")
    require(launches["grid_pool_fwd"] == n_steps,
            f"grid_pool_fwd launched {launches['grid_pool_fwd']} times in "
            f"{n_steps} steps")
    report["grid_pool_fwd"]["launches"] = launches["grid_pool_fwd"]

    # the same steps with the plain pool on the card
    real_pool = nav_mod.grid_pool
    nav_mod.grid_pool = GP.grid_scatter_pool
    try:
        fused_plain, _ = run_engine(model, cfg, rows, texts)
    finally:
        nav_mod.grid_pool = real_pool
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
    denominator)."""
    b, n, d = g.shape
    valid = int(((cells >= 0) & (cells < 196)).sum())
    return (valid * d * g.element_size() + b * n * 8
            + b * 196 * d * 4 + b * 196 + b * 256 * 4)


def time_pool(g, cells, w, label, dev_name):
    """(e) times of one pool configuration; returns a dict of ms."""
    b, n, d = g.shape
    cmax = cell_max(cells, w)
    numer = torch.zeros((b, 196, d), device="cuda")
    denom = torch.zeros((b, 256), device="cuda")
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
            g, cells, w, cmax, numer, denom)),
        "plain_ms": cuda_ms(lambda: GP.grid_scatter_pool_raw(g, cells, w)),
        "library_ms": cuda_ms(lambda: flat.index_add_(0, rows, src)),
    }
    require(GRID_POOL_FWD.launches > before, "timed pool did not launch")
    times["bound_ms"] = pool_bytes(g, cells) / HBM_BYTES_PER_S * 1e3
    print(f"  grid_pool_fwd {label}: pool {times['ms']:.4f} ms (kernel alone "
          f"{times['kernel_only_ms']:.4f}), plain {times['plain_ms']:.4f}, "
          f"index_add_ {times['library_ms']:.4f}, byte bound "
          f"{times['bound_ms']:.4f} ms [{dev_name}]")
    return times


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
    report = {"card": dev_name, "grid_pool_fwd": {
        "name": GRID_POOL_FWD.name, "route": "cuda",
        "source": GRID_POOL_FWD.source, "replaces": GRID_POOL_FWD.replaces,
        "bound_by": "bytes"}}

    # (b) build
    t0 = time.time()
    logs = build.build_all(["grid_pool_fwd"])
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

    # (d) main path
    print("(d) main path: serving engine, r2r_config() width")
    eng, cfg, rows = main_path(report)
    report["tiny_cpu_vs_card_max_abs_diff"] = tiny_cpu_reference()

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
    for dtype in (torch.float32, torch.bfloat16):
        g, c, w = pool_case("random", POOL_B, dtype, seed=5)
        timing[f"B8_{str(dtype)[6:]}"] = time_pool(
            g, c, w, f"B=8 N=8832 D=768 {str(dtype)[6:]} (5% invalid)",
            dev_name)
        del g, c, w
    report["timing"] = timing
    k = report["grid_pool_fwd"]
    main_t = timing["main_path_B4_f32"]
    for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
        k[key] = main_t[key]

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
        {key: k[key] for key in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

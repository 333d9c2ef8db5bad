#!/usr/bin/env python3
"""Where the serving step's, the encoder's and the train update's time goes
on the card (gridmm_tpu_torch).

    python3 chip_profile.py [--steps 5]
    python3 chip_profile.py --ab OTHER_TREE

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
    the device-busy share of the update.

The encode's and the pipeline's tables are followed by LayerNorm's launches
and device time per launch.

With --ab, it only times LayerNorm (K3), per-head attention (K4) and the
pool backward's two passes (K5a, K5b) as built from this tree's csrc/ and from OTHER_TREE's (a checkout
of another commit, for example the parent unpacked with `git archive`) in
one process, on the same inputs, in turns (other, this, this, other), at the
main paths' shapes, reading from device memory.

Needs one NVIDIA card; writes the tables to chiprun_out/chip_profile.txt
(chip_profile_ab.json with --ab).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import (CLIP_BATCH, PIPE_PANOS, SERVE_SLOTS, VIEWS,
                        attn_atol, bwd_inputs, card, copies_for, cuda_ms,
                        pipeline_inputs, pool_case, request_text, require,
                        rotating_ms, step_row)
from gridmm_tpu_torch.config import r2r_config
from gridmm_tpu_torch.data.preprocess import ClipFeatureExtractor
from gridmm_tpu_torch.models.clip_vit import clip_b32
from gridmm_tpu_torch.pipeline import encode_and_pool
from gridmm_tpu_torch.models.navigator import init_navigator
from gridmm_tpu_torch.ops import geometry as G
from gridmm_tpu_torch.ops import grid_pool as GP
from gridmm_tpu_torch.ops import attention as ATT
from gridmm_tpu_torch.ops.cuda import build
from gridmm_tpu_torch.ops.cuda.attention import ATTENTION_FWD
from gridmm_tpu_torch.ops.cuda.grid_pool import (GRID_POOL_BWD1,
                                                 GRID_POOL_BWD2, SOURCE_BWD)
from gridmm_tpu_torch.ops.cuda.layernorm import LAYERNORM_FWD
from gridmm_tpu_torch.serve.engine import NavServingEngine
from gridmm_tpu_torch.utils.export import (export_navigator_serving,
                                           save_serving_bundle)
from gridmm_tpu_torch.train.step import create_train_state, make_train_step
from gridmm_tpu_torch.train.synthetic import synthetic_trajectory_batch

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


def attn_args(tensors, code, bh, length, hd):
    """The C arguments of gridmm_attention_fwd but the stream."""
    q, k, v, o = tensors
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), code, o.data_ptr(), bh,
            length, hd, 1.0 / hd ** 0.5)


def ab_kernels(other_root: Path, dev_name: str) -> dict:
    """K3, K4, K5a and K5b from this tree's csrc/ and from `other_root`'s, on the
    same inputs, timed in turns (other, this, this, other). Both trees must
    export the same C entry points. Returns {case: {tree: [ms, ms]}}."""
    trees = {"other": other_root / "gridmm_tpu_torch" / "csrc",
             "this": build.SRC_DIR}
    fns = {}
    for tree, src in trees.items():
        build.build_all(["layernorm_fwd", SOURCE_BWD, "attention_fwd"], src)
        fns[tree] = {
            "attn": build.function("attention_fwd", ATTENTION_FWD.symbol,
                                   ATTENTION_FWD.argtypes, src),
            "ln": build.function("layernorm_fwd", LAYERNORM_FWD.symbol,
                                 LAYERNORM_FWD.argtypes, src),
            "bwd1": build.function(SOURCE_BWD, GRID_POOL_BWD1.symbol,
                                   GRID_POOL_BWD1.argtypes, src),
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

    # K4 at the tiny tower's, B/16's and ViT-H/14's shapes, each call on its
    # own q, k, v and o; a shape that a tree's kernel refuses is not timed
    # for that tree
    gen = torch.Generator(device="cuda").manual_seed(6)
    for bh, length, hd, dtype in (
            (4 * VIEWS * 4, 50, 16, torch.float32),
            (CLIP_BATCH * VIEWS * 12, 197, 64, torch.bfloat16),
            (CLIP_BATCH * VIEWS * 16, 257, 80, torch.bfloat16)):
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
        case = f"attention_fwd ({bh}, {length}, {hd}) {str(dtype)[6:]}"
        if takes["other"]:
            turns(case, lambda tree: rotating_ms(
                lambda *a: attn(tree, *a), sets))
        else:     # the parent's K4 took hd 16, 32, 64 and 128 only
            result[case] = {"other": None, "this": [
                rotating_ms(lambda *a: attn("this", *a), sets)
                for _ in range(2)]}
            print(f"  {case}: other refuses it, this "
                  f"{result[case]['this'][0]:.5f} / "
                  f"{result[case]['this'][1]:.5f} ms [{dev_name}]")
        del sets, q, k, v, o, want

    # the pool backward at the train shape: B=16, N=8820, D=768 f32
    g, cells, w = pool_case("random", 16, torch.float32, seed=6, n=8820)
    b, n, d = g.shape
    cmax, denom, cot = bwd_inputs(g, cells, w, seed=1)
    dg = torch.empty_like(g)
    s_pt = torch.empty((b, n), device="cuda")
    big_s = torch.zeros((b, 256), device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def pass1(tree):
        big_s.zero_()
        run(fns[tree]["bwd1"], g.data_ptr(), 0, cells.data_ptr(),
            w.data_ptr(), cmax.data_ptr(), denom.data_ptr(), cot.data_ptr(),
            dg.data_ptr(), s_pt.data_ptr(), big_s.data_ptr(), b, n, d, 196,
            sms * 32)

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
    one = torch.ones(1, device="cuda")
    result["launch floor (a one-element torch.add)"] = cuda_ms(
        lambda: torch.add(one, one, out=one), iters=30)
    print(f"  launch floor (a one-element torch.add): "
          f"{result['launch floor (a one-element torch.add)']:.5f} ms "
          f"[{dev_name}]")
    return result


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--ab", type=Path, default=None, metavar="OTHER_TREE",
                    help="only time K3, K4, K5a and K5b against OTHER_TREE's "
                         "sources")
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
    if args.ab is not None:
        result = ab_kernels(args.ab.resolve(), dev_name)
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
    (out_dir / "chip_profile.txt").write_text("\n".join(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

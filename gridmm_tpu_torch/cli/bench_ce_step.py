"""Per-step latency of the full-scale continuous-env (VLN-CE) policy (twin
of scripts/bench_ce_step.py).

    python -m gridmm_tpu_torch.cli.bench_ce_step [--batches 1 4]
        [--view_tower] [--breakdown] [--legacy]
    python -m gridmm_tpu_torch.cli.bench_ce_step --device cpu --tiny

Times whole greedy `CEAgent.rollout`s of the r2r_ce agent
(`ce/factory.build_ce_agent(tiny=False, img=224)`: the ResNet50 and ddppo
waypoint towers, the waypoint predictor and NMS, clip_b32 grid tokens,
with `--view_tower` the timm ViT-B/16 view encoder, the navigation
forward) on `SyntheticContinuousEnv` (224 px RGB, 256 px depth), host env
moves included: the time a VLN-CE user waits per action. By default the
step runs fused on the device (ce/device_step.py); `--legacy` takes the
host path (`fused_rollout = False`). Per batch: one warm-up rollout, then
`--rounds` rollouts of `--steps` steps; the p50 over rounds of the time per
policy step. `--breakdown` attributes a further rollout's time to its
phases (utils/logging.SectionTimer).
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def run(device: str = "cuda", batches=(1, 4), steps: int = 6,
        rounds: int = 5, view_tower: bool = False, breakdown: bool = False,
        legacy: bool = False, tiny: bool = False, agent=None) -> dict:
    """{batch: {"p50_ms", "frames_per_s", "breakdown" (ms a step, or
    None)}}. `agent` (a CEAgent on `device`) replaces the one built here
    from `tiny` and `view_tower`."""
    from gridmm_tpu_torch.ce.env import SyntheticContinuousEnv
    from gridmm_tpu_torch.ce.factory import build_ce_agent
    from gridmm_tpu_torch.utils import device as D
    from gridmm_tpu_torch.utils.logging import SectionTimer

    dev = D.resolve(device)
    img = 56 if tiny else 224
    if agent is None:
        _, agent = build_ce_agent(img=img, tiny=tiny, view_tower=view_tower,
                                  device=dev)
    agent.fused_rollout = not legacy
    path = "host path (--legacy)" if legacy else "fused"
    out = {}
    for b in batches:
        env = SyntheticContinuousEnv(num_envs=b, image_size=img,
                                     depth_size=256, seed=0)
        agent.rollout(env, max_steps=steps, feedback="argmax")  # warm-up
        per_step = []
        for _ in range(rounds):
            hooks = []
            t0 = time.perf_counter()
            agent.rollout(env, max_steps=steps, feedback="argmax",
                          on_step=lambda t, obs: hooks.append(t))
            # an episode that stops after k hook calls ran k policy steps
            per_step.append((time.perf_counter() - t0) * 1e3
                            / max(len(hooks), 1))
        lat = float(np.percentile(per_step, 50))
        print(f"batch={b}: p50 step={lat:.1f} ms  "
              f"({12 * b * 1e3 / lat:.0f} frames/s)  [{path}, "
              f"{D.name(dev)}]", flush=True)
        out[b] = {"p50_ms": lat, "frames_per_s": 12 * b * 1e3 / lat,
                  "breakdown": None}
        if breakdown:
            timer = SectionTimer()
            agent.rollout(env, max_steps=steps, feedback="argmax",
                          timer=timer)
            parts = timer.summary()
            for k, v in sorted(parts.items(), key=lambda kv: -kv[1]):
                print(f"  {k:<12} {v * 1e3:7.1f} ms/step")
            out[b]["breakdown"] = {k: v * 1e3 for k, v in parts.items()}
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--device", default="cuda")
    p.add_argument("--batches", type=int, nargs="+", default=[1, 4])
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--view_tower", action="store_true",
                   help="include the timm ViT-B/16 view encoder")
    p.add_argument("--breakdown", action="store_true",
                   help="attribute per-step time to rollout phases")
    p.add_argument("--legacy", action="store_true",
                   help="the host-assembly rollout path")
    p.add_argument("--tiny", action="store_true",
                   help="the tiny CE agent at 56 px (the CPU tests)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    return run(args.device, args.batches, args.steps, args.rounds,
               args.view_tower, args.breakdown, args.legacy, args.tiny)


if __name__ == "__main__":
    main()

"""A full evaluation epoch on the procedurally generated synthetic world
(twin of scripts/run_synthetic_eval.py): the no-real-data counterpart of
`main_nav --test`.

    python -m gridmm_tpu_torch.cli.run_synthetic_eval [--teacher]
    python -m gridmm_tpu_torch.cli.run_synthetic_eval --device cpu

Builds the tiny-config agent (seeded random weights) over a SyntheticWorld
of 2 scans x 10 nodes with 9 episodes (seed 1), rolls out 3 batches
greedily (or, with --teacher, teacher-forced) and prints SR, oracle SR,
SPL, nDTW, SDTW, CLS, navigation error, lengths and steps. The world and
agent are built here from the port's env/ and train/agent.py, where the
JAX script borrows `build_all` from its tests.
"""

from __future__ import annotations

import argparse
import time

METRICS = ("sr", "oracle_sr", "spl", "nDTW", "SDTW", "CLS", "nav_error",
           "lengths", "steps")


def build_all(seed: int = 1, device="cuda", model=None):
    """(cfg, env, agent) at tiny_config() over the synthetic world; `model`
    (a navigator at tiny_config() widths) replaces the seeded one."""
    from gridmm_tpu_torch.config import tiny_config
    from gridmm_tpu_torch.env.discrete import (DiscreteNavEnv,
                                               synthetic_episodes)
    from gridmm_tpu_torch.env.world import SyntheticWorld
    from gridmm_tpu_torch.models.navigator import init_navigator
    from gridmm_tpu_torch.train.agent import NavAgent

    cfg = tiny_config()
    world = SyntheticWorld(num_scans=2, nodes_per_scan=10, feat_dim=768,
                           seed=seed)
    episodes = synthetic_episodes(world, num=9, seed=seed, max_len=4)
    env = DiscreteNavEnv(world, world.graphs, episodes,
                         batch_size=cfg.train.batch_size, seed=seed)
    if model is None:
        model = init_navigator(cfg.model, seed=seed, device=device)
    return cfg, env, NavAgent(model.to(device), cfg, env)


def run(device: str = "cuda", teacher: bool = False, seed: int = 1,
        model=None):
    """(metrics, predictions) of the epoch; prints the table."""
    from gridmm_tpu_torch.utils import device as D

    dev = D.resolve(device)
    _, env, agent = build_all(seed, dev, model)
    t0 = time.time()
    if not teacher:
        avg, preds = agent.evaluate(num_batches=3)
    else:
        env.reset_epoch(shuffle=False)
        seen = {}
        for _ in range(3):
            traj, _, _ = agent.rollout(feedback="teacher")
            for item in traj:
                seen.setdefault(item["instr_id"], {
                    "instr_id": item["instr_id"],
                    "trajectory": item["trajectory"]})
        preds = list(seen.values())
        avg, _ = env.eval_metrics(preds)
    dt = time.time() - t0
    print(f"policy={'teacher' if teacher else 'argmax'}  "
          f"episodes={len(preds)}  wall={dt:.1f}s  [{D.name(dev)}]")
    for k in METRICS:
        print(f"  {k:>12}: {avg[k]:.2f}")
    return avg, preds


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--device", default="cuda")
    p.add_argument("--teacher", action="store_true",
                   help="teacher-forced rollouts instead of greedy ones")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    return run(args.device, args.teacher)


if __name__ == "__main__":
    main()

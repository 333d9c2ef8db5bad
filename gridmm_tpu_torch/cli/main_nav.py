"""Fine-tune / evaluate the GridMM navigator (discrete environments; twin of
gridmm_tpu/cli/main_nav.py, the equivalent of map_nav_src/main_nav.py).

  # synthetic world, tiny model: smoke-trainable anywhere
  python -m gridmm_tpu_torch.cli.main_nav --world synthetic --iters 6 --eval

  # the same on the CPU
  python -m gridmm_tpu_torch.cli.main_nav --world synthetic --device cpu

The real-data worlds wait for the dataset and store modules (see the error
they raise).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

WORLDS = ["synthetic", "r2r", "reverie", "soon", "rxr"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--world", choices=WORLDS, default="synthetic")
    p.add_argument("--root_dir", default=None,
                   help="dataset root (reference layout: "
                        "ROOT/{DATASET}/{features,connectivity,annotations})")
    p.add_argument("--output_dir", default="runs/main_nav")
    p.add_argument("--device", default="cuda",
                   help="torch device of the model and the updates")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--log_every", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--eval", action="store_true")
    p.add_argument("--eval_batches", type=int, default=0,
                   help="0 (default) = FULL val split for best-SPL ckpt "
                        "selection (reference test() wraparound, "
                        "main_nav.py:180-204); >0 subsamples (smoke only)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true",
                   help="tiny model dims (tests/smoke)")
    p.add_argument("--resume", default=None,
                   help="checkpoint file written by this CLI")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--feature_backend", choices=["auto", "hdf5", "gmmstore"],
                   default="auto")
    p.add_argument("--aug", default=None,
                   help="augmented-instruction annotation split or file; "
                        "trains 1:1 interleaved with the GT env")
    p.add_argument("--aug_views", default=None,
                   help="EnvEdit augmented-view HDF5")
    p.add_argument("--dagger_sum", action="store_true",
                   help="sum teacher+sample losses per iteration "
                        "(reference DAgger gradient shape)")
    p.add_argument("--scene_shard", action="store_true")
    p.add_argument("--multihost", action="store_true",
                   help="multi-process training (not ported yet)")
    p.add_argument("--mesh", choices=["off", "auto"], default="off",
                   help="auto = shard the replay update over all visible "
                        "devices (not ported yet)")
    p.add_argument("--mp_size", type=int, default=1)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 activations/matmuls (params, logits, loss "
                        "and gmap accumulators stay f32)")
    p.add_argument("--scan_buckets", default=None,
                   help="comma-separated episode-length buckets (e.g. "
                        "'6,10,15'); short episodes pad to the smallest "
                        "covering bucket instead of max_action_len")
    p.add_argument("--submit", default=None,
                   help="write leaderboard-format predictions JSON here "
                        "after the final eval (main_nav.py:246-260)")
    p.add_argument("--detailed_output", action="store_true",
                   help="include per-node stop probabilities in the "
                        "submission records (r2r/agent.py:427-431 details)")
    return p.parse_args(argv)


def build_synthetic(args, cfg):
    from gridmm_tpu_torch.env.discrete import (DiscreteNavEnv,
                                               synthetic_episodes)
    from gridmm_tpu_torch.env.world import SyntheticWorld

    world = SyntheticWorld(num_scans=2, nodes_per_scan=10, seed=args.seed)
    train_eps = synthetic_episodes(world, num=24, seed=args.seed)
    val_eps = synthetic_episodes(world, num=12, seed=args.seed + 1)
    train_env = DiscreteNavEnv(world, world.graphs, train_eps,
                               batch_size=args.batch_size, seed=args.seed)
    val_env = DiscreteNavEnv(world, world.graphs, val_eps,
                             batch_size=args.batch_size, seed=args.seed,
                             name="val")
    return train_env, val_env


def _check_ported(args) -> None:
    if args.world != "synthetic":
        raise NotImplementedError(
            f"--world {args.world} needs data/datasets.py and data/store.py, "
            "which are not ported yet (ROADMAP Queue 1 item 14); "
            "--world synthetic runs")
    if args.mesh != "off":
        raise NotImplementedError(
            "--mesh auto waits for the parallel layer (ROADMAP Queue 1 "
            "item 11)")
    if args.multihost:
        raise NotImplementedError(
            "--multihost waits for parallel/multihost.py (ROADMAP Queue 1 "
            "item 11)")
    # options of the real-data builders and of the mesh: refuse them rather
    # than run without what was asked for
    for flag, default, item in (
            ("root_dir", None, 14), ("feature_backend", "auto", 14),
            ("aug", None, 14), ("aug_views", None, 14),
            ("scene_shard", False, 11), ("mp_size", 1, 11)):
        if getattr(args, flag) != default:
            raise NotImplementedError(
                f"--{flag} is read only by modules that are not ported yet "
                f"(ROADMAP Queue 1 item {item})")
    if args.detailed_output and not args.submit:
        raise ValueError("--detailed_output shapes the --submit file; give "
                         "--submit with it")


def main(argv=None):
    args = parse_args(argv)
    _check_ported(args)
    from gridmm_tpu_torch.config import r2r_config, tiny_config
    from gridmm_tpu_torch.models.navigator import init_navigator
    from gridmm_tpu_torch.train.agent import NavAgent
    from gridmm_tpu_torch.train.loop import train_navigator
    from gridmm_tpu_torch.utils.logging import MetricLogger

    cfg = tiny_config() if (args.tiny or args.world == "synthetic") \
        else r2r_config()
    if args.lr:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, lr=args.lr))
    buckets = (tuple(int(x) for x in args.scan_buckets.split(","))
               if args.scan_buckets else None)
    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(
            cfg.train, batch_size=args.batch_size, iters=args.iters,
            log_every=args.log_every, dagger_sum=args.dagger_sum,
            scan_buckets=buckets))
    if args.bf16:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model,
                                           compute_dtype="bfloat16"))

    train_env, val_env = build_synthetic(args, cfg)

    model = init_navigator(cfg.model, seed=args.seed, device=args.device)
    if args.resume:
        from gridmm_tpu_torch.utils.checkpoint import restore_checkpoint

        restore_checkpoint(os.path.abspath(args.resume), model)

    agent = NavAgent(model, cfg, train_env)
    # --submit needs a val agent even without periodic --eval
    val_agent = NavAgent(model, cfg, val_env) \
        if (args.eval or args.submit) else None

    logger = MetricLogger(os.path.join(args.output_dir, "logs"))
    try:
        result = train_navigator(
            cfg, model, agent, val_agent if args.eval else None,
            iters=args.iters, log_every=args.log_every,
            eval_batches=args.eval_batches or None,  # 0 -> full split
            ckpt_dir=os.path.join(args.output_dir, "ckpts"), logger=logger,
            seed=args.seed)
    finally:
        logger.close()
    if args.submit and val_agent is not None:
        # final full-split predictions in leaderboard format
        # (main_nav.py:246-260 valid() submit JSON)
        _, preds = val_agent.evaluate(None,
                                      detailed_output=args.detailed_output)
        val_agent.write_submission(
            preds, args.submit, objects=cfg.model.obj_feat_size > 0)
        print(f"wrote {len(preds)} predictions -> {args.submit}")
    print(json.dumps({
        "best_spl": result.best_spl, "best_iter": result.best_iter,
        **{f"final_{k}": v for k, v in result.final_metrics.items()}}))
    return result


if __name__ == "__main__":
    main()

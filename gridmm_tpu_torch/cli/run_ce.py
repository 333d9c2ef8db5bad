"""Train/evaluate the continuous-environment (VLN-CE) GridMap policy (twin of
gridmm_tpu/cli/run_ce.py, the equivalent of VLN_CE/run.py +
run_GridMap.bash).

Habitat-backed environments plug in through the ContinuousEnv protocol when
habitat is installed (--env habitat raises where it is not); the synthetic
arena runs anywhere.

  # tiny agent on the CPU (its point buffer holds 4 steps): train one
  # epoch, then evaluate
  python -m gridmm_tpu_torch.cli.run_ce --device cpu --epochs 1 --max_steps 4

  # the full r2r_ce agent with the timm view tower on the card
  python -m gridmm_tpu_torch.cli.run_ce --full --view_tower --num_envs 4

  python -m gridmm_tpu_torch.cli.run_ce --run-type eval --poll_ckpt_dir D

  # over the launched world (one process a card), TP in pairs of cards
  torchrun --nproc_per_node 8 -m gridmm_tpu_torch.cli.run_ce --full \
      --mesh auto --mp_size 2 --num_envs 8

Prints one JSON line per epoch and one with the eval metrics. Under --mesh
auto each rank rolls out the whole env batch and updates on its data
slice (--num_envs must divide by the data-axis size); rank 0 writes the
checkpoints and every rank its own eval stats file.
"""

from __future__ import annotations

import argparse
import json
import math
import os


def epochs_per_ratio(epochs: int, decay_time: int) -> int:
    """num_epoches_per_ratio = ceil(IL.epochs / IL.decay_time)
    (ss_trainer_GridMap.py:570); the ratio then decays as
    schedule_ratio^(epoch // num_epoches_per_ratio + 1) (:619)."""
    return max(1, math.ceil(epochs / decay_time))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run-type", choices=["train", "eval", "inference"],
                   default="train")
    p.add_argument("--env", choices=["synthetic", "habitat"],
                   default="synthetic")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--schedule_ratio", type=float, default=0.5,
                   help="schedule-sampling base (IL.schedule_ratio=0.50, "
                        "run_GridMap.yaml:21)")
    p.add_argument("--decay_time", type=int, default=20,
                   help="ratio decays as ratio^(epoch//ceil(epochs/"
                        "decay_time)+1) (IL.decay_time=20, "
                        "ss_trainer_GridMap.py:570,619)")
    p.add_argument("--batches_per_epoch", type=int, default=0,
                   help="train batches per epoch; 0 (default) derives "
                        "ceil(num_episodes/num_envs) from the env's episode "
                        "split so one epoch covers the whole split, matching "
                        "the reference (ss_trainer_GridMap.py:606-607)")
    p.add_argument("--num_envs", type=int, default=2)
    p.add_argument("--max_steps", type=int, default=20,
                   help="episode step cap — default matches the reference's "
                        "IL.max_traj_len=20 (run_GridMap.yaml:23, enforced "
                        "as MAX_EPISODE_STEPS, ss_trainer_GridMap.py:503)")
    p.add_argument("--eval_batches", type=int, default=0,
                   help="eval/inference rollout batches; 0 (default) covers "
                        "the FULL episode split exactly once (dedup until "
                        "the episode iterator wraps, like the reference's "
                        "stats_episodes loop, base_il_trainer.py:336,666)")
    p.add_argument("--num_episodes", type=int, default=16,
                   help="synthetic env: size of the finite cycling episode "
                        "split (habitat envs define their own splits)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device of the agent and the updates")
    p.add_argument("--output_dir", default="runs/ce")
    p.add_argument("--predictions_file", default=None,
                   help="inference output (INFERENCE.PREDICTIONS_FILE)")
    p.add_argument("--predictions_format", choices=["r2r", "rxr"],
                   default="r2r")
    p.add_argument("--poll_ckpt_dir", default=None,
                   help="eval mode: evaluate checkpoints appearing in this "
                        "folder (base_il_trainer.py:896-912 polling loop)")
    p.add_argument("--poll_timeout", type=float, default=0.0,
                   help="stop after this many seconds without a new ckpt")
    p.add_argument("--habitat_config", default=None,
                   help="habitat task yaml for --env habitat")
    p.add_argument("--data_path", default=None,
                   help="VLN-CE {split}.json.gz episode file; with --env "
                        "habitat --run-type train, the episodes are "
                        "scene-balance-allocated (one process here) and "
                        "passed as the env's EPISODES_ALLOWED whitelist "
                        "(allocate_allowed_episode_by_scene, "
                        "ss_trainer_GridMap.py:77-139)")
    p.add_argument("--train_split", default="train")
    p.add_argument("--full", action="store_true",
                   help="full-scale agent (r2r_ce preset, ResNet50/ddppo "
                        "towers, ViT-B/32 grid CLIP) instead of the tiny "
                        "smoke agent")
    p.add_argument("--view_tower", action="store_true",
                   help="add the timm ViT-B/16 live view encoder "
                        "(gridmap/vilmodel.py:631)")
    p.add_argument("--depth_only_waypoint", action="store_true",
                   help="RxR-CE depth-only waypoint predictor "
                        "(DepthDistPredictor_TRM)")
    p.add_argument("--task", choices=["r2r", "rxr"], default="r2r",
                   help="rxr = RxR-CE preset: MAX_DIST 40 / MAX_STEP 30 "
                        "normalizers + xlm-roberta text dims "
                        "(Policy:280-286); pair with --depth_only_waypoint")
    p.add_argument("--results_dir", default=None,
                   help="eval: write per-rank episode stats JSON + rank-0 "
                        "aggregate here (base_il_trainer.py:725-746)")
    p.add_argument("--video_dir", default=None,
                   help="eval: write one episode video here per episode "
                        "(base_il_trainer.py:631-644)")
    p.add_argument("--eval_split", default="val_unseen")
    p.add_argument("--checkpoint_index", type=int, default=0,
                   help="names the eval stats/video files (the reference "
                        "keys them by checkpoint index so evals of several "
                        "checkpoints into one --results_dir don't clobber "
                        "each other); the polling mode numbers checkpoints "
                        "automatically")
    p.add_argument("--ckpt_dir", default=None,
                   help="train: write ckpt.{epoch} training state here "
                        "(default <output_dir>/checkpoints; '' disables) — "
                        "the reference's per-epoch ckpt.{epoch}.pth "
                        "(ss_trainer_GridMap.py:65-75)")
    p.add_argument("--save_every", type=int, default=1,
                   help="train: checkpoint every N epochs (last epoch "
                        "always saved)")
    p.add_argument("--resume", action="store_true",
                   help="train: restore the newest ckpt.{N} in --ckpt_dir "
                        "(params + optimizer + epoch) and continue — "
                        "IL.is_requeue semantics (base_il_trainer.py:147-150)")
    p.add_argument("--mesh", choices=["off", "auto"], default="off",
                   help="train over a (data, model) mesh of the launched "
                        "world: the reference's DDP CE trainer "
                        "(base_il_trainer _init_distributed); --num_envs "
                        "must be divisible by the data-axis size")
    p.add_argument("--mp_size", type=int, default=1,
                   help="model-parallel axis size within --mesh auto")
    # released-weights set (base_il_trainer.py:80-117 + vlnbert_init.py:11-65)
    p.add_argument("--waypoint_ckpt", default=None)
    p.add_argument("--navigator_ckpt", default=None,
                   help="grid_map.pt")
    p.add_argument("--clip_ckpt", default=None, help="ViT-B-32.pt")
    p.add_argument("--vit_ckpt", default=None,
                   help="vit_base_p16_224.pth (needs --view_tower)")
    p.add_argument("--rgb_resnet_ckpt", default=None,
                   help="torchvision resnet50 state_dict")
    p.add_argument("--ddppo_ckpt", default=None,
                   help="gibson ddppo visual_encoder state_dict")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch.distributed as dist

    from gridmm_tpu_torch.parallel.mesh import init_world

    created = init_world(args.device) if args.mesh == "auto" else False
    try:
        return _main(args)
    finally:
        if created:
            dist.destroy_process_group()


def _main(args):
    from gridmm_tpu_torch.ce.env import SyntheticContinuousEnv
    from gridmm_tpu_torch.ce.factory import build_ce_agent
    from gridmm_tpu_torch.ce.trainer import CETrainer
    from gridmm_tpu_torch.config import MeshConfig
    from gridmm_tpu_torch.parallel.mesh import local_device, make_mesh
    from gridmm_tpu_torch.parallel.multihost import (process_count,
                                                     process_index)
    from gridmm_tpu_torch.utils.logging import MetricLogger

    device = local_device(args.device)
    cfg, agent = build_ce_agent(
        tiny=not args.full, view_tower=args.view_tower,
        waypoint_rgb=not args.depth_only_waypoint,
        img=224 if args.full else 56, seed=args.seed, preset=args.task,
        device=device)
    ckpts = dict(waypoint_ckpt=args.waypoint_ckpt,
                 navigator_ckpt=args.navigator_ckpt,
                 clip_ckpt=args.clip_ckpt, vit_ckpt=args.vit_ckpt,
                 rgb_resnet_sd=args.rgb_resnet_ckpt,
                 ddppo_sd=args.ddppo_ckpt)
    if any(v is not None for v in ckpts.values()):
        from gridmm_tpu_torch.ce.factory import load_ce_released_weights

        load_ce_released_weights(agent, **ckpts)
    if args.env == "habitat":
        from gridmm_tpu_torch.ce.habitat_env import HabitatContinuousEnv

        if not args.habitat_config:
            raise SystemExit("--env habitat needs --habitat_config")
        episodes_allowed = None
        if args.data_path and args.run_type == "train":
            # scene-balanced train allocation (ss_trainer_GridMap.py:77-139)
            # over the ranks
            from gridmm_tpu_torch.ce.dataset import (
                allocate_episodes_by_scene, load_vlnce_dataset)

            eps, _ = load_vlnce_dataset(args.data_path, args.train_split,
                                        shuffle_seed=None)
            episodes_allowed = allocate_episodes_by_scene(
                eps, process_count())[process_index()]
        env = HabitatContinuousEnv(
            args.habitat_config, num_envs=args.num_envs,
            eval_mode=args.run_type in ("eval", "inference"),
            episodes_allowed=episodes_allowed)
    else:
        # observation size must match the agent's towers (224 for the
        # full-scale ResNet50/ViT agent, 56 for the tiny smoke agent)
        env = SyntheticContinuousEnv(num_envs=args.num_envs,
                                     image_size=224 if args.full else 56,
                                     depth_size=256, seed=args.seed,
                                     num_episodes=args.num_episodes or None)
    mesh = None
    if args.mesh == "auto":
        mesh = make_mesh(MeshConfig(mp_size=args.mp_size), device.type)
        print(f"mesh: data={mesh.size(0)} model={args.mp_size}")
    trainer = CETrainer(
        cfg, agent, mesh=mesh, schedule_ratio=args.schedule_ratio,
        epochs_per_ratio=epochs_per_ratio(args.epochs, args.decay_time))
    logger = MetricLogger(args.output_dir if process_index() == 0 else None)
    try:
        return _run(args, trainer, env, logger)
    finally:
        logger.close()


def _run(args, trainer, env, logger):
    if args.run_type == "inference":
        path = args.predictions_file or os.path.join(
            args.output_dir, f"predictions_{args.predictions_format}.json")
        n = trainer.inference(env, path, fmt=args.predictions_format,
                              batches=args.eval_batches,
                              max_steps=args.max_steps)
        print(json.dumps({"predictions": n, "file": path}))
        return {"predictions": n, "file": path}

    if args.run_type == "train":
        from gridmm_tpu_torch.ce.trainer import (derive_batches_per_epoch,
                                                 latest_checkpoint)

        if args.batches_per_epoch == 0:
            args.batches_per_epoch = derive_batches_per_epoch(
                env, args.num_envs)
            print(f"batches_per_epoch derived from split: "
                  f"{args.batches_per_epoch}")
        ckpt_dir = (os.path.join(args.output_dir, "checkpoints")
                    if args.ckpt_dir is None else args.ckpt_dir)
        start_ep = 0
        if args.resume and ckpt_dir:
            newest = latest_checkpoint(ckpt_dir)
            if newest is not None:
                start_ep = trainer.restore(newest) + 1
                print(json.dumps({"resumed": newest, "epoch": start_ep}))
        for ep in range(start_ep, args.epochs):
            stats = trainer.train_epoch(env, ep,
                                        batches=args.batches_per_epoch,
                                        max_steps=args.max_steps,
                                        logger=logger, seed=args.seed)
            print(json.dumps({"epoch": ep, **stats}), flush=True)
            if ckpt_dir and (ep % args.save_every == 0
                             or ep == args.epochs - 1):
                trainer.save(os.path.join(ckpt_dir, f"ckpt.{ep}"))
        trainer.close()  # the last checkpoint is on disk before eval
    if args.run_type == "eval" and args.poll_ckpt_dir:
        from gridmm_tpu_torch.ce.trainer import evaluate_checkpoints_polling

        results = evaluate_checkpoints_polling(
            trainer, env, args.poll_ckpt_dir, batches=args.eval_batches,
            max_steps=args.max_steps, timeout_seconds=args.poll_timeout,
            results_dir=args.results_dir, split=args.eval_split,
            video_dir=args.video_dir)
        print(json.dumps({"polled": results}))
        return results[-1] if results else {}
    metrics = trainer.evaluate(env, batches=args.eval_batches,
                               max_steps=args.max_steps,
                               results_dir=args.results_dir,
                               checkpoint_index=args.checkpoint_index,
                               split=args.eval_split,
                               video_dir=args.video_dir)
    print(json.dumps({"eval": metrics}))
    return metrics


if __name__ == "__main__":
    main()

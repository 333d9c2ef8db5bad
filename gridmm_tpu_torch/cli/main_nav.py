"""Fine-tune / evaluate the GridMM navigator (discrete environments; twin of
gridmm_tpu/cli/main_nav.py, the equivalent of map_nav_src/main_nav.py).

  # synthetic world, tiny model: smoke-trainable anywhere
  python -m gridmm_tpu_torch.cli.main_nav --world synthetic --iters 6 --eval

  # the same on the CPU
  python -m gridmm_tpu_torch.cli.main_nav --world synthetic --device cpu

  # real R2R data laid out per the reference convention, features converted
  # to gmmstore files by gridmm_tpu_torch.cli.convert_store
  python -m gridmm_tpu_torch.cli.main_nav --world r2r --root_dir /data \
      --feature_backend gmmstore --iters 20000 --log_every 500 --eval

  # data parallel over the 8 cards of a host (torchrun starts one process
  # a card); --mp_size 2 adds tensor parallelism inside pairs of cards
  torchrun --nproc_per_node 8 -m gridmm_tpu_torch.cli.main_nav \
      --world synthetic --mesh auto --batch_size 16 --iters 6

--batch_size is the global batch: under --mesh auto each data rank rolls
out batch_size / dp episodes of its own (seed + its data rank) and
evaluates its contiguous shard of the val split; --multihost joins the
torchrun/env:// world without a mesh (each rank trains its own replica, as
the JAX CLI does per host).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from gridmm_tpu_torch.parallel.multihost import allocate_episodes_by_scene

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
                   default="auto",
                   help="gmmstore = mmap stores from cli/convert_store.py "
                        "(auto uses them when present next to the HDF5 files)")
    p.add_argument("--aug", default=None,
                   help="augmented-instruction annotation split or file; "
                        "trains 1:1 interleaved with the GT env")
    p.add_argument("--aug_views", default=None,
                   help="EnvEdit augmented-view HDF5")
    p.add_argument("--dagger_sum", action="store_true",
                   help="sum teacher+sample losses per iteration "
                        "(reference DAgger gradient shape)")
    p.add_argument("--scene_shard", action="store_true",
                   help="partition the train split by scene across the "
                        "data ranks (the CE trainer's allocation) instead "
                        "of the full split on every rank")
    p.add_argument("--multihost", action="store_true",
                   help="join the world torchrun / env:// describes "
                        "(init_process_group from the environment)")
    p.add_argument("--mesh", choices=["off", "auto"], default="off",
                   help="auto = shard the replay update over a (data, "
                        "model) mesh of the launched world")
    p.add_argument("--mp_size", type=int, default=1,
                   help="model-parallel axis size within --mesh auto")
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


def build_synthetic(args, cfg, rank: int = 0, n: int = 1,
                    batch_size: int = 0):
    """(train_env, val_env) of data rank `rank` of `n`: the train env with
    seed + rank, the val env over the rank's contiguous shard."""
    from gridmm_tpu_torch.env.discrete import (DiscreteNavEnv,
                                               synthetic_episodes)
    from gridmm_tpu_torch.env.world import SyntheticWorld

    bs = batch_size or args.batch_size
    world = SyntheticWorld(num_scans=2, nodes_per_scan=10, seed=args.seed)
    train_eps = synthetic_episodes(world, num=24, seed=args.seed)
    val_eps = synthetic_episodes(world, num=12, seed=args.seed + 1)
    if n > 1 and args.scene_shard:
        train_eps = allocate_episodes_by_scene(train_eps, n)[rank]
    train_env = DiscreteNavEnv(world, world.graphs, train_eps,
                               batch_size=bs, seed=args.seed + rank)
    val_env = DiscreteNavEnv(world, world.graphs, val_eps,
                             batch_size=bs, seed=args.seed, name="val",
                             sel_data_idxs=(rank, n) if n > 1 else None)
    return train_env, val_env


def _hdf5_view_bank(path: str, image_feat_size: int):
    """Aug-view lookup over aug_views.hdf5 (utils/data.py:36 contract).

    One persistent read handle (not a per-key open/close cycle) and an f16
    cache: the same footprint the reference's in-RAM aug store keeps
    (utils/data.py:34-38). h5py is imported only here."""
    import h5py

    cache = {}
    handle = []

    def lookup(scan, vp):
        key = f"{scan}_{vp}"
        if key not in cache:
            if not handle:
                handle.append(h5py.File(path, "r"))
            cache[key] = handle[0][key][...][:, :image_feat_size].astype(
                "float16")
        return cache[key].astype("float32")

    return lookup


def build_real(args, cfg, rank: int = 0, n: int = 1, batch_size: int = 0):
    """(train_env, val_env, aug_env) over the reference layout
    ROOT/{DATASET}/{features,connectivity,annotations} (twin of
    gridmm_tpu/cli/main_nav.py build_real) for data rank `rank` of `n`."""
    from gridmm_tpu_torch.data.datasets import construct_instrs
    from gridmm_tpu_torch.env.discrete import DiscreteNavEnv
    from gridmm_tpu_torch.env.nav_graph import load_nav_graphs
    from gridmm_tpu_torch.env.world import (AugmentedViewWorld,
                                            GmmStoreWorld, Hdf5ObjectWorld,
                                            Hdf5World)

    ds = args.world.upper()
    root = os.path.join(args.root_dir, ds)
    anno = os.path.join(root, "annotations")
    feat = os.path.join(root, "features")
    conn = os.path.join(root, "connectivity")
    tok = "xlm" if args.world == "rxr" else "bert"
    train_data = construct_instrs(anno, ds, ["train"], tok,
                                  cfg.shapes.max_txt_len)
    val_data = construct_instrs(anno, ds, ["val_unseen"], tok,
                                cfg.shapes.max_txt_len)
    with open(os.path.join(feat, "viewpoint_info.json")) as f:
        vp_info = json.load(f)
    base_files = (
        os.path.join(feat, "pth_vit_base_patch16_224_imagenet.hdf5"),
        os.path.join(feat, "depth.hdf5"),
        os.path.join(feat, "clip_p32.hdf5"))
    gmm_files = tuple(os.path.splitext(f)[0] + ".gmm" for f in base_files)
    use_gmm = args.feature_backend == "gmmstore" or (
        args.feature_backend == "auto"
        and all(os.path.exists(f) for f in gmm_files))
    obj_ft = os.path.join(feat, "obj.avg.top3.min80_vit_base_patch16_224.hdf5")
    # SOON bboxes are annotated on 600x600 renders; REVERIE on 480x640
    # (SoonTextPathData dataset.py:849-850)
    obj_hw = (600.0, 600.0) if args.world == "soon" else (480.0, 640.0)
    if use_gmm:
        world = GmmStoreWorld(*gmm_files, vp_info)
        if args.world in ("reverie", "soon"):
            if os.path.exists(obj_ft):
                # objects keep coming from the reference HDF5: the gmm
                # backend only replaces the dense view/depth/grid stores
                from gridmm_tpu_torch.env.world import (Hdf5ObjectReader,
                                                        ObjectWorld)

                world = ObjectWorld(world, Hdf5ObjectReader(
                    obj_ft, image_hw=obj_hw))
            else:
                print(f"warning: object features not found at {obj_ft}; "
                      "object grounding disabled")
    elif args.world in ("reverie", "soon") and os.path.exists(obj_ft):
        world = Hdf5ObjectWorld(*base_files, vp_info, obj_ft_file=obj_ft,
                                image_hw=obj_hw)
    else:
        if args.world in ("reverie", "soon"):
            print(f"warning: object features not found at {obj_ft}; "
                  "object grounding disabled")
        world = Hdf5World(*base_files, vp_info)
    # SOON: object pseudo-labels from the GT bbox polygons
    # (soon/env.py:331-424 scoring contract; the og teacher needs gt_obj_id)
    if args.world == "soon" and hasattr(world, "objects"):
        from gridmm_tpu_torch.data.datasets import soon_pseudo_obj_labels

        soon_pseudo_obj_labels(train_data, world)
        soon_pseudo_obj_labels(val_data, world)
    # EnvEdit aug bank on the TRAIN env only (utils/data.py:22-39)
    train_world = world
    if args.aug_views:
        train_world = AugmentedViewWorld(
            world, _hdf5_view_bank(args.aug_views, cfg.model.image_feat_size),
            seed=args.seed)
    # several ranks: the val env takes the reference's contiguous shard
    # via sel_data_idxs (main_nav.py:79 / r2r/env.py:427-435); the
    # reference's discrete DDP keeps the FULL train split on every rank
    # with a decorrelated shuffle (main_nav.py:54-58: seed=args.seed+rank),
    # and --scene_shard opts into the scene-balanced partition
    bs = batch_size or args.batch_size
    val_shard = (rank, n) if n > 1 else None
    if n > 1 and args.scene_shard:
        train_data = allocate_episodes_by_scene(train_data, n)[rank]
    # augmented-instruction env, interleaved with GT (main_nav.py:35-47)
    aug_data = None
    if args.aug:
        aug_data = construct_instrs(anno, ds, [args.aug], tok,
                                    cfg.shapes.max_txt_len)
        if n > 1 and args.scene_shard:
            aug_data = allocate_episodes_by_scene(aug_data, n)[rank]
    scans = {x["scan"] for x in train_data} | {x["scan"] for x in val_data}
    if aug_data:
        scans |= {x["scan"] for x in aug_data}
    graphs = load_nav_graphs(conn, scans)
    train_env = DiscreteNavEnv(train_world, graphs, train_data,
                               batch_size=bs, seed=args.seed + rank)
    val_env = DiscreteNavEnv(world, graphs, val_data, batch_size=bs,
                             seed=args.seed, name="val_unseen",
                             sel_data_idxs=val_shard)
    aug_env = None
    if aug_data:
        aug_env = DiscreteNavEnv(train_world, graphs, aug_data,
                                 batch_size=bs, seed=args.seed + rank,
                                 name="aug")
    return train_env, val_env, aug_env


def _check_args(args) -> None:
    if args.world != "synthetic" and not args.root_dir:
        raise ValueError(f"--world {args.world} needs --root_dir")
    if args.detailed_output and not args.submit:
        raise ValueError("--detailed_output shapes the --submit file; give "
                         "--submit with it")


def main(argv=None):
    args = parse_args(argv)
    _check_args(args)
    import torch.distributed as dist

    from gridmm_tpu_torch.parallel.mesh import init_world

    created = False
    if args.multihost or args.mesh == "auto":
        created = init_world(args.device, args.multihost)
    try:
        return _main(args)
    finally:
        if created:
            dist.destroy_process_group()


def _main(args):
    from gridmm_tpu_torch.config import (MeshConfig, r2r_config,
                                         reverie_config, rxr_config,
                                         soon_config, tiny_config)
    from gridmm_tpu_torch.parallel.mesh import (data_rank, local_device,
                                                make_mesh)
    from gridmm_tpu_torch.parallel.multihost import (merge_prediction_lists,
                                                     process_count,
                                                     process_index)
    from gridmm_tpu_torch.models.navigator import init_navigator
    from gridmm_tpu_torch.train.agent import NavAgent
    from gridmm_tpu_torch.train.loop import train_navigator
    from gridmm_tpu_torch.utils.logging import MetricLogger

    cfg = {"reverie": reverie_config, "soon": soon_config,
           "rxr": rxr_config}.get(args.world, r2r_config)()
    if args.tiny or args.world == "synthetic":
        cfg = tiny_config()
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

    device = local_device(args.device)
    # the data rank and count the envs are sharded by, and each rank's
    # share of the batch
    rank, n, local_batch = process_index(), process_count(), args.batch_size
    mesh = None
    if args.mesh == "auto":
        world = process_count()
        if world % args.mp_size:
            raise ValueError(f"{world} devices not divisible by --mp_size "
                             f"{args.mp_size}")
        mesh = make_mesh(MeshConfig(mp_size=args.mp_size), device.type)
        n = world // args.mp_size
        if cfg.train.batch_size % n:
            raise ValueError(f"--batch_size {cfg.train.batch_size} not "
                             f"divisible by data-parallel size {n}")
        rank, local_batch = data_rank(mesh), cfg.train.batch_size // n
        print(f"mesh: data={n} model={args.mp_size}")

    if args.world == "synthetic":
        train_env, val_env = build_synthetic(args, cfg, rank, n, local_batch)
        aug_env = None
    else:
        train_env, val_env, aug_env = build_real(args, cfg, rank, n,
                                                 local_batch)

    model = init_navigator(cfg.model, seed=args.seed, device=device)
    if args.resume:
        from gridmm_tpu_torch.utils.checkpoint import restore_checkpoint

        restore_checkpoint(os.path.abspath(args.resume), model)

    agent = NavAgent(model, cfg, train_env)
    # --submit needs a val agent even without periodic --eval
    val_agent = NavAgent(model, cfg, val_env) \
        if (args.eval or args.submit) else None
    aug_agent = NavAgent(model, cfg, aug_env) if aug_env else None

    # rank 0 writes the event log
    logger = MetricLogger(os.path.join(args.output_dir, "logs")
                          if process_index() == 0 else None)
    try:
        result = train_navigator(
            cfg, model, agent, val_agent if args.eval else None,
            aug_agent=aug_agent, iters=args.iters, log_every=args.log_every,
            eval_batches=args.eval_batches or None,  # 0 -> full split
            ckpt_dir=os.path.join(args.output_dir, "ckpts"), logger=logger,
            seed=args.seed, mesh=mesh)
    finally:
        logger.close()
    if args.submit and val_agent is not None:
        # final full-split predictions in leaderboard format
        # (main_nav.py:246-260 valid() submit JSON); the ranks' shards
        # merged like the reference's all_gather + merge_dist_results
        _, preds = val_agent.evaluate(None,
                                      detailed_output=args.detailed_output)
        preds = merge_prediction_lists(preds)
        if process_index() == 0:
            val_agent.write_submission(
                preds, args.submit, objects=cfg.model.obj_feat_size > 0,
                fmt=args.world if args.world in ("soon", "reverie")
                else "auto")
            print(f"wrote {len(preds)} predictions -> {args.submit}")
    if process_index() == 0:
        print(json.dumps({
            "best_spl": result.best_spl, "best_iter": result.best_iter,
            **{f"final_{k}": v for k, v in result.final_metrics.items()}}))
    return result


if __name__ == "__main__":
    main()

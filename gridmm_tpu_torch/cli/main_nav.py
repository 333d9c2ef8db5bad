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

One process trains on one device; the multi-process and mesh options wait
for the parallel layer (see the error they raise).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict, List

import numpy as np

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
                   help="partition the train split by scene across ranks "
                        "(not ported yet: one process)")
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


def allocate_episodes_by_scene(episodes: List[dict], num_workers: int,
                               scene_key: str = "scan") -> List[List[dict]]:
    """Scene-load-balanced episode allocation across workers (a copy of
    gridmm_tpu/parallel/multihost.py's, VLN_CE ss_trainer_GridMap.py:77-139):
    whole scenes go greedily to the least-loaded worker."""
    by_scene: Dict[str, List[dict]] = {}
    for ep in episodes:
        by_scene.setdefault(str(ep[scene_key]), []).append(ep)
    buckets: List[List[dict]] = [[] for _ in range(num_workers)]
    loads = [0] * num_workers
    for scene, eps in sorted(by_scene.items(), key=lambda kv: -len(kv[1])):
        w = int(np.argmin(loads))
        buckets[w].extend(eps)
        loads[w] += len(eps)
    return buckets


def build_real(args, cfg):
    """(train_env, val_env, aug_env) over the reference layout
    ROOT/{DATASET}/{features,connectivity,annotations} (twin of
    gridmm_tpu/cli/main_nav.py build_real) for one process: rank 0 of 1."""
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
    # augmented-instruction env, interleaved with GT (main_nav.py:35-47)
    aug_data = None
    if args.aug:
        aug_data = construct_instrs(anno, ds, [args.aug], tok,
                                    cfg.shapes.max_txt_len)
    scans = {x["scan"] for x in train_data} | {x["scan"] for x in val_data}
    if aug_data:
        scans |= {x["scan"] for x in aug_data}
    graphs = load_nav_graphs(conn, scans)
    train_env = DiscreteNavEnv(train_world, graphs, train_data,
                               batch_size=args.batch_size, seed=args.seed)
    val_env = DiscreteNavEnv(world, graphs, val_data,
                             batch_size=args.batch_size, seed=args.seed,
                             name="val_unseen")
    aug_env = None
    if aug_data:
        aug_env = DiscreteNavEnv(train_world, graphs, aug_data,
                                 batch_size=args.batch_size, seed=args.seed,
                                 name="aug")
    return train_env, val_env, aug_env


def _check_ported(args) -> None:
    if args.mesh != "off":
        raise NotImplementedError(
            "--mesh auto waits for the parallel layer (ROADMAP Queue 1, "
            "parallel layer: parallel/mesh.py)")
    if args.multihost:
        raise NotImplementedError(
            "--multihost waits for the parallel layer (ROADMAP Queue 1, "
            "parallel layer: parallel/multihost.py)")
    # options of the multi-process builder and of the mesh: refuse them
    # rather than run without what was asked for
    for flag, default in (("scene_shard", False), ("mp_size", 1)):
        if getattr(args, flag) != default:
            raise NotImplementedError(
                f"--{flag} is read only by the parallel layer, which is not "
                "ported yet (ROADMAP Queue 1, parallel layer)")
    if args.world != "synthetic" and not args.root_dir:
        raise ValueError(f"--world {args.world} needs --root_dir")
    if args.detailed_output and not args.submit:
        raise ValueError("--detailed_output shapes the --submit file; give "
                         "--submit with it")


def main(argv=None):
    args = parse_args(argv)
    _check_ported(args)
    from gridmm_tpu_torch.config import (r2r_config, reverie_config,
                                         rxr_config, soon_config, tiny_config)
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

    if args.world == "synthetic":
        train_env, val_env = build_synthetic(args, cfg)
        aug_env = None
    else:
        train_env, val_env, aug_env = build_real(args, cfg)

    model = init_navigator(cfg.model, seed=args.seed, device=args.device)
    if args.resume:
        from gridmm_tpu_torch.utils.checkpoint import restore_checkpoint

        restore_checkpoint(os.path.abspath(args.resume), model)

    agent = NavAgent(model, cfg, train_env)
    # --submit needs a val agent even without periodic --eval
    val_agent = NavAgent(model, cfg, val_env) \
        if (args.eval or args.submit) else None
    aug_agent = NavAgent(model, cfg, aug_env) if aug_env else None

    logger = MetricLogger(os.path.join(args.output_dir, "logs"))
    try:
        result = train_navigator(
            cfg, model, agent, val_agent if args.eval else None,
            aug_agent=aug_agent, iters=args.iters, log_every=args.log_every,
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
            preds, args.submit, objects=cfg.model.obj_feat_size > 0,
            fmt=args.world if args.world in ("soon", "reverie") else "auto")
        print(f"wrote {len(preds)} predictions -> {args.submit}")
    print(json.dumps({
        "best_spl": result.best_spl, "best_iter": result.best_iter,
        **{f"final_{k}": v for k, v in result.final_metrics.items()}}))
    return result


if __name__ == "__main__":
    main()

"""One-command released-checkpoint parity evaluation (twin of
scripts/parity_eval.py).

Imports a reference PyTorch checkpoint into the port's navigator, runs the
FULL val split greedy eval and prints the SR/SPL metric line: the "SPL
within 0.5 points" check of BASELINE.md as one invocation (reference flow:
main_nav.py:218-262 valid() over val_unseen with a --resume_file imported
via models/vlnbert_init.py:13-63).

Real-asset invocation (reference data layout), on the card:

  python -m gridmm_tpu_torch.cli.parity_eval --world r2r --root_dir /data \\
      --navigator_ckpt /data/ckpts/grid_map.pt --batch_size 8

  # pretrain checkpoint flavor (model_step_N.pt: 'bert.'-prefixed trunk)
  python -m gridmm_tpu_torch.cli.parity_eval --world r2r --root_dir /data \\
      --navigator_ckpt /data/ckpts/model_step_100000.pt --flavor pretrain

Dry run (no assets; synthetic world, tiny dims):

  python -m gridmm_tpu_torch.cli.parity_eval --world synthetic \\
      --navigator_ckpt fake.pt --device cpu
"""

from __future__ import annotations

import argparse
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--world", choices=["synthetic", "r2r", "reverie", "soon",
                                       "rxr"], default="r2r")
    p.add_argument("--synthetic_preset", choices=["r2r", "reverie", "soon",
                                                  "rxr"], default="r2r",
                   help="--world synthetic only: shape the tiny dry-run like "
                        "this released artifact family (reverie/soon: object "
                        "tokens + og head, has_obj import rules; rxr: "
                        "xlm-roberta-sized word embeddings)")
    p.add_argument("--root_dir", default=None,
                   help="dataset root (ROOT/{DATASET}/{features,connectivity,"
                        "annotations})")
    p.add_argument("--navigator_ckpt", required=True,
                   help="torch checkpoint: fine-tuned grid_map.pt/best_val_"
                        "unseen (vln_bert/state_dict nesting) or a pretrain "
                        "model_step_N.pt")
    p.add_argument("--flavor", choices=["finetune", "pretrain"],
                   default="finetune",
                   help="finetune: agent_base.py:213-228 save format; "
                        "pretrain: ModelSaver files with 'bert.' trunk "
                        "prefixes (vlnbert_init.py:19-27 remap)")
    p.add_argument("--split", default="val_unseen")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--eval_batches", type=int, default=0,
                   help="0 = full split (the parity number); >0 subsamples")
    p.add_argument("--feature_backend", choices=["auto", "hdf5", "gmmstore"],
                   default="auto")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device of the navigator")
    p.add_argument("--submit", default=None,
                   help="also write leaderboard predictions JSON here")
    return p.parse_args(argv)


def synthetic_config(preset: str):
    """Tiny dry-run config shaped like one released artifact family."""
    import dataclasses

    from gridmm_tpu_torch.config import tiny_config

    cfg = tiny_config()
    if preset in ("reverie", "soon"):
        # object tokens on: og_head/obj projections exist and the import
        # runs the has_obj rule set (reverie_config at real scale)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, obj_feat_size=cfg.model.image_feat_size))
    elif preset == "rxr":
        # xlm-roberta-shaped vocab stand-in: larger than BERT's, still tiny
        # in params; synthetic instruction ids reach 29000
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, vocab_size=40000))
    return cfg


def import_navigator_checkpoint(ckpt, model, cfg, flavor: str,
                                what: str = "navigator"):
    """A reference checkpoint (file path or loaded dict) onto `model` in
    place, failing loudly on a key-space mismatch; returns the report."""
    from gridmm_tpu_torch.utils import checkpoint as CK

    # a file is read without running pickled code (tensors, dicts, numbers)
    sd = CK.restore_checkpoint(ckpt) if isinstance(ckpt, str) else ckpt
    if flavor == "pretrain":
        sd = CK.remap_pretrain_to_navigator(
            sd.get("model", sd) if isinstance(sd, dict) else sd)
    else:
        # grid_map.pt / best_val_unseen ({'vln_bert': {'state_dict'}}) and
        # CE ckpt.{epoch}.pth nestings alike
        sd = CK.remap_ce_released(sd)
    out, report = CK.import_torch_navigator(
        sd, model,
        num_l_layers=cfg.model.num_l_layers,
        num_x_layers=cfg.model.num_x_layers,
        num_pano_layers=cfg.model.num_pano_layers,
        has_obj=cfg.model.obj_feat_size > 0)
    CK.require_navigator_coverage(report, what=f"{flavor} {what}")
    model.load_state_dict(out, strict=True)
    n_filled = len(out) - len(report["unfilled_flax_leaves"])
    print(f"imported {n_filled} leaves "
          f"({len(report['unused_torch_keys'])} torch keys unused)")
    return report


def build_val_env(args, cfg):
    """Eval-only env for one split (the val half of cli/main_nav.build_real)."""
    if args.world == "synthetic":
        from gridmm_tpu_torch.env.discrete import (DiscreteNavEnv,
                                                   synthetic_episodes)
        from gridmm_tpu_torch.env.world import SyntheticWorld

        world = SyntheticWorld(num_scans=2, nodes_per_scan=10, seed=args.seed)
        # REVERIE/SOON episodes carry a gt object at the goal viewpoint
        eps = synthetic_episodes(
            world, num=12, seed=args.seed + 1,
            with_objects=args.synthetic_preset in ("reverie", "soon"))
        return DiscreteNavEnv(world, world.graphs, eps,
                              batch_size=args.batch_size, seed=args.seed,
                              name=args.split)

    from gridmm_tpu_torch.data.datasets import construct_instrs
    from gridmm_tpu_torch.env.discrete import DiscreteNavEnv
    from gridmm_tpu_torch.env.nav_graph import load_nav_graphs
    from gridmm_tpu_torch.env.world import (GmmStoreWorld, Hdf5ObjectWorld,
                                            Hdf5World)

    ds = args.world.upper()
    root = os.path.join(args.root_dir, ds)
    anno = os.path.join(root, "annotations")
    feat = os.path.join(root, "features")
    tok = "xlm" if args.world == "rxr" else "bert"
    data = construct_instrs(anno, ds, [args.split], tok,
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
    obj_hw = (600.0, 600.0) if args.world == "soon" else (480.0, 640.0)
    if use_gmm:
        world = GmmStoreWorld(*gmm_files, vp_info)
        if args.world in ("reverie", "soon") and os.path.exists(obj_ft):
            from gridmm_tpu_torch.env.world import (Hdf5ObjectReader,
                                                    ObjectWorld)

            world = ObjectWorld(world, Hdf5ObjectReader(obj_ft,
                                                        image_hw=obj_hw))
    elif args.world in ("reverie", "soon") and os.path.exists(obj_ft):
        world = Hdf5ObjectWorld(*base_files, vp_info, obj_ft_file=obj_ft,
                                image_hw=obj_hw)
    else:
        world = Hdf5World(*base_files, vp_info)
    if args.world == "soon" and hasattr(world, "objects"):
        from gridmm_tpu_torch.data.datasets import soon_pseudo_obj_labels

        soon_pseudo_obj_labels(data, world)
    graphs = load_nav_graphs(os.path.join(root, "connectivity"),
                             {x["scan"] for x in data})
    return DiscreteNavEnv(world, graphs, data, batch_size=args.batch_size,
                          seed=args.seed, name=args.split)


def main(argv=None):
    args = parse_args(argv)
    from gridmm_tpu_torch.config import (r2r_config, reverie_config,
                                         rxr_config, soon_config)
    from gridmm_tpu_torch.models.navigator import init_navigator
    from gridmm_tpu_torch.train.agent import NavAgent

    if args.world == "synthetic":
        cfg = synthetic_config(args.synthetic_preset)
    else:
        if not args.root_dir:
            raise ValueError(f"--world {args.world} needs --root_dir")
        cfg = {"reverie": reverie_config, "soon": soon_config,
               "rxr": rxr_config}.get(args.world, r2r_config)()

    env = build_val_env(args, cfg)
    model = init_navigator(cfg.model, seed=args.seed, device=args.device)
    import_navigator_checkpoint(args.navigator_ckpt, model, cfg, args.flavor)

    agent = NavAgent(model, cfg, env)
    metrics, preds = agent.evaluate(args.eval_batches or None)
    if args.submit:
        agent.write_submission(
            preds, args.submit,
            fmt=args.world if args.world in ("soon", "reverie") else "auto")
        print(f"wrote {len(preds)} predictions -> {args.submit}")
    print(json.dumps({"split": args.split, "n_preds": len(preds),
                      **{k: round(float(v), 4)
                         for k, v in metrics.items()}}))
    return metrics


if __name__ == "__main__":
    main()

"""Export the navigator's serving programs (twin of
gridmm_tpu/cli/export_serving.py).

The deployment counterpart of cli/main_nav.py: given a dataset preset and a
checkpoint, writes `language.pt2` + `nav_step.pt2` + `manifest.json`,
`torch.export` programs that a host loads and calls without the model code
(see gridmm_tpu_torch/utils/export.py; serve them with
`NavServingEngine.from_bundle`). The programs take the weights as an input
and hold none; with --navigator_ckpt the imported weights are written
beside them as `navigator.pt` (a state dict; the manifest names it under
"weights"). Examples:

  # tiny smoke export on the CPU
  python -m gridmm_tpu_torch.cli.export_serving --tiny --device cpu \\
      --out_dir runs/bundle_tiny

  # R2R programs for serving 4 slots on the card
  python -m gridmm_tpu_torch.cli.export_serving --config r2r --batch 4 \\
      --out_dir runs/bundle_r2r

  # the same for a released fine-tune checkpoint (grid_map.pt)
  python -m gridmm_tpu_torch.cli.export_serving --config r2r --batch 4 \\
      --navigator_ckpt ckpts/grid_map.pt --out_dir runs/bundle_released

  # one pair of programs per card of a 4-card host, 2 x 2 (data, model)
  torchrun --nproc_per_node 4 -m gridmm_tpu_torch.cli.export_serving \\
      --config r2r --batch 8 --mesh auto --mp_size 2 --out_dir runs/b4
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

# the imported weights beside the programs (--navigator_ckpt)
WEIGHTS_FILE = "navigator.pt"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", choices=["r2r", "reverie", "soon", "rxr"],
                   default="r2r")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model dims (tests/smoke)")
    p.add_argument("--batch", type=int, default=1,
                   help="static serving batch of the exported step graph")
    p.add_argument("--max_action_len", type=int, default=None,
                   help="episode-length cap; sizes the exported point buffer")
    p.add_argument("--device", default="cuda",
                   help="device type the programs are traced for")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--resume", default=None,
                   help="checkpoint file written by main_nav")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--int8", action="store_true",
                   help="int8 trunk matmuls (ModelConfig.int8_matmuls): the "
                        "programs quantize the f32 weights they are given "
                        "at every call (with --mesh, with the absmax of "
                        "the whole batch and the whole weight row)")
    p.add_argument("--navigator_ckpt", default=None,
                   help="released torch checkpoint (grid_map/finetune "
                        "format); supersedes --resume")
    p.add_argument("--mesh", choices=["auto"], default=None,
                   help="export over a (data, model) mesh of the launched "
                        "world: one pair of programs per rank over its "
                        "shards (run under torchrun, one process a card)")
    p.add_argument("--mp_size", type=int, default=1,
                   help="model-axis size of --mesh auto")
    p.add_argument("--fsdp", action="store_true",
                   help="with --mesh auto: the programs take parameters "
                        "sharded over the data axis too and all-gather "
                        "them")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch.distributed as dist

    from gridmm_tpu_torch.parallel.mesh import init_world

    created = init_world(args.device) if args.mesh else False
    try:
        return _main(args)
    finally:
        if created:
            dist.destroy_process_group()


def _main(args):
    from gridmm_tpu_torch import config as C
    from gridmm_tpu_torch.models.navigator import init_navigator
    from gridmm_tpu_torch.parallel.mesh import local_device, make_mesh
    from gridmm_tpu_torch.parallel.multihost import (process_count,
                                                     process_index)
    from gridmm_tpu_torch.utils.export import (
        export_navigator_serving, export_navigator_serving_sharded,
        save_serving_bundle)

    cfg = C.tiny_config() if args.tiny else {
        "r2r": C.r2r_config, "reverie": C.reverie_config,
        "soon": C.soon_config, "rxr": C.rxr_config}[args.config]()
    if args.max_action_len:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(
                cfg.train, max_action_len=args.max_action_len),
            shapes=dataclasses.replace(
                cfg.shapes,
                max_points=args.max_action_len * cfg.grid.points_per_step))
    if args.int8:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, int8_matmuls=True))

    device = local_device(args.device)
    model = init_navigator(cfg.model, seed=args.seed, device=device)
    extra = {}
    if args.navigator_ckpt:
        from gridmm_tpu_torch.cli.parity_eval import \
            import_navigator_checkpoint

        import_navigator_checkpoint(args.navigator_ckpt, model, cfg,
                                    "finetune", what="serving navigator")
        extra["weights"] = WEIGHTS_FILE
    elif args.resume:
        from gridmm_tpu_torch.utils.checkpoint import restore_checkpoint

        restore_checkpoint(os.path.abspath(args.resume), model)
    rank = None
    if args.mesh:
        # every rank holds the same full weights (seed or checkpoint) and
        # exports its own programs
        mesh = make_mesh(C.MeshConfig(mp_size=args.mp_size), device.type)
        exports, extra["mesh"] = export_navigator_serving_sharded(
            model, cfg, model.state_dict(), mesh, batch=args.batch,
            fsdp=args.fsdp, device=device)
        rank = process_index()
    else:
        exports = export_navigator_serving(model, cfg, model.state_dict(),
                                           batch=args.batch, device=device)
    manifest = save_serving_bundle(
        exports, args.out_dir, cfg=cfg,
        extra_manifest={"batch": args.batch,
                        "config": "tiny" if args.tiny else args.config,
                        "int8": args.int8, **extra},
        rank=rank, world=process_count() if args.mesh else 1)
    if rank in (None, 0):
        if args.navigator_ckpt:
            from gridmm_tpu_torch.utils.checkpoint import save_checkpoint

            save_checkpoint(os.path.join(args.out_dir, WEIGHTS_FILE),
                            model.state_dict())
        print(json.dumps(manifest))
    return manifest


if __name__ == "__main__":
    main()

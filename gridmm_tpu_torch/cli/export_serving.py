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
                   help="int8 trunk matmuls (not ported yet)")
    p.add_argument("--navigator_ckpt", default=None,
                   help="released torch checkpoint (grid_map/finetune "
                        "format); supersedes --resume")
    p.add_argument("--mesh", choices=["auto"], default=None,
                   help="multi-device export (not ported yet)")
    p.add_argument("--mp_size", type=int, default=1,
                   help="model-axis size of --mesh auto (not ported yet)")
    p.add_argument("--fsdp", action="store_true",
                   help="shard parameters over the data axis (not ported "
                        "yet)")
    return p.parse_args(argv)


def _check_ported(args) -> None:
    waits = (
        (args.int8, "--int8", "ops/quant.py (ROADMAP Queue 1, int8 matmuls)"),
        (args.mesh, "--mesh", "parallel/mesh.py (ROADMAP Queue 1, parallel "
         "layer)"),
        (args.mp_size != 1, "--mp_size", "parallel/mesh.py (ROADMAP Queue 1, "
         "parallel layer)"),
        (args.fsdp, "--fsdp", "parallel/mesh.py (ROADMAP Queue 1, parallel "
         "layer)"))
    for given, flag, what in waits:
        if given:
            raise NotImplementedError(f"{flag} waits for {what}, which is "
                                      "not ported yet")


def main(argv=None):
    args = parse_args(argv)
    _check_ported(args)

    from gridmm_tpu_torch import config as C
    from gridmm_tpu_torch.models.navigator import init_navigator
    from gridmm_tpu_torch.utils.export import (export_navigator_serving,
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

    model = init_navigator(cfg.model, seed=args.seed, device=args.device)
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
    exports = export_navigator_serving(model, cfg, model.state_dict(),
                                       batch=args.batch, device=args.device)
    manifest = save_serving_bundle(
        exports, args.out_dir, cfg=cfg,
        extra_manifest={"batch": args.batch,
                        "config": "tiny" if args.tiny else args.config,
                        "int8": False, **extra})
    if args.navigator_ckpt:
        from gridmm_tpu_torch.utils.checkpoint import save_checkpoint

        save_checkpoint(os.path.join(args.out_dir, WEIGHTS_FILE),
                        model.state_dict())
    print(json.dumps(manifest))
    return manifest


if __name__ == "__main__":
    main()

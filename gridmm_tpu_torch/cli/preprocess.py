"""Offline preprocessing command (twin of gridmm_tpu/cli/preprocess.py):
render panoramas, encode CLIP grid features, write the reference artifact
set.

It walks the connectivity viewpoints, renders 12 horizon views per
viewpoint (MatterSim when installed, a deterministic synthetic renderer
otherwise), encodes them through the double-buffered CLIP extractor on
`--device` (the card by default), and writes

  clip_p32.hdf5        {scan}_{vp}: (12, 50, 768) f16   (r2r/env.py:167)
  depth.hdf5           {scan}_{vp}: (12, 128, 128) u16  (r2r/env.py:166)
  viewpoint_info.json  {scan}_{vp}: {x, y, z}           (r2r/env.py:168)

  python -m gridmm_tpu_torch.cli.preprocess --connectivity_dir conn/ \\
      --output_dir feats/ --renderer mattersim --scan_data_dir v1/scans \\
      --clip_ckpt ViT-B-32.pt

Writing HDF5 needs h5py.
"""

from __future__ import annotations

import argparse
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--connectivity_dir", required=True,
                   help="MP3D connectivity (scans.txt + *_connectivity.json)")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--renderer", choices=["mattersim", "synthetic"],
                   default="mattersim")
    p.add_argument("--scan_data_dir", default=None,
                   help="MatterSim dataset path (v1/scans)")
    p.add_argument("--clip_ckpt", default=None,
                   help="OpenAI ViT-B-32.pt to import; random init otherwise")
    p.add_argument("--batch_panos", type=int, default=8)
    p.add_argument("--resolution", type=int, default=224)
    p.add_argument("--tiny", action="store_true",
                   help="tiny CLIP dims (smoke tests; still 50 tokens)")
    p.add_argument("--device", default="cuda",
                   help="torch device that runs the tower (default cuda)")
    return p.parse_args(argv)


def load_clip_state_dict(path: str):
    """The state dict of an OpenAI CLIP checkpoint: a TorchScript archive
    (the released ViT-B-32.pt) or a plain saved state dict."""
    import torch

    try:
        return torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:  # not TorchScript
        return torch.load(path, map_location="cpu", weights_only=True)


def main(argv=None):
    args = parse_args(argv)
    from gridmm_tpu_torch.data.preprocess import (ClipFeatureExtractor,
                                                  Hdf5Sink,
                                                  extract_viewpoint_info,
                                                  load_viewpoint_ids,
                                                  mattersim_renderer,
                                                  synthetic_renderer)
    from gridmm_tpu_torch.env.nav_graph import load_nav_graphs
    from gridmm_tpu_torch.models.clip_vit import ClipVisionConfig, clip_b32

    os.makedirs(args.output_dir, exist_ok=True)
    viewpoints = load_viewpoint_ids(args.connectivity_dir)
    scans = sorted({s for s, _ in viewpoints})
    print(f"{len(viewpoints)} viewpoints over {len(scans)} scans")

    if args.renderer == "mattersim":
        records = mattersim_renderer(viewpoints, args.connectivity_dir,
                                     args.scan_data_dir,
                                     resolution=args.resolution)
    else:
        records = synthetic_renderer(viewpoints, resolution=args.resolution)

    if args.tiny:
        cfg = ClipVisionConfig(input_resolution=args.resolution,
                               patch_size=args.resolution // 7, width=64,
                               layers=1, heads=4, compute_dtype="float32")
    else:
        cfg = clip_b32()
    extractor = ClipFeatureExtractor(cfg, batch_panos=args.batch_panos,
                                     device=args.device)
    if args.clip_ckpt:
        from gridmm_tpu_torch.utils.checkpoint import import_torch_clip_visual

        import_torch_clip_visual(load_clip_state_dict(args.clip_ckpt),
                                 extractor.model)

    sink = Hdf5Sink(os.path.join(args.output_dir, "clip_p32.hdf5"),
                    os.path.join(args.output_dir, "depth.hdf5"))
    try:
        n = extractor.run(records, sink)
    finally:
        sink.close()
    print(f"encoded {n} panoramas")

    graphs = load_nav_graphs(args.connectivity_dir, scans)
    info = extract_viewpoint_info(graphs)
    with open(os.path.join(args.output_dir, "viewpoint_info.json"), "w") as f:
        json.dump(info, f)
    print(f"wrote viewpoint_info.json ({len(info)} entries)")
    return n


if __name__ == "__main__":
    main()

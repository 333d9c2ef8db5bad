"""Multi-task pretraining command line, MLM/MRC/SAP[/OG] (twin of
gridmm_tpu/cli/pretrain.py, the equivalent of pretrain_src/train_r2r.py:
70-333): task-multiplexed updates with periodic task-accuracy validation.
Two data sources:

  * real trajectory annotations: --traj_files jsonl + the preprocess HDF5
    artifacts (view/depth/grid stores + viewpoint_info + connectivity), the
    contract of pretrain_src/train_r2r.py:162-203 / config/r2r_pretrain.json
  * synthetic batches (default; smoke tests and benchmarks)

  python -m gridmm_tpu_torch.cli.pretrain --steps 20 --valid_every 10
  python -m gridmm_tpu_torch.cli.pretrain --device cpu --steps 4
  python -m gridmm_tpu_torch.cli.pretrain --preset r2r \\
      --traj_files anns/train_1.jsonl,anns/train_2.jsonl \\
      --connectivity_dir connectivity/ \\
      --view_ft_file fts/views.hdf5 --depth_file fts/depth.hdf5 \\
      --grid_ft_file fts/clip_p32.hdf5 --viewpoint_info fts/vp_info.json

  # data (x tensor) parallel over the launched world, one process a card
  torchrun --nproc_per_node 8 -m gridmm_tpu_torch.cli.pretrain \
      --mesh auto --mp_size 2 --batch_size 16

Under --mesh auto every rank draws the same global batch and trains on its
data rank's slice of it (an accumulation window's microbatches each
split), the losses are the whole batch's, and rank 0 writes full
checkpoints.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--tasks", default="mlm,mrc,sap")
    p.add_argument("--mix_ratio", default="1,1,1")
    p.add_argument("--steps", type=int, default=20,
                   help="optimizer steps (with --accum_steps k each consumes "
                        "k microbatches)")
    p.add_argument("--accum_steps", type=int, default=1,
                   help="gradient-accumulation window: the task is held "
                        "fixed for k microbatches, grads averaged, ONE "
                        "optimizer step per window (loader.py:44-59 + "
                        "train_r2r.py:251-296 semantics)")
    p.add_argument("--valid_every", type=int, default=10)
    p.add_argument("--save_every", type=int, default=0,
                   help="save a checkpoint every N optimizer steps (0 = "
                        "final only); the ModelSaver model_step_N cadence "
                        "(pretrain_src/utils/save.py:23-45). Each save also "
                        "writes a navigator state dict that main_nav "
                        "--resume takes")
    p.add_argument("--resume", default=None,
                   help="checkpoint file from a previous run "
                        "(ckpts/latest): restores weights, optimizer, step")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--num_traj_steps", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device of the model and the updates")
    p.add_argument("--mesh", choices=["off", "auto"], default="off",
                   help="auto = shard the update over a (data, model) mesh "
                        "of the launched world")
    p.add_argument("--mp_size", type=int, default=1,
                   help="model-parallel axis size within --mesh auto")
    p.add_argument("--output_dir", default="runs/pretrain")
    p.add_argument("--preset", default=None,
                   choices=["tiny", "r2r", "reverie", "soon", "rxr"],
                   help="config preset (default tiny; r2r when --full)")
    p.add_argument("--full", action="store_true",
                   help="alias for --preset r2r")
    # real-data mode (pretrain_src/train_r2r.py:162-203 contract)
    p.add_argument("--traj_files", default=None,
                   help="comma-separated trajectory jsonl files")
    p.add_argument("--val_traj_files", default=None,
                   help="validation jsonl files (default: tail split)")
    p.add_argument("--val_fraction", type=float, default=0.1)
    p.add_argument("--val_batches", type=int, default=0,
                   help="0 = the WHOLE val split in order (reference "
                        "validate() iterates the full loader, "
                        "train_r2r.py:355-448); >0 subsamples")
    p.add_argument("--connectivity_dir", default=None)
    p.add_argument("--view_ft_file", default=None)
    p.add_argument("--depth_file", default=None)
    p.add_argument("--grid_ft_file", default=None)
    p.add_argument("--viewpoint_info", default=None)
    p.add_argument("--obj_ft_file", default=None,
                   help="REVERIE/SOON object feature HDF5 (enables og)")
    p.add_argument("--aug_view_ft_file", default=None,
                   help="EnvEdit aug_views.hdf5; train views swapped with "
                        "p=0.5 (SoonTextPathData.get_scanvp_feature "
                        "is_train branch, dataset.py:856-864)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 activations/matmuls (params, head logits "
                        "and losses stay f32)")
    # model init (train_r2r.py:105-141)
    p.add_argument("--init_checkpoint", default=None,
                   help="torch pretrain checkpoint (ModelSaver "
                        "model_step_N.pt key space) to continue from "
                        "(train_r2r.py --checkpoint)")
    p.add_argument("--init_pretrained", default="none",
                   choices=["none", "bert", "lxmert"],
                   help="initialize from released language-model weights "
                        "(train_r2r.py:109-141); needs --init_weights")
    p.add_argument("--init_weights", default=None,
                   help="torch state-dict file for --init_pretrained "
                        "(bert-base pytorch_model.bin / model_LXRT.pth)")
    p.add_argument("--init_fill_lang_encoder", action="store_true",
                   help="with --init_pretrained bert: also map "
                        "encoder.layer.i onto the language trunk — the "
                        "reference init drops those keys silently "
                        "(see utils/checkpoint.remap_hf_bert_init)")
    args = p.parse_args(argv)
    # fail fast, before dataset/param init (train_r2r.py:105-141 semantics)
    if args.init_checkpoint and args.init_pretrained != "none":
        p.error("--init_checkpoint and --init_pretrained are mutually "
                "exclusive (a checkpoint supersedes the language-model init)")
    if args.init_pretrained != "none" and not args.init_weights:
        p.error("--init_pretrained needs --init_weights (a local torch "
                "state-dict file)")
    return args


def _load_torch_state(path: str):
    """A reference torch checkpoint's state dict: the file's top level, or
    its 'state_dict' / 'model' entry (read without running pickled
    code)."""
    from gridmm_tpu_torch.utils.checkpoint import restore_checkpoint

    sd = restore_checkpoint(path)
    for key in ("state_dict", "model"):
        if isinstance(sd, dict) and isinstance(sd.get(key), dict):
            sd = sd[key]
    return sd


def _apply_init_weights(args, cfg, model) -> None:
    """Model init from torch weights (train_r2r.py:105-141), into `model`
    in place: a pretrain checkpoint supersedes the language-model init;
    bert fills only the embedding stack (faithfully), lxmert fills
    embeddings + language layers + local x-layers + MLM head."""
    if not (args.init_checkpoint or args.init_pretrained != "none"):
        return
    from gridmm_tpu_torch.utils import checkpoint as ckpt_lib

    path = args.init_checkpoint or args.init_weights
    sd = _load_torch_state(path)
    m = cfg.model
    kw = dict(num_l_layers=m.num_l_layers, num_x_layers=m.num_x_layers,
              num_pano_layers=m.num_pano_layers, has_obj=m.obj_feat_size > 0)
    if args.init_checkpoint:
        out, report = ckpt_lib.import_torch_pretrain(sd, model, **kw)
    elif args.init_pretrained == "bert":
        out, report = ckpt_lib.import_hf_bert_pretrain(
            sd, model, fill_lang_encoder=args.init_fill_lang_encoder, **kw)
    else:
        out, report = ckpt_lib.import_lxmert_pretrain(sd, model, **kw)
    n_leaves = len(out)
    filled = n_leaves - len(report["unfilled_flax_leaves"])
    if filled == 0:
        raise ValueError(
            f"init weights at {path} matched ZERO parameters — wrong key "
            f"space? unused keys (first few): "
            f"{report['unused_torch_keys'][:8]}")
    model.load_state_dict(out, strict=True)
    print(json.dumps({"init_filled_leaves": filled,
                      "init_total_leaves": n_leaves,
                      "init_unused_torch_keys":
                          len(report["unused_torch_keys"])}))


def _resolve_config(args):
    from gridmm_tpu_torch import config as C

    preset = args.preset or ("r2r" if args.full else "tiny")
    cfg = {
        "tiny": C.tiny_config, "r2r": C.r2r_config,
        "reverie": C.reverie_config, "soon": C.soon_config,
        "rxr": C.rxr_config,
    }[preset]()
    if preset == "tiny":
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, image_prob_size=32))
    else:
        # pretraining trajectories reach TRAIN_MAX_STEP+1 = 21 panoramas
        # (the truncation appends end_vp, pretrain_src/data/dataset.py:
        # 251-253); size the point buffer for 21 steps (12348 -> x128 12416)
        need = 21 * cfg.grid.points_per_step
        if cfg.shapes.max_points < need:
            cfg = dataclasses.replace(
                cfg,
                shapes=dataclasses.replace(cfg.shapes, max_points=12416),
                grid=dataclasses.replace(cfg.grid, max_steps=21))
    if args.obj_ft_file and cfg.model.obj_feat_size == 0:
        # object store provided -> enable object tokens + the og head
        cfg = dataclasses.replace(
            cfg,
            model=dataclasses.replace(cfg.model,
                                      obj_feat_size=cfg.model.image_feat_size),
            shapes=dataclasses.replace(cfg.shapes, max_obj_len=20))
    if args.bf16:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model,
                                           compute_dtype="bfloat16"))
    return cfg


def build_dataset(args, cfg):
    """TextPathDataset over real annotations (train_r2r.py:162-203)."""
    from gridmm_tpu_torch.data.pretrain_data import (TextPathDataset,
                                                     load_trajectory_jsonl)
    from gridmm_tpu_torch.env.nav_graph import load_nav_graphs
    from gridmm_tpu_torch.env.world import Hdf5ObjectWorld, Hdf5World

    data = load_trajectory_jsonl(args.traj_files.split(","))
    if not data:
        raise ValueError(f"no trajectories in {args.traj_files}")
    with open(args.viewpoint_info) as f:
        vp_info = json.load(f)
    kwargs = dict(view_ft_file=args.view_ft_file, depth_file=args.depth_file,
                  grid_ft_file=args.grid_ft_file, viewpoint_info=vp_info,
                  image_feat_size=cfg.model.image_feat_size)
    if args.obj_ft_file:
        obj_hw = ((600.0, 600.0) if args.preset == "soon"
                  else (480.0, 640.0))  # SOON bboxes live on 600x600 renders
        world = Hdf5ObjectWorld(obj_ft_file=args.obj_ft_file,
                                max_objects=cfg.shapes.max_obj_len or 20,
                                angle_feat_size=cfg.model.angle_feat_size,
                                image_hw=obj_hw, **kwargs)
    else:
        world = Hdf5World(**kwargs)

    scans = sorted({d["scan"] for d in data})
    graphs = load_nav_graphs(args.connectivity_dir, scans)
    if args.val_traj_files:
        val_data = load_trajectory_jsonl(args.val_traj_files.split(","))
        train_data = data
    else:
        n_val = max(int(len(data) * args.val_fraction), 1)
        train_data, val_data = data[:-n_val] or data, data[-n_val:]

    # SOON annotations carry only bbox polygons; derive object pseudo-labels
    # once so the og task has supervision (soon/env.py:331-424 matching;
    # items that already carry obj_pseudo_label.idx are consumed directly)
    def _needs_labels(items):
        return any("bboxes" in d and "objId" not in d
                   and "obj_pseudo_label" not in d for d in items)

    if args.obj_ft_file and (_needs_labels(train_data)
                             or _needs_labels(val_data)):
        from gridmm_tpu_torch.data.datasets import soon_pseudo_obj_labels

        soon_pseudo_obj_labels(train_data, world)
        soon_pseudo_obj_labels(val_data, world)
    train_world = world
    if args.aug_view_ft_file:
        # EnvEdit aug bank, train split only (the reference gates the swap on
        # is_train, pretrain_src/data/dataset.py:856-864)
        from gridmm_tpu_torch.cli.main_nav import _hdf5_view_bank
        from gridmm_tpu_torch.env.world import AugmentedViewWorld

        train_world = AugmentedViewWorld(
            world, _hdf5_view_bank(args.aug_view_ft_file,
                                   cfg.model.image_feat_size),
            seed=args.seed)
    # end-vp sampling / SAP-teacher flavor follows the reference dataset
    # class per task: R2RTextPathData for r2r AND rxr (train_rxr.py:30)
    flavor = {"reverie": "reverie", "soon": "soon"}.get(args.preset, "r2r")
    train_ds = TextPathDataset(train_data, train_world, graphs, cfg,
                               seed=args.seed, flavor=flavor)
    val_ds = TextPathDataset(val_data, world, graphs, cfg,
                             seed=args.seed + 1,
                             shortest_paths=train_ds.shortest_paths,
                             flavor=flavor)
    return train_ds, val_ds


class DatasetBatcher:
    """Shuffled-epoch index sampler over a TextPathDataset."""

    def __init__(self, ds, batch_size: int, seed: int = 0):
        self.ds = ds
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed)
        self._queue: list = []

    def _next_indices(self):
        while len(self._queue) < self.batch_size:
            self._queue.extend(self._rng.permutation(len(self.ds)).tolist())
        out, self._queue = (self._queue[: self.batch_size],
                            self._queue[self.batch_size:])
        return out

    def batch(self, task: str):
        return self.ds.build_batch(self._next_indices(), task)


class SyntheticBatcher:
    """`n` rotating synthetic batches (all task labels present in every
    batch), seeds seed..seed+n-1, each made on the host when first asked
    for (a short run does not pay for batches it never takes)."""

    def __init__(self, cfg, batch_size, num_traj_steps, seed, n=4):
        self._shape = (cfg, batch_size, num_traj_steps)
        self._seed, self._n = seed, n
        self._batches: dict = {}
        self._i = 0

    def batch(self, task: str):
        from gridmm_tpu_torch.train.synthetic import synthetic_pretrain_batch

        k = self._i % self._n
        if k not in self._batches:
            self._batches[k] = synthetic_pretrain_batch(
                *self._shape, seed=self._seed + k, device="cpu")
        self._i += 1
        return self._batches[k]


def prefetched_task_batches(mux, batcher, steps: int, size: int = 2,
                            device="cuda"):
    """Overlap host batch collation (TextPathDataset expansion is host
    python) and the copy to the device with device compute: the
    PrefetchLoader equivalent (pretrain_src/data/loader.py:90-124) for the
    task-multiplexed stream, built on train/prefetch.device_prefetch. Yields
    (task, device_batch) `steps` times; closing it early stops its
    thread."""
    from gridmm_tpu_torch.train.prefetch import device_prefetch

    def host():
        for _ in range(steps):
            task = next(mux)
            yield task, batcher.batch(task)

    return device_prefetch(host(), size=size, device=device)


def validate(model, batches_by_task):
    """Task accuracies (train_r2r.py:355-448 validate_{mlm,mrc,sap,og}), in
    eval mode, without gradients; the model's mode is restored after.

    Correct/total COUNTS accumulate across batches and divide once (the
    reference's n_correct/n_word reduction) so metrics are invariant to how
    the val split is chunked into batches."""
    import torch

    from gridmm_tpu_torch.train.pretrain import (_enc_kwargs,
                                                 _mask_mrc_features)

    was_training = model.training
    model.eval()
    out = {}
    try:
        with torch.no_grad():
            for task, batches in batches_by_task.items():
                if callable(batches):  # lazy full-split iterator factory
                    batches = batches()
                counts: dict = {}

                def tally(name, correct, total):
                    c, t = counts.get(name, (0.0, 0.0))
                    counts[name] = (c + float(correct), t + float(total))

                for batch in batches:
                    if task == "mlm":
                        logits = model.forward_mlm_logits(
                            batch.txt_ids, batch.txt_mask, _enc_kwargs(batch))
                        sel = batch.txt_labels != -1
                        correct = (logits.argmax(-1) == batch.txt_labels) & sel
                        tally("mlm_acc", correct.sum(), sel.sum())
                        continue
                    if task == "mrc":
                        batch = _mask_mrc_features(batch)
                    enc = model.encode(batch.txt_ids, batch.txt_mask,
                                       **_enc_kwargs(batch))
                    if task == "mrc":
                        logits = model.forward_mrc_logits(enc)
                        sel = batch.view_mrc_masks
                        correct = ((logits.argmax(-1)
                                    == batch.view_probs.argmax(-1)) & sel)
                        tally("mrc_acc", correct.sum(), sel.sum())
                    elif task == "sap":
                        g, lo, f, _ = model.forward_sap_logits(
                            enc, batch.gmap_mask, batch.gmap_visited_mask,
                            batch.vp_nav_mask, batch.fused_add_idx,
                            batch.cand_backtrack_mask)
                        n = batch.global_act_labels.shape[0]
                        tally("sap_gacc", (g.argmax(-1)
                                           == batch.global_act_labels).sum(),
                              n)
                        tally("sap_lacc", (lo.argmax(-1)
                                           == batch.local_act_labels).sum(),
                              n)
                        tally("sap_acc", (f.argmax(-1)
                                          == batch.global_act_labels).sum(),
                              n)
                    elif task == "og":
                        logits = model.forward_og_logits(enc,
                                                         batch.vp_obj_mask)
                        sel = batch.obj_labels >= 0
                        correct = (logits.argmax(-1) == batch.obj_labels) & sel
                        tally("og_acc", correct.sum(), sel.sum())
                for name, (c, t) in counts.items():
                    out[name] = c / max(t, 1.0)
                out.setdefault(f"{task}_acc", 0.0)
    finally:
        model.train(was_training)
    return out


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
    import torch

    from gridmm_tpu_torch.config import MeshConfig
    from gridmm_tpu_torch.parallel.mesh import (ShardedParams, data_rank,
                                                local_device, make_mesh,
                                                mesh_shape, shard_batch)
    from gridmm_tpu_torch.parallel.multihost import process_index

    from gridmm_tpu_torch.models.navigator import GridMMNavigator
    from gridmm_tpu_torch.train.optimizers import (build_optimizer,
                                                   warmup_linear_schedule)
    from gridmm_tpu_torch.train.pretrain import (TaskMultiplexer,
                                                 init_pretrain_params,
                                                 make_pretrain_accum_step,
                                                 make_pretrain_step,
                                                 pretrain_batch_to_device)
    from gridmm_tpu_torch.train.step import create_train_state
    from gridmm_tpu_torch.utils.checkpoint import (AsyncSaver,
                                                   pretrain_params_to_navigator,
                                                   restore_checkpoint)
    from gridmm_tpu_torch.utils.logging import MetricLogger

    cfg = _resolve_config(args)
    tasks = args.tasks.split(",")
    mix = [float(x) for x in args.mix_ratio.split(",")]
    if len(mix) != len(tasks):
        raise ValueError(f"--mix_ratio has {len(mix)} entries for "
                         f"{len(tasks)} tasks")
    device = local_device(args.device)
    mesh = None
    if args.mesh == "auto":
        mesh = make_mesh(MeshConfig(mp_size=args.mp_size), device.type)
        dp = mesh_shape(mesh)[0]
        if args.batch_size % dp:
            raise SystemExit(
                f"--batch_size {args.batch_size} not divisible by the "
                f"data-parallel axis ({dp})")
        print(f"mesh: data={dp} model={args.mp_size}")

    if args.traj_files:
        train_ds, val_ds = build_dataset(args, cfg)
        batcher = DatasetBatcher(train_ds, args.batch_size, seed=args.seed)
        if args.val_batches:
            val_batcher = DatasetBatcher(val_ds, args.batch_size,
                                         seed=args.seed + 1)
            val_by_task = {
                t: [pretrain_batch_to_device(val_batcher.batch(t), device)
                    for _ in range(args.val_batches)]
                for t in tasks}
        else:
            # full val split in order, rebuilt lazily per validation call
            # (reference validates the whole loader, train_r2r.py:355-448)
            def _full_split(task, bs=args.batch_size, ds=val_ds):
                return (pretrain_batch_to_device(ds.build_batch(
                    list(range(i, min(i + bs, len(ds)))), task), device)
                    for i in range(0, len(ds), bs))

            val_by_task = {t: (lambda t=t: _full_split(t)) for t in tasks}
    else:
        from gridmm_tpu_torch.train.synthetic import synthetic_pretrain_batch

        # made on the host: the prefetcher stages them on the device
        batcher = SyntheticBatcher(cfg, args.batch_size, args.num_traj_steps,
                                   seed=args.seed)
        val_batches = [synthetic_pretrain_batch(
            cfg, args.batch_size, args.num_traj_steps, seed=args.seed + 100,
            device=device)]
        val_by_task = {t: val_batches for t in tasks}

    model = init_pretrain_params(cfg.model, seed=args.seed, device=device)
    _apply_init_weights(args, cfg, model)
    model.train()
    ckpt = (restore_checkpoint(os.path.abspath(args.resume))
            if args.resume else None)
    if ckpt is not None:
        model.load_state_dict(ckpt["model"], strict=True)
    # every rank holds the same full weights here; each keeps its slices
    sharded = ShardedParams(model, mesh) if mesh is not None else None
    # warmup + linear decay, the reference pretraining schedule
    # (pretrain_src/optim/sched.py warmup_linear)
    sched = warmup_linear_schedule(
        cfg.train.lr, min(cfg.train.warmup_steps, max(args.steps // 10, 1)),
        max(cfg.train.num_train_steps, args.steps))
    # pretraining's AdamW constants differ from the fine-tune ones:
    # betas (0.9, 0.98) (parser.py:69, *_pretrain.json) and the vendored
    # optim/adamw.py eps default 1e-6
    tcfg = dataclasses.replace(cfg.train, betas=cfg.train.pretrain_betas,
                               adam_eps=cfg.train.pretrain_adam_eps)
    state = create_train_state(cfg, model,
                               build_optimizer("adamw", tcfg, model, sched),
                               sharded)

    if ckpt is not None:
        if sharded is not None:
            sharded.load_optimizer_state(state.optimizer, ckpt["optimizer"])
        else:
            state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = int(ckpt["step"])
        print(json.dumps({"resumed_step": state.step}))

    ckpt_root = os.path.abspath(os.path.join(args.output_dir, "ckpts"))
    # the fine-tune tree's keys, without allocating its weights
    with torch.device("meta"):
        nav_template = GridMMNavigator(cfg.model)
    # cadence saves copy to the host and write in a thread, overlapping the
    # next training window
    saver = AsyncSaver()

    def _save(tag: str, nav: bool = True) -> None:
        # under a mesh every rank gathers (a collective), rank 0 writes
        if sharded is not None:
            sd = sharded.full_state_dict()
            opt = sharded.full_optimizer_state(state.optimizer)
        else:
            sd, opt = model.state_dict(), state.optimizer.state_dict()
        if process_index() != 0:
            return
        saver.save(os.path.join(ckpt_root, tag),
                   {"model": sd, "optimizer": opt, "step": state.step})
        if nav:
            # fine-tune handoff: main_nav --resume <dir>/navigator_latest;
            # the pretrain-only language branch and heads dropped
            saver.save(os.path.join(ckpt_root, "navigator_latest"),
                       pretrain_params_to_navigator(sd, nav_template))

    accum = max(args.accum_steps, 1)
    if accum > 1:
        steps = {t: make_pretrain_accum_step(cfg, t, accum) for t in tasks}
    else:
        steps = {t: make_pretrain_step(cfg, t) for t in tasks}
    mux = iter(TaskMultiplexer(tasks, mix, seed=args.seed,
                               accum_steps=accum))
    logger = MetricLogger(args.output_dir if process_index() == 0 else None)

    def local(batch):
        """The data rank's slice of a global batch."""
        if sharded is None:
            return batch
        return shard_batch(batch, data_rank(mesh), sharded.dp)

    # --steps counts OPTIMIZER steps; each consumes `accum` microbatches of
    # the same (held) task
    stream = prefetched_task_batches(mux, batcher, args.steps * accum,
                                     device=device)
    window: list = []
    it = 0
    try:
        for task, batch in stream:
            window.append((task, batch))
            if len(window) < accum:
                continue
            if any(t != task for t, _ in window):
                raise RuntimeError("task changed inside an accumulation "
                                   "window")
            if accum == 1:
                metrics = steps[task](state, local(batch), seed=args.seed + 1)
            else:
                metrics = steps[task](state, [local(b) for _, b in window],
                                      seed=args.seed + 1)
            window = []
            it += 1
            logger.log(it, {k: float(v) for k, v in metrics.items()},
                       prefix="pretrain/")
            if args.save_every and it % args.save_every == 0:
                # the navigator export once per cadence (with 'latest'); the
                # step_N file is a resume point only
                _save(f"step_{state.step}", nav=False)
                _save("latest")
            if it % args.valid_every == 0 or it == args.steps:
                # every rank validates the whole batches (the same numbers)
                with (sharded.compute_params() if sharded is not None
                      else contextlib.nullcontext()):
                    acc = validate(model, val_by_task)
                logger.log(it, acc, prefix="valid/")
                if process_index() == 0:
                    print(json.dumps({"step": it, **acc}))
    except BaseException:
        # interrupted: park a resumable checkpoint before propagating, but
        # only if this run stepped (a crash before the first update must not
        # overwrite a previous run's 'latest' with fresh init); under a mesh
        # the other ranks may not reach the gather, so the last cadence
        # save stays the resume point
        if it > 0 and sharded is None:
            try:
                _save("latest")
                saver.close()  # durable before exiting
            except Exception as save_err:  # don't mask the original error
                print(f"interrupt-save failed: {save_err!r}", flush=True)
        raise
    finally:
        stream.close()
        logger.close()
    _save("latest")
    saver.close()
    if sharded is not None:
        # the returned module is one process's again
        sharded.unshard()
        state.sharded = None
    return state


if __name__ == "__main__":
    main()

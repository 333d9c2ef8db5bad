"""Spawned gloo ranks on the CPU for the parallel layer's tests
(tests/test_torch_parallel.py): a runner and the per-rank cases.

This module imports torch and the port only, so that each spawned rank
starts without JAX. The tests start the ranks with the port's launcher,
parallel/dryrun.spawn_ranks: it picks a free port, gathers each rank's
result with a timeout and joins every process with a timeout, so a hung
collective fails the test that started it instead of stalling the suite.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


# ------------------------------------------------------------ the cases
def _mesh(mp_size, device="cpu"):
    from gridmm_tpu_torch.config import MeshConfig
    from gridmm_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(MeshConfig(mp_size=mp_size), device)


def update_cases(rank, world, cases):
    """One make_train_step update per case on this rank's slice of the
    case's batch. cases: [(tcfg, state_dict of numpy arrays, TrajectoryBatch
    of numpy arrays, mp, fsdp)]. Returns per case the global loss, the
    grad norm, the updated full state dict (numpy, rank 0) and the size of
    the rank's slice."""
    import numpy as np
    import torch

    from gridmm_tpu_torch.models.navigator import GridMMNavigator
    from gridmm_tpu_torch.parallel.mesh import (ShardedParams, data_rank,
                                                mesh_shape,
                                                shard_trajectory_batch)
    from gridmm_tpu_torch.train.step import (batch_to_device,
                                             create_train_state,
                                             make_train_step)

    out = []
    for tcfg, sd, batch, mp_size, fsdp in cases:
        mesh = _mesh(mp_size)
        model = GridMMNavigator(tcfg.model)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        model.train()
        sharded = ShardedParams(model, mesh, fsdp)
        state = create_train_state(tcfg, model, sharded=sharded)
        dp = mesh_shape(mesh)[0]
        local = shard_trajectory_batch(batch, data_rank(mesh), dp)
        metrics = make_train_step(tcfg)(state, batch_to_device(local, "cpu"),
                                        seed=0)
        full = {k: v.numpy() for k, v in sharded.full_state_dict().items()}
        out.append({"loss": float(metrics["loss"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    "params": full if rank == 0 else None,
                    "local_batch": int(local.txt_ids.shape[0])})
    return out


def pretrain_cases(rank, world, cases):
    """One make_pretrain_step update per case: (tcfg, state_dict, numpy
    PretrainBatch, task, mp). Returns per case the global loss, the grad
    norm and the updated full state dict (rank 0)."""
    import torch

    from gridmm_tpu_torch.models.pretrain import GridMMPretrain
    from gridmm_tpu_torch.parallel.mesh import (ShardedParams, data_rank,
                                                mesh_shape, shard_batch)
    from gridmm_tpu_torch.train.pretrain import (make_pretrain_step,
                                                 pretrain_batch_to_device)
    from gridmm_tpu_torch.train.step import create_train_state

    out = []
    for tcfg, sd, batch, task, mp_size in cases:
        mesh = _mesh(mp_size)
        model = GridMMPretrain(tcfg.model)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        model.train()
        sharded = ShardedParams(model, mesh)
        state = create_train_state(tcfg, model, sharded=sharded)
        local = shard_batch(batch, data_rank(mesh), mesh_shape(mesh)[0])
        metrics = make_pretrain_step(tcfg, task)(
            state, pretrain_batch_to_device(local, "cpu"), seed=0)
        full = {k: v.numpy() for k, v in sharded.full_state_dict().items()}
        out.append({"loss": float(metrics[f"loss_{task}"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    "params": full if rank == 0 else None})
    return out


def ce_refuses_indivisible_envs(rank, world):
    """CETrainer over a (world, 1) mesh and an env of world + 1 envs: the
    message of the ValueError train_epoch raises."""
    from gridmm_tpu_torch.ce.env import SyntheticContinuousEnv
    from gridmm_tpu_torch.ce.factory import build_ce_agent
    from gridmm_tpu_torch.ce.trainer import CETrainer

    cfg, agent = build_ce_agent(tiny=True, img=56, seed=0, device="cpu")
    trainer = CETrainer(cfg, agent, mesh=_mesh(1))
    env = SyntheticContinuousEnv(num_envs=world + 1, image_size=56,
                                 depth_size=256, seed=0)
    try:
        trainer.train_epoch(env, 0, batches=1, max_steps=2)
    except ValueError as e:
        return str(e)
    return None


def ddp_case(rank, world, nav_case):
    """What DDP makes of the port's update shapes, against the reduction it
    is meant to make (the mean over the ranks of each rank's own
    gradient): the navigator's teacher-forced update under DDP as built and
    with find_unused_parameters, and an MLM pretraining update under
    DDP(static_graph=True), whose task calls the model's methods rather
    than its forward. nav_case: (tcfg, state_dict of numpy arrays, numpy
    TrajectoryBatch). Returns each one's worst |diff| / max|leaf|."""
    import torch
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel as DDP

    from gridmm_tpu_torch.models.navigator import GridMMNavigator
    from gridmm_tpu_torch.parallel.mesh import (shard_batch,
                                                shard_trajectory_batch)
    from gridmm_tpu_torch.train.pretrain import (init_pretrain_params,
                                                 task_loss)
    from gridmm_tpu_torch.train.step import batch_to_device, trajectory_loss
    from gridmm_tpu_torch.train.synthetic import synthetic_pretrain_batch

    def worst(make, loss_of, ddp_kw):
        model = make()
        loss_of(model).backward()
        want = {k: p.grad for k, p in model.named_parameters()
                if p.grad is not None}
        for g in want.values():
            dist.all_reduce(g)
            g /= world
        model = make()
        wrapped = DDP(model, **ddp_kw)
        loss_of(wrapped).backward()
        return max(float((p.grad - want[k]).abs().max()
                         / want[k].abs().max().clamp_min(1e-30))
                   for k, p in model.named_parameters() if k in want)

    tcfg, sd, batch = nav_case

    def navigator():
        model = GridMMNavigator(tcfg.model)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        return model.train()

    local = batch_to_device(shard_trajectory_batch(batch, rank, world), "cpu")

    def nav_loss(m):
        return trajectory_loss(m, tcfg, local)

    pre_batch = shard_batch(synthetic_pretrain_batch(tcfg, 2 * world, 3,
                                                     seed=0, device="cpu"),
                            rank, world)

    def pretrain_loss(m):
        return task_loss(getattr(m, "module", m), pre_batch, "mlm")

    return {
        "navigator": worst(navigator, nav_loss, {}),
        "navigator_find_unused": worst(navigator, nav_loss,
                                       {"find_unused_parameters": True}),
        "pretrain_static_graph": worst(
            lambda: init_pretrain_params(tcfg.model, seed=0,
                                         device="cpu").train(),
            pretrain_loss, {"static_graph": True})}


def checks(rank, world, spec):
    """Several of the cases above in one start of the ranks: spec maps a
    case function's name to its arguments."""
    return {name: globals()[name](rank, world, *args)
            for name, args in spec.items()}


def multihost_case(rank, world, per_rank):
    """The multihost functions on this rank's inputs: per_rank[rank] is
    (predictions, metrics, weight)."""
    from gridmm_tpu_torch.parallel import multihost as MH

    preds, metrics, weight = per_rank[rank]
    return {"count": MH.process_count(), "index": MH.process_index(),
            "merged": MH.merge_prediction_lists(preds),
            "weighted": MH.weighted_mean_scalars(metrics, weight),
            "mean": MH.all_mean_scalars(metrics)}


def sharded_bundle_case(rank, world, out_dirs, texts, rows, steps):
    """Per out_dir (fsdp off, then on): export the tiny navigator's serving
    programs over a (world / 2, 2) mesh at batch 4, serve them with
    from_bundle on this rank's data shard of the requests (texts, rows:
    numpy, one per request and step) and return each step's outputs
    (numpy); first, the batch % dp refusal's message."""
    import torch

    from gridmm_tpu_torch.config import MeshConfig, tiny_config
    from gridmm_tpu_torch.models.navigator import init_navigator
    from gridmm_tpu_torch.parallel.mesh import data_rank, make_mesh
    from gridmm_tpu_torch.serve.engine import NavServingEngine
    from gridmm_tpu_torch.utils.export import (
        export_navigator_serving_sharded, save_serving_bundle)

    cfg = tiny_config()
    mesh = make_mesh(MeshConfig(mp_size=2), "cpu")
    model = init_navigator(cfg.model, seed=0, device="cpu")
    out = {}
    try:
        export_navigator_serving_sharded(model, cfg, model.state_dict(),
                                         mesh, batch=3, device="cpu")
    except ValueError as e:
        out["refusal"] = str(e)
    local = len(texts) // mesh.size(0)
    mine = range(data_rank(mesh) * local, (data_rank(mesh) + 1) * local)
    for out_dir, fsdp in zip(out_dirs, (False, True)):
        exports, entry = export_navigator_serving_sharded(
            model, cfg, model.state_dict(), mesh, batch=len(texts),
            fsdp=fsdp, device="cpu")
        save_serving_bundle(exports, out_dir, cfg=cfg,
                            extra_manifest={"batch": len(texts),
                                            "mesh": entry},
                            rank=rank, world=world)
        eng = NavServingEngine.from_bundle(out_dir, cfg,
                                           dict(model.state_dict()),
                                           len(texts), device="cpu")
        for slot, r in enumerate(mine):
            eng.submit(slot, *texts[r])
        eng.admit()
        got = []
        for s in range(steps):
            o = eng.step({slot: rows[r][s] for slot, r in enumerate(mine)})
            got.append({f: getattr(o, f).numpy() for f in
                        ("global_logits", "local_logits", "fused_logits",
                         "grid_logits")})
        out[fsdp] = {"rows": list(mine), "steps": got,
                     "slots": eng.batch}
    torch.distributed.barrier()
    return out


def int8_sharded_bundle_case(rank, world, out_dir, sd, texts, rows, steps,
                             mp_size):
    """Export the tiny int8 navigator's serving programs over a
    (world / mp_size, mp_size) mesh at batch len(texts), from the full
    state dict `sd` (numpy), serve them with from_bundle on this rank's
    data shard of the requests and return each step's outputs (numpy)
    with the rows they belong to."""
    import dataclasses

    import torch

    from gridmm_tpu_torch.config import tiny_config
    from gridmm_tpu_torch.models.navigator import GridMMNavigator
    from gridmm_tpu_torch.parallel.mesh import data_rank
    from gridmm_tpu_torch.serve.engine import NavServingEngine
    from gridmm_tpu_torch.utils.export import (
        export_navigator_serving_sharded, save_serving_bundle)

    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, int8_matmuls=True))
    mesh = _mesh(mp_size)
    model = GridMMNavigator(cfg.model).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    b = len(texts)
    exports, entry = export_navigator_serving_sharded(
        model, cfg, model.state_dict(), mesh, batch=b, device="cpu")
    save_serving_bundle(exports, out_dir, cfg=cfg,
                        extra_manifest={"batch": b, "int8": True,
                                        "mesh": entry},
                        rank=rank, world=world)
    eng = NavServingEngine.from_bundle(out_dir, cfg, dict(model.state_dict()),
                                       b, device="cpu")
    local = b // mesh.size(0)
    mine = list(range(data_rank(mesh) * local, (data_rank(mesh) + 1) * local))
    for slot, r in enumerate(mine):
        eng.submit(slot, *texts[r])
    eng.admit()
    got = []
    for s in range(steps):
        o = eng.step({slot: rows[r][s] for slot, r in enumerate(mine)})
        got.append({f: getattr(o, f).numpy() for f in
                    ("global_logits", "local_logits", "fused_logits",
                     "grid_logits")})
    torch.distributed.barrier()
    return {"rows": mine, "steps": got}

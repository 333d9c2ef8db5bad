"""A sharded training step on n gloo ranks of the CPU (twin of
`dryrun_multichip` in the JAX package's __graft_entry__.py).

    python -m gridmm_tpu_torch.parallel.dryrun 4

`dryrun_multichip(n)` spawns n processes, lays them out as a (dp, mp) mesh
(mp = 2 where n is even and at least 4, as in JAX), shards the navigator at
the flagship widths (768 wide, 12 heads, 3072 FFN: every TP divisibility
rule of mp = 2) with the depth cut to 2 language + 1 cross-modal + 1
panorama layers, and runs one `make_train_step` update on a batch of dp
trajectories, each data rank on its own. The step's loss must be finite and
equal, within 1e-5 relative, to the loss of one process's step on the whole
batch. Dropout is off: the ranks would draw different masks.

`spawn_ranks` is the launcher: it picks a free port, starts the ranks with
the `spawn` method, gathers each rank's result with a timeout and joins
every process with a timeout, so a hung collective raises instead of
hanging the caller.
"""

from __future__ import annotations

import dataclasses
import math
import multiprocessing as mp
import queue
import socket
import sys
import time
import traceback


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, fn, args, out):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        try:
            out.put((rank, "ok", fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))


def spawn_ranks(fn, world: int, *args, timeout: float = 300.0) -> list:
    """fn(rank, world, *args) on `world` spawned gloo ranks of this host,
    each with one intra-op thread; their results in rank order. Raises if a
    rank fails or the ranks give no result within `timeout` seconds; every
    process is ended before it returns."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_entry, args=(r, world, port, fn, args, out),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            rank, status, value = out.get(timeout=max(left, 0.01))
            if status != "ok":
                errors.append(f"rank {rank}:\n{value}")
                break
            results[rank] = value
    except queue.Empty:
        errors.append(f"ranks {sorted(set(range(world)) - set(results))} "
                      f"gave no result within {timeout} s")
    finally:
        for p in procs:
            p.join(timeout=1 if errors else 30)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [results[r] for r in range(world)]


def flagship_config(dp: int, mp: int):
    """r2r_config() at its widths with the JAX dryrun's cuts: depth 2 + 1 +
    1 layers, 2 steps, short text and graph caps; dropout off."""
    from gridmm_tpu_torch.config import MeshConfig, r2r_config

    cfg = r2r_config()
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, num_l_layers=2, num_x_layers=1,
                                  num_pano_layers=1, hidden_dropout_prob=0.0,
                                  attention_probs_dropout_prob=0.0,
                                  feat_dropout=0.0),
        grid=dataclasses.replace(cfg.grid, max_steps=2),
        shapes=dataclasses.replace(cfg.shapes, max_txt_len=32,
                                   max_gmap_len=16, max_vp_len=16,
                                   max_points=2 * 588),
        train=dataclasses.replace(cfg.train, batch_size=dp,
                                  max_action_len=2),
        mesh=MeshConfig(mp_size=mp))


def _step(cfg, mesh=None) -> dict:
    """One update on this rank's share of the dp-trajectory batch (all of
    it without a mesh): the loss and grad norm."""
    from gridmm_tpu_torch.models.navigator import init_navigator
    from gridmm_tpu_torch.parallel.mesh import (ShardedParams, data_rank,
                                                mesh_shape,
                                                shard_trajectory_batch)
    from gridmm_tpu_torch.train.step import create_train_state, make_train_step
    from gridmm_tpu_torch.train.synthetic import synthetic_trajectory_batch

    model = init_navigator(cfg.model, seed=0, device="cpu").train()
    batch = synthetic_trajectory_batch(cfg, cfg.train.batch_size, 2, seed=0,
                                       device="cpu")
    sharded = None
    if mesh is not None:
        sharded = ShardedParams(model, mesh)
        batch = shard_trajectory_batch(batch, data_rank(mesh),
                                       mesh_shape(mesh)[0])
    state = create_train_state(cfg, model, sharded=sharded)
    metrics = make_train_step(cfg)(state, batch, seed=1)
    return {k: float(v) for k, v in metrics.items()}


def _rank_step(rank, world, cfg):
    from gridmm_tpu_torch.parallel.mesh import make_mesh

    return _step(cfg, make_mesh(cfg.mesh, "cpu"))


def dryrun_multichip(n_devices: int, timeout: float = 600.0) -> dict:
    """The sharded step on n gloo ranks against one process's step; returns
    {"mesh": (dp, mp), "loss": ..., "grad_norm": ...}."""
    t0 = time.monotonic()
    n = int(n_devices)
    mp_size = 2 if n % 2 == 0 and n >= 4 else 1
    dp = n // mp_size
    cfg = flagship_config(dp, mp_size)
    ranks = spawn_ranks(_rank_step, n, cfg, timeout=timeout)
    one = _step(cfg)
    for r, got in enumerate(ranks):
        for k in ("loss", "grad_norm"):
            if not math.isfinite(got[k]):
                raise RuntimeError(f"rank {r}: non-finite {k} {got[k]}")
            if not math.isclose(got[k], one[k], rel_tol=1e-5):
                raise RuntimeError(f"rank {r}: {k} {got[k]} != one "
                                   f"process's {one[k]}")
    print(f"dryrun_multichip({n}): mesh=({dp}x{mp_size}) "
          f"loss={ranks[0]['loss']:.6f} grad_norm="
          f"{ranks[0]['grad_norm']:.6f} (one process: {one['loss']:.6f}) "
          f"in {time.monotonic() - t0:.1f} s", flush=True)
    return {"mesh": (dp, mp_size), **ranks[0]}


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)

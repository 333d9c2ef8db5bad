"""Multi-process utilities: eval-result merging and cross-rank reductions
(twin of gridmm_tpu/parallel/multihost.py).

The reference gathers variable-length prediction lists by pickling them
into padded ByteTensors and an NCCL all_gather (map_nav_src/utils/
distributed.py:90-130 + merge_dist_results :160-164), and reduces scalar
stats with dist.all_gather (pretrain train_r2r.py:370-372). Here the
ranks of the torch.distributed world take the place of the JAX hosts:
`all_gather_object` for Python objects, with a fast path where there is
no process group or one rank. The ranks of one model-parallel group hold
the same shard; they count once each in a merge (deduplicated by
instr_id) and equally in a weighted mean, which leaves both unchanged.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch.distributed as dist


def process_count() -> int:
    """The world size, 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def _all_gather(obj) -> list:
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def merge_prediction_lists(local_preds: List[dict]) -> List[dict]:
    """Every rank's prediction list, on every rank, deduplicated by
    instr_id: the first entry wins, in rank order (the reference's
    all_gather + merge_dist_results)."""
    if process_count() == 1:
        return local_preds
    merged: Dict[str, dict] = {}
    for preds in _all_gather(local_preds):
        for item in preds:
            merged.setdefault(item["instr_id"], item)
    return list(merged.values())


def allocate_episodes_by_scene(episodes: List[dict], num_workers: int,
                               scene_key: str = "scan") -> List[List[dict]]:
    """Scene-load-balanced episode allocation across workers/ranks
    (VLN_CE/.../ss_trainer_GridMap.py:77-139 + vlnce_baselines/utils.py:
    45-162): whole scenes go greedily to the least-loaded worker, so each
    worker touches few scenes (simulator scene loads are expensive)."""
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


def weighted_mean_scalars(values: Dict[str, float],
                          weight: float) -> Dict[str, float]:
    """Weight-averaged rank-local scalars (per-rank eval metrics weighted by
    shard size: the reference computes metrics over the CONCATENATED
    prediction lists, which is exactly a count-weighted mean)."""
    if process_count() == 1:
        return dict(values)
    keys = sorted(values)
    if weight <= 0.0:
        # an empty shard (fewer val scenes than ranks): its metrics are
        # np.mean([]) = NaN, and NaN * 0.0 would poison every rank's sums
        arr = np.zeros(1 + len(keys), np.float64)
    else:
        arr = np.asarray([weight] + [values[k] * weight for k in keys],
                         np.float64)
    gathered = np.stack(_all_gather(arr))
    total_w = max(gathered[:, 0].sum(), 1e-12)
    sums = gathered[:, 1:].sum(0) / total_w
    return {k: float(v) for k, v in zip(keys, sums)}


def all_mean_scalars(values: Dict[str, float]) -> Dict[str, float]:
    """Mean of rank-local scalars across ranks (validate_* reductions)."""
    if process_count() == 1:
        return dict(values)
    keys = sorted(values)
    arr = np.asarray([values[k] for k in keys], np.float64)
    mean = np.stack(_all_gather(arr)).mean(0)
    return {k: float(v) for k, v in zip(keys, mean)}

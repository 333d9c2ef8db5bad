"""Pretraining pieces (twin of gridmm_tpu/train/pretrain.py): the task
batch, the per-task loss, the update steps and the task multiplexer.

Host-side counterpart of pretrain_src/data/{tasks,loader}.py and
train_r2r.py:231-333. The MetaLoader's cross-rank task broadcast
(loader.py:54-59) is a shared-seed draw: every process draws the same task
sequence without communication.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import numpy as np
import torch

from gridmm_tpu_torch.config import GridMMConfig, ModelConfig
from gridmm_tpu_torch.models.layers import init_weights
from gridmm_tpu_torch.models.pretrain import GridMMPretrain
from gridmm_tpu_torch.train.losses import (GlobalSum, cross_entropy_ignore,
                                           mlm_loss,
                                           mrc_kl_loss, sap_loss)
from gridmm_tpu_torch.train.step import TrainState, _seeded, _update_scope


class PretrainBatch(NamedTuple):
    """Trajectory-level inputs shared by all proxy tasks, plus per-task
    labels (zero-filled when unused)."""

    txt_ids: torch.Tensor          # (B, T)
    txt_mask: torch.Tensor         # (B, T)
    traj_view_fts: torch.Tensor    # (B, S, V-1, D_img)
    traj_loc_fts: torch.Tensor     # (B, S, V-1, A+3)
    traj_nav_types: torch.Tensor   # (B, S, V-1)
    traj_token_mask: torch.Tensor  # (B, S, V-1)
    traj_step_mask: torch.Tensor   # (B, S)
    visited_idx: torch.Tensor      # (B, S, V-1)
    cand_idx: torch.Tensor         # (B, S, V-1)
    gmap_step_ids: torch.Tensor    # (B, G)
    gmap_pos_fts: torch.Tensor     # (B, G, A+3)
    gmap_mask: torch.Tensor        # (B, G)
    gmap_visited_mask: torch.Tensor  # (B, G)
    vp_pos_fts: torch.Tensor       # (B, V, 2A+6)
    vp_nav_mask: torch.Tensor      # (B, V)
    fused_add_idx: torch.Tensor    # (B, G)
    cand_backtrack_mask: torch.Tensor  # (B, V)
    grid_fts: torch.Tensor         # (B, N, D_img)
    grid_cells: torch.Tensor       # (B, N)
    gridmap_pos_fts: torch.Tensor  # (B, C, 5)
    # task labels
    txt_labels: torch.Tensor       # (B, T) MLM targets, -1 = not masked
    view_mrc_masks: torch.Tensor   # (B, V-1) bool
    view_probs: torch.Tensor       # (B, V-1, image_prob_size) soft labels
    global_act_labels: torch.Tensor  # (B,)
    local_act_labels: torch.Tensor   # (B,)
    obj_labels: torch.Tensor       # (B,)
    vp_obj_mask: torch.Tensor      # (B, V)


def pretrain_batch_to_device(batch: PretrainBatch, device,
                             non_blocking: bool = False) -> PretrainBatch:
    """A PretrainBatch of numpy arrays or tensors as tensors on `device`."""
    return PretrainBatch(*(torch.as_tensor(a).to(device,
                                                  non_blocking=non_blocking)
                           for a in batch))


def _enc_kwargs(b: PretrainBatch) -> Dict[str, torch.Tensor]:
    return dict(
        traj_view_fts=b.traj_view_fts, traj_loc_fts=b.traj_loc_fts,
        traj_nav_types=b.traj_nav_types, traj_token_mask=b.traj_token_mask,
        traj_step_mask=b.traj_step_mask, visited_idx=b.visited_idx,
        cand_idx=b.cand_idx, gmap_step_ids=b.gmap_step_ids,
        gmap_pos_fts=b.gmap_pos_fts, gmap_mask=b.gmap_mask,
        vp_pos_fts=b.vp_pos_fts, grid_fts=b.grid_fts,
        grid_cells=b.grid_cells, gridmap_pos_fts=b.gridmap_pos_fts)


def _mask_mrc_features(batch: PretrainBatch) -> PretrainBatch:
    """Zero the view features selected for MRC on the LAST trajectory step
    (reference _mask_img_feat, pretrain_src/data/tasks.py:195-196)."""
    s = batch.traj_view_fts.shape[1]
    last = torch.clamp(batch.traj_step_mask.sum(dim=1) - 1, min=0)  # (B,)
    is_last = (torch.arange(s, device=last.device)[None, :]
               == last[:, None])                                    # (B,S)
    kill = is_last[:, :, None] & batch.view_mrc_masks[:, None, :]   # (B,S,V-1)
    fts = torch.where(kill[..., None], 0.0, batch.traj_view_fts)
    return batch._replace(traj_view_fts=fts)


def task_loss(model: GridMMPretrain, batch: PretrainBatch, task: str,
              global_sum: GlobalSum = None):
    """Per-task scalar loss (pretrain_cmt.py forward_*). Dropout follows
    `model.training`. With `global_sum` (a data-parallel rank's slice of
    the batch) every mean divides by the global batch's count, so the
    ranks' losses sum to the loss of the whole batch."""
    if task == "mlm":
        logits = model.forward_mlm_logits(batch.txt_ids, batch.txt_mask,
                                          _enc_kwargs(batch))
        return mlm_loss(logits, batch.txt_labels, ignore_id=-1,
                        global_sum=global_sum)
    if task not in ("mrc", "sap", "og"):
        raise ValueError(task)
    if task == "mrc":
        # zero the masked regions BEFORE encoding (tasks.py:195-196):
        # otherwise the classifier sees the feature it must label
        batch = _mask_mrc_features(batch)
    enc = model.encode(batch.txt_ids, batch.txt_mask, **_enc_kwargs(batch))
    if task == "mrc":
        return mrc_kl_loss(model.forward_mrc_logits(enc), batch.view_probs,
                           batch.view_mrc_masks, global_sum)
    if task == "sap":
        g, lo, f, gr = model.forward_sap_logits(
            enc, batch.gmap_mask, batch.gmap_visited_mask, batch.vp_nav_mask,
            batch.fused_add_idx, batch.cand_backtrack_mask)
        per_example = sap_loss(g, lo, f, gr, batch.global_act_labels,
                               batch.local_act_labels, global_sum)
        if global_sum is None:
            return per_example.mean()
        n = per_example.new_tensor(float(per_example.shape[0]))
        return per_example.sum() / global_sum(n)
    logits = model.forward_og_logits(enc, batch.vp_obj_mask)
    return cross_entropy_ignore(logits, batch.obj_labels, ignore_id=-100,
                                reduction="mean", global_sum=global_sum)


def make_pretrain_step(cfg: GridMMConfig, task: str):
    """step(state, batch, seed) -> metrics: one update of `state.model` in
    place for one task (the reference dispatches per task too). Dropout is
    on iff `state.model.training`; `seed` and the update count seed its
    masks."""

    def step(state: TrainState, batch: PretrainBatch,
             seed: int = 0) -> Dict[str, torch.Tensor]:
        state.optimizer.zero_grad(set_to_none=True)
        sp = state.sharded
        with _update_scope(state, seed, state.step, batch.txt_ids.device):
            loss = task_loss(state.model, batch, task,
                             sp.global_sum if sp else None)
            loss.backward()
            if sp:
                sp.reduce_grads()
        state.optimizer.step()
        state.step += 1
        return {f"loss_{task}": sp.global_sum(loss) if sp else loss.detach(),
                "grad_norm": state.optimizer.last_grad_norm}

    return step


def make_pretrain_accum_step(cfg: GridMMConfig, task: str, accum: int = 2):
    """step(state, batches, seed) -> metrics: one update over `accum`
    microbatches of ONE task, the reference accumulation window
    (train_r2r.py:251-296). Each microbatch's loss is scaled by 1/accum
    and backpropagated at once (the gradients sum over the window, so one
    microbatch's activations are alive at a time), then ONE optimizer step.
    Each microbatch draws its dropout masks from its own seeded stream."""

    def step(state: TrainState, batches: Sequence[PretrainBatch],
             seed: int = 0) -> Dict[str, torch.Tensor]:
        if len(batches) != accum:
            raise ValueError(f"{len(batches)} microbatches for a window of "
                             f"{accum}")
        state.optimizer.zero_grad(set_to_none=True)
        sp = state.sharded
        losses = []
        with _update_scope(state, None, 0, batches[0].txt_ids.device):
            for i, mb in enumerate(batches):
                with _seeded(seed + (sp.dp_rank * 1000 if sp else 0),
                             state.step * accum + i, mb.txt_ids.device):
                    loss = task_loss(state.model, mb, task,
                                     sp.global_sum if sp else None)
                    (loss / accum).backward()
                losses.append(sp.global_sum(loss) if sp else loss.detach())
            if sp:
                sp.reduce_grads()
        state.optimizer.step()
        state.step += 1
        return {f"loss_{task}": torch.stack(losses).mean(),
                "grad_norm": state.optimizer.last_grad_norm}

    return step


class TaskMultiplexer:
    """Samples the next task by mix ratio with a shared-seed RNG (replaces
    the reference MetaLoader's dist.broadcast(task_id), loader.py:54-59).

    accum_steps > 1 holds each sampled task for accum_steps consecutive
    yields, the MetaLoader accumulation-window contract (the task is
    re-sampled only when step % accum_steps == 0)."""

    def __init__(self, tasks, mix_ratio, seed: int = 0,
                 accum_steps: int = 1):
        self.tasks = list(tasks)
        p = np.asarray(mix_ratio, np.float64)
        self.p = p / p.sum()
        self.accum_steps = int(accum_steps)
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        while True:
            task = self.tasks[self._rng.choice(len(self.tasks), p=self.p)]
            for _ in range(self.accum_steps):
                yield task


def init_pretrain_params(cfg: ModelConfig, seed: int = 0,
                         device="cuda") -> GridMMPretrain:
    """The whole GridMMPretrain, every task's parameters included (the JAX
    package runs every task once to materialize them), with seeded random
    weights (layers.init_weights), in eval mode, on `device`."""
    model = GridMMPretrain(cfg)
    init_weights(model, torch.Generator().manual_seed(seed),
                 cfg.initializer_range)
    return model.to(device).eval()

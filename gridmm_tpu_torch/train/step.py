"""The per-step navigation graph and the training steps built on it (twin of
gridmm_tpu/train/step.py).

One call of `nav_device_step` is one action for a batch of episodes:
panorama encode, project + score the 588 new grid points, append them to the
on-device point buffer, egocentric cell assignment over the whole buffer,
graph-node embedding aggregation, navigation forward. Host work is limited to
assembling the `StepInputs` index maps.

Teacher-forced training needs no model-in-the-loop decisions, so the whole
trajectory loss (language encode, per-step panorama encode, point buffer +
grid assignment, node aggregation, navigation forward, CE) is one autograd
graph over a recorded `TrajectoryBatch`, with one backward. Gradient flow
matches the reference: the navigation loss reaches the panorama encoder
through both the vp tokens and the gmap node embeddings (agent.py:312-320,
vilmodel.py:592-626). `make_train_step` / `make_dagger_step` wrap it with the
clipped AdamW update.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from gridmm_tpu_torch.config import GridMMConfig
from gridmm_tpu_torch.models.navigator import GridMMNavigator, NavOutputs
from gridmm_tpu_torch.ops import geometry as G
from gridmm_tpu_torch.parallel.mesh import ShardedParams
from gridmm_tpu_torch.train.losses import cross_entropy_ignore
from gridmm_tpu_torch.train.optimizers import ChainOptimizer
from gridmm_tpu_torch.utils.logging import span


class StepInputs(NamedTuple):
    """Per-step tensors for a batch of B episodes: leading dim B for one
    step, (S, B, ...) when stacked into a TrajectoryBatch."""

    # panorama tokens (V-1 view/object tokens; stop slot added here)
    view_img_fts: torch.Tensor   # (B, V-1, D_img)
    loc_fts: torch.Tensor        # (B, V-1, angle+3)
    nav_types: torch.Tensor      # (B, V-1) int
    view_mask: torch.Tensor      # (B, V-1) bool
    # grid memory inputs
    depth: torch.Tensor          # (B, views, patches) raw depth
    patch_fts: torch.Tensor      # (B, views*patches, D_img) CLIP patch fts
    pos_xy: torch.Tensor         # (B, 2) agent world position
    heading: torch.Tensor        # (B,)
    # topological graph (host-assembled index maps)
    gmap_step_ids: torch.Tensor      # (B, G)
    gmap_pos_fts: torch.Tensor       # (B, G, angle+3)
    gmap_mask: torch.Tensor          # (B, G) bool
    gmap_visited_mask: torch.Tensor  # (B, G) bool
    cur_node_idx: torch.Tensor       # (B,) gmap slot of the current node
    cand_gmap_idx: torch.Tensor      # (B, V-1) gmap slot per view, -1 none
    # local branch
    vp_pos_fts: torch.Tensor     # (B, V, 2*angle+6)
    vp_nav_mask: torch.Tensor    # (B, V) bool
    # fusion index maps
    fused_add_idx: torch.Tensor        # (B, G)
    cand_backtrack_mask: torch.Tensor  # (B, V)
    # supervision, read by the trajectory loss only
    target: torch.Tensor         # (B,) fused-action label, ignore_id when done
    grid_target: torch.Tensor    # (B,) grid-cell label (0 stop) or ignore_id
    # object grounding (REVERIE/SOON; zero-filled otherwise)
    vp_obj_mask: torch.Tensor    # (B, V) bool
    obj_target: torch.Tensor     # (B,) object token index or ignore_id


class TrajectoryBatch(NamedTuple):
    txt_ids: torch.Tensor   # (B, T)
    txt_mask: torch.Tensor  # (B, T) bool
    steps: StepInputs       # each field (S, B, ...)


def batch_to_device(batch: TrajectoryBatch, device,
                    non_blocking: bool = False) -> TrajectoryBatch:
    """A TrajectoryBatch of numpy arrays or tensors as tensors on `device`."""
    def put(a):
        return torch.as_tensor(a).to(device, non_blocking=non_blocking)

    return TrajectoryBatch(put(batch.txt_ids), put(batch.txt_mask),
                           StepInputs(*(put(a) for a in batch.steps)))


@dataclasses.dataclass
class TrainState:
    """What a train step updates in place: the module, its optimizer and the
    number of updates made (the JAX package's (params, opt_state, step)).
    `sharded` (parallel/mesh.ShardedParams) lays the module's parameters
    over a device mesh: the step's batch is then this rank's slice, and
    the loss and gradients are those of the whole batch."""

    model: GridMMNavigator
    optimizer: ChainOptimizer
    step: int = 0
    sharded: Optional[ShardedParams] = None


def make_optimizer(cfg: GridMMConfig, model: GridMMNavigator
                   ) -> ChainOptimizer:
    """AdamW on every parameter + global-norm clip 40
    (agent_base.py:122-138,205)."""
    return ChainOptimizer(
        model.parameters(), "adamw", lr=cfg.train.lr,
        clip=cfg.train.grad_norm_clip, betas=tuple(cfg.train.betas),
        eps=cfg.train.adam_eps, weight_decay=cfg.train.weight_decay)


def create_train_state(cfg: GridMMConfig, model: GridMMNavigator,
                       optimizer: Optional[ChainOptimizer] = None,
                       sharded: Optional[ShardedParams] = None
                       ) -> TrainState:
    """`sharded` must already hold `model` (it replaces the parameters
    that the optimizer takes)."""
    return TrainState(model, optimizer or make_optimizer(cfg, model), 0,
                      sharded)


class NavCarry(NamedTuple):
    """Cross-step device state of an episode batch."""

    point_state: G.PointCloudState
    gmap_sum: torch.Tensor  # (B, G, D) running node-embedding sums
    gmap_cnt: torch.Tensor  # (B, G)


def init_carry(cfg: GridMMConfig, batch: int, gmap_len: Optional[int] = None,
               device="cuda") -> NavCarry:
    g = gmap_len if gmap_len is not None else cfg.shapes.max_gmap_len
    d = cfg.model.hidden_size
    return NavCarry(
        point_state=G.PointCloudState.create(batch, cfg.grid,
                                             cfg.shapes.max_points,
                                             device=device),
        gmap_sum=torch.zeros((batch, g, d), dtype=torch.float32,
                             device=device),
        gmap_cnt=torch.zeros((batch, g), dtype=torch.float32, device=device),
    )


def _update_node_embeds(gmap_sum, gmap_cnt, pano_embeds, pano_mask,
                        cur_node_idx, cand_gmap_idx, gmap_visited_mask,
                        accumulate: bool = True):
    """GraphMap.update_node_embed (agent.py:312-320): the current node is
    rewritten with the masked-average pano embedding; unvisited candidate
    nodes accumulate a running sum of their view embeddings.

    accumulate=False (VLN-CE, ModelConfig.frontier_accumulate): every slot
    past the current node is cleared first, so a frontier slot holds exactly
    this step's candidate embedding. Returns new tensors."""
    b = pano_embeds.shape[0]
    bi = torch.arange(b, device=pano_embeds.device)
    avg = (pano_embeds * pano_mask[..., None]).sum(dim=1) / torch.clamp(
        pano_mask.sum(dim=1, keepdim=True), min=1)

    # one copy, then in place: earlier steps' sums stay intact, and autograd
    # follows the writes on the copy into pano_embeds
    gmap_sum = gmap_sum.clone()
    gmap_cnt = gmap_cnt.clone()
    cur = cur_node_idx.long()
    if not accumulate:
        g = gmap_sum.shape[1]
        future = (torch.arange(g, device=gmap_sum.device)[None, :]
                  > cur[:, None])
        gmap_sum.masked_fill_(future[..., None], 0.0)
        gmap_cnt.masked_fill_(future, 0.0)

    gmap_sum[bi, cur] = avg
    gmap_cnt[bi, cur] = gmap_cnt.new_ones(b)  # not a host scalar: see
    # geometry.append_panorama

    cand = cand_gmap_idx.long()
    valid = (cand >= 0) & ~torch.gather(gmap_visited_mask, 1,
                                        cand.clamp(min=0))
    tgt = torch.where(valid, cand, torch.zeros_like(cand))
    contrib = pano_embeds.masked_fill(~valid[..., None], 0.0)
    rows = bi[:, None].expand_as(tgt)
    # repeated slots add up, like JAX's .at[].add
    gmap_sum.index_put_((rows, tgt), contrib, accumulate=True)
    gmap_cnt.index_put_((rows, tgt), valid.to(gmap_cnt.dtype),
                        accumulate=True)
    return gmap_sum, gmap_cnt


def _nav_inputs(cfg, txt_embeds, txt_mask, gmap_img_embeds, x: StepInputs,
                pano_embeds, grid_fts, grid_cells, grid_weights,
                gridmap_pos_fts) -> dict:
    """The per-step "navigation" batch dict (shared definition with the
    JAX package's replay loss)."""
    b = txt_mask.shape[0]
    d = cfg.model.hidden_size
    vp_img_embeds = torch.cat(
        [pano_embeds.new_zeros((b, 1, d)), pano_embeds], dim=1)
    vp_mask = torch.cat([torch.ones((b, 1), dtype=torch.bool,
                                    device=txt_mask.device), x.view_mask],
                        dim=1)
    return {
        "txt_embeds": txt_embeds, "txt_mask": txt_mask,
        "gmap_img_embeds": gmap_img_embeds.to(cfg.model.dtype),
        "gmap_step_ids": x.gmap_step_ids, "gmap_pos_fts": x.gmap_pos_fts,
        "gmap_mask": x.gmap_mask, "gmap_visited_mask": x.gmap_visited_mask,
        "vp_img_embeds": vp_img_embeds, "vp_pos_fts": x.vp_pos_fts,
        "vp_mask": vp_mask, "vp_nav_mask": x.vp_nav_mask,
        "grid_fts": grid_fts, "grid_cells": grid_cells,
        "grid_weights": grid_weights, "gridmap_pos_fts": gridmap_pos_fts,
        "fused_add_idx": x.fused_add_idx,
        "cand_backtrack_mask": x.cand_backtrack_mask,
        "vp_obj_mask": x.vp_obj_mask if cfg.model.obj_feat_size > 0 else None,
        # None = the reference's max over PADDED text
        "txt_relevance_mask":
            txt_mask if cfg.model.mask_txt_relevance else None,
    }


def nav_device_step(model: GridMMNavigator, cfg: GridMMConfig, txt_embeds,
                    txt_mask, carry: NavCarry, x: StepInputs):
    """One navigation step: returns (new carry, NavOutputs).

    Gmap tokens use a stable discovery-order slot space (slot 0 = [stop]);
    attention is permutation-equivariant under masks, so this equals the
    reference's per-step repacking (agent.py:104-147). The point buffer in
    `carry` is written in place (geometry.append_panorama), except under
    autograd, where each step appends into a copy."""
    pano_embeds, pano_mask = model("panorama", {
        "view_img_fts": x.view_img_fts, "loc_fts": x.loc_fts,
        "nav_types": x.nav_types, "view_mask": x.view_mask})

    # project + score the 588 new points once; the buffer stores them ready
    # to pool
    proj_new, w_new = model("project_grid", {
        "txt_embeds": txt_embeds, "patch_fts": x.patch_fts,
        "txt_relevance_mask":
            txt_mask if cfg.model.mask_txt_relevance else None})
    point_state = carry.point_state
    if torch.is_grad_enabled() and proj_new.requires_grad:
        # the backward pass (and a recomputed step) needs this step's
        # buffer as it was: append into a copy, so that the next step's
        # write leaves it intact
        point_state = G.PointCloudState(*(t.clone() for t in point_state))
    point_state = G.append_panorama(point_state, x.depth, proj_new,
                                    x.pos_xy, cfg.grid, w_new,
                                    headings=x.heading)
    cells, _, grid_pos_fts = G.egocentric_grid_assignment(
        point_state, x.pos_xy, x.heading, cfg.grid)

    gmap_sum, gmap_cnt = _update_node_embeds(
        carry.gmap_sum, carry.gmap_cnt, pano_embeds.float(), pano_mask,
        x.cur_node_idx, x.cand_gmap_idx, x.gmap_visited_mask,
        accumulate=cfg.model.frontier_accumulate)
    gmap_img_embeds = gmap_sum / torch.clamp(gmap_cnt, min=1.0)[..., None]
    gmap_img_embeds[:, 0] = 0.0  # slot 0 is [stop] (agent.py:127-129)

    out: NavOutputs = model("navigation", _nav_inputs(
        cfg, txt_embeds, txt_mask, gmap_img_embeds, x, pano_embeds,
        point_state.features, cells, point_state.weights, grid_pos_fts))
    return NavCarry(point_state, gmap_sum, gmap_cnt), out


def _loss_head_logits(cfg, out: NavOutputs, x: StepInputs):
    """Select the training head. 'ce' is the continuous-env action head:
    fused = global+local over [stop]+candidates (gridmap/vilmodel.py:
    788-800), the logits the CE trainer acts on (ss_trainer_GridMap.py:
    269-330); imported here, as the JAX package does, because ce/ imports
    this module."""
    if cfg.train.loss_head == "ce":
        from gridmm_tpu_torch.ce.device_step import ce_action_logits
        return ce_action_logits(out.global_logits, out.local_logits,
                                x.cand_gmap_idx)
    return getattr(out, f"{cfg.train.loss_head}_logits")


def _step_loss(cfg, out: NavOutputs, x: StepInputs):
    """Summed CE of one step: the action head, RxR's doubled stop CE
    (rxr/agent.py:367-373) and the object-grounding CE (REVERIE
    agent_obj.py og_loss)."""
    ignore = cfg.train.ignoreid
    head_logits = _loss_head_logits(cfg, out, x)
    loss = cross_entropy_ignore(head_logits, x.target, ignore, "sum")
    if cfg.train.stop_extra_ce:
        stop_only = torch.where(x.target == 0, torch.zeros_like(x.target),
                                torch.full_like(x.target, ignore))
        loss = loss + cross_entropy_ignore(head_logits, stop_only, ignore,
                                           "sum")
    if out.obj_logits is not None:
        loss = loss + cross_entropy_ignore(out.obj_logits, x.obj_target,
                                           ignore, "sum")
    return loss


def _check_capacity(cfg, s: int) -> None:
    ppstep = cfg.grid.points_per_step
    if s * ppstep > cfg.shapes.max_points:
        raise ValueError(
            f"point buffer overflow: {s} steps x {ppstep} points/step "
            f"exceeds max_points={cfg.shapes.max_points}")


def _trajectory_loss_stacked(model: GridMMNavigator, cfg: GridMMConfig,
                             batch: TrajectoryBatch,
                             ml_weight: Optional[float] = None,
                             sharded: Optional[ShardedParams] = None):
    """Teacher-forced loss with one shared full-trajectory point buffer.

    Replay knows the whole trajectory up front, so all steps' patches are
    projected and scored in one call, all panoramas encoded in one batched
    call, and one buffer (geometry.stacked_point_state), of which a prefix
    is bit-identical to every step's incremental buffer, is step-masked via
    egocentric_grid_assignment(num_active=...). Autograd then keeps one
    buffer, not one per step; the pool's backward adds every step's
    gradient into it. Same loss as the incremental `trajectory_loss`.
    """
    x = batch.steps
    s, b = x.target.shape
    ppstep = cfg.grid.points_per_step
    _check_capacity(cfg, s)
    relevance_mask = batch.txt_mask if cfg.model.mask_txt_relevance else None

    txt_embeds = model("language", {"txt_ids": batch.txt_ids,
                                    "txt_mask": batch.txt_mask})

    def fold(a):  # (S, B, ...) -> (S*B, ...)
        return a.reshape((s * b,) + a.shape[2:])

    pano_embeds, pano_mask = model("panorama", {
        "view_img_fts": fold(x.view_img_fts), "loc_fts": fold(x.loc_fts),
        "nav_types": fold(x.nav_types), "view_mask": fold(x.view_mask)})
    pano_embeds = pano_embeds.reshape((s, b) + pano_embeds.shape[1:])
    pano_mask = pano_mask.reshape((s, b) + pano_mask.shape[1:])

    # step-major point layout: step t's points at rows [t*ppstep, (t+1)*ppstep)
    patch_all = x.patch_fts.permute(1, 0, 2, 3).reshape(
        b, s * ppstep, x.patch_fts.shape[-1])
    proj_all, w_all = model("project_grid", {
        "txt_embeds": txt_embeds, "patch_fts": patch_all,
        "txt_relevance_mask": relevance_mask})
    stacked = G.stacked_point_state(x.depth, proj_all, w_all, x.pos_xy,
                                    x.heading, cfg.grid)

    g = x.gmap_mask.shape[-1]
    dev = x.target.device
    gsum = torch.zeros((b, g, cfg.model.hidden_size), dtype=torch.float32,
                       device=dev)
    gcnt = torch.zeros((b, g), dtype=torch.float32, device=dev)

    def nav_step(x_t, gmap_emb_t, pano_t, num_active):
        cells, _, grid_pos_fts = G.egocentric_grid_assignment(
            stacked, x_t.pos_xy, x_t.heading, cfg.grid,
            num_active=num_active)
        out = model("navigation", _nav_inputs(
            cfg, txt_embeds, batch.txt_mask, gmap_emb_t, x_t, pano_t,
            stacked.features, cells, stacked.weights, grid_pos_fts))
        return _step_loss(cfg, out, x_t)

    remat = cfg.train.remat_steps
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for t in range(s):
        x_t = StepInputs(*(a[t] for a in x))
        gsum, gcnt = _update_node_embeds(
            gsum, gcnt, pano_embeds[t].float(), pano_mask[t],
            x_t.cur_node_idx, x_t.cand_gmap_idx, x_t.gmap_visited_mask,
            accumulate=cfg.model.frontier_accumulate)
        emb = gsum / torch.clamp(gcnt, min=1.0)[..., None]
        # slot 0 is [stop]: zero embedding (agent.py:127-129)
        emb = torch.cat([torch.zeros_like(emb[:, :1]), emb[:, 1:]], dim=1)
        args = (x_t, emb, pano_embeds[t], (t + 1) * ppstep)
        if remat and torch.is_grad_enabled():
            # recompute the step's activations in the backward pass; the
            # saved RNG state replays the same dropout masks
            total = total + checkpoint(nav_step, *args, use_reentrant=False)
        else:
            total = total + nav_step(*args)
    return _scale_trajectory_loss(cfg, batch, total, b, ml_weight, sharded)


def trajectory_loss(model: GridMMNavigator, cfg: GridMMConfig,
                    batch: TrajectoryBatch,
                    ml_weight: Optional[float] = None,
                    sharded: Optional[ShardedParams] = None):
    """Teacher-forced loss over a full episode batch, all on the device.

    cfg.train.stacked_replay=True (default) uses the stacked formulation
    above; False keeps the incremental point buffer, the graph the
    interactive rollout uses. Dropout follows `model.training`; each step
    draws fresh masks from torch's generator. With `sharded`, `batch` is
    this rank's slice and the loss its share of the whole batch's loss
    (`_scale_trajectory_loss`)."""
    if cfg.train.stacked_replay:
        return _trajectory_loss_stacked(model, cfg, batch, ml_weight, sharded)
    s, b = batch.steps.target.shape
    _check_capacity(cfg, s)
    txt_embeds = model("language", {"txt_ids": batch.txt_ids,
                                    "txt_mask": batch.txt_mask})
    dev = batch.steps.target.device
    carry = init_carry(cfg, b, batch.steps.gmap_mask.shape[-1], device=dev)

    def device_step(carry, x_t):
        carry, out = nav_device_step(model, cfg, txt_embeds, batch.txt_mask,
                                     carry, x_t)
        return carry, _step_loss(cfg, out, x_t)

    remat = cfg.train.remat_steps
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for t in range(s):
        x_t = StepInputs(*(a[t] for a in batch.steps))
        if remat and torch.is_grad_enabled():
            carry, step_loss = checkpoint(device_step, carry, x_t,
                                          use_reentrant=False)
        else:
            carry, step_loss = device_step(carry, x_t)
        total = total + step_loss
    return _scale_trajectory_loss(cfg, batch, total, b, ml_weight, sharded)


def _scale_trajectory_loss(cfg, batch, total, b, ml_weight, sharded=None):
    """Discrete fine-tune scales by ml_weight / batch_size (agent.py:447; the
    DAgger student-sampled pass uses weight 1.0, agent_base.py:164-196).
    VLN-CE (cfg.train.loss_norm='actions') divides by the number of
    non-ignored targets instead, with no ml_weight factor
    (ss_trainer_GridMap.py:284,493).

    Under a mesh both denominators are the whole batch's: the batch size
    times dp, the action count summed over the data ranks (the ranks'
    counts differ, and a mean of per-rank means is not the JAX loss). The
    gradients are then summed over the ranks, never averaged."""
    if cfg.train.loss_norm == "actions":
        count = (batch.steps.target != cfg.train.ignoreid).sum()
        if sharded is not None:
            count = sharded.global_sum(count)
        return total / torch.clamp(count, min=1)
    w = cfg.train.ml_weight if ml_weight is None else ml_weight
    return total * w / (b * (sharded.dp if sharded is not None else 1))


@contextlib.contextmanager
def _seeded(seed: int, step: int, device):
    """A forked RNG scope seeded from (seed, step): dropout masks depend on
    both, and the caller's generators are left as they were."""
    devices = [device] if torch.device(device).type == "cuda" else []
    with torch.random.fork_rng(devices=devices):
        torch.manual_seed((int(seed) * 1000003 + int(step)) % (2 ** 63))
        yield


@contextlib.contextmanager
def _update_scope(state: TrainState, seed: Optional[int], step: int, device):
    """An update's forward and backward: the seeded dropout scope (none if
    seed is None) and, under a mesh, the parameters as the modules compute
    with them (ShardedParams.compute_params). The data ranks draw
    different masks, the ranks of one model group the same ones."""
    sp = state.sharded
    with contextlib.ExitStack() as stack:
        if seed is not None:
            stack.enter_context(_seeded(
                seed + (sp.dp_rank * 1000 if sp else 0), step, device))
        if sp is not None:
            stack.enter_context(sp.compute_params(grad=True))
        yield


def make_train_step(cfg: GridMMConfig):
    """train_step(state, batch, seed) -> metrics: one teacher-forced loss,
    one backward, one clipped optimizer update of `state.model` in place.
    Dropout is on iff `state.model.training`; `seed` and the step count seed
    its masks. Under a mesh (`state.sharded`) the batch is the rank's
    slice; the loss is the whole batch's, the gradients are summed over the
    data ranks before the update."""

    def train_step(state: TrainState, batch: TrajectoryBatch,
                   seed: int = 0) -> Dict[str, torch.Tensor]:
        with span("train.update"):
            state.optimizer.zero_grad(set_to_none=True)
            sp = state.sharded
            with _update_scope(state, seed, state.step,
                               batch.txt_ids.device):
                with span("train.forward"):
                    loss = trajectory_loss(state.model, cfg, batch,
                                           sharded=sp)
                with span("train.backward"):
                    loss.backward()
                    if sp is not None:
                        sp.reduce_grads()
            state.optimizer.step()
            state.step += 1
            return {"loss": sp.global_sum(loss) if sp else loss.detach(),
                    "grad_norm": state.optimizer.last_grad_norm}

    return train_step


def make_dagger_step(cfg: GridMMConfig):
    """Reference DAgger gradient shape (agent_base.py:164-196): per
    iteration the teacher-forced loss (weight ml_weight) and the
    student-sampled-replay loss (weight 1.0) are summed into one optimizer
    step, not alternated. Each loss is backpropagated as soon as it is
    formed (the gradients add up), so only one graph is alive at a time."""

    def train_step(state: TrainState, teacher_batch: TrajectoryBatch,
                   sample_batch: TrajectoryBatch,
                   seed: int = 0) -> Dict[str, torch.Tensor]:
        state.optimizer.zero_grad(set_to_none=True)
        sp = state.sharded
        with _update_scope(state, seed, state.step,
                           teacher_batch.txt_ids.device):
            lt = trajectory_loss(state.model, cfg, teacher_batch, sharded=sp)
            lt.backward()
            ls = trajectory_loss(state.model, cfg, sample_batch,
                                 ml_weight=1.0, sharded=sp)
            ls.backward()
            if sp is not None:
                sp.reduce_grads()
        lt, ls = ((sp.global_sum(lt), sp.global_sum(ls)) if sp
                  else (lt.detach(), ls.detach()))
        state.optimizer.step()
        state.step += 1
        return {"loss": lt + ls, "loss_teacher": lt, "loss_sample": ls,
                "grad_norm": state.optimizer.last_grad_norm}

    return train_step

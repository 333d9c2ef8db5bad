"""Continuous-env trainer: schedule-sampled imitation learning (twin of
gridmm_tpu/ce/trainer.py).

Reference: VLN_CE/vlnce_baselines/ss_trainer_GridMap.py:141-675: per-step
waypoint prediction, oracle teacher via cand_dist_to_goal, CE loss, and a
schedule-sampling ratio decaying per epoch (ratio^(epoch//num_epoches_per_
ratio+1), ss_trainer:619). The recorded episode replays through the shared
teacher-forced `trajectory_loss` (K1 forward, K5a/K5b backward on the card)
on the CE action head, fused = global+local over the [stop]+candidates
columns (gridmap/vilmodel.py:788-800), the logits the rollout acts on.

`mesh=` (a (data, model) DeviceMesh, parallel/mesh.py) is the counterpart
of the reference's DDP-wrapped CE trainer (base_il_trainer.py
_init_distributed) and of the JAX trainer's mesh: the navigator's
parameters follow the TP rules, the frozen perception towers stay
replicated and are never wrapped, each rank rolls out the whole env batch
(as the JAX program does, on one controller) and updates on its data slice
of it, with the loss of the whole batch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from gridmm_tpu_torch.ce.agent import CEAgent, step_to_device
from gridmm_tpu_torch.ce.env import ContinuousEnv
from gridmm_tpu_torch.config import GridMMConfig
from gridmm_tpu_torch.parallel.mesh import (ShardedParams, data_rank,
                                            mesh_shape,
                                            shard_trajectory_batch)
from gridmm_tpu_torch.parallel.multihost import (process_count,
                                                 process_index,
                                                 weighted_mean_scalars)
from gridmm_tpu_torch.train.recollection import pad_to_steps
from gridmm_tpu_torch.train.step import (StepInputs, TrainState,
                                         TrajectoryBatch, batch_to_device,
                                         init_carry, make_optimizer,
                                         make_train_step, nav_device_step)
from gridmm_tpu_torch.utils.checkpoint import (AsyncSaver,
                                               restore_checkpoint)
from gridmm_tpu_torch.utils.logging import MetricLogger

def derive_batches_per_epoch(env: ContinuousEnv, num_envs: int) -> int:
    """batches_per_epoch = ceil(dataset_length / batch_size), so one epoch
    covers the env's whole episode split (ss_trainer_GridMap.py:606-607).
    Envs advertise their split via `num_episodes` (SyntheticContinuousEnv)
    or an `episodes_allowed` whitelist (HabitatContinuousEnv); an env with
    neither (unbounded stream) raises: pass an explicit batch count."""
    n = getattr(env, "num_episodes", None)
    if not n:
        allowed = getattr(env, "episodes_allowed", None)
        n = len(allowed) if allowed else None
    if not n:
        raise ValueError(
            "cannot derive batches_per_epoch: env advertises no episode "
            "split (num_episodes/episodes_allowed); pass "
            "--batches_per_epoch explicitly")
    return max(1, int(np.ceil(n / num_envs)))


def _stack_steps(recorded: List[StepInputs]) -> StepInputs:
    """Per-field stack of recorded steps: host fields on the host, device
    fields (the CLIP patch tokens) on the device, where they stay."""
    return StepInputs(*[
        torch.stack([getattr(s, f) for s in recorded])
        if isinstance(getattr(recorded[0], f), torch.Tensor)
        else np.stack([np.asarray(getattr(s, f)) for s in recorded])
        for f in StepInputs._fields])


class CETrainer:
    def __init__(self, cfg: GridMMConfig, agent: CEAgent,
                 schedule_ratio: float = 0.5,
                 epochs_per_ratio: int = 1, mesh=None):
        # CE acts AND trains on fused = global+local over [stop]+candidates
        # (ss_trainer_GridMap.py:269-330); the loss accumulates over the
        # whole episode and updates once, like the reference ss_trainer.
        # CE loss contract: il_loss = ml_loss / total actions
        # (ss_trainer_GridMap.py:284,328,493, no ml_weight factor)
        self.cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, loss_head="ce",
                                           loss_norm="actions"))
        self.agent = agent
        self.schedule_ratio = schedule_ratio
        self.epochs_per_ratio = epochs_per_ratio
        self.mesh = mesh
        # the navigator only: the towers have no TP rules and no gradient
        self.sharded = (ShardedParams(agent.navigator, mesh)
                        if mesh is not None else None)
        self.state = TrainState(agent.navigator,
                                make_optimizer(self.cfg, agent.navigator),
                                sharded=self.sharded)
        self._train_step = make_train_step(self.cfg)
        self._epoch = 0
        self._saver: Optional[AsyncSaver] = None

    def ss_ratio(self, epoch: int) -> float:
        return self.schedule_ratio ** (epoch // self.epochs_per_ratio + 1)

    def _view(self):
        """The navigator's parameters as the rollouts compute with them."""
        return (self.sharded.compute_params() if self.sharded is not None
                else contextlib.nullcontext())

    def update(self, batch: TrajectoryBatch, seed: int = 0,
               dropout: bool = True) -> Dict[str, torch.Tensor]:
        """One teacher-forced update of the navigator: the trajectory loss
        (dropout on unless `dropout` is False, its masks seeded by `seed`
        and the update count), one backward, the clipped AdamW step. The
        navigator is in eval mode after, as the agent keeps it."""
        nav = self.agent.navigator
        nav.train(dropout)
        try:
            return self._train_step(self.state, batch, seed)
        finally:
            nav.eval()

    def train_epoch(self, env: ContinuousEnv, epoch: int, batches: int = 2,
                    max_steps: int = 6, logger: Optional[MetricLogger] = None,
                    seed: int = 0) -> Dict[str, float]:
        """Schedule-sampled training: during the rollout the executed action
        is the teacher's with prob ss_ratio, else the student's argmax
        (ss_trainer train_ml); the recorded episode then replays through the
        trajectory loss for ONE update per batch (the reference also
        accumulates the whole rollout before stepping, ss_trainer:644-646).
        """
        rng = np.random.default_rng(seed + epoch)
        ratio = self.ss_ratio(epoch)
        if self.mesh is not None:
            dp = mesh_shape(self.mesh)[0]
            if env.num_envs % dp:
                raise ValueError(f"num_envs {env.num_envs} not divisible by "
                                 f"the data-axis size {dp}")
        losses = []
        for bi in range(batches):
            with self._view(), self.agent.inference():
                batch = self.record_batch(env, max_steps, rng, ratio)
            if self.mesh is not None:
                batch = shard_trajectory_batch(batch, data_rank(self.mesh),
                                               dp)
            # outside inference mode: the loss saves its inputs for the
            # backward, so the recorded CLIP tokens (inference tensors) are
            # copied
            batch = batch_to_device(batch, self.agent.device)
            batch = batch._replace(steps=batch.steps._replace(
                patch_fts=batch.steps.patch_fts.clone()))
            metrics = self.update(batch, seed * 1000 + epoch)
            losses.append(float(metrics["loss"]))
            if logger:
                logger.log(epoch * batches + bi,
                           {"loss": losses[-1], "ss_ratio": ratio},
                           prefix="ce_train/")
        self._epoch = epoch
        return {"loss": float(np.mean(losses)), "ss_ratio": ratio}

    def record_batch(self, env, max_steps, rng, ratio) -> TrajectoryBatch:
        """One schedule-sampled rollout; returns its recorded
        TrajectoryBatch, padded to max_steps: host fields as numpy, the CLIP
        patch tokens on the device."""
        agent, cfg = self.agent, self.cfg
        dev = agent.device
        obs = env.reset()
        b = env.num_envs
        txt_ids, txt_mask = agent.language_batch(obs)
        txt_mask_dev = torch.from_numpy(txt_mask).to(dev)
        txt_embeds = agent.language(torch.from_numpy(txt_ids).to(dev),
                                    txt_mask_dev)
        carry = init_carry(cfg, b, device=dev)
        ended = np.zeros((b,), bool)
        next_slot = np.full((b,), 1, np.int32)
        centers = np.asarray([19 + 36 * i for i in range(7)])
        recorded = []
        for t in range(max_steps):
            rgb, depth = agent.observation_tensors(obs)
            nms_maps, probs, patch, view_cls, view_feats = agent.perception(
                rgb, depth)
            nms_maps, probs = nms_maps.cpu().numpy(), probs.cpu().numpy()
            view_cls = view_cls.cpu().numpy()
            if view_feats is not None:
                # the same view tokens in train as in the eval rollout (the
                # reference runs one policy forward for both)
                view_feats = view_feats.float().cpu().numpy()
            # train-time waypoint sampling augmentation (Policy:393-425)
            cand_lists = [
                agent.candidates_from_nms(nms_maps[i], obs[i].heading,
                                          agent.max_candidates,
                                          probs=probs[i], rng=rng)
                for i in range(b)]
            x, _ = agent._build_step(obs, cand_lists, view_cls, centers,
                                     next_slot, t, view_feats=view_feats,
                                     ended=ended)
            targets = agent._teacher(env, obs, cand_lists, ended)
            x = x._replace(target=targets.astype(np.int32), patch_fts=patch)
            recorded.append(x)

            carry, out = nav_device_step(
                agent.navigator, cfg, txt_embeds, txt_mask_dev, carry,
                step_to_device(x, dev))
            student = out.local_logits.double().cpu().numpy().argmax(-1)
            use_teacher = rng.random(b) < ratio
            a_t = np.where(use_teacher & (targets >= 0), targets, student)
            for i in range(b):
                if ended[i]:
                    continue
                if a_t[i] == 0 or t == max_steps - 1 or \
                        a_t[i] > len(cand_lists[i]):
                    ended[i] = True
                    continue
                h_i, d_i, _ = cand_lists[i][a_t[i] - 1]
                env.step_to(i, h_i, d_i)
            obs = env.observations()
            if ended.all():
                break
        return pad_to_steps(
            TrajectoryBatch(txt_ids, txt_mask, _stack_steps(recorded)),
            max_steps, cfg.train.ignoreid)

    def evaluate(self, env: ContinuousEnv, batches: int = 0,
                 max_steps: int = 20, results_dir: Optional[str] = None,
                 checkpoint_index: int = 0, split: str = "val_unseen",
                 video_dir: Optional[str] = None) -> Dict[str, float]:
        """Greedy eval; optionally persists the reference's observability
        artifacts (base_il_trainer.py:631-644, 725-746):

          results_dir -> stats_ep_ckpt_{i}_{split}_r{r}_w{w}.json (per-
                         episode metric dicts) and the aggregated
                         stats_ckpt_{i}_{split}.json (rank 0 of 1 here)
          video_dir   -> one animated GIF of the first camera per episode

        batches=0 (the default) evaluates the FULL episode split: rollouts
        continue until the env's episode iterator wraps (a rollout yields
        no unseen episode id), and every episode scores exactly once
        (base_il_trainer.py:336,666). max_steps defaults to the reference's
        IL.max_traj_len=20 (run_GridMap.yaml:23)."""
        all_m: List[dict] = []
        ep_stats: Dict[str, dict] = {}
        total = _full_split_total(env, batches, "eval")
        rollouts = 0
        while batches == 0 or rollouts < batches:
            rollouts += 1
            frames: Dict[int, list] = {}
            hook = None
            if video_dir:
                def hook(t, obs, frames=frames):
                    for i, ob in enumerate(obs):
                        frames.setdefault(i, []).append(
                            np.asarray(ob.rgb[0], np.uint8))
            with self._view():
                ms = self.agent.rollout(env, max_steps=max_steps,
                                        feedback="argmax", on_step=hook)
            obs = env.observations()
            fresh = 0
            for i, m in enumerate(ms):
                eid = getattr(obs[i], "episode_id", "") or \
                    f"anon{rollouts}_{i}"
                if eid in ep_stats:
                    continue  # wraparound repeat: each episode counts once
                fresh += 1
                ep_stats[eid] = {k: float(v) for k, v in m.items()}
                all_m.append(m)
                if video_dir and i in frames:
                    from gridmm_tpu_torch.utils.visualize import \
                        save_episode_video

                    os.makedirs(video_dir, exist_ok=True)
                    save_episode_video(
                        os.path.join(video_dir,
                                     f"ep_{eid}_ckpt_{checkpoint_index}"),
                        frames[i])
            if batches == 0:
                if fresh == 0 or (total and len(ep_stats) >= total):
                    break
                if rollouts >= 10000:
                    raise RuntimeError(
                        "full-split eval (batches=0) saw 10000 rollouts "
                        "without the episode iterator wrapping: this env "
                        "has no finite episode set; pass batches=N or give "
                        "the env a num_episodes")
        # union of keys: 'collisions' appears only where the env recorded
        # sub-step flags; average each key over the episodes that have it
        keys = sorted({k for m in all_m for k in m})
        avg = {k: float(np.mean([m[k] for m in all_m if k in m]))
               for k in keys}
        if results_dir:
            os.makedirs(results_dir, exist_ok=True)
            rank, world = process_index(), process_count()
            with open(os.path.join(
                    results_dir,
                    f"stats_ep_ckpt_{checkpoint_index}_{split}_r{rank}_"
                    f"w{world}.json"), "w") as f:
                json.dump(ep_stats, f, indent=4)
            # the episode-count-weighted mean over the ranks: the metrics of
            # all ranks' episodes together
            avg = weighted_mean_scalars(avg, float(len(all_m)))
            if rank == 0:
                with open(os.path.join(
                        results_dir,
                        f"stats_ckpt_{checkpoint_index}_{split}.json"),
                        "w") as f:
                    json.dump(avg, f, indent=4)
        return avg

    # ----------------------------------------------------------- checkpoints
    def save(self, path: str) -> None:
        """Write the `ckpt.{epoch}` training state: navigator weights,
        optimizer state and epoch (ss_trainer_GridMap.py:65-75). The write
        overlaps the next epoch and lands by an atomic rename, so a polling
        evaluator never reads a half-written file."""
        sp = self.sharded
        # under a mesh every rank gathers (a collective), rank 0 writes
        params = (sp.full_state_dict() if sp is not None
                  else self.agent.navigator.state_dict())
        opt = (sp.full_optimizer_state(self.state.optimizer) if sp is not None
               else self.state.optimizer.state_dict())
        if process_index() != 0:
            return
        if self._saver is None:
            self._saver = AsyncSaver()
        self._saver.save(os.path.abspath(path), {
            "params": params, "opt_state": opt,
            "epoch": self._epoch, "step": self.state.step})

    def flush(self) -> None:
        """Block until the last save is on disk."""
        if self._saver is not None:
            self._saver.wait()

    def close(self) -> None:
        """flush() and release the writer (end of training)."""
        if self._saver is not None:
            self._saver.close()
            self._saver = None

    def restore(self, path: str) -> int:
        """Restore the training state written by `save`; returns the stored
        epoch (the reference's IL.is_requeue restore,
        base_il_trainer.py:147-150)."""
        self.flush()
        state = restore_checkpoint(os.path.abspath(path))
        if self.sharded is not None:
            self.sharded.load_state_dict(state["params"])
            self.sharded.load_optimizer_state(self.state.optimizer,
                                              state["opt_state"])
        else:
            self.agent.navigator.load_state_dict(state["params"],
                                                 strict=True)
            self.state.optimizer.load_state_dict(state["opt_state"])
        self.state.step = int(state.get("step", 0))
        self._epoch = int(state["epoch"])
        return self._epoch

    # ------------------------------------------------------------- inference
    def inference(self, env: ContinuousEnv, predictions_file: str,
                  fmt: str = "r2r", batches: int = 0,
                  max_steps: int = 20) -> int:
        """Greedy rollouts -> leaderboard predictions file
        (base_il_trainer.inference, :915+/1336-1367).

        batches=0 (default) predicts the FULL episode split exactly once
        (the same wraparound detection as evaluate).

        fmt='r2r': JSON {episode_id: [{"position": [x, y, z], "heading": h,
        "stop": false}]}, the reference's get_info records verbatim
        (habitat_extensions/nav.py:127-137; stop is hardcoded False there).
        Envs that expose `path_infos` (the habitat adapter) supply real 3D
        positions + headings; the synthetic arena gives [x, 0, y] / heading
        0. fmt='rxr': jsonlines of {"instruction_id", "path"} with
        consecutive duplicate positions dropped, sorted by instruction_id.
        """
        episode_predictions: Dict[str, list] = {}
        total = _full_split_total(env, batches, "inference")
        rollouts = 0
        while batches == 0 or rollouts < batches:
            rollouts += 1
            with self._view():
                self.agent.rollout(env, max_steps=max_steps,
                                   feedback="argmax")
            obs = env.observations()
            infos_all = getattr(env, "path_infos", None)
            fresh = 0
            for i, ob in enumerate(obs):
                if ob.episode_id in episode_predictions:
                    continue
                fresh += 1
                if infos_all is not None:
                    episode_predictions[ob.episode_id] = [
                        dict(rec) for rec in infos_all[i]]
                else:
                    episode_predictions[ob.episode_id] = [
                        {"position": [float(p[0]), 0.0, float(p[1])],
                         "heading": 0.0, "stop": False}
                        for p in env.paths[i]]
            if batches == 0:
                done = total and len(episode_predictions) >= total
                if fresh == 0 or done:
                    break
                if rollouts >= 10000:
                    raise RuntimeError(
                        "full-split inference (batches=0) never wrapped: "
                        "pass batches=N or give the env a num_episodes")
        # rxr instruction ids: real numeric episode ids when ALL are numeric
        # (the released data's case); otherwise a collision-free enumeration
        if all(e.isdigit() for e in episode_predictions):
            instruction_ids = {e: int(e) for e in episode_predictions}
        else:
            instruction_ids = {e: j for j, e in
                               enumerate(sorted(episode_predictions))}
        if fmt == "r2r":
            with open(predictions_file, "w") as f:
                json.dump(episode_predictions, f, indent=2)
        else:  # rxr-habitat leaderboard format
            out = []
            for eid, infos in episode_predictions.items():
                path = [infos[0]["position"]]
                for rec in infos[1:]:
                    if path[-1] != rec["position"]:
                        path.append(rec["position"])
                out.append({"instruction_id": instruction_ids[eid],
                            "path": path})
            out.sort(key=lambda x: x["instruction_id"])
            with open(predictions_file, "w") as f:
                for rec in out:
                    f.write(json.dumps(rec) + "\n")
        return len(episode_predictions)


def _numbered_checkpoints(ckpt_dir: str) -> List[str]:
    """Checkpoint entries in a folder, ordered by the trailing number in the
    entry name. Only numbered entries count: rolling 'latest' links, logs
    and a write in flight (`<ckpt>.tmp.<pid>` until its atomic rename) are
    ignored rather than restored."""
    if not os.path.isdir(ckpt_dir):
        return []
    entries = []
    for name in os.listdir(ckpt_dir):
        if name.endswith((".tmp", ".log")) or name.startswith((".", "tmp")):
            continue
        if ".tmp." in name:
            continue
        m = re.search(r"(\d+)(?!.*\d)", name)
        if m is None:
            continue  # e.g. a 'latest' rolling checkpoint
        entries.append((int(m.group(1)), name))
    entries.sort()
    return [os.path.join(ckpt_dir, name) for _, name in entries]


def _full_split_total(env: ContinuousEnv, batches: int,
                      what: str) -> Optional[int]:
    """Split size for batches=0 full-split sweeps, or None when unknown.

    An env that DECLARES itself unbounded (num_episodes attribute present
    and None) can never wrap, so a full-split sweep fails fast; an env
    without the attribute (habitat iterators cycle without advertising a
    size) keeps the wraparound+backstop path."""
    total = getattr(env, "num_episodes", "absent")
    if batches == 0 and total is None:
        raise ValueError(
            f"full-split {what} (batches=0) needs a finite episode split, "
            f"but this env declares an unbounded stream (num_episodes="
            f"None). Pass batches=N or construct the env with num_episodes.")
    return None if total == "absent" else total


def poll_checkpoint_dir(ckpt_dir: str, prev_index: int) -> Optional[str]:
    """Next unevaluated checkpoint in a folder (habitat's
    poll_checkpoint_folder, used at base_il_trainer.py:896-912); None if not
    yet written."""
    entries = _numbered_checkpoints(ckpt_dir)
    if prev_index + 1 < len(entries):
        return entries[prev_index + 1]
    return None


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Newest numbered checkpoint (the --resume entry point), or None."""
    entries = _numbered_checkpoints(ckpt_dir)
    return entries[-1] if entries else None


def evaluate_checkpoints_polling(trainer: CETrainer, env: ContinuousEnv,
                                 ckpt_dir: str, batches: int = 0,
                                 max_steps: int = 20,
                                 poll_seconds: float = 2.0,
                                 timeout_seconds: float = 0.0,
                                 results_dir: Optional[str] = None,
                                 split: str = "val_unseen",
                                 video_dir: Optional[str] = None
                                 ) -> List[Dict[str, float]]:
    """Evaluate checkpoints as they appear in ckpt_dir
    (base_il_trainer.eval(), :896-912: a sleep-and-poll loop). Stops once no
    new checkpoint shows up within timeout_seconds (0 = a single sweep)."""
    results: List[Dict[str, float]] = []
    prev = -1
    deadline = time.monotonic() + timeout_seconds
    nav = trainer.agent.navigator
    while True:
        ckpt = poll_checkpoint_dir(ckpt_dir, prev)
        if ckpt is None:
            if time.monotonic() >= deadline:
                break
            time.sleep(poll_seconds)
            continue
        prev += 1
        state = restore_checkpoint(os.path.abspath(ckpt))
        # CETrainer.save layout: only its 'params' entry (eval never touches
        # the optimizer moments); else a bare navigator state dict
        nav.load_state_dict(state["params"] if "params" in state else state,
                            strict=True)
        # stats/video files are named per checkpoint ordinal so successive
        # evals never overwrite each other
        metrics = trainer.evaluate(env, batches=batches, max_steps=max_steps,
                                   results_dir=results_dir,
                                   checkpoint_index=prev, split=split,
                                   video_dir=video_dir)
        metrics["checkpoint"] = ckpt
        results.append(metrics)
        deadline = time.monotonic() + timeout_seconds
    return results

"""Fine-tuning loop: interactive rollout -> replay update -> periodic
eval -> checkpointing (twin of gridmm_tpu/train/loop.py).

Reference: map_nav_src/main_nav.py:86-215 (train loop with log_every cadence,
best-SPL checkpoint selection) + r2r/agent_base.py:164-211 (per-iteration
train with teacher/sample interleave for DAgger).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np

from gridmm_tpu_torch.config import GridMMConfig
from gridmm_tpu_torch.models.navigator import GridMMNavigator
from gridmm_tpu_torch.train.agent import NavAgent
from gridmm_tpu_torch.train.recollection import pad_to_steps
from gridmm_tpu_torch.train.step import (batch_to_device, create_train_state,
                                         make_dagger_step, make_train_step)
from gridmm_tpu_torch.utils.checkpoint import AsyncSaver
from gridmm_tpu_torch.utils.logging import MetricLogger, SectionTimer


@dataclasses.dataclass
class TrainerResult:
    best_spl: float
    best_iter: int
    final_metrics: Dict[str, float]


def train_navigator(
    cfg: GridMMConfig,
    model: GridMMNavigator,
    agent: NavAgent,
    val_agent: Optional[NavAgent] = None,
    aug_agent: Optional[NavAgent] = None,
    iters: Optional[int] = None,
    log_every: Optional[int] = None,
    eval_batches: Optional[int] = None,
    ckpt_dir: Optional[str] = None,
    logger: Optional[MetricLogger] = None,
    seed: int = 0,
    mesh=None,
) -> TrainerResult:
    """DAgger-style training, replayed through the trajectory loss. `model`
    is updated in place; every agent must hold this same module.

    cfg.train.dagger_sum=True reproduces the reference gradient shape: one
    optimizer step per iteration over the SUM of a teacher-forced loss
    (ml_weight) and a student-sampled loss (weight 1), agent_base.py:164-196.
    Default (False) alternates the two passes across iterations: half the
    rollout cost per update, acknowledged schedule drift.

    eval_batches=None (the default) evaluates the FULL val split for the
    best-SPL checkpoint decision (reference test() + main_nav.py:180-204); a
    positive count is a subsampled probe for smoke configs only.

    aug_agent (an agent over the augmented-instruction env) alternates 1:1
    with the GT-data agent per iteration (main_nav.py:142-154).

    Dropout is on during the replay updates and off in the rollouts and the
    evaluation, as in the JAX package.
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (data/tensor-parallel training) waits for the parallel "
            "layer (parallel/mesh.py; ROADMAP Queue 1, parallel layer)")
    for a in (agent, val_agent, aug_agent):
        if a is not None and a.model is not model:
            raise ValueError("every agent must hold the module being trained")
    iters = iters or cfg.train.iters
    log_every = log_every or cfg.train.log_every
    logger = logger or MetricLogger()
    timer = SectionTimer()
    dagger_sum = cfg.train.dagger_sum
    device = agent.device

    state = create_train_state(cfg, model)
    train_step = make_train_step(cfg)
    dagger_step = make_dagger_step(cfg) if dagger_sum else None
    np_rng = np.random.default_rng(seed)

    best_spl, best_iter = -1.0, -1
    final_metrics: Dict[str, float] = {}

    # async cadence saves: the write overlaps the next training interval
    # (AsyncSaver host-copies before returning, so the next update may
    # overwrite the parameters at once)
    saver = AsyncSaver()

    def _save(name):
        if ckpt_dir:
            saver.save(os.path.join(os.path.abspath(ckpt_dir), name),
                       model.state_dict())

    def _bucket(s: int) -> int:
        """Smallest configured bucket covering s (else max_action_len), so
        short episodes skip the padded tail of the step loop."""
        buckets = cfg.train.scan_buckets
        if not buckets:
            return cfg.train.max_action_len
        fits = [b for b in buckets if b >= s]
        return min(fits) if fits else cfg.train.max_action_len

    def _rollout(cur_agent, feedback):
        _, batch, _ = cur_agent.rollout(feedback=feedback, record=True,
                                        rng=np_rng)
        return batch

    def _pad(batch, num_steps=None):
        batch = pad_to_steps(
            batch, num_steps or _bucket(batch.steps.target.shape[0]),
            cfg.train.ignoreid)
        return batch_to_device(batch, device)

    def _update(step_fn, *batches):
        model.train()
        try:
            return step_fn(state, *batches, seed=seed)
        finally:
            model.eval()

    try:
        for it in range(1, iters + 1):
            # GT/aug interleave: odd iterations GT env, even iterations aug
            cur = agent if (aug_agent is None or it % 2 == 1) else aug_agent
            if dagger_sum:
                with timer.section("rollout"):
                    tb = _rollout(cur, "teacher")
                    sb = _rollout(cur, "sample")
                nb = _bucket(max(tb.steps.target.shape[0],
                                 sb.steps.target.shape[0]))
                with timer.section("update"):
                    metrics = _update(dagger_step, _pad(tb, nb), _pad(sb, nb))
            else:
                # alternate teacher/sample per ENV visit so the aug env sees
                # both passes too (with aug: T(gt) T(aug) S(gt) S(aug) ...)
                phase = ((it + 1) // 2) if aug_agent is not None else it
                feedback = "teacher" if phase % 2 == 1 else "sample"
                with timer.section("rollout"):
                    batch = _pad(_rollout(cur, feedback))
                with timer.section("update"):
                    metrics = _update(train_step, batch)
            logger.log(it, {k: float(v) for k, v in metrics.items()},
                       prefix="train/")

            if it % log_every == 0:
                # rolling latest checkpoint for crash recovery
                # (agent_base.py latest_dict / IL.is_requeue semantics)
                _save("latest")

            if it % log_every == 0 and val_agent is not None:
                with timer.section("eval"):
                    avg, _ = val_agent.evaluate(eval_batches)
                logger.log(it, avg, prefix="val/")
                final_metrics = avg
                # >= so equal-SPL ties keep the LATEST checkpoint, matching
                # main_nav.py:199 / main_rxr.py:199 / main_nav_obj.py:205
                if avg["spl"] >= best_spl:
                    best_spl, best_iter = avg["spl"], it
                    _save("best_spl")
    except BaseException:
        # interrupted (preemption / SIGINT): park a resumable checkpoint
        # before propagating; --resume picks it up. Never let a save
        # failure mask the original exception.
        try:
            _save("latest")
            saver.close()  # make the interrupt save durable before exiting
        except Exception as save_err:
            print(f"interrupt-save failed: {save_err!r}", flush=True)
        raise
    saver.close()
    logger.log(iters, timer.summary(), prefix="time/")
    return TrainerResult(best_spl, best_iter, final_metrics)

"""Teacher-recollection store: record trajectories once, train offline (twin
of gridmm_tpu/train/recollection.py).

Reference: TeacherRecollectionDataset (VLN_CE/vlnce_baselines/common/
recollection_dataset.py:22-297) replays teacher rollouts from disk so epochs
don't pay simulator cost. A recorded TrajectoryBatch (the input of the
trajectory loss) serializes to one compressed npz per batch, in the JAX
package's file layout; a round-robin loader feeds training without touching
the env at all."""

from __future__ import annotations

import os
from typing import Iterator, List, Optional

import numpy as np
import torch

from gridmm_tpu_torch.train.step import StepInputs, TrajectoryBatch


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def save_trajectory_batch(path: str, batch: TrajectoryBatch) -> None:
    arrays = {"txt_ids": _np(batch.txt_ids), "txt_mask": _np(batch.txt_mask)}
    for f in StepInputs._fields:
        arrays[f"steps_{f}"] = _np(getattr(batch.steps, f))
    np.savez_compressed(path, **arrays)


def load_trajectory_batch(path: str) -> TrajectoryBatch:
    """The recorded batch as numpy arrays (train/step.batch_to_device moves
    it to the card)."""
    with np.load(path) as z:
        steps = StepInputs(*[z[f"steps_{f}"] for f in StepInputs._fields])
        return TrajectoryBatch(txt_ids=z["txt_ids"], txt_mask=z["txt_mask"],
                               steps=steps)


def pad_to_steps(batch: TrajectoryBatch, num_steps: int,
                 ignore_id: int = -100) -> TrajectoryBatch:
    """Pad (or cut) the step axis to a fixed length. Padding steps replay
    the last real step with ignore targets: loss-neutral (the reference
    likewise keeps feeding ended episodes, agent.py:434). Tensors are padded
    where they lie, numpy arrays on the host."""
    s = batch.steps.target.shape[0]
    if s >= num_steps:
        return TrajectoryBatch(
            txt_ids=batch.txt_ids, txt_mask=batch.txt_mask,
            steps=StepInputs(*[a[:num_steps] for a in batch.steps]))

    def pad(a, field):
        if isinstance(a, torch.Tensor):
            reps = torch.cat([a, a[-1:].expand(num_steps - s, *a.shape[1:])])
        else:
            a = np.asarray(a)
            reps = np.concatenate(
                [a, np.repeat(a[-1:], num_steps - s, axis=0)])
        if field in ("target", "obj_target"):
            reps[s:] = ignore_id
        return reps

    steps = StepInputs(*[pad(getattr(batch.steps, f), f)
                         for f in StepInputs._fields])
    return TrajectoryBatch(batch.txt_ids, batch.txt_mask, steps)


class RecollectionStore:
    """Directory of recorded teacher trajectories."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def record(self, agent, num_batches: int, feedback: str = "teacher",
               rng=None) -> int:
        """Roll out and persist `num_batches` recorded batches."""
        n0 = len(self.paths())
        for i in range(num_batches):
            _, batch, _ = agent.rollout(feedback=feedback, record=True,
                                        rng=rng)
            save_trajectory_batch(
                os.path.join(self.root, f"traj_{n0 + i:06d}.npz"), batch)
        return num_batches

    def paths(self) -> List[str]:
        return sorted(
            os.path.join(self.root, f) for f in os.listdir(self.root)
            if f.endswith(".npz"))

    def __len__(self) -> int:
        return len(self.paths())

    def batches(self, epochs: int = 1,
                pad_steps: Optional[int] = None) -> Iterator[TrajectoryBatch]:
        for _ in range(epochs):
            for p in self.paths():
                b = load_trajectory_batch(p)
                if pad_steps is not None:
                    b = pad_to_steps(b, pad_steps)
                yield b

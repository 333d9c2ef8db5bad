"""Faults planted under a cell's timed path, to see `correct` come out
false: each cell's loop takes them as hooks. The CPU tests plant every one
at tiny widths; `calibrate.py --fault NAME` reads one on the card at the
cell's own size.

- state_unchanged: a step that returns the state it was given;
- half_batch: half of the batch left out (in training, the loss the mean
  over the rest);
- answer_altered: an answer altered where it is produced.

No cell runs over several chips, so none has an exchange between chips to
leave out.
"""

from __future__ import annotations

import contextlib


# --- serving (loops/serve.py hooks: program, rows, outputs)
@contextlib.contextmanager
def serve_state_unchanged():
    """The navigation step that `NavServingEngine.create` binds returns the
    carry it was given, untouched."""
    from gridmm_tpu_torch.serve import engine

    step = engine.nav_device_step

    def stale(model, cfg, txt, mask, carry, x):
        scratch = type(carry)(*(
            type(part)(*(t.clone() for t in part))
            if isinstance(part, tuple) else part.clone() for part in carry))
        return carry, step(model, cfg, txt, mask, scratch, x)[1]

    engine.nav_device_step = stale
    try:
        yield
    finally:
        engine.nav_device_step = step


def serve_half_batch(rows):
    """Half of the slots run the engine's zero row."""
    return {s: r for s, r in rows.items() if s < len(rows) // 2}


def serve_answer_altered(out):
    """Slot 0's fused logits scaled by 1.001."""
    fused = out.fused_logits.clone()
    fused[0] = fused[0] * 1.001
    return out._replace(fused_logits=fused)


# --- training (loops/train.py hooks: state, batch)
def train_state_unchanged(state):
    state.optimizer.step = lambda closure=None: None


def train_half_batch(k, batch):
    half = batch.txt_ids.shape[0] // 2
    return type(batch)(batch.txt_ids[:half], batch.txt_mask[:half],
                       type(batch.steps)(*(a[:, :half]
                                           for a in batch.steps)))


def train_answer_altered(k, batch):
    """Row 0's first teacher action altered where the batch is made."""
    import torch

    target = batch.steps.target.clone()
    target[0, 0] = torch.where(target[0, 0] == 0, target[0, 0] + 2, 0)
    return batch._replace(steps=batch.steps._replace(target=target))


FAULTS = {
    "serve": {"state_unchanged": {"program": serve_state_unchanged},
              "half_batch": {"rows": serve_half_batch},
              "answer_altered": {"outputs": serve_answer_altered}},
    "train": {"state_unchanged": {"state": train_state_unchanged},
              "half_batch": {"batch": train_half_batch},
              "answer_altered": {"batch": train_answer_altered}},
}

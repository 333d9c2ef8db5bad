"""Continuous-batching serving engine (twin of gridmm_tpu/serve/engine.py).

Requests (episodes) arrive and finish at different times; B slots share one
step graph with static shapes:

  * ``submit()`` queues a request (instruction token ids);
  * ``admit()`` packs queued requests into free slots: one language forward
    for the admitted rows, a row-write into the resident (B, T, D) text
    buffer, and a zero-reset of the admitted slots' episode carry;
  * ``step()`` takes per-slot StepInputs rows, runs the navigation step once
    for all slots and returns outputs with leading dim B;
  * ``finish()`` frees a slot for the next admission.

Free slots run zero rows (fully masked; the compute is row-independent, so
a free row never contaminates an active one). All device work runs under
`torch.inference_mode()`.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from gridmm_tpu_torch.train.step import (NavCarry, StepInputs, init_carry,
                                         nav_device_step)
from gridmm_tpu_torch.utils.export import zero_step_inputs


def serving_cfg(cfg):
    """Serving keeps rows INDEPENDENT: the reference's compaction-alias stray
    keys depend on the batch's max occupied-cell count
    (ops/masking.compaction_stray_count), so serving turns them off and runs
    the clean masked semantics (training/eval keep them)."""
    if getattr(cfg.model, "compaction_stray_keys", False):
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compaction_stray_keys=False))
    return cfg


class NavServingEngine:
    """Fixed-slot continuous batching over the navigator's step."""

    def __init__(self, model, cfg, batch: int, device="cuda"):
        """Use `create` instead of calling this directly."""
        self.cfg = serving_cfg(cfg)
        self.model = model
        self.batch = batch
        self.device = torch.device(device)
        t, d = self.cfg.shapes.max_txt_len, self.cfg.model.hidden_size
        with torch.inference_mode():
            self._txt_buf = torch.zeros((batch, t, d), device=self.device)
            self._mask_buf = torch.zeros((batch, t), dtype=torch.bool,
                                         device=self.device)
            self._carry: NavCarry = init_carry(self.cfg, batch,
                                               device=self.device)
        self._zero_row = StepInputs(*(
            a[:1].numpy() for a in zero_step_inputs(self.cfg, 1, "cpu")))
        self._queue: deque = deque()
        self._slot_req: List[Optional[object]] = [None] * batch
        self._req_slot: Dict[object, int] = {}

    @classmethod
    def create(cls, model, cfg, batch: int, device="cuda"
               ) -> "NavServingEngine":
        """An engine over `model`. The stray-key decision lives in the
        module's own cfg, so the model is rebuilt on the serving config when
        it differs (same parameters, shared)."""
        scfg = serving_cfg(cfg)
        if model.cfg != scfg.model:
            with torch.device("meta"):
                served = type(model)(scfg.model)
            served.load_state_dict(model.state_dict(), assign=True)
            model = served
        return cls(model.to(device).eval(), scfg, batch, device)

    # ------------------------------------------------------------- requests
    def submit(self, req_id, txt_ids: np.ndarray,
               txt_mask: np.ndarray) -> None:
        """Queue an episode. txt_ids/txt_mask: (max_txt_len,) host arrays."""
        self._queue.append((req_id, np.asarray(txt_ids, np.int32),
                            np.asarray(txt_mask, bool)))

    def free_slots(self) -> List[int]:
        return [s for s, r in enumerate(self._slot_req) if r is None]

    def active(self) -> Dict[object, int]:
        return dict(self._req_slot)

    def admit(self) -> Dict[object, int]:
        """Admit queued requests into free slots with one language forward;
        returns {req_id: slot} for the new ones."""
        free = self.free_slots()
        if not free or not self._queue:
            return {}
        slots, ids, masks = [], [], []
        admitted: Dict[object, int] = {}
        for slot in free:
            if not self._queue:
                break
            req_id, rid, rmask = self._queue.popleft()
            slots.append(slot)
            ids.append(rid)
            masks.append(rmask)
            self._slot_req[slot] = req_id
            self._req_slot[req_id] = slot
            admitted[req_id] = slot
        dev = self.device
        with torch.inference_mode():
            ids_t = torch.as_tensor(np.stack(ids), device=dev)
            mask_t = torch.as_tensor(np.stack(masks), device=dev)
            rows = torch.as_tensor(slots, device=dev)
            self._txt_buf[rows] = self.model(
                "language", {"txt_ids": ids_t, "txt_mask": mask_t})
            self._mask_buf[rows] = mask_t
            for t in (*self._carry.point_state, self._carry.gmap_sum,
                      self._carry.gmap_cnt):
                t[rows] = 0
        return admitted

    def finish(self, req_id) -> None:
        slot = self._req_slot.pop(req_id)
        self._slot_req[slot] = None

    # ----------------------------------------------------------------- step
    def step(self, rows: Dict[int, StepInputs]):
        """One navigation step for every slot. rows: {slot: single-row (b=1)
        StepInputs of host arrays} for (a subset of) active slots; free or
        absent slots run the zero row. Returns NavOutputs, leading dim B."""
        cols = []
        for f in StepInputs._fields:
            parts = [np.asarray(getattr(rows[s], f)) if s in rows
                     else getattr(self._zero_row, f)
                     for s in range(self.batch)]
            cols.append(np.concatenate(parts, axis=0))
        with torch.inference_mode():
            x = StepInputs(*(torch.as_tensor(c, device=self.device)
                             for c in cols))
            self._carry, out = nav_device_step(
                self.model, self.cfg, self._txt_buf, self._mask_buf,
                self._carry, x)
        return out

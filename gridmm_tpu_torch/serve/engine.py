"""Continuous-batching serving engine (twin of gridmm_tpu/serve/engine.py).

Requests (episodes) arrive and finish at different times; B slots share one
step graph with static shapes:

  * ``submit()`` queues a request (instruction token ids);
  * ``admit()`` packs queued requests into free slots: one language forward
    over the k admitted rows (over all B rows where the forward couples its
    rows or takes only B: see `admit`), a row-write of the admitted rows
    into the resident (B, T, D) text buffer, and a zero-reset of their
    episode carry, all in `_admit_rows(n)` over static admission buffers;
  * ``step()`` takes per-slot StepInputs rows, runs the navigation step once
    for all slots and returns outputs with leading dim B;
  * ``finish()`` frees a slot for the next admission.

Free slots run zero rows (fully masked; the compute is row-independent, so
a free row never contaminates an active one). All device work runs under
`torch.inference_mode()`.

The engine runs the live navigator (`create`) or a bundle of exported
programs (`from_bundle`, utils/export.py). Its text buffer, carry and step
inputs are static buffers: `step()` writes each input field's rows into its
buffer and the step's new carry back into the carry's. The rows of a field
that outweighs one thread's share of the step's bytes (the patch features)
are written in parallel, one task a row on the engine's threads, one for
each CPU the process may run on; meanwhile the calling thread writes every
other field by one concatenation. On the card the rows go through pinned
host buffers and up on a copy stream of the engine's own, each row of a
split field as soon as it is written, so the upload overlaps the writing
of the next rows and whatever the compute stream runs meanwhile (the
admission's kernels). The compute stream waits on the copies' event before
the step runs; the next step's copies wait on the step's event before they
overwrite its inputs. On a CUDA device the step is captured once in a
`torch.cuda.CUDAGraph` when the engine is made and replayed by every
`step()`: the port's counterpart of the JAX engine's single jitted dispatch.
The admission is graphed too: `_admit_rows(n)` is captured beside the step
for every row count n an admission can encode (1..B where it encodes only
the admitted rows, B alone where it encodes all of them), the graphs
sharing one memory pool, and `admit()` copies the ids, masks and slots into
the admission's buffers and replays graph n. A capture that fails raises;
nothing falls back to eager. On the CPU, and with `cuda_graph=False`, the
step and `_admit_rows(n)` run eagerly over the same buffers.

Under a torch.profiler the admission and the step record the spans and
counters of utils/logging.span (`serve.admit`, `serve.step` with its
`assemble` and `replay`); the admission's and the step's carry the ids of
the requests they served, the admission counts its calls and the ones
that replayed a graph (`serve.admit.calls`, `serve.admit.replays`), and
the step the bytes of its inputs and those of them that went up on the
copy stream (`serve.step.h2d_bytes`, `serve.step.h2d_streamed_bytes`).
"""

from __future__ import annotations

import dataclasses
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor, wait
from functools import partial
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from gridmm_tpu_torch.models.navigator import NavOutputs
from gridmm_tpu_torch.train.step import (NavCarry, StepInputs, init_carry,
                                         nav_device_step)
from gridmm_tpu_torch.utils.export import (carry_to_dict, dict_to_carry,
                                           zero_step_inputs)
from gridmm_tpu_torch.utils.logging import span


def serving_cfg(cfg):
    """Serving keeps rows INDEPENDENT: the reference's compaction-alias stray
    keys depend on the batch's max occupied-cell count
    (ops/masking.compaction_stray_count), so serving turns them off and runs
    the clean masked semantics (training/eval keep them)."""
    if getattr(cfg.model, "compaction_stray_keys", False):
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compaction_stray_keys=False))
    return cfg


def _carry_tensors(carry: NavCarry):
    return (*carry.point_state, carry.gmap_sum, carry.gmap_cnt)


def _kernel_launches() -> Dict[str, int]:
    """Launch counts of the kernels a step may run (module-level counters
    of ops/cuda/*.py)."""
    from gridmm_tpu_torch.ops.cuda.grid_pool import GRID_POOL_FWD

    return {GRID_POOL_FWD.name: GRID_POOL_FWD.launches}


def _host_threads() -> int:
    """The CPUs this process may run on."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # a platform without affinity masks
        return os.cpu_count() or 1


def _end_generator_capture(device) -> None:
    """A capture that fails ends before CUDA's default generator leaves its
    capture state, and every later random op on the card (dropout) then
    raises "Offset increment outside graph capture". One capture that
    completes puts the generator back."""
    graph = torch.cuda.CUDAGraph()
    x = torch.zeros(1, device=device)
    with torch.cuda.graph(graph):
        x.add_(1.0)


def _shard_for_rank(mesh: dict, state_dict, batch: int, device):
    """A sharded bundle's share for this rank: (its slices of the full
    state dict, its rank, its slots). The process group's world must have
    the bundle's data x model ranks. Where this process lacks the process
    groups the programs name (the exporting process's), it makes the mesh
    itself (parallel.mesh.make_mesh, the bundle's shape) and registers each
    of its groups under the recorded name, as JAX's sharded export needs
    only as many devices."""
    import torch.distributed as dist
    from torch._C._distributed_c10d import _register_process_group
    from torch.distributed.distributed_c10d import _resolve_process_group

    from gridmm_tpu_torch.config import MeshConfig
    from gridmm_tpu_torch.parallel.mesh import local_slice, make_mesh

    dp, mp = mesh["data"], mesh["model"]
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not dist.is_initialized() or world != dp * mp:
        raise ValueError(f"bundle exported for a {dp}x{mp} mesh "
                         f"({dp * mp} ranks); this world has {world}"
                         + ("" if dist.is_initialized() else " (no process "
                            "group: init_process_group first)"))
    rank = dist.get_rank()

    def missing():
        out = []
        for axis, name in mesh["groups"][rank].items():
            try:
                _resolve_process_group(name)
            except (KeyError, ValueError, RuntimeError):
                out.append((axis, name))
        return out

    if missing():
        made = make_mesh(MeshConfig(dp_size=dp, mp_size=mp), device)
        groups = {"data": made.get_group(0), "model": made.get_group(1)}
        for axis, name in missing():
            _register_process_group(name, groups[axis])
    pls = mesh["placements"]
    shards = {k: local_slice(v, tuple(pls[k]), dp, mp, rank // mp, rank % mp)
              if k in pls else v for k, v in state_dict.items()}
    return shards, rank, batch // dp


class NavServingEngine:
    """Fixed-slot continuous batching over the navigator's step."""

    def __init__(self, cfg, batch: int, lang_fn: Callable,
                 step_fn: Callable, device="cuda", model=None,
                 cuda_graph: bool = True):
        """lang_fn(txt_ids (B,T), txt_mask (B,T)) -> txt_embeds (B,T,D);
        step_fn(txt_embeds, txt_mask, carry, x) -> (carry, NavOutputs).
        Use `create` / `from_bundle` instead of calling this directly."""
        self.cfg = serving_cfg(cfg)
        self.model = model
        self.batch = batch
        self.device = torch.device(device)
        self._lang_fn = lang_fn
        self._step_fn = step_fn
        # the live f32/bf16 trunk encodes each row on its own and takes any
        # row count; an int8 trunk's activation scale is an absmax over the
        # whole batch, and a bundle's language program is traced at B rows
        self._encode_admitted_only = (model is not None
                                      and not self.cfg.model.int8_matmuls)
        t, d = self.cfg.shapes.max_txt_len, self.cfg.model.hidden_size
        on_card = self.device.type == "cuda"
        with torch.inference_mode():
            self._txt_buf = torch.zeros((batch, t, d), device=self.device)
            self._mask_buf = torch.zeros((batch, t), dtype=torch.bool,
                                         device=self.device)
            self._carry: NavCarry = init_carry(self.cfg, batch,
                                               device=self.device)
            self._x = zero_step_inputs(self.cfg, batch, self.device)
            # host side of the input copies: pinned on the card, the
            # buffers themselves on the CPU
            self._x_host = StepInputs(*(
                torch.empty_like(a, device="cpu", pin_memory=True)
                for a in self._x)) if on_card else self._x
            # the admission's inputs: token ids, masks and the slot each
            # encoded row is written to (see `admit`)
            self._admit_in = (
                torch.zeros((batch, t), dtype=torch.int32,
                            device=self.device),
                torch.zeros((batch, t), dtype=torch.bool, device=self.device),
                torch.zeros((batch,), dtype=torch.int64, device=self.device))
            self._admit_host = tuple(
                torch.zeros_like(a, device="cpu", pin_memory=True)
                for a in self._admit_in) if on_card else self._admit_in
        # a copy: on the CPU `a[:1]` is row 0 of the step's buffer
        self._zero_row = StepInputs(*(
            a[:1].cpu().numpy().copy() for a in self._x))
        # what a step's copies move (on the CPU the host writes fill the
        # step's buffers themselves)
        self._h2d_bytes = sum(a.nbytes for a in self._x_host)
        # (field, its host buffer, its buffer, and where the threads write
        # it row by row each slot's row of the host buffer as an array and
        # of both buffers, else None): a field is split where it outweighs
        # one thread's share of the step's bytes; a smaller one costs less
        # whole, on the calling thread, while the threads write
        threads = _host_threads()
        self._fields = [
            (f, host, buf,
             [(host[s:s + 1].numpy(), host[s:s + 1], buf[s:s + 1])
              for s in range(batch)]
             if host.nbytes * threads > self._h2d_bytes else None)
            for f, host, buf in zip(StepInputs._fields, self._x_host,
                                    self._x)]
        self._row_writers = ThreadPoolExecutor(
            threads, thread_name_prefix="serve-rows")
        # the stream the inputs go up on, and the event after the last
        # step's reads of its input buffers, which the copies wait on
        self._copy_stream: Optional[torch.cuda.Stream] = None
        self._replayed: Optional[torch.cuda.Event] = None
        if on_card:
            self._copy_stream = torch.cuda.Stream(self.device)
            self._replayed = torch.cuda.Event()
            # after the buffers' zero fill
            self._replayed.record(torch.cuda.current_stream(self.device))
        # the last copies out of the pinned buffers, which wait for them
        # before they are written again
        self._copied: Optional[torch.cuda.Event] = None
        self._admit_copied: Optional[torch.cuda.Event] = None
        self._queue: deque = deque()
        self._slot_req: List[Optional[object]] = [None] * batch
        self._req_slot: Dict[object, int] = {}
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        # {rows encoded: the graph of `_admit_rows(rows)`}
        self._admit_graphs: Dict[int, torch.cuda.CUDAGraph] = {}
        # kernel launches recorded by the capture (each replay repeats them)
        self.graph_launches: Dict[str, int] = {}
        self.replays = 0
        if on_card and cuda_graph:
            self._capture()

    # ------------------------------------------------------------ factories
    @classmethod
    def create(cls, model, cfg, batch: int, device="cuda",
               cuda_graph: bool = True) -> "NavServingEngine":
        """An engine over `model`. The stray-key decision lives in the
        module's own cfg, so the model is rebuilt on the serving config when
        it differs (same parameters, shared)."""
        scfg = serving_cfg(cfg)
        if model.cfg != scfg.model:
            with torch.device("meta"):
                served = type(model)(scfg.model)
            served.load_state_dict(model.state_dict(), assign=True)
            model = served
        model = model.to(device).eval()
        return cls(
            scfg, batch,
            lang_fn=lambda ids, mask: model(
                "language", {"txt_ids": ids, "txt_mask": mask}),
            step_fn=lambda txt, mask, carry, x: nav_device_step(
                model, scfg, txt, mask, carry, x),
            device=device, model=model, cuda_graph=cuda_graph)

    @classmethod
    def from_bundle(cls, bundle_dir: str, cfg, state_dict, batch: int,
                    device="cuda", cuda_graph: bool = True
                    ) -> "NavServingEngine":
        """Serve from exported programs (utils/export.py): no model code.
        `state_dict` holds the navigator's weights (any checkpoint of the
        bundle's architecture; moved to `device`); `batch` must equal the
        bundle's exported batch. An int8 bundle's programs quantize the
        weights they are given at every step.

        A sharded bundle (export_navigator_serving_sharded) runs on every
        rank of a process group's world of the bundle's data x model size;
        where the process has not made the (data, model) mesh the programs'
        collectives name, from_bundle makes it. Each rank loads its
        programs, keeps its slices of the full `state_dict` and serves
        batch / dp slots (the ranks of one model group take the same
        requests). Under a world of another size it raises."""
        import json
        import os

        from gridmm_tpu_torch.utils.export import load_exported

        with open(os.path.join(bundle_dir, "manifest.json")) as f:
            manifest = json.load(f)
        exported_batch = manifest.get("batch")
        if exported_batch is not None and exported_batch != batch:
            raise ValueError(f"bundle exported for batch {exported_batch}, "
                             f"engine asked for {batch}")
        if bool(manifest.get("int8", False)) != cfg.model.int8_matmuls:
            raise ValueError(
                f"bundle exported with int8={manifest.get('int8', False)}, "
                f"config has int8_matmuls={cfg.model.int8_matmuls}")
        files = {name: art["file"]
                 for name, art in manifest["artifacts"].items()}
        mesh = manifest.get("mesh")
        if mesh is not None:
            state_dict, rank, batch = _shard_for_rank(mesh, state_dict,
                                                      batch, device)
            files = {k: v.format(rank=rank) for k, v in files.items()}
        lang = load_exported(os.path.join(bundle_dir, files["language"])
                             ).module()
        step = load_exported(os.path.join(bundle_dir, files["nav_step"])
                             ).module()
        params = {k: v.to(device) for k, v in state_dict.items()}

        def step_fn(txt, mask, carry, x):
            new, out = step(params, txt, mask, carry_to_dict(carry),
                            x._asdict())
            return dict_to_carry(new), NavOutputs(
                **{f: out.get(f) for f in NavOutputs._fields})

        return cls(cfg, batch,
                   lang_fn=lambda ids, mask: lang(params, ids, mask),
                   step_fn=step_fn, device=device, cuda_graph=cuda_graph)

    # ------------------------------------------------------------ the graph
    def _run_step(self):
        """The step on the static buffers; the new carry is copied into
        the carry's buffers where the step did not write them in place."""
        new, out = self._step_fn(self._txt_buf, self._mask_buf, self._carry,
                                 self._x)
        for dst, src in zip(_carry_tensors(self._carry),
                            _carry_tensors(new)):
            if src.data_ptr() != dst.data_ptr():
                dst.copy_(src)
        return out

    def _admit_rows(self, n: int) -> None:
        """The language forward over the first n rows of the admission's
        buffers, written into the text and mask buffers at the slots of
        the rows buffer, whose carry rows it zeroes. Where the engine
        encodes all B rows (n = B, zeros in the slots not admitted), the
        rows buffer lists the admitted slots, the first of them repeated
        to length B, and only those rows are written. Keeps no output."""
        ids, mask, rows = (a[:n] for a in self._admit_in)
        txt = self._lang_fn(ids, mask)
        if not self._encode_admitted_only:
            txt, mask = txt[rows], mask[rows]
        self._txt_buf[rows] = txt
        self._mask_buf[rows] = mask
        for buf in _carry_tensors(self._carry):
            buf.index_fill_(0, rows, 0)

    def _captured(self, fn, what: str, pool=None):
        """(`fn()` captured in a CUDA graph, in `pool` where given; what
        the capture returned). Raises if capture fails."""
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.inference_mode(), torch.cuda.graph(graph, pool=pool):
                out = fn()
        except Exception as e:
            _end_generator_capture(self.device)
            raise RuntimeError(f"CUDA-graph capture of the serving {what} "
                               "failed; the engine does not run eager in "
                               "its place (cuda_graph=False asks for "
                               "eager)") from e
        return graph, out

    def _capture(self):
        """Warm the step and the admission at every row count up on a side
        stream (the kernels build and load, libraries make their
        workspaces; the step over a copy of the carry, the admission's
        writes undone after), then capture them on the static buffers: the
        step in a graph of its own, the admissions in graphs that share one
        memory pool (they never run at once, and none keeps an output).
        Raises if a capture fails."""
        dev = self.device
        # the row counts an admission may encode, largest first
        counts = (range(self.batch, 0, -1) if self._encode_admitted_only
                  else [self.batch])
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), torch.inference_mode():
            scratch = NavCarry(*(
                type(part)(*(t.clone() for t in part))
                if isinstance(part, tuple) else part.clone()
                for part in self._carry))
            self._step_fn(self._txt_buf, self._mask_buf, scratch, self._x)
            written = (self._txt_buf, self._mask_buf,
                       *_carry_tensors(self._carry))
            kept = [t.clone() for t in written]
            for n in counts:
                self._admit_rows(n)
            for t, k in zip(written, kept):
                t.copy_(k)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        before = _kernel_launches()
        self._graph, self._graph_out = self._captured(self._run_step, "step")
        after = _kernel_launches()
        self.graph_launches = {k: after[k] - before[k] for k in after}
        pool = torch.cuda.graph_pool_handle()
        self._admit_graphs = {
            n: self._captured(partial(self._admit_rows, n), "admission",
                              pool)[0]
            for n in counts}

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
        """Admit queued requests into free slots; returns {req_id: slot} for
        the new ones. A live engine without int8 matmuls runs one language
        forward over the k admitted rows, in slot order; an int8 engine and
        a bundle's engine run it over all B rows, zeros in the slots not
        admitted, and keep the admitted rows. Either way the rows of other
        slots in the text buffer stay as they are. The ids, masks and slots
        go into the admission's buffers (one pinned copy each on the card)
        and `_admit_rows(n)` runs on them: graph n's replay where the step
        is graphed, else eagerly."""
        free = self.free_slots()
        if not free or not self._queue:
            return {}
        admitted: Dict[object, int] = {}
        texts = []
        for slot in free:
            if not self._queue:
                break
            req_id, ids, mask = self._queue.popleft()
            self._slot_req[slot] = req_id
            self._req_slot[req_id] = slot
            admitted[req_id] = slot
            texts.append((ids, mask))
        slots = list(admitted.values())
        n = len(slots) if self._encode_admitted_only else self.batch
        graph = self._admit_graphs.get(n)
        with span("serve.admit", self.device) as sp, torch.inference_mode():
            if self._admit_copied is not None:
                self._admit_copied.synchronize()  # the pinned buffers are free
            ids, mask, rows = (a.numpy() for a in self._admit_host)
            if self._encode_admitted_only:
                at = range(len(slots))
            else:
                at = slots
                ids[:], mask[:], rows[:] = 0, False, slots[0]
            for i, (t, m) in zip(at, texts):
                ids[i], mask[i] = t, m
            rows[:len(slots)] = slots
            for host, buf in zip(self._admit_host, self._admit_in):
                if host is not buf:
                    buf[:n].copy_(host[:n], non_blocking=True)
            if self.device.type == "cuda":
                self._admit_copied = torch.cuda.Event()
                self._admit_copied.record()
            if graph is None:
                self._admit_rows(n)
            else:
                graph.replay()
            if sp is not None:
                sp.attrs["ids"] = list(admitted)
                sp.count("serve.admit.rows_admitted", len(admitted))
                sp.count("serve.admit.rows_encoded", n)
                sp.count("serve.admit.calls", 1)
                sp.count("serve.admit.replays", int(graph is not None))
        return admitted

    def finish(self, req_id) -> None:
        slot = self._req_slot.pop(req_id)
        self._slot_req[slot] = None

    # ----------------------------------------------------------------- step
    def _assemble(self, rows: Dict[int, StepInputs]) -> None:
        """Write every slot's row (the zero row where `rows` has none) into
        the step's inputs: into the pinned buffers and up on the copy
        stream on the card, into the buffers themselves on the CPU. Returns
        once every row is written; the compute stream then waits on the
        copies (the `_copied` event)."""
        copy = self._copy_stream
        if copy is None:
            self._write_rows(rows)
            return
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(copy):
            copy.wait_event(self._replayed)   # the last step read its inputs
            self._write_rows(rows)
            self._copied = torch.cuda.Event()
            self._copied.record(copy)
        compute.wait_event(self._copied)

    def _write_rows(self, rows: Dict[int, StepInputs]) -> None:
        """The host writes of `_assemble`, each followed by its upload (on
        the current stream) where the host buffer is not the step's: the
        split fields' rows handed to the threads first, the other fields
        meanwhile, then each row's upload as soon as it is written."""
        def parts(f):
            return [np.asarray(getattr(rows[s], f)) if s in rows
                    else getattr(self._zero_row, f)
                    for s in range(self.batch)]

        pending = [(self._row_writers.submit(np.copyto, dst, part), h, b)
                   for f, _, _, by_row in self._fields if by_row is not None
                   for part, (dst, h, b) in zip(parts(f), by_row)]
        try:
            for f, host, buf, by_row in self._fields:
                if by_row is None:
                    np.concatenate(parts(f), axis=0, out=host.numpy())
                    if host is not buf:
                        buf.copy_(host, non_blocking=True)
            for written, h, b in pending:
                written.result()
                if h is not b:
                    b.copy_(h, non_blocking=True)
        finally:
            # no thread writes a buffer after a failed step returns
            wait([written for written, _, _ in pending])

    def step(self, rows: Dict[int, StepInputs]):
        """One navigation step for every slot. rows: {slot: single-row (b=1)
        StepInputs of host arrays} for (a subset of) active slots; free or
        absent slots run the zero row. Returns NavOutputs, leading dim B,
        fresh tensors the next step does not overwrite. The rows may be
        overwritten as soon as it returns."""
        with span("serve.step") as sp, torch.inference_mode():
            if sp is not None:
                sp.attrs["ids"] = list(self._req_slot)
                sp.count("serve.step.h2d_bytes", self._h2d_bytes)
                sp.count("serve.step.h2d_streamed_bytes",
                         0 if self._copy_stream is None else self._h2d_bytes)
            if self._copied is not None:
                self._copied.synchronize()  # the pinned buffers are free
            with span("serve.step.assemble"):
                self._assemble(rows)
            with span("serve.step.replay", self.device):
                if self._graph is None:
                    out = self._run_step()
                else:
                    self._graph.replay()
            if self._replayed is not None:
                self._replayed.record(torch.cuda.current_stream(self.device))
            if self._graph is None:
                return out
            self.replays += 1
            return NavOutputs(*(None if t is None else t.clone()
                                for t in self._graph_out))

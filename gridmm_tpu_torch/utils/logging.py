"""Observability: meters, structured logging and the span recorder (twin of
gridmm_tpu/utils/logging.py).

One JSONL-first MetricLogger (TensorBoard optional), smoothed meters, a
wall-clock section timer, and a recorder of spans and counters inside the
program that records exactly while a torch.profiler does (`span`,
`profiled_stretch`): each span is also a `gridmm.<name>` annotation on the
profiler's timeline, so an idle stretch of the device can be put down to the
span the host was in.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch
from torch.autograd import _profiler_enabled


class RunningMeter:
    """Exponentially smoothed scalar (pretrain_src/utils/logger.py)."""

    def __init__(self, name: str, smooth: float = 0.99):
        self.name = name
        self.smooth = smooth
        self.val: Optional[float] = None

    def update(self, v: float) -> None:
        self.val = v if self.val is None else (
            self.smooth * self.val + (1 - self.smooth) * v)

    def __float__(self):
        return float(self.val if self.val is not None else 0.0)


class SectionTimer:
    """Accumulating wall-clock timer per named section."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str):
        """Time the block; under a profiler it is also the span `name`."""
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        return {k: self.totals[k] / max(self.counts[k], 1)
                for k in self.totals}


class MetricLogger:
    """JSONL event log + optional TensorBoard."""

    def __init__(self, log_dir: Optional[str] = None,
                 use_tensorboard: bool = False):
        self.log_dir = log_dir
        self._fh = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            if use_tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                except ImportError:
                    self._tb = None
                else:
                    self._tb = SummaryWriter(log_dir)
        self.meters: Dict[str, RunningMeter] = {}

    def log(self, step: int, metrics: Dict[str, float],
            prefix: str = "") -> None:
        rec = {"step": int(step)}
        for k, v in metrics.items():
            key = f"{prefix}{k}"
            v = float(v)
            rec[key] = v
            self.meters.setdefault(key, RunningMeter(key)).update(v)
            if self._tb is not None:
                self._tb.add_scalar(key, v, step)
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._tb:
            self._tb.close()
            self._tb = None


# ------------------------------------------------------------- the recorder
class Span:
    """One recorded span: its `name`, host `start` and `end`
    (`time.perf_counter`), the span of the same thread it opened inside
    (`parent`, None at the top), the `thread`, `attrs` (such as the ids of
    the requests it served) and the `counters` added inside it. A span
    opened with a CUDA device also holds two timing events recorded on that
    device's current stream at its boundaries (none inside a CUDA-graph
    capture); `device_ms()` resolves them when read."""

    __slots__ = ("name", "start", "end", "parent", "thread", "attrs",
                 "counters", "stretch", "_events", "_annotation")

    def __init__(self, name: str, parent: Optional["Span"],
                 stretch: "Stretch"):
        self.name, self.parent, self.stretch = name, parent, stretch
        self.thread = threading.get_ident()
        self.attrs: Dict[str, object] = {}
        self.counters: Dict[str, int] = {}
        self.start = self.end = None
        self._events = None
        self._annotation = None

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def count(self, name: str, n: int) -> None:
        """Add `n` to the counter `name`, of this span and of its stretch."""
        self.counters[name] = self.counters.get(name, 0) + n
        self.stretch.add(name, n)

    def device_ms(self) -> Optional[float]:
        """Device time between the span's two events (waits for the second),
        or None where it recorded none."""
        if self._events is None:
            return None
        first, last, _ = self._events
        last.synchronize()
        return first.elapsed_time(last)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        RECORDER.close(self)


class Stretch:
    """The spans (in the order they closed) and the counters' totals of one
    profiled stretch."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self._lock = threading.Lock()

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def add(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n


class _Off:
    """What `span` gives while no profiler records: entering yields None."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


class Recorder:
    """The process's spans, kept in memory. One per process, as the
    profiler that switches it is: a stretch starts when a span opens under
    a profiler after one opened without it, and only the newest is kept."""

    def __init__(self):
        self.stretch = Stretch()
        self.fresh = True  # the next span under a profiler starts a stretch
        self._local = threading.local()
        self._lock = threading.Lock()

    def open(self, name: str, device) -> Span:
        with self._lock:
            if self.fresh:
                self.stretch, self.fresh = Stretch(), False
            stretch = self.stretch
        stack = self._local.__dict__.setdefault("stack", [])
        sp = Span(name, stack[-1] if stack else None, stretch)
        sp._annotation = torch.profiler.record_function(f"gridmm.{name}")
        sp._annotation.__enter__()
        if (device is not None and torch.device(device).type == "cuda"
                and not torch.cuda.is_current_stream_capturing()):
            stream = torch.cuda.current_stream(device)
            sp._events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True), stream)
            sp._events[0].record(stream)
        stack.append(sp)
        sp.start = time.perf_counter()
        return sp

    def close(self, sp: Span) -> None:
        sp.end = time.perf_counter()
        if sp._events is not None:
            sp._events[1].record(sp._events[2])
        self._local.stack.pop()
        sp._annotation.__exit__(None, None, None)
        sp._annotation = None
        sp.stretch.spans.append(sp)


RECORDER = Recorder()


def span(name: str, device=None):
    """A span of the program: `with span("serve.step") as sp:` records it
    (`sp` a Span) while a torch.profiler records, and is also the profiler
    annotation `gridmm.<name>`; otherwise `sp` is None and the span costs
    the one check of the profiler (no clock read, no allocation, no CUDA
    event). With `device` (a CUDA device), it also times the device work
    enqueued on that device's current stream inside it."""
    if not _profiler_enabled():
        RECORDER.fresh = True
        return _OFF
    return RECORDER.open(name, device)


def profiled_stretch() -> Stretch:
    """The spans and counters of the newest profiled stretch."""
    return RECORDER.stretch

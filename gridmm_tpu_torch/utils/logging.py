"""Observability: meters, structured logging, profiling hooks (twin of
gridmm_tpu/utils/logging.py).

One JSONL-first MetricLogger (TensorBoard optional), smoothed meters, a
wall-clock section timer and a torch.profiler trace context.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional


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
        t0 = time.perf_counter()
        try:
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


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """torch.profiler trace (CPU and, where there is one, the card) of a
    code region, written as a Chrome trace under `log_dir`; yields the
    profiler, or None when `log_dir` is empty."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

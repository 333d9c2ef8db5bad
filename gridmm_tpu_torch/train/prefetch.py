"""Asynchronous host->device batch prefetching (twin of
gridmm_tpu/train/prefetch.py).

The reference overlaps host data work with device compute via CUDA-stream
prefetch (pretrain_src/data/loader.py:90-124 PrefetchLoader). Here a
background thread stages the next batch: tensors go through pinned host
memory and are copied on a side stream with `non_blocking=True`, so the
copy overlaps the current step; the consumer's stream waits on the copy's
event before it reads the batch.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator

import torch


def _map_tensors(tree: Any, fn):
    """Apply `fn` to every array leaf of nested tuples/NamedTuples/dicts;
    strings (a task name beside its batch) and None pass through."""
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tensors(v, fn) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    if tree is None or isinstance(tree, str):
        return tree
    return fn(torch.as_tensor(tree))


def device_prefetch(batches: Iterable, size: int = 2,
                    device="cuda") -> Iterator:
    """Wrap a host batch iterator; yields batches resident on `device`.

    `size` bounds the number of staged batches (device memory x size). A
    producer error is raised in the consumer. When the consumer stops early
    (a loop that breaks, an exception, a generator closed or collected), the
    producer thread stops within a tick of its bounded wait and the staged
    batches are released."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=size)
    end = object()
    stop = threading.Event()
    err: list = []

    def stage(batch):
        if not on_card:
            return _map_tensors(batch, lambda t: t.to(device)), None
        stream = torch.cuda.Stream(device)
        with torch.cuda.stream(stream):
            staged = _map_tensors(
                batch, lambda t: (t if t.is_cuda else t.pin_memory()).to(
                    device, non_blocking=True))
            done = torch.cuda.Event()
            done.record(stream)
        return staged, done

    def put(item) -> bool:
        # bounded waits: an abandoned consumer cannot leave this thread
        # blocked on a full queue for good (stop is checked every tick)
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in batches:
                if stop.is_set() or not put(stage(batch)):
                    return
        except Exception as e:  # handed to the consumer, which raises it
            err.append(e)
        finally:
            put(end)

    threading.Thread(target=producer, daemon=True,
                     name="device_prefetch").start()
    try:
        while True:
            item = q.get()
            if item is end:
                if err:
                    raise err[0]
                return
            staged, done = item
            if done is not None:
                cur = torch.cuda.current_stream(device)
                cur.wait_event(done)
                # allocated on the copy stream, read on this one: the
                # allocator must not hand the memory out again before this
                # stream is done
                _map_tensors(staged, lambda t: t.record_stream(cur))
            yield staged
    finally:
        stop.set()
        while True:  # release the staged batches now
            try:
                q.get_nowait()
            except queue.Empty:
                break

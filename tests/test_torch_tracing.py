"""The span recorder (gridmm_tpu_torch/utils/logging.py) in the serving
engine and the training update, at tiny_config() widths: off without a
profiler, the spans and counters under one, their annotations on the
profiler's timeline, one stretch at a time, and the device times on a card.

These tests import no JAX, so they also run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py -q
"""

import sys
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gridmm_tpu_torch.config import tiny_config  # noqa: E402
from gridmm_tpu_torch.models.navigator import init_navigator  # noqa: E402
from gridmm_tpu_torch.serve.engine import NavServingEngine  # noqa: E402
from gridmm_tpu_torch.train.step import (StepInputs,  # noqa: E402
                                         batch_to_device,
                                         create_train_state,
                                         make_train_step)
from gridmm_tpu_torch.train.synthetic import \
    synthetic_trajectory_batch  # noqa: E402
from gridmm_tpu_torch.utils import logging as L  # noqa: E402

SLOTS = 16
MORE = 3    # requests admitted after the first step


def _profiled(fn, device="cpu"):
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        out = fn()
    return out, prof


def _engine(device="cpu"):
    cfg = tiny_config()
    model = init_navigator(cfg.model, seed=3, device=device)
    batch = synthetic_trajectory_batch(cfg, batch=SLOTS, num_steps=2,
                                       seed=5, device="cpu")
    return NavServingEngine.create(model, cfg, SLOTS, device=device), batch


def _rows(batch, t, slots):
    return {s: StepInputs(*(a[t, s:s + 1].numpy() for a in batch.steps))
            for s in slots}


def _serve(eng, batch, first=0):
    """SLOTS requests admitted and stepped, MORE of them finished and MORE
    new ones admitted and stepped: (each admission, each step's
    outputs)."""
    ids, mask = batch.txt_ids.numpy(), batch.txt_mask.numpy()
    for r in range(first, first + SLOTS):
        eng.submit(r, ids[r % SLOTS], mask[r % SLOTS])
    admitted = [eng.admit()]
    outs = [eng.step(_rows(batch, 0, range(SLOTS)))]
    for r in range(first, first + MORE):
        eng.finish(r)
        eng.submit(r + SLOTS, ids[r % SLOTS], mask[r % SLOTS])
    admitted.append(eng.admit())
    outs.append(eng.step(_rows(batch, 1, range(SLOTS))))
    return admitted, outs


def _train():
    cfg = tiny_config()
    model = init_navigator(cfg.model, seed=7, device="cpu").train()
    state = create_train_state(cfg, model)
    batch = batch_to_device(synthetic_trajectory_batch(
        cfg, batch=2, num_steps=3, seed=9, device="cpu"), "cpu")
    return state, batch, make_train_step(cfg)


def _off_span():
    """A span opened with no profiler: the next profiled span starts a new
    stretch."""
    with L.span("unprofiled") as sp:
        assert sp is None


def _boom(*args, **kwargs):
    raise AssertionError("the recorder did work with no profiler")


class _Untouchable:
    def __getattr__(self, name):
        _boom()


def _same(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert torch.equal(x, y), f


def test_nothing_is_recorded_without_a_profiler(monkeypatch):
    """No clock read, no span made, no CUDA call and no annotation while no
    profiler records; the outputs equal a traced run's bit for bit."""
    eng, batch = _engine()
    state, tbatch, train_step = _train()
    before = L.profiled_stretch()
    n_spans = len(before.spans)
    with monkeypatch.context() as m:
        m.setattr(L, "time", _Untouchable())
        m.setattr(L, "torch", _Untouchable())
        m.setattr(L, "Span", _boom)
        admitted, outs = _serve(eng, batch)
        loss = train_step(state, tbatch, 0)["loss"]
    assert L.profiled_stretch() is before and len(before.spans) == n_spans

    eng2, _ = _engine()
    state2, _, _ = _train()
    _off_span()
    (admitted2, outs2), _ = _profiled(lambda: _serve(eng2, batch))
    loss2, _ = _profiled(lambda: train_step(state2, tbatch, 0)["loss"])
    assert len(L.profiled_stretch().named("serve.step")) == 2
    assert admitted2 == admitted
    for a, b in zip(outs, outs2):
        _same(a, b)
    assert torch.equal(loss, loss2)
    for (n, p), (_, q) in zip(state.model.named_parameters(),
                              state2.model.named_parameters()):
        assert torch.equal(p, q), n


def test_serving_spans_counters_and_request_ids():
    eng, batch = _engine()
    _off_span()
    (admitted, _), _ = _profiled(lambda: _serve(eng, batch))
    st = L.profiled_stretch()
    admits = st.named("serve.admit")
    assert [list(a) for a in admitted] == [sp.attrs["ids"] for sp in admits]
    assert [sp.attrs["ids"] for sp in admits] == [
        list(range(SLOTS)), list(range(SLOTS, SLOTS + MORE))]
    assert [sp.counters for sp in admits] == [
        {"serve.admit.rows_admitted": n, "serve.admit.rows_encoded": SLOTS}
        for n in (SLOTS, MORE)]
    steps = st.named("serve.step")
    assert len(steps) == 2
    assert steps[0].attrs["ids"] == list(range(SLOTS))
    assert steps[1].attrs["ids"] == list(range(MORE, SLOTS + MORE))
    h2d = sum(t.nbytes for t in eng._x_host)
    assert h2d == sum(t.nbytes for t in eng._x) > 0
    assert all(sp.counters == {"serve.step.h2d_bytes": h2d} for sp in steps)
    assert st.counters == {"serve.admit.rows_admitted": SLOTS + MORE,
                           "serve.admit.rows_encoded": 2 * SLOTS,
                           "serve.step.h2d_bytes": 2 * h2d}
    for child in ("serve.step.assemble", "serve.step.replay"):
        assert [sp.parent for sp in st.named(child)] == steps
    assert all(sp.parent is None for sp in admits + steps)
    for sp in st.spans:
        assert sp.start <= sp.end and sp.device_ms() is None
        assert sp.parent is None or (sp.parent.start <= sp.start
                                     and sp.end <= sp.parent.end)


def test_train_step_spans_and_section_timer_spans():
    state, batch, train_step = _train()
    timer = L.SectionTimer()
    train_step(state, batch, 0)

    def update():
        with timer.section("update"):
            return train_step(state, batch, 0)

    _profiled(update)
    st = L.profiled_stretch()
    assert [sp.name for sp in st.spans] == [
        "train.forward", "train.backward", "train.update", "update"]
    fwd, bwd, upd, sec = st.spans
    assert fwd.parent is upd and bwd.parent is upd and upd.parent is sec
    assert sec.parent is None and fwd.end <= bwd.start
    assert timer.counts["update"] == 1


def _descendants(e):
    for c in e.cpu_children:
        yield c
        yield from _descendants(c)


def test_annotations_enclose_the_ops_they_launched():
    """Each span is a `gridmm.<name>` annotation on the profiler's clock: the
    aten ops under it lie inside its time range, every op of its thread
    that starts inside it ends inside it, and there is one annotation for
    each recorded span."""
    eng, batch = _engine()
    state, tbatch, train_step = _train()
    _off_span()

    def work():
        _serve(eng, batch, first=100)
        train_step(state, tbatch, 0)

    _, prof = _profiled(work)
    st = L.profiled_stretch()
    events = list(prof.events())
    notes = [e for e in events if e.name.startswith("gridmm.")]
    recorded = sorted(sp.name for sp in st.spans)
    assert sorted(e.name[len("gridmm."):] for e in notes) == recorded
    ops = [e for e in events if e.name.startswith("aten::")]
    with_ops = set()
    for note in notes:
        lo, hi = note.time_range.start, note.time_range.end
        for op in _descendants(note):
            assert lo <= op.time_range.start <= op.time_range.end <= hi
            if op.name.startswith("aten::"):
                with_ops.add(note.name)
        for op in ops:
            if op.thread == note.thread and lo <= op.time_range.start < hi:
                assert op.time_range.end <= hi, (note.name, op.name)
    assert {"gridmm.serve.admit", "gridmm.serve.step.replay",
            "gridmm.train.forward", "gridmm.train.backward"} <= with_ops


def test_a_reader_sees_only_the_newest_stretch():
    eng, batch = _engine()
    _off_span()
    _profiled(lambda: _serve(eng, batch))
    assert len(L.profiled_stretch().named("serve.step")) == 2
    eng.step(_rows(batch, 0, range(SLOTS)))   # unprofiled
    _profiled(lambda: eng.step(_rows(batch, 1, range(SLOTS))))
    st = L.profiled_stretch()
    assert [sp.name for sp in st.spans] == [
        "serve.step.assemble", "serve.step.replay", "serve.step"]
    assert st.counters == {"serve.step.h2d_bytes":
                           sum(t.nbytes for t in eng._x_host)}


@pytest.mark.cuda
def test_device_times_on_the_card():
    """The admission's and the replay's device times are positive, and the
    replay's is at most the step's host time with its sync."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    eng, batch = _engine("cuda")
    eng.admit()
    eng.step(_rows(batch, 0, range(SLOTS)))
    torch.cuda.synchronize()

    def work():
        _serve(eng, batch, first=100)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step(_rows(batch, 1, range(SLOTS)))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    host_s, _ = _profiled(work, "cuda")
    st = L.profiled_stretch()
    admits, replays = st.named("serve.admit"), st.named("serve.step.replay")
    assert len(admits) == 2 and len(replays) == 3
    assert all(sp.device_ms() > 0 for sp in admits + replays)
    assert replays[-1].device_ms() <= host_s * 1e3
    assert all(sp.device_ms() is None for sp in st.named("serve.step"))
    assert all(sp.device_ms() is None
               for sp in st.named("serve.step.assemble"))

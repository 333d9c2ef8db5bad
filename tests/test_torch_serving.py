"""Port vs JAX package: the serving engine under staggered admission.

Five requests go through a 3-slot engine of each package with the same
weights (carried by gridmm_tpu_torch.convert) and the same step rows: two
start together, one slot idles on zero rows, finished requests free their
slots mid-flight and queued ones take them. Every step's per-slot outputs
agree within 1e-5 absolute and relative, -inf positions exactly.

An admission's language forward: a live f32 engine encodes only the rows it
admits, an int8 engine and a bundle's engine all B rows; in every kind the
admitted rows of the text buffer hold the bits of the B-row forward and the
other rows stay as they were. `_admit_rows(n)`, which the card replays from
CUDA graphs, runs eagerly here over the same static buffers.

A step's assembly writes the largest fields row by row on its threads and
the others by one concatenation each: its buffers hold what one
`np.concatenate` a field of the rows (zero rows where a slot has none)
holds, bit for bit, and the outputs equal those of an engine that
assembles so."""

import dataclasses
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import gridmm_tpu.config as JC  # noqa: E402
from gridmm_tpu.serve.engine import NavServingEngine as JEngine  # noqa: E402
from gridmm_tpu_torch.models.navigator import init_navigator  # noqa: E402
from gridmm_tpu_torch.ops.cuda.grid_pool import GRID_POOL_FWD  # noqa: E402
from gridmm_tpu_torch.serve.engine import NavServingEngine as TEngine  # noqa: E402
from gridmm_tpu_torch.serve.engine import _carry_tensors  # noqa: E402
from gridmm_tpu_torch.serve.engine import serving_cfg  # noqa: E402
from gridmm_tpu_torch.serve import engine as engine_mod  # noqa: E402
from gridmm_tpu_torch.train.step import StepInputs  # noqa: E402
from gridmm_tpu_torch.utils import export as TX  # noqa: E402
from torch_parity import (assert_close, jax_navigator, port_config,  # noqa: E402
                          port_navigator, step_rows)

LENGTHS = [3, 2, 4, 1, 2]   # steps per request


def test_engine_matches_jax_engine_under_staggered_admission():
    jcfg = JC.tiny_config()
    jmodel, params = jax_navigator(jcfg, seed=1)
    tcfg = port_config(jcfg)
    tmodel = port_navigator(tcfg, params)
    assert tcfg.model.compaction_stray_keys
    jeng = JEngine.create(jmodel, jcfg, params, batch=3)
    teng = TEngine.create(tmodel, tcfg, batch=3, device="cpu")
    assert not teng.cfg.model.compaction_stray_keys
    assert teng.model.cfg == serving_cfg(tcfg).model

    rng = np.random.default_rng(0)
    t = jcfg.shapes.max_txt_len
    txt = {r: (rng.integers(0, 1000, size=t).astype(np.int32),
               np.arange(t) < rng.integers(4, t + 1)) for r in
           range(len(LENGTHS))}
    done = {r: 0 for r in txt}
    queue = list(txt)

    def submit(n):
        for _ in range(n):
            if queue:
                r = queue.pop(0)
                for eng in (jeng, teng):
                    eng.submit(r, *txt[r])

    submit(2)
    assert jeng.admit() == teng.admit()
    launches = GRID_POOL_FWD.launches
    steps = 0
    while jeng.active() or queue:
        active = teng.active()
        assert active == jeng.active()
        rows = {slot: step_rows(jcfg, rng, done[r])
                for r, slot in active.items()}
        jout = jeng.step(rows)
        tout = teng.step(rows)
        steps += 1
        for r, slot in active.items():
            for f in ("fused_logits", "global_logits", "local_logits",
                      "grid_logits", "gmap_embeds"):
                assert_close(getattr(tout, f)[slot],
                             np.asarray(getattr(jout, f))[slot],
                             msg=f"req {r} step {done[r]} {f}")
            done[r] += 1
        finished = [r for r, slot in active.items()
                    if done[r] == LENGTHS[r]]
        for r in finished:
            jeng.finish(r)
            teng.finish(r)
        if finished:
            submit(len(finished))
            assert jeng.admit() == teng.admit()
        assert steps < 20
    assert done == {r: n for r, n in enumerate(LENGTHS)}
    # CPU tensors never reach the kernel
    assert GRID_POOL_FWD.launches == launches


SLOTS = 3
# (requests finished, requests submitted) before each admission: 1, 2 and
# SLOTS rows admitted, then 1 with another slot left free
ROUNDS = [([], [0]), ([], [1, 2]), ([0, 1, 2], [3, 4, 5]), ([3, 5], [6])]


def _admission_engine(kind, tmp_path, batch=SLOTS):
    """A tiny `create` engine (f32 or int8) or a `from_bundle` engine on the
    weights of a seed."""
    tcfg = port_config(JC.tiny_config())
    if kind == "int8":
        tcfg = dataclasses.replace(tcfg, model=dataclasses.replace(
            tcfg.model, int8_matmuls=True))
    model = init_navigator(tcfg.model, seed=4, device="cpu")
    if kind != "bundle":
        return TEngine.create(model, tcfg, batch, device="cpu")
    TX.save_serving_bundle(
        TX.export_navigator_serving(model, tcfg, model.state_dict(),
                                    batch=SLOTS, device="cpu"),
        str(tmp_path), cfg=tcfg, extra_manifest={"batch": SLOTS})
    return TEngine.from_bundle(str(tmp_path), tcfg, dict(model.state_dict()),
                               SLOTS, device="cpu")


@pytest.mark.parametrize("kind,encodes_admitted_only",
                         [("f32", True), ("int8", False), ("bundle", False)])
def test_admission_encodes_the_admitted_rows_where_rows_are_independent(
        kind, encodes_admitted_only, tmp_path):
    eng = _admission_engine(kind, tmp_path)
    lang, seen = eng._lang_fn, []

    def spy(ids, mask):
        seen.append(tuple(ids.shape))
        return lang(ids, mask)

    eng._lang_fn = spy
    rng = np.random.default_rng(3)
    t = eng.cfg.shapes.max_txt_len
    for done, new in ROUNDS:
        for r in done:
            eng.finish(r)
        texts = {r: (rng.integers(1, 1000, size=t).astype(np.int32),
                     np.arange(t) < rng.integers(3, t + 1)) for r in new}
        for r in new:
            eng.submit(r, *texts[r])
        txt_before, mask_before = eng._txt_buf.clone(), eng._mask_buf.clone()
        admitted = eng.admit()
        assert sorted(admitted) == new
        ids = np.zeros((SLOTS, t), np.int32)
        mask = np.zeros((SLOTS, t), bool)
        for r, slot in admitted.items():
            ids[slot], mask[slot] = texts[r]
        with torch.inference_mode():
            want = lang(torch.from_numpy(ids), torch.from_numpy(mask))
        for slot in range(SLOTS):
            if slot in admitted.values():
                assert torch.equal(eng._txt_buf[slot], want[slot]), slot
                assert torch.equal(eng._mask_buf[slot],
                                   torch.from_numpy(mask[slot])), slot
            else:
                assert torch.equal(eng._txt_buf[slot], txt_before[slot])
                assert torch.equal(eng._mask_buf[slot], mask_before[slot])
    rows = ([len(new) for _, new in ROUNDS] if encodes_admitted_only
            else [SLOTS] * len(ROUNDS))
    assert seen == [(k, t) for k in rows]


ROWS_B = 5   # slots of the engines that run `_admit_rows` directly


def _state(eng):
    return (eng._txt_buf, eng._mask_buf, *_carry_tensors(eng._carry))


def _scramble(eng, seed):
    """Random contents in the text, mask and carry buffers, so that a write
    or a zero-reset of a row shows."""
    g = torch.Generator().manual_seed(seed)
    with torch.inference_mode():
        for t in _state(eng):
            if t.dtype == torch.bool:
                t.copy_(torch.rand(t.shape, generator=g) < 0.5)
            elif t.is_floating_point():
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            else:
                t.copy_(torch.randint(1, 7, t.shape, generator=g))


@pytest.mark.parametrize("kind", ["f32", "int8"])
@pytest.mark.parametrize("k", [1, 3, ROWS_B])
def test_admit_rows_writes_the_admitted_slots_alone(kind, k, tmp_path):
    """`_admit_rows(n)` over the admission's buffers, filled as `admit`
    fills them for k admitted slots (out of order, among slots that hold
    other requests' rows): the admitted slots' text and mask rows equal a
    direct language forward, their carry rows are zero, and every other
    slot's rows keep their bits."""
    eng = _admission_engine(kind, tmp_path, batch=ROWS_B)
    assert eng._encode_admitted_only == (kind == "f32")
    _scramble(eng, seed=k)
    before = [t.clone() for t in _state(eng)]
    rng = np.random.default_rng(10 + k)
    t = eng.cfg.shapes.max_txt_len
    slots = [int(s) for s in rng.permutation(ROWS_B)[:k]]
    texts = [(rng.integers(1, 1000, size=t).astype(np.int32),
              np.arange(t) < rng.integers(3, t + 1)) for _ in slots]
    ids, mask, rows = (a.numpy() for a in eng._admit_in)
    if kind == "f32":
        n = k
        ids[:], mask[:] = 7, True   # stale rows past n are never read
        at = range(k)
    else:
        n = ROWS_B
        ids[:], mask[:], rows[:] = 0, False, slots[0]
        at = slots
    for i, (ti, mi) in zip(at, texts):
        ids[i], mask[i] = ti, mi
    rows[:k] = slots
    with torch.inference_mode():
        want = eng._lang_fn(torch.from_numpy(ids[:n].copy()),
                            torch.from_numpy(mask[:n].copy()))
        eng._admit_rows(n)
    for i, slot in enumerate(slots):
        src = i if kind == "f32" else slot
        assert torch.equal(eng._txt_buf[slot], want[src]), slot
        assert torch.equal(eng._mask_buf[slot],
                           torch.from_numpy(texts[i][1])), slot
        for buf in _carry_tensors(eng._carry):
            assert not buf[slot].any(), slot
    for slot in set(range(ROWS_B)) - set(slots):
        for got, old in zip(_state(eng), before):
            assert torch.equal(got[slot], old[slot]), slot


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_admissions_never_read_an_earlier_admissions_ids(kind, tmp_path):
    """A reused engine admits 3 rows, then 1: the second forward sees that
    one request's ids and mask alone (an int8 engine: in its slot, zeros in
    every other row) and the slot's text row equals a direct forward of
    them."""
    eng = _admission_engine(kind, tmp_path, batch=ROWS_B)
    lang, seen = eng._lang_fn, []

    def spy(ids, mask):
        seen.append((ids.clone(), mask.clone()))
        return lang(ids, mask)

    eng._lang_fn = spy
    rng = np.random.default_rng(21)
    t = eng.cfg.shapes.max_txt_len
    texts = [(rng.integers(1, 1000, size=t).astype(np.int32),
              np.arange(t) < rng.integers(3, t + 1)) for _ in range(4)]
    for r in range(3):
        eng.submit(r, *texts[r])
    assert eng.admit() == {0: 0, 1: 1, 2: 2}
    eng.finish(1)
    eng.submit(3, *texts[3])
    assert eng.admit() == {3: 1}
    ids, mask = seen[-1]
    if kind == "f32":
        want_ids, want_mask = texts[3][0][None], texts[3][1][None]
        src = 0
    else:
        want_ids = np.zeros((ROWS_B, t), np.int32)
        want_mask = np.zeros((ROWS_B, t), bool)
        want_ids[1], want_mask[1] = texts[3]
        src = 1
    assert np.array_equal(ids.numpy(), want_ids)
    assert np.array_equal(mask.numpy(), want_mask)
    with torch.inference_mode():
        want = lang(torch.from_numpy(want_ids), torch.from_numpy(want_mask))
    assert torch.equal(eng._txt_buf[1], want[src])
    assert torch.equal(eng._mask_buf[1], torch.from_numpy(texts[3][1]))


ASM_B = 4
# the slots a step has rows for, in the order `rows` lists them
ASSEMBLY_CASES = {"every_slot": [0, 1, 2, 3], "some_slots": [0, 2],
                  "out_of_slot_order": [3, 1, 0, 2]}


class _ConcatEngine(TEngine):
    """The assembly as one `np.concatenate` a field into the step's buffer,
    the zero rows from `zero_step_inputs`."""

    def _assemble(self, rows):
        zero = TX.zero_step_inputs(self.cfg, 1, "cpu")
        for f, buf in zip(StepInputs._fields, self._x):
            np.concatenate([np.asarray(getattr(rows[s], f)) if s in rows
                            else getattr(zero, f).numpy()
                            for s in range(self.batch)],
                           axis=0, out=buf.numpy())


@pytest.mark.parametrize("case", sorted(ASSEMBLY_CASES))
def test_step_buffers_hold_the_concatenated_rows_bit_for_bit(case,
                                                              monkeypatch):
    """Two steps of a 4-slot engine given rows for every slot, for slots 0
    and 2 alone (the others take the zero row), or out of slot order: after
    each, every field of the step's buffers equals `np.concatenate` of the
    rows bit for bit, and the outputs equal those of an engine that
    assembles by one concatenation a field. The engine sees 4 CPUs, so
    that its threads write the patch features row by row."""
    monkeypatch.setattr(engine_mod, "_host_threads", lambda: 4)
    jcfg = JC.tiny_config()
    tcfg = port_config(jcfg)
    model = init_navigator(tcfg.model, seed=6, device="cpu")
    eng = TEngine.create(model, tcfg, ASM_B, device="cpu")
    ref = _ConcatEngine.create(model, tcfg, ASM_B, device="cpu")
    by_row = {f for f, _, _, rows in eng._fields if rows is not None}
    assert by_row == {"patch_fts"}
    rng = np.random.default_rng(8)
    t = jcfg.shapes.max_txt_len
    for r in range(ASM_B):
        text = (rng.integers(1, 1000, size=t).astype(np.int32),
                np.arange(t) < rng.integers(3, t + 1))
        for e in (eng, ref):
            e.submit(r, *text)
    assert eng.admit() == ref.admit()
    zero = TX.zero_step_inputs(eng.cfg, 1, "cpu")
    for step in range(2):
        rows = {s: step_rows(jcfg, rng, step) for s in ASSEMBLY_CASES[case]}
        out, want = eng.step(rows), ref.step(rows)
        for f, buf in zip(StepInputs._fields, eng._x):
            cat = np.concatenate([np.asarray(getattr(rows[s], f)) if s in rows
                                  else getattr(zero, f).numpy()
                                  for s in range(ASM_B)], axis=0)
            got = buf.numpy()
            assert got.dtype == cat.dtype, f
            assert got.tobytes() == cat.tobytes(), f
        for f in out._fields:
            a, b = getattr(out, f), getattr(want, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert torch.equal(a, b), (step, f)


def test_row_writers_under_contention(monkeypatch):
    """More row-writing threads than CPUs and a switch interval of a
    microsecond: twenty assemblies in a row of a 16-slot engine, each with
    new rows for a random subset of the slots, leave the step's buffers
    equal to `np.concatenate` of the rows bit for bit every time."""
    threads = 4 * (os.cpu_count() or 1)
    monkeypatch.setattr(engine_mod, "_host_threads", lambda: threads)
    jcfg = JC.tiny_config()
    tcfg = port_config(jcfg)
    eng = TEngine.create(init_navigator(tcfg.model, seed=6, device="cpu"),
                         tcfg, 16, device="cpu", cuda_graph=False)
    assert sum(rows is not None for *_, rows in eng._fields) > 1
    zero = TX.zero_step_inputs(eng.cfg, 1, "cpu")
    rng = np.random.default_rng(9)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in range(20):
            slots = rng.permutation(16)[:int(rng.integers(1, 17))]
            rows = {int(s): step_rows(jcfg, rng, t % 4) for s in slots}
            start = time.perf_counter()
            with torch.inference_mode():
                eng._assemble(rows)
            assert time.perf_counter() - start < 30
            for f, buf in zip(StepInputs._fields, eng._x):
                cat = np.concatenate(
                    [np.asarray(getattr(rows[s], f)) if s in rows
                     else getattr(zero, f).numpy() for s in range(16)])
                assert buf.numpy().tobytes() == cat.tobytes(), (t, f)
    finally:
        sys.setswitchinterval(interval)

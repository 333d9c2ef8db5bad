"""Serving loop: a closed loop of episodes through the CUDA-graphed
NavServingEngine (`create`, `submit`/`admit`, `step`).

Every slot runs one episode after another; a finished slot gets the next
waiting episode through `submit` and `admit` before the next `step`. Episode
and instruction lengths come from the configuration's `assumed` mixes, as a
fixed pool that each seed plays in its own order. Step rows come from a host
bank made in set-up from the seed and reach `step()` as host arrays, as the
engine's API takes them. An action's latency runs from the moment the
benchmark hands over the observation (the `admit()` before the step
included) until the slot's logits are on the host.

After the window, a sample of the finished episodes drawn from the seed
(the longest among them) is replayed from its admission through the plain
reference with the same weights and inputs, and every served step's logits
are compared: they carry the admission's text embeddings and every earlier
step's carry (point buffer, cell ids, gmap sums). The benchmark reads only
what the engine's API returns.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np

from benchmark import harness
from benchmark.costs import grid_pool as pool_cost
from benchmark.loops import nav

HEADS = ("fused", "global", "local", "grid")


class Episode:
    __slots__ = ("id", "length", "ids", "mask", "rows", "logits", "slot")

    def __init__(self, eid, length, ids, mask, rows):
        self.id, self.length, self.ids, self.mask = eid, length, ids, mask
        self.rows = rows        # bank row of each step
        self.logits = []        # host logits of each served step
        self.slot = None


class Source:
    """Episodes in a fixed pool of lengths, replayed in a new order from the
    seed on every pass."""

    def __init__(self, conf, cfg, traffic, rng, variants):
        a = conf["assumed"]
        size = traffic["episode_pool"]
        self.lengths = nav.length_pool(a["episode_steps"], size)
        it = a["instruction_tokens"]
        self.txt_lens = nav.even_pool(it["min"], it["max"], size)
        t = cfg.shapes.max_txt_len
        self.ids = rng.integers(1000, cfg.model.vocab_size,
                                size=(size, t)).astype(np.int32)
        self.rng, self.variants, self.t = rng, variants, t
        self.order, self.pos, self.count = [], 0, 0

    def next(self) -> Episode:
        if self.pos == len(self.order):
            self.order, self.pos = self.rng.permutation(len(self.lengths)), 0
        i = self.order[self.pos]
        self.pos += 1
        n = int(self.lengths[i])
        rows = (np.arange(n) * self.variants
                + self.rng.integers(0, self.variants, size=n))
        ep = Episode(self.count, n, self.ids[i],
                     np.arange(self.t) < self.txt_lens[i], rows)
        self.count += 1
        return ep


def _fetch(out):
    import torch

    return torch.cat([getattr(out, f"{h}_logits") for h in HEADS],
                     dim=1).cpu().numpy()


class Loop:
    """The closed loop over the engine's slots."""

    def __init__(self, engine, bank, source, valid, widths, spans, hooks):
        self.eng, self.bank, self.src, self.valid = engine, bank, source, valid
        self.widths, self.spans, self.hooks = widths, spans, hooks
        self.slots = [None] * engine.batch
        self.finished, self.latencies = [], []
        self.steps = self.admit_calls = 0
        self.failed = 0
        self.k1_bytes = 0.0
        self.count_bytes = False
        self.slot_valid = np.zeros(engine.batch, np.int64)

    def row(self, ep, t):
        r = ep.rows[t]
        return type(self.bank)(*(f[r] for f in self.bank))

    def refill(self):
        for s, ep in enumerate(self.slots):
            if ep is None:
                ep = self.src.next()
                self.eng.submit(ep.id, ep.ids, ep.mask)
                self.slots[s] = ep
                ep.slot = s

    def step(self):
        t0 = time.perf_counter()
        if any(len(ep.logits) == 0 for ep in self.slots):
            self.spans.run("admit", self.eng.admit, sync=True)
            self.admit_calls += 1
            self.slot_valid[[len(ep.logits) == 0 for ep in self.slots]] = 0
        rows = {s: self.row(ep, len(ep.logits))
                for s, ep in enumerate(self.slots)}
        for s, ep in enumerate(self.slots):
            self.slot_valid[s] += self.valid[ep.rows[len(ep.logits)]]
        if "rows" in self.hooks:
            rows = self.hooks["rows"](rows)
        out = self.spans.run("step", self.eng.step, rows)
        if "outputs" in self.hooks:
            out = self.hooks["outputs"](out)
        logits = self.spans.run("fetch", _fetch, out)
        self.latencies.append(time.perf_counter() - t0)
        self.steps += 1
        if self.count_bytes:
            b = self.eng.batch
            n = self.eng.cfg.shapes.max_points
            d = self.eng.cfg.model.image_feat_size
            self.k1_bytes += pool_cost.fwd_bytes(
                b, n, d, int(self.slot_valid.sum()), 4)
        fused = logits[:, :self.widths[0]]
        bad = ~np.isfinite(fused).any(axis=1) | np.isnan(fused).any(axis=1)
        self.failed += int(bad.sum())
        for s, ep in enumerate(self.slots):
            ep.logits.append(logits[s])
            if len(ep.logits) == ep.length:
                self.eng.finish(ep.id)
                self.finished.append(ep)
                self.slots[s] = None
        self.refill()


def run(ctx) -> dict:
    """One run; a fault's `program` hook (a context manager) breaks the
    program underneath for the whole of it."""
    with ctx.hooks.get("program", contextlib.nullcontext)():
        return _run(ctx)


def _run(ctx) -> dict:
    import torch

    from gridmm_tpu_torch.serve.engine import NavServingEngine, serving_cfg

    c, dev = ctx.cell, ctx.device
    conf, traffic = c["config"], c["traffic"]
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 as configured
    cfg = serving_cfg(nav.port_config(conf))
    slots, variants = traffic["slots"], traffic["bank_variants"]
    rng = np.random.default_rng(ctx.seed)
    model, sd = nav.navigator(cfg, ctx.seed, dev)
    bank = nav.step_bank(cfg, rng, cfg.grid.max_steps, variants)
    valid = nav.valid_points(bank)
    engine = NavServingEngine.create(model, cfg, slots, device=dev)
    sync = (torch.cuda.synchronize if torch.device(dev).type == "cuda"
            else (lambda: None))
    spans = harness.Spans(ctx.trace, sync)
    sh = cfg.shapes
    widths = (sh.max_gmap_len, sh.max_gmap_len, sh.max_vp_len,
              sh.max_gmap_len)

    # warm-up: admissions and steps at the cell's shapes, on episodes of
    # another source, then every slot freed
    warm = Source(conf, cfg, traffic, np.random.default_rng(
        [ctx.seed, 1]), variants)
    loop = Loop(engine, bank, warm, valid, widths, harness.Spans(False), {})
    loop.refill()
    if warm.lengths.min() < 3:
        raise ValueError("the warm-up's two steps need episodes of 3 steps "
                         "or more")
    for _ in range(2):
        loop.step()
    for ep in loop.slots:
        engine.finish(ep.id)
    if ctx.trace:
        harness.profile(lambda: None, dev)  # the profiler's own start-up
    sync()

    src = Source(conf, cfg, traffic, rng, variants)
    loop = Loop(engine, bank, src, valid, widths, spans, ctx.hooks)
    loop.refill()
    with harness.Window() as win:
        setup_s = win.start - ctx.t0
        end = win.start + ctx.seconds
        while time.perf_counter() < end:
            loop.step()
        window = time.perf_counter() - win.start
    steps, admit_calls, latencies = (loop.steps, loop.admit_calls,
                                     list(loop.latencies))
    trace = None
    if ctx.trace:
        # a bounded stretch of the same loop under the profiler, after the
        # window, so that reducing the trace costs the window nothing
        loop.count_bytes = True
        trace = harness.profile(
            lambda: [loop.step() for _ in range(traffic["trace_steps"])], dev)
    device = harness.device_record(dev, ctx.chips)

    lat = np.repeat(np.asarray(latencies), slots)
    actions = steps * slots
    e2e = {"actions_per_s": actions / window,
           "action_p95_ms": float(np.percentile(lat, 95)) * 1e3,
           "setup_s": setup_s}
    record = {"config": conf, "slots": slots, "steps": steps,
              "admit_calls": admit_calls, "window_s": window,
              "spans": spans.durations, "trace": trace,
              "k1_bytes": loop.k1_bytes,
              "k1_launches": traffic["trace_steps"]}

    # --- the comparison, after the window, with the program's state freed
    failed, loop_steps = loop.failed, loop.steps
    finished = loop.finished
    del engine, model, loop
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    sample = draw_sample(finished, traffic["check_episodes"], ctx.seed)
    ref = nav.reference_navigator(conf, sd)
    readings = compare(ref, conf, bank, sample, widths, dev,
                       control=bool(ctx.hooks.get("control")))
    return {"attempted": loop_steps * slots, "failed": failed,
            "end_to_end": e2e, "record": record, "device": device,
            "checks": harness.limited(readings, c["limits"]),
            "readings": readings}


def draw_sample(finished, count: int, seed: int):
    """`count` finished episodes drawn from the seed, the longest (the first
    of the longest) always among them."""
    if not finished:
        return []
    longest = max(range(len(finished)), key=lambda i: finished[i].length)
    rng = np.random.default_rng([seed, 2])
    rest = [i for i in rng.permutation(len(finished)) if i != longest]
    return [finished[i] for i in [longest] + rest[:count - 1]]


def replay(ref, conf, bank, episodes, dev, batch: int = 16):
    """The reference over `episodes`, each for its length, in blocks of
    `batch` episodes run in lockstep (a row past its steps keeps its
    carry). Returns each episode's host logits of every step."""
    import torch

    from benchmark.reference import navigator as R

    ns = R.namespace(conf)
    out = []
    for lo in range(0, len(episodes), batch):
        eps = episodes[lo:lo + batch]
        n_steps = [e.length for e in eps]
        with torch.no_grad():
            ids = torch.as_tensor(np.stack([e.ids for e in eps]), device=dev)
            mask = torch.as_tensor(np.stack([e.mask for e in eps]),
                                   device=dev)
            txt = ref.language(ids, mask)
            carry = R.empty_carry(ns, len(eps), dev)
            logs = [[] for _ in eps]
            for t in range(max(n_steps)):
                rows = [e.rows[min(t, k - 1)] for e, k in zip(eps, n_steps)]
                x = R.Steps(**{f: torch.as_tensor(np.concatenate(
                    [getattr(bank, f)[r] for r in rows]), device=dev)
                    for f in R.Steps._fields})
                new, o = R.serve_step(ref, ns, txt, mask, carry, x)
                live = torch.as_tensor([t < k for k in n_steps], device=dev)
                carry = R.keep_rows(live, new, carry)
                host = torch.cat([o.fused_logits, o.global_logits,
                                  o.local_logits, o.grid_logits],
                                 dim=1).cpu().numpy()
                for i, k in enumerate(n_steps):
                    if t < k:
                        logs[i].append(host[i])
        out.extend(logs)
    return out


def logit_readings(prog, ref, widths):
    """(largest gap of a head's logits as a share of the head's largest
    reference magnitude, positions whose finiteness differs, widest gap
    by which the served fused action's reference logit lies below the
    reference's best)."""
    err, mismatch, gap = 0.0, 0, 0.0
    lo = 0
    for k, w in enumerate(widths):
        p, r = prog[lo:lo + w], ref[lo:lo + w]
        lo += w
        pf, rf = np.isfinite(p), np.isfinite(r)
        mismatch += int((pf != rf).sum()) + int(np.isnan(p).sum())
        both = pf & rf
        if both.any():
            scale = max(float(np.abs(r[rf]).max()), 1e-30)
            err = max(err, float(np.abs(p[both] - r[both]).max()) / scale)
        if k == 0:
            a = int(np.argmax(np.where(np.isnan(p), -np.inf, p)))
            gap = max(gap, float(r.max() - r[a]) if rf[a] else float("inf"))
    return err, mismatch, gap


def compare(ref, conf, bank, sample, widths, dev,
            control: bool = False) -> dict:
    """Every reading of the comparison over the sampled episodes' served
    steps: `logit_err`, `action_gap` and `mask_mismatch`. With `control`,
    also the same readings of the control: the reference itself in TF32
    put in the program's place (`control.*`)."""
    ref = ref.to(dev)
    got = replay(ref, conf, bank, sample, dev)
    out = score([e.logits for e in sample], got, widths)
    if control:
        from benchmark.reference import navigator as R

        with R.tf32(dev):
            c_got = replay(ref, conf, bank, sample, dev)
        c = score(c_got, got, widths)
        out.update({f"control.{k}": v for k, v in c.items()})
    return out


def score(served, got, widths) -> dict:
    err, mismatch, gap, n = 0.0, 0, 0.0, 0
    for logs, ref_logs in zip(served, got):
        for p, r in zip(logs, ref_logs):
            e, m, g = logit_readings(p, r, widths)
            err, mismatch, gap = max(err, e), mismatch + m, max(gap, g)
            n += 1
    if n == 0:
        err = float("inf")  # no episode finished: no answer ever came
    return {"logit_err": err, "action_gap": gap, "mask_mismatch": mismatch,
            "compared_steps": n, "compared_episodes": len(served)}

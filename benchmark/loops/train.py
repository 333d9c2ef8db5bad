"""Training loop: teacher-forced updates through `make_train_step`.

Set-up builds one train state (the navigator with weights made on the card
from the seed, in train mode, dropout as configured, and its clipped AdamW)
and makes the traffic's distinct batches on the card. The state runs, all
through one call, the first `checked_updates` updates (which also warm
every shape up), the window with the batches cycled, and then
`checked_updates` more. Both groups of checked updates are judged: the
first from the weights made from the seed, the second (`after.*`) from the
state the window left, which the benchmark copies to the host right before
them: the weights, the optimizer's checkpoint (`state_dict()`: the moments
and the update count) and the train state's step, which seeds dropout.

Of each group the benchmark reads each update's loss, the first update's
gradient as the optimizer got it (from its first moment before and after:
g = (mu_1 - beta1 mu_0) / (1 - beta1)) and each leaf's change after the
last. Once the program's state is freed, the plain reference follows each
group from the same start, with the same batches and dropout seeds.

Every update of the run goes through the faults' hooks, so a fault planted
under the timed path is in the state that the second group starts from.

Trajectory lengths come from the configuration's `episode_steps` mix; a row's
targets past its episode's end are `ignoreid`.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np

from benchmark import harness
from benchmark.costs import grid_pool as pool_cost
from benchmark.loops import nav


def make_batches(cfg, conf, traffic, seed: int, dev):
    """`distinct_batches` TrajectoryBatches on `dev`: the index maps and
    small fields from a numpy generator, the view and patch features drawn
    on the device."""
    import torch

    from gridmm_tpu_torch.train.step import StepInputs, TrajectoryBatch

    b, s = traffic["batch"], traffic["steps"]
    rng = np.random.default_rng([seed, 3])
    gen = torch.Generator(device=dev)
    gen.manual_seed((int(seed) * 7919 + 17) % (2 ** 63))
    lengths = nav.length_pool(conf["assumed"]["episode_steps"],
                              b * traffic["distinct_batches"])
    it = conf["assumed"]["instruction_tokens"]
    txt_lens = nav.even_pool(it["min"], it["max"], len(lengths))
    order = rng.permutation(len(lengths))
    t_len, m = cfg.shapes.max_txt_len, cfg.model
    out, valid = [], []
    for k in range(traffic["distinct_batches"]):
        rows = order[k * b:(k + 1) * b]
        length = np.minimum(lengths[rows], s)
        bank = nav.step_bank(cfg, rng, s, b, features=False)
        fields = {f: (None if a is None else
                      a.reshape((s, b) + a.shape[2:]))
                  for f, a in zip(StepInputs._fields, bank)}
        t = np.arange(s)[:, None]
        cur = fields["cur_node_idx"]
        frontier = cur + 1 + rng.integers(0, 3, size=(s, b))
        target = np.where(t < length[None] - 1, frontier, 0)
        fields["target"] = np.where(t < length[None], target,
                                    cfg.train.ignoreid).astype(np.int32)
        valid.append((fields["depth"] > 0).reshape(s, b, -1).sum(-1))
        steps = {f: None if a is None else torch.as_tensor(a, device=dev)
                 for f, a in fields.items()}
        steps["view_img_fts"] = torch.randn(
            (s, b, cfg.shapes.max_vp_len - 1, m.image_feat_size),
            generator=gen, device=dev)
        steps["patch_fts"] = torch.randn(
            (s, b, cfg.grid.points_per_step, m.image_feat_size),
            generator=gen, device=dev)
        ids = rng.integers(1000, m.vocab_size, size=(b, t_len)).astype(
            np.int32)
        mask = np.arange(t_len)[None] < txt_lens[rows][:, None]
        out.append(TrajectoryBatch(torch.as_tensor(ids, device=dev),
                                   torch.as_tensor(mask, device=dev),
                                   StepInputs(**steps)))
    return out, valid


def checkpoint(state, named) -> dict:
    """What the checked updates start from, copied to the host: the
    weights, each leaf's Adam moments from the optimizer's checkpoint
    (`state_dict()`, None where it holds none), its update count and the
    train state's step (which seeds dropout)."""
    opt = state.optimizer.state_dict()
    moments = moments_of(state.optimizer, opt, named)
    return {"weights": {n: p.detach().cpu().clone() for n, p in named},
            "mu": {n: None if m is None else m[0].cpu().clone()
                   for n, m in moments.items()},
            "nu": {n: None if m is None else m[1].cpu().clone()
                   for n, m in moments.items()},
            "count": int(opt.get("count", state.step)),
            "step": int(state.step)}


def moments_of(optimizer, opt_sd: dict, named) -> dict:
    """Each leaf's (first, second) moment as the optimizer's checkpoint
    holds them, by name: the checkpoint numbers the parameters in the order
    of the optimizer's groups."""
    index = {id(p): i for i, p in enumerate(
        p for g in optimizer.param_groups for p in g["params"])}
    out = {}
    for n, p in named:
        st = opt_sd["state"].get(index.get(id(p)), {})
        out[n] = (st["mu"], st["nu"]) if "mu" in st else None
    return out


def first_moments(optimizer, named) -> dict:
    """Each leaf's first moment in the optimizer's checkpoint now (not
    copied), None where it holds none."""
    return {n: None if m is None else m[0] for n, m in moments_of(
        optimizer, optimizer.state_dict(), named).items()}


def seeded_start(weights: dict) -> dict:
    """The start of the first checked updates: the weights made from the
    seed, no moments, no update made."""
    return {"weights": {n: t.cpu() for n, t in weights.items()},
            "mu": {n: None for n in weights}, "nu": {n: None for n in weights},
            "count": 0, "step": 0}


def grad_norms(mu0: dict, mu1: dict, b1: float, dev) -> dict:
    """Each leaf's norm of the gradient an update gave its optimizer, from
    the first moment before (`mu0`) and after (`mu1`) it; a leaf with no
    moment after the update got none."""
    import torch

    out = {}
    for n, m1 in mu1.items():
        if m1 is None:
            out[n] = 0.0
            continue
        g = m1.to(dev, torch.float64)
        if mu0.get(n) is not None:
            g = g - b1 * mu0[n].to(dev, torch.float64)
        out[n] = float(g.norm()) / (1 - b1)
    return out


def change_norms(named, start: dict, dev) -> dict:
    """Each leaf's norm of its change from `start`."""
    import torch

    return {n: float((p.detach().to(dev, torch.float64)
                      - start[n].to(dev, torch.float64)).norm())
            for n, p in named}


def run(ctx) -> dict:
    import torch

    from gridmm_tpu_torch.train.step import (create_train_state,
                                             make_train_step)

    c, dev = ctx.cell, ctx.device
    conf, traffic = c["config"], c["traffic"]
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 as configured
    cfg = nav.port_config(conf)
    model, _ = nav.navigator(cfg, ctx.seed, dev)
    model.train()
    state = create_train_state(cfg, model)
    train_step = make_train_step(cfg)
    batches, valid = make_batches(cfg, conf, traffic, ctx.seed, dev)
    on_card = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    spans = harness.Spans(ctx.trace, sync)
    b, n_checked = traffic["batch"], traffic["checked_updates"]
    hook = ctx.hooks.get("batch", lambda k, batch: batch)
    if "state" in ctx.hooks:
        ctx.hooks["state"](state)
    named = list(model.named_parameters())
    b1 = cfg.train.betas[0]
    k = 0

    def update():
        """The next update of the run, every one through the same call."""
        nonlocal k
        out = train_step(state, hook(k, batches[k % len(batches)]),
                         ctx.seed)
        k += 1
        return out

    def checked(mu0):
        """`n_checked` updates: their losses and batches, and the first
        one's gradient norms as the optimizer got them."""
        group = [batches[(k + i) % len(batches)] for i in range(n_checked)]
        losses, grads = [], {}
        for i in range(n_checked):
            losses.append(float(update()["loss"]))
            if i == 0:
                grads = grad_norms(mu0, first_moments(state.optimizer,
                                                      named), b1, dev)
        return {"losses": losses, "grads": grads, "batches": group}

    first = checked({})
    _, seeded = nav.navigator(cfg, ctx.seed, dev)
    first["change"] = change_norms(named, seeded, dev)
    del seeded
    if ctx.trace:
        harness.profile(lambda: None, dev)  # the profiler's own start-up
    sync()

    updates, failed = 0, 0
    with harness.Window() as win:
        setup_s = win.start - ctx.t0
        end, last = win.start + ctx.seconds, win.start
        while time.perf_counter() < end:
            loss = float(spans.run("update", update)["loss"])
            last = time.perf_counter()
            updates += 1
            failed += 0 if np.isfinite(loss) else 1
    window = last - win.start

    start = checkpoint(state, named)
    after = checked(start["mu"])
    after["change"] = change_norms(named, start["weights"], dev)
    failed += sum(0 if np.isfinite(x) else 1 for x in after["losses"])

    trace = None
    k5a_bytes = 0.0
    if ctx.trace:
        n_up = traffic["trace_updates"]
        s, d = traffic["steps"], cfg.model.image_feat_size
        pp = cfg.grid.points_per_step
        for i in range(n_up):
            v = valid[(k + i) % len(batches)]  # (S, B) valid points a row
            prefix = np.cumsum(v.sum(axis=1))
            k5a_bytes += sum(pool_cost.bwd1_bytes(b, s * pp, d,
                                                  int(prefix[t]), 4)
                             for t in range(s))
        trace = harness.profile(
            lambda: [spans.run("update", update) for _ in range(n_up)], dev)
    device = harness.device_record(dev, ctx.chips)
    e2e = {"train_episodes_per_s": updates * b / window if window else 0.0,
           "setup_s": setup_s}
    record = {"config": conf, "batch": b, "steps": traffic["steps"],
              "updates": updates, "window_s": window,
              "spans": spans.durations, "trace": trace,
              "trace_updates": traffic["trace_updates"],
              "k5a_bytes": k5a_bytes,
              "k5a_launches": traffic["trace_updates"] * traffic["steps"]}
    attempted = (updates + n_checked
                 + (traffic["trace_updates"] if ctx.trace else 0))

    # --- the comparison, after the window, with the program's state freed
    del state, model, named, update, checked
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    _, seeded = nav.navigator(cfg, ctx.seed, dev)
    starts = [(first, "", seeded_start(seeded)), (after, "after.", start)]
    del seeded
    readings = {}
    for prog, prefix, begin in starts:
        ref = follow(conf, cfg, prog["batches"], ctx.seed, dev, begin)
        readings.update({prefix + key: v for key, v in
                         score(prog, ref).items()})
        if ctx.hooks.get("control"):
            from benchmark.reference import navigator as R

            with R.tf32(dev):
                ctl = follow(conf, cfg, prog["batches"], ctx.seed, dev,
                             begin)
            readings.update({f"control.{prefix}{key}": v for key, v in
                             score(ctl, ref).items()})
    return {"attempted": attempted, "failed": failed, "end_to_end": e2e,
            "record": record, "device": device,
            "checks": harness.limited(readings, c["limits"]),
            "readings": readings}


@contextlib.contextmanager
def dropout_seed(seed: int, step: int, dev):
    """The dropout seed of update `step`, as make_train_step draws it (a
    forked generator seeded with seed * 1000003 + step)."""
    import torch

    devices = [dev] if torch.device(dev).type == "cuda" else []
    with torch.random.fork_rng(devices=devices):
        torch.manual_seed((int(seed) * 1000003 + int(step)) % (2 ** 63))
        yield


def follow(conf, cfg, batches, seed: int, dev, start: dict) -> dict:
    """The plain reference through the checked updates from `start`
    (`checkpoint`'s copy: weights, moments, update count, step): each
    loss, each leaf's first gradient as the update got it (clipped, from
    the first moment before and after) and each leaf's change after the
    last."""
    import torch

    from benchmark.reference import navigator as R

    sd = {n: t.to(dev, copy=True) for n, t in start["weights"].items()}
    ref = nav.reference_navigator(conf, sd).train()
    ns = R.namespace(conf)
    opt = R.AdamW(ref.parameters(), ns.train)
    named = list(ref.named_parameters())
    opt.t = start["count"]
    for (n, _), mu, nu in zip(named, opt.mu, opt.nu):
        if start["mu"][n] is not None:
            mu.copy_(start["mu"][n])
            nu.copy_(start["nu"][n])
    losses, grads = [], {}
    for k, batch in enumerate(batches):
        steps = R.Steps(**{f: getattr(batch.steps, f)
                           for f in R.Steps._fields})
        for p in ref.parameters():
            p.grad = None
        with dropout_seed(seed, start["step"] + k, dev):
            loss = R.trajectory_loss(ref, ns, batch.txt_ids, batch.txt_mask,
                                     steps)
            loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if k == 0:
            grads = grad_norms(start["mu"], {n: mu for (n, _), mu in
                                             zip(named, opt.mu)},
                               opt.b1, dev)
    change = change_norms(named, start["weights"], dev)
    return {"losses": losses, "grads": grads, "change": change}


def score(prog: dict, ref: dict) -> dict:
    """`loss_gap`: the largest gap of a checked update's loss as a share of
    the reference's, `loss_gap_first` the first update's. For the first
    gradient and the change after the last checked update, each leaf's gap
    between the two norms as a share of the larger of the reference's norm
    of that leaf and of the median leaf: `grad_gap` and `change_gap` the
    worst leaf's (named in `*_worst`), `grad_gap_median` and
    `change_gap_median` the median leaf's. The change leaves out leaves
    whose reference gradient is under a thousandth of the median leaf's
    (they move by round-off alone under Adam)."""
    losses, grads, change = prog["losses"], prog["grads"], prog["change"]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                       ref["losses"]))
    rg, rc = ref["grads"], ref["change"]
    g_med = float(np.median(list(rg.values())))
    c_med = float(np.median(list(rc.values())))
    g_gaps = {n: abs(grads[n] - rg[n]) / max(rg[n], g_med) for n in rg}
    moved = [n for n in rc if rg[n] >= 1e-3 * g_med]
    c_gaps = {n: abs(change[n] - rc[n]) / max(rc[n], c_med) for n in moved}
    g_worst = max(g_gaps, key=g_gaps.get)
    c_worst = max(c_gaps, key=c_gaps.get)
    return {"loss_gap": loss_gap,
            "loss_gap_first": abs(losses[0] - ref["losses"][0])
            / abs(ref["losses"][0]),
            "grad_gap": g_gaps[g_worst],
            "change_gap": c_gaps[c_worst],
            "grad_gap_median": float(np.median(list(g_gaps.values()))),
            "change_gap_median": float(np.median(list(c_gaps.values()))),
            "grad_worst": g_worst, "change_worst": c_worst,
            "leaves": len(rg), "leaves_moved": len(moved), "losses": losses,
            "reference_losses": ref["losses"]}

"""Port vs JAX package: the serving engine under staggered admission.

Five requests go through a 3-slot engine of each package with the same
weights (carried by gridmm_tpu_torch.convert) and the same step rows: two
start together, one slot idles on zero rows, finished requests free their
slots mid-flight and queued ones take them. Every step's per-slot outputs
agree within 1e-5 absolute and relative, -inf positions exactly."""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import gridmm_tpu.config as JC  # noqa: E402
from gridmm_tpu.serve.engine import NavServingEngine as JEngine  # noqa: E402
from gridmm_tpu_torch.ops.cuda.grid_pool import GRID_POOL_FWD  # noqa: E402
from gridmm_tpu_torch.serve.engine import NavServingEngine as TEngine  # noqa: E402
from gridmm_tpu_torch.serve.engine import serving_cfg  # noqa: E402
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

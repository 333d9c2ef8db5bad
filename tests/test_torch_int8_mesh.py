"""int8 serving over a mesh (`export_serving --int8 --mesh auto`,
utils/export.export_navigator_serving_sharded with an int8 config) on the
CPU.

An int8 layer quantizes with the absmax of its whole activation and of each
whole weight row; under GSPMD the JAX program reduces both across devices.
The sharded programs take them as MAX all-reduces over `data` (and over
`model` in a row-parallel layer, which also sums its int32 products there).
So spawned gloo ranks serving the tiny int8 navigator over (2, 1) and
(2, 2) meshes give, batch for batch, the bits of the port's unsharded int8
engine on all four requests (the row-parallel sums are int32, so exact),
and the JAX int8 engine's outputs within test_torch_quant.STEP_TOL of each
output's spread (one quantization step where an activation sits on a
rounding boundary; the port's unsharded engine is 5.9e-4 of the spread
from JAX's here). The bits are what tell a fault: a data rank that takes
the activation's absmax over its own half of the batch moves the outputs
by 1.9e-3 of the spread, within STEP_TOL; a row-parallel layer that takes
its weight rows' absmax from its own shard, by 1.2e-2.
Over a world of one the sharded bundle serves the bits of the unsharded
int8 bundle."""

import dataclasses
import socket
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import gridmm_tpu.config as JC  # noqa: E402
import torch_ranks as R  # noqa: E402
from gridmm_tpu.serve.engine import NavServingEngine as JEngine  # noqa: E402
from gridmm_tpu_torch.cli import export_serving as TEXP  # noqa: E402
from gridmm_tpu_torch.models.navigator import init_navigator  # noqa: E402
from gridmm_tpu_torch.parallel.dryrun import spawn_ranks  # noqa: E402
from gridmm_tpu_torch.serve.engine import NavServingEngine  # noqa: E402
from gridmm_tpu_torch.train.step import StepInputs  # noqa: E402
from test_torch_quant import STEP_TOL  # noqa: E402
from torch_parity import (jax_navigator, port_config,  # noqa: E402
                          port_navigator, step_rows)

B, STEPS = 4, 2
FIELDS = ("global_logits", "local_logits", "fused_logits", "grid_logits")


def _int8(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, int8_matmuls=True))


@pytest.fixture(scope="module")
def jax_int8():
    """The requests, the port's state dict (numpy) of the JAX weights and
    the JAX int8 engine's outputs on all B requests, step by step."""
    jcfg8 = _int8(JC.tiny_config())
    jmodel8, params = jax_navigator(jcfg8, seed=0)
    sd = {k: v.numpy() for k, v in port_navigator(
        port_config(jcfg8), params).state_dict().items()}
    rng = np.random.default_rng(3)
    t = jcfg8.shapes.max_txt_len
    texts = [(rng.integers(1, 1000, size=t).astype(np.int32),
              np.arange(t) < rng.integers(3, t + 1)) for _ in range(B)]
    rows = [[StepInputs(*step_rows(jcfg8, rng, s)) for s in range(STEPS)]
            for _ in range(B)]
    jeng = JEngine.create(jmodel8, jcfg8, params, batch=B)
    for r, (ids, mask) in enumerate(texts):
        jeng.submit(r, ids, mask)
    jeng.admit()
    want = []
    for s in range(STEPS):
        o = jeng.step({r: rows[r][s] for r in range(B)})
        want.append({f: np.asarray(getattr(o, f)) for f in FIELDS})
    return sd, texts, rows, want


@pytest.fixture(scope="module")
def port_int8(jax_int8):
    """The port's unsharded int8 engine's outputs on the same weights and
    requests, step by step."""
    from gridmm_tpu_torch.models.navigator import GridMMNavigator

    sd, texts, rows, _ = jax_int8
    tcfg8 = _int8(port_config(JC.tiny_config()))
    model = GridMMNavigator(tcfg8.model).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    eng = NavServingEngine.create(model, tcfg8, B, device="cpu")
    for r, (ids, mask) in enumerate(texts):
        eng.submit(r, ids, mask)
    eng.admit()
    out = []
    for s in range(STEPS):
        o = eng.step({r: rows[r][s] for r in range(B)})
        out.append({f: getattr(o, f).numpy() for f in FIELDS})
    return out


@pytest.mark.parametrize("world,mp", [(2, 1), (4, 2)],
                         ids=["2x1", "2x2"])
def test_int8_sharded_bundle_matches_jax_int8_engine(jax_int8, port_int8,
                                                     tmp_path, world, mp):
    sd, texts, rows, want = jax_int8
    ranks = spawn_ranks(R.int8_sharded_bundle_case, world, str(tmp_path),
                        sd, texts, rows, STEPS, mp, timeout=240)
    assert [r["rows"] for r in ranks[::mp]] == [[0, 1], [2, 3]]
    worst = 0.0
    for s in range(STEPS):
        for f in FIELDS:
            # the whole batch, assembled from one rank of each model group
            got = np.concatenate([r["steps"][s][f] for r in ranks[::mp]])
            for r in ranks:
                np.testing.assert_array_equal(
                    r["steps"][s][f], got[r["rows"]], err_msg=f"{s} {f}")
            np.testing.assert_array_equal(got, port_int8[s][f],
                                          err_msg=f"{s} {f} vs unsharded")
            fin = np.isfinite(want[s][f])
            np.testing.assert_array_equal(np.isfinite(got), fin,
                                          err_msg=f"{s} {f}")
            spread = want[s][f][fin].max() - want[s][f][fin].min() + 1e-9
            worst = max(worst, np.abs(got[fin] - want[s][f][fin]).max()
                        / spread)
    assert worst < STEP_TOL, worst


def test_int8_mesh_of_one_serves_the_unsharded_int8_bits(tmp_path, capsys,
                                                         monkeypatch):
    """`export_serving --int8 --mesh auto` over a world of one exports (the
    absmax MAXes run over groups of one) and from_bundle serves the bits
    of the unsharded `--int8` bundle. The parallel layer's updates still
    refuse an int8 navigator and name the serving export."""
    import torch.distributed as dist

    from gridmm_tpu_torch.config import MeshConfig
    from gridmm_tpu_torch.parallel.mesh import (ShardedParams, init_world,
                                                make_mesh)

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
                 "WORLD_SIZE": "1", "RANK": "0"}.items():
        monkeypatch.setenv(k, v)
    common = ["--tiny", "--int8", "--device", "cpu", "--batch", "2",
              "--max_action_len", "2"]
    man = TEXP.main(common + ["--mesh", "auto", "--mp_size", "1",
                              "--out_dir", str(tmp_path / "mesh")])
    assert man["int8"] is True
    assert (man["mesh"]["data"], man["mesh"]["model"]) == (1, 1)
    monkeypatch.delenv("WORLD_SIZE")
    TEXP.main(common + ["--out_dir", str(tmp_path / "one")])
    capsys.readouterr()
    tcfg8 = _int8(port_config(JC.tiny_config()))
    tcfg8 = dataclasses.replace(
        tcfg8, train=dataclasses.replace(tcfg8.train, max_action_len=2),
        shapes=dataclasses.replace(tcfg8.shapes, max_points=2 * 588))
    model = init_navigator(tcfg8.model, seed=9, device="cpu")
    sd = dict(model.state_dict())
    one = NavServingEngine.from_bundle(str(tmp_path / "one"), tcfg8, sd, 2,
                                       device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert init_world("cpu")
    try:
        mesh = make_mesh(MeshConfig(), "cpu")
        with pytest.raises(ValueError, match="export_serving --int8"):
            ShardedParams(init_navigator(tcfg8.model, seed=0, device="cpu"),
                          mesh)
        sharded = NavServingEngine.from_bundle(str(tmp_path / "mesh"), tcfg8,
                                               sd, 2, device="cpu")
        rng = np.random.default_rng(6)
        t = tcfg8.shapes.max_txt_len
        for r in range(2):
            ids = rng.integers(1, 1000, size=t).astype(np.int32)
            m = np.arange(t) < rng.integers(3, t + 1)
            for eng in (one, sharded):
                eng.submit(r, ids, m)
        assert one.admit() == sharded.admit()
        jcfg = JC.tiny_config()
        for s in range(2):
            x = {slot: step_rows(jcfg, rng, s) for slot in (0, 1)}
            a, b = one.step(x), sharded.step(x)
            for f in FIELDS:
                assert torch.equal(getattr(a, f), getattr(b, f)), (s, f)
    finally:
        dist.destroy_process_group()

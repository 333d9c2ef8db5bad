"""The sharded serving export (utils/export.export_navigator_serving_sharded,
`export_serving --mesh auto --mp_size --fsdp`, from_bundle for such a
bundle) on the CPU.

Four spawned gloo ranks export the tiny navigator over a (2, 2) (data,
model) mesh, with and without fsdp; each serves its data shard of four
requests through from_bundle and must give the logits of one process's
live engine on all four, within 1e-5 (the tensor-parallel sums add in
another order). `batch % dp` and loading under another world raise; the
CLI exports over a world of one."""

import json
import socket
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import gridmm_tpu.config as JC  # noqa: E402
import torch_ranks as R  # noqa: E402
from gridmm_tpu_torch.cli import export_serving as TEXP  # noqa: E402
from gridmm_tpu_torch.models.navigator import init_navigator  # noqa: E402
from gridmm_tpu_torch.parallel.dryrun import spawn_ranks  # noqa: E402
from gridmm_tpu_torch.serve.engine import NavServingEngine  # noqa: E402
from torch_parity import port_config, step_rows  # noqa: E402

B, STEPS = 4, 2
FIELDS = ("global_logits", "local_logits", "fused_logits", "grid_logits")


def _requests(cfg, seed=3):
    rng = np.random.default_rng(seed)
    t = cfg.shapes.max_txt_len
    texts = [(rng.integers(1, 1000, size=t).astype(np.int32),
              np.arange(t) < rng.integers(3, t + 1)) for _ in range(B)]
    rows = [[step_rows(cfg, rng, s) for s in range(STEPS)]
            for _ in range(B)]
    return texts, rows


def _live(tcfg, texts, rows):
    """One process's create engine on all B requests: per step, outputs."""
    eng = NavServingEngine.create(init_navigator(tcfg.model, seed=0,
                                                 device="cpu"),
                                  tcfg, B, device="cpu")
    for r, (ids, mask) in enumerate(texts):
        eng.submit(r, ids, mask)
    eng.admit()
    out = []
    for s in range(STEPS):
        o = eng.step({r: rows[r][s] for r in range(B)})
        out.append({f: getattr(o, f).numpy() for f in FIELDS})
    return out


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    jcfg = JC.tiny_config()
    tcfg = port_config(jcfg)
    texts, rows = _requests(jcfg)
    dirs = [str(tmp_path_factory.mktemp(f"sharded_{f}")) for f in
            ("plain", "fsdp")]
    ranks = spawn_ranks(R.sharded_bundle_case, 4, dirs, texts, rows, STEPS,
                        timeout=240)
    return tcfg, dirs, ranks, _live(tcfg, texts, rows)


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "tp-fsdp"])
def test_sharded_bundle_serves_the_live_engines_logits(sharded, fsdp):
    _, dirs, ranks, live = sharded
    man = json.loads((Path(dirs[fsdp]) / "manifest.json").read_text())
    assert (man["mesh"]["data"], man["mesh"]["model"]) == (2, 2)
    assert man["mesh"]["fsdp"] is fsdp and len(man["mesh"]["groups"]) == 4
    assert man["artifacts"]["nav_step"]["nr_devices"] == 4
    assert sorted(p.name for p in Path(dirs[fsdp]).glob("*.pt2")) == sorted(
        f"{n}_r{r}.pt2" for n in ("language", "nav_step") for r in range(4))
    n_model = sum(pl[1] is not None for pl in
                  man["mesh"]["placements"].values())
    n_data = sum(pl[0] is not None for pl in
                 man["mesh"]["placements"].values())
    assert n_model > 40 and (n_data > 20) == fsdp
    for rank, res in enumerate(ranks):
        got = res[fsdp]
        assert got["slots"] == B // 2
        assert got["rows"] == [2 * (rank // 2), 2 * (rank // 2) + 1]
        for s in range(STEPS):
            for f in FIELDS:
                want = live[s][f][got["rows"]]
                have = got["steps"][s][f]
                fin = np.isfinite(want)
                np.testing.assert_array_equal(np.isfinite(have), fin)
                np.testing.assert_allclose(have[fin], want[fin], rtol=1e-5,
                                           atol=1e-5,
                                           err_msg=f"rank {rank} {s} {f}")


def test_sharded_export_refuses_an_indivisible_batch_and_another_world(
        sharded):
    tcfg, dirs, ranks, _ = sharded
    assert all("not divisible by data-axis size 2" in r["refusal"]
               for r in ranks)
    model = init_navigator(tcfg.model, seed=0, device="cpu")
    with pytest.raises(ValueError, match="2x2 mesh"):
        NavServingEngine.from_bundle(dirs[0], tcfg,
                                     dict(model.state_dict()), B,
                                     device="cpu")


def test_export_serving_mesh_auto_over_a_world_of_one(tmp_path, capsys,
                                                      monkeypatch):
    """`export_serving --mesh auto` in a world of one (torchrun's
    environment): rank 0's programs, the mesh in the manifest, and a
    from_bundle engine over the same world that gives the live engine's
    logits; --int8 with --mesh exports too."""
    import torch.distributed as dist

    from gridmm_tpu_torch.config import MeshConfig
    from gridmm_tpu_torch.parallel.mesh import init_world, make_mesh

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
                 "WORLD_SIZE": "1", "RANK": "0"}.items():
        monkeypatch.setenv(k, v)
    out = tmp_path / "b"
    man = TEXP.main(["--tiny", "--device", "cpu", "--mesh", "auto",
                     "--fsdp", "--batch", "2", "--max_action_len", "2",
                     "--out_dir", str(out)])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == man
    assert (man["mesh"]["data"], man["mesh"]["model"]) == (1, 1)
    assert (out / "nav_step_r0.pt2").exists() and not dist.is_initialized()
    man8 = TEXP.main(["--tiny", "--int8", "--device", "cpu", "--mesh",
                      "auto", "--batch", "2", "--max_action_len", "2",
                      "--out_dir", str(tmp_path / "c")])
    assert man8["int8"] is True and man8["mesh"]["data"] == 1
    assert (tmp_path / "c" / "nav_step_r0.pt2").exists()
    jcfg = JC.tiny_config()
    tcfg = port_config(jcfg)
    import dataclasses

    tcfg = dataclasses.replace(
        tcfg, train=dataclasses.replace(tcfg.train, max_action_len=2),
        shapes=dataclasses.replace(tcfg.shapes, max_points=2 * 588))
    model = init_navigator(tcfg.model, seed=4, device="cpu")
    assert init_world("cpu")
    try:
        make_mesh(MeshConfig(), "cpu")
        served = NavServingEngine.from_bundle(str(out), tcfg,
                                              dict(model.state_dict()), 2,
                                              device="cpu")
        live = NavServingEngine.create(model, tcfg, 2, device="cpu")
        rng = np.random.default_rng(5)
        t = tcfg.shapes.max_txt_len
        for r in range(2):
            ids = rng.integers(1, 1000, size=t).astype(np.int32)
            m = np.arange(t) < rng.integers(3, t + 1)
            served.submit(r, ids, m)
            live.submit(r, ids, m)
        served.admit()
        live.admit()
        for s in range(2):
            x = {slot: step_rows(jcfg, rng, s) for slot in (0, 1)}
            a, b = served.step(x), live.step(x)
            for f in FIELDS:
                torch.testing.assert_close(getattr(a, f), getattr(b, f),
                                           rtol=1e-6, atol=1e-6)
    finally:
        dist.destroy_process_group()

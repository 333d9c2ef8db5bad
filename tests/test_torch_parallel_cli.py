"""The parallel layer in pretraining and in the command lines, on the CPU:
pretraining's sharded update on four spawned gloo ranks (DP = 2 x TP = 2)
against the JAX single-device update, and `main_nav`, `pretrain` and
`run_ce` with `--mesh auto` (and `--multihost`, `--scene_shard`,
`--mp_size 1`) at world size 1 against the same runs without them.

MLM runs through the vocabulary-sharded word embeddings and the gathered
tied logits; SAP's stop rate takes the whole batch's counts. Dropout is
off in the updates (torch_parity.shallow_parity_config).
"""

import json
import socket
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

import gridmm_tpu.config as JC  # noqa: E402
import gridmm_tpu.train.pretrain as JPT  # noqa: E402
import gridmm_tpu.train.step as JS  # noqa: E402
import gridmm_tpu.train.synthetic as JSYN  # noqa: E402
import torch_ranks as R  # noqa: E402
from gridmm_tpu.models.pretrain import GridMMPretrain as JPretrain  # noqa: E402
from gridmm_tpu_torch.parallel.dryrun import spawn_ranks  # noqa: E402
from gridmm_tpu_torch.train.pretrain import init_pretrain_params  # noqa: E402
from torch_parity import (assert_state_close, jax_params_of,  # noqa: E402
                          port_config, shallow_parity_config, state_dict_np)

TASKS = ("mlm", "sap")


@pytest.fixture(scope="module")
def pre():
    """Per task: (port cfg, port model, numpy batch of 4, JAX update
    metrics, JAX params after) on the same seed-0 weights."""
    jcfg = shallow_parity_config(JC.tiny_config())
    jmodel = JPretrain(jcfg.model)
    batch = JSYN.synthetic_pretrain_batch(jcfg, 4, 3, seed=0)
    tcfg = port_config(jcfg)
    model = init_pretrain_params(tcfg.model, seed=0, device="cpu")
    params = jax_params_of(model, lambda k: JPT.init_pretrain_params(
        jmodel, jcfg, k, batch))
    out = {}
    for task in TASKS:
        jstate, metrics = jax.jit(JPT.make_pretrain_step(jmodel, jcfg, task))(
            JS.create_train_state(jcfg, params), batch,
            jax.random.PRNGKey(0))
        out[task] = (tcfg, model, jax.tree.map(np.array, batch),
                     {k: float(v) for k, v in metrics.items()},
                     jstate.params)
    return out


@pytest.fixture(scope="module")
def four_ranks(pre):
    cases = [(pre[t][0], state_dict_np(pre[t][1]), pre[t][2], t, 2)
             for t in TASKS]
    return spawn_ranks(R.checks, 4, {"pretrain_cases": (cases,)},
                       timeout=200)


@pytest.mark.parametrize("task", TASKS)
def test_sharded_pretrain_update_matches_jax(task, pre, four_ranks):
    """One make_pretrain_step update on a (2, 2) mesh: the loss within 1e-6
    relative of the JAX update on the whole batch, the clip active, every
    updated parameter within 1e-5 of its leaf's max."""
    tcfg, model, _, want, want_params = pre[task]
    assert want["grad_norm"] > tcfg.train.grad_norm_clip
    got = [r["pretrain_cases"][TASKS.index(task)] for r in four_ranks]
    for r in got:
        assert r["loss"] == pytest.approx(want[f"loss_{task}"], rel=1e-6)
        assert r["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-5)
    assert_state_close(got[0]["params"], want_params, model, task)


# ------------------------------------------------------------ the CLIs
@pytest.fixture
def env_world(monkeypatch):
    """torchrun's environment for a world of one process."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
                 "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0"}.items():
        monkeypatch.setenv(k, v)


def test_main_nav_mesh_auto_at_world_one_equals_the_plain_run(
        tmp_path, capsys, env_world):
    """--mesh auto --multihost --scene_shard --mp_size 1 over the
    environment's world of one: the result and the checkpoint of the run
    without them (one data rank: seed + 0, the whole val split), and no
    process group left after."""
    import torch.distributed as dist

    from gridmm_tpu_torch.cli import main_nav

    common = ["--world", "synthetic", "--device", "cpu", "--iters", "2",
              "--log_every", "1", "--eval", "--batch_size", "2",
              "--scan_buckets", "3,6"]
    plain = main_nav.main(common + ["--output_dir", str(tmp_path / "a")])
    meshed = main_nav.main(common + ["--output_dir", str(tmp_path / "b"),
                                     "--mesh", "auto", "--multihost",
                                     "--scene_shard", "--mp_size", "1"])
    assert "mesh: data=1 model=1" in capsys.readouterr().out
    assert meshed.best_spl == plain.best_spl
    assert meshed.final_metrics == pytest.approx(plain.final_metrics)
    assert not dist.is_initialized()
    ck_a = torch.load(tmp_path / "a" / "ckpts" / "latest", weights_only=True)
    ck_b = torch.load(tmp_path / "b" / "ckpts" / "latest", weights_only=True)
    assert ck_a.keys() == ck_b.keys()
    for k, v in ck_a.items():
        assert torch.allclose(ck_b[k], v, rtol=1e-6, atol=1e-7), k


def test_main_nav_mp_size_must_divide_the_world(tmp_path):
    from gridmm_tpu_torch.cli import main_nav

    with pytest.raises(ValueError, match="not divisible by --mp_size 2"):
        main_nav.main(["--device", "cpu", "--mesh", "auto", "--mp_size",
                       "2", "--output_dir", str(tmp_path)])


def test_pretrain_mesh_auto_at_world_one_equals_the_plain_run(tmp_path):
    from gridmm_tpu_torch.cli import pretrain

    common = ["--device", "cpu", "--steps", "2", "--valid_every", "2",
              "--accum_steps", "2"]
    a = pretrain.main(common + ["--output_dir", str(tmp_path / "a")])
    b = pretrain.main(common + ["--output_dir", str(tmp_path / "b"),
                                "--mesh", "auto", "--mp_size", "1"])
    assert a.step == b.step == 2
    for (k, v), (k2, w) in zip(a.model.state_dict().items(),
                               b.model.state_dict().items()):
        assert k == k2 and torch.allclose(v, w, rtol=1e-6, atol=1e-7), k
    ma = [json.loads(x) for x in (tmp_path / "a" / "metrics.jsonl")
          .read_text().splitlines()]
    mb = [json.loads(x) for x in (tmp_path / "b" / "metrics.jsonl")
          .read_text().splitlines()]
    assert ma == mb
    ck = torch.load(tmp_path / "b" / "ckpts" / "latest", weights_only=True)
    assert ck["step"] == 2 and ck["model"].keys() == a.model.state_dict(
    ).keys()
    # resuming under the mesh takes the full optimizer state it wrote
    again = ["--device", "cpu", "--steps", "1", "--valid_every", "1"]
    a2 = pretrain.main(again + ["--output_dir", str(tmp_path / "a"),
                                "--resume", str(tmp_path / "a" / "ckpts" /
                                                "latest")])
    b2 = pretrain.main(again + ["--output_dir", str(tmp_path / "b"),
                                "--resume", str(tmp_path / "b" / "ckpts" /
                                                "latest"),
                                "--mesh", "auto"])
    assert a2.step == b2.step == 3
    for (k, v), w in zip(a2.model.state_dict().items(),
                         b2.model.state_dict().values()):
        assert torch.allclose(v, w, rtol=1e-6, atol=1e-7), k


def test_run_ce_mesh_auto_at_world_one_equals_the_plain_run(tmp_path):
    from gridmm_tpu_torch.cli import run_ce

    common = ["--device", "cpu", "--epochs", "1", "--max_steps", "4"]
    a = run_ce.main(common + ["--output_dir", str(tmp_path / "a"),
                              "--results_dir", str(tmp_path / "a" / "r")])
    b = run_ce.main(common + ["--output_dir", str(tmp_path / "b"),
                              "--results_dir", str(tmp_path / "b" / "r"),
                              "--mesh", "auto"])
    assert a == b
    assert (tmp_path / "b" / "r" /
            "stats_ep_ckpt_0_val_unseen_r0_w1.json").exists()
    assert (tmp_path / "b" / "checkpoints" / "ckpt.0").exists()

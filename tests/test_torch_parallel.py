"""The parallel layer (gridmm_tpu_torch/parallel/) against gridmm_tpu on the
CPU: placements by the JAX partition rules, the navigator's sharded update
on spawned gloo ranks against the JAX single-device update, the multihost
reductions, the batch split, the mesh at world size 1 and the dryrun.
Pretraining's sharded update and the CLIs' mesh options are in
test_torch_parallel_cli.py.

The updates run with dropout off (the ranks would draw different masks),
adam_eps 1e-2, a clip of 0.5 that the gradient norm exceeds, and action
counts that differ between the data ranks' halves of the batch
(torch_parity.shallow_parity_config). Each spawned rank joins with a
timeout (parallel/dryrun.spawn_ranks), so a hung collective fails its
test instead of the suite.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

import gridmm_tpu.config as JC  # noqa: E402
import gridmm_tpu.parallel.mesh as JM  # noqa: E402
import gridmm_tpu.parallel.multihost as JMH  # noqa: E402
import gridmm_tpu.train.pretrain as JPT  # noqa: E402
import gridmm_tpu.train.step as JS  # noqa: E402
import gridmm_tpu.train.synthetic as JSYN  # noqa: E402
import gridmm_tpu_torch.parallel.mesh as TM  # noqa: E402
import gridmm_tpu_torch.parallel.multihost as TMH  # noqa: E402
import torch_ranks as R  # noqa: E402
from gridmm_tpu.models.navigator import GridMMNavigator as JNav  # noqa: E402
from gridmm_tpu.models.navigator import init_navigator as jinit  # noqa: E402
from gridmm_tpu.models.pretrain import GridMMPretrain as JPretrain  # noqa: E402
from gridmm_tpu_torch.convert import flax_paths  # noqa: E402
from gridmm_tpu_torch.models.navigator import init_navigator  # noqa: E402
from gridmm_tpu_torch.parallel.dryrun import (dryrun_multichip,  # noqa: E402
                                              spawn_ranks)
from gridmm_tpu_torch.train.pretrain import init_pretrain_params  # noqa: E402
from torch_parity import (assert_state_close, jax_params_of,  # noqa: E402
                          port_config, shallow_parity_config, state_dict_np)

CLIP = 0.5
B = 4
NORMS = ("batch", "actions")


@pytest.fixture(scope="module")
def nav():
    """Per loss_norm: (port cfg, port model, numpy batch, JAX update
    metrics, JAX params after) on the same seed-0 weights. Targets of the
    second data rank's half are ignored from step 1 on: the halves count
    2 x 3 and 2 x 1 actions."""
    base = shallow_parity_config(JC.tiny_config(), CLIP)
    jmodel = JNav(base.model)
    tmodel = init_navigator(port_config(base).model, seed=0, device="cpu")
    params = jax_params_of(tmodel, lambda k: jinit(jmodel, base.shapes, k))
    batch = jax.tree.map(np.array, JSYN.synthetic_trajectory_batch(
        base, B, 3, seed=0))
    target = batch.steps.target.copy()
    target[1:, B // 2:] = base.train.ignoreid
    batch = batch._replace(steps=batch.steps._replace(target=target))
    out = {}
    for norm in NORMS:
        jcfg = dataclasses.replace(base, train=dataclasses.replace(
            base.train, loss_norm=norm))
        jstate, metrics = jax.jit(JS.make_train_step(jmodel, jcfg))(
            JS.create_train_state(jcfg, params), batch,
            jax.random.PRNGKey(0))
        out[norm] = (port_config(jcfg), tmodel, batch,
                     {k: float(v) for k, v in metrics.items()},
                     jstate.params)
    return out


MH_INPUTS = [
    # rank 0: three predictions (one id repeated within it) and metrics
    ([{"instr_id": "a", "v": 0}, {"instr_id": "b", "v": 1},
      {"instr_id": "a", "v": 2}], {"spl": 0.25, "sr": 0.5}, 3.0),
    # rank 1: an empty val shard: no predictions, NaN metrics, weight 0
    ([], {"spl": float("nan"), "sr": float("nan")}, 0.0),
]


@pytest.fixture(scope="module")
def two_ranks(nav):
    """DP = 2 updates at both loss norms, the multihost functions, the CE
    trainer's refusal and DDP on the same updates, in one start of two
    ranks."""
    cases = [(nav[n][0], state_dict_np(nav[n][1]), nav[n][2], 1, False)
             for n in NORMS]
    return spawn_ranks(R.checks, 2, {
        "update_cases": (cases,), "multihost_case": (MH_INPUTS,),
        "ce_refuses_indivisible_envs": (),
        "ddp_case": (cases[0][:3],)}, timeout=150)


FOUR = [(n, f) for n in NORMS for f in (False, True)]


@pytest.fixture(scope="module")
def four_ranks(nav):
    """DP = 2 x TP = 2 updates at both loss norms, with and without fsdp,
    in one start of four ranks."""
    cases = [(nav[n][0], state_dict_np(nav[n][1]), nav[n][2], 2, fsdp)
             for n, fsdp in FOUR]
    return spawn_ranks(R.checks, 4, {"update_cases": (cases,)},
                       timeout=200)


# ------------------------------------------------------------ placements
def _jax_spec_in_torch_layout(spec, path, ndim):
    """A JAX PartitionSpec over the flax leaf -> (data dim, model dim) of
    the torch parameter."""
    dims = {}
    for i, axis in enumerate(tuple(spec)):
        if axis is not None:
            dims[axis] = TM._torch_dim(path, ndim, i)
    return dims.get("data"), dims.get("model")


@pytest.fixture(scope="module")
def trees():
    """{"navigator" | "pretrain": (port module, JAX parameter shapes)} at
    tiny_config()."""
    jcfg = JC.tiny_config()
    tcfg = port_config(jcfg)
    jn, jp = JNav(jcfg.model), JPretrain(jcfg.model)
    batch = JSYN.synthetic_pretrain_batch(jcfg, 2, 3, seed=0)
    key = jax.random.PRNGKey(0)
    return {
        "navigator": (init_navigator(tcfg.model, seed=0, device="cpu"),
                      jax.eval_shape(lambda k: jinit(jn, jcfg.shapes, k),
                                     key)),
        "pretrain": (init_pretrain_params(tcfg.model, seed=0, device="cpu"),
                     jax.eval_shape(lambda k: JPT.init_pretrain_params(
                         jp, jcfg, k, batch), key))}


@pytest.mark.parametrize("dp", [2, 3])
@pytest.mark.parametrize("fsdp", [False, True], ids=["replicated", "fsdp"])
@pytest.mark.parametrize("which", ["navigator", "pretrain"])
def test_placements_match_jax_param_shardings(which, fsdp, dp, trees):
    """Every leaf's placement is JAX `param_shardings`' spec over a
    (dp, 2) mesh, in the torch layout; at dp = 3 fsdp drops the dims 3
    does not divide, as JAX does. No ranks needed."""
    model, params = trees[which]
    shardings = JM.param_shardings(
        params, AbstractMesh((dp, 2), ("data", "model")), fsdp=fsdp)
    flat = {JM._path_str(p).removeprefix("params/"): s.spec for p, s in
            jax.tree_util.tree_flatten_with_path(shardings)[0]}
    got = TM.placements(model, dp, 2, fsdp)
    paths = flax_paths(model)
    named = dict(model.named_parameters())
    assert set(got) == set(named) and len(flat) == len(named)
    for name, pl in got.items():
        want = _jax_spec_in_torch_layout(flat[paths[name]], paths[name],
                                         named[name].ndim)
        assert pl == want, (name, paths[name], pl, want)
    n_model = sum(pl[1] is not None for pl in got.values())
    n_data = sum(pl[0] is not None for pl in got.values())
    assert n_model > 40
    assert (n_data > 20) == (fsdp and dp == 2)


def test_param_spec_is_the_jax_rules():
    paths = ["a/query/kernel", "x/attention/output/dense/kernel",
             "ffn/intermediate_dense/bias", "ffn/output_dense/kernel",
             "l/linear2/kernel", "e/word_embeddings/embedding",
             "ln/scale", "head/net_0/kernel", "z/key/bias", "attn_out/bias"]
    for fsdp in (False, True):
        for p in paths:
            assert TM.param_spec(p, fsdp) == tuple(JM.param_spec(p, fsdp)), p


def test_placements_raise_where_the_model_axis_does_not_divide(nav):
    with pytest.raises(ValueError, match="not divisible by the model axis"):
        TM.placements(nav["batch"][1], 1, 3)


# ------------------------------------------------------------ updates
def _per_rank(nav, two_ranks, four_ranks, mesh, norm, fsdp):
    if mesh == "dp2":
        return [r["update_cases"][NORMS.index(norm)] for r in two_ranks]
    return [r["update_cases"][FOUR.index((norm, fsdp))] for r in four_ranks]


NAV_CASES = [("dp2", "batch", False), ("dp2", "actions", False),
             ("dp2xtp2", "batch", False), ("dp2xtp2", "batch", True),
             ("dp2xtp2", "actions", False), ("dp2xtp2", "actions", True)]


@pytest.mark.parametrize("mesh,norm,fsdp", NAV_CASES,
                         ids=[f"{m}-{n}" + ("-fsdp" if f else "")
                              for m, n, f in NAV_CASES])
def test_sharded_update_matches_jax_single_device(mesh, norm, fsdp, nav,
                                                  two_ranks, four_ranks):
    """One make_train_step update on every rank: the loss within 1e-6
    relative of the JAX update on the whole batch, the clip active, the
    updated parameters within 1e-5 of each leaf's max."""
    _, tmodel, _, want, want_params = nav[norm]
    assert want["grad_norm"] > CLIP  # the clip scales this update
    per_rank = _per_rank(nav, two_ranks, four_ranks, mesh, norm, fsdp)
    for r, got in enumerate(per_rank):
        assert got["local_batch"] == B // 2, r
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-6), r
        assert got["grad_norm"] == pytest.approx(want["grad_norm"],
                                                 rel=1e-5), r
    assert_state_close(per_rank[0]["params"], want_params, tmodel,
                       f"{mesh} {norm} fsdp={fsdp}")


def test_ddp_does_not_reduce_the_port_updates(two_ranks):
    """Why parallel/mesh.py reduces the gradients itself (its docstring):
    against the mean of the ranks' own gradients, DDP as built leaves the
    navigator update's buckets that hold an unused parameter unreduced
    (find_unused_parameters reduces them), and reduces nothing of an MLM
    pretraining update, whose task calls the model's methods, not its
    forward, even with static_graph."""
    for r in two_ranks:
        got = r["ddp_case"]
        assert got["navigator"] > 1e-2, got
        assert got["navigator_find_unused"] < 1e-6, got
        assert got["pretrain_static_graph"] > 1e-2, got


# ------------------------------------------------------------ multihost
def test_multihost_at_two_ranks_matches_jax_on_the_concatenation(two_ranks):
    """merge: the JAX single process's list over the ranks' concatenation,
    the first entry of each instr_id kept (rank order); the weighted mean:
    the JAX single process's metrics of the concatenated episodes, the
    empty rank's NaN ignored; all_mean: the mean of the ranks' values."""
    res = [r["multihost_case"] for r in two_ranks]
    assert [r["count"] for r in res] == [2, 2]
    assert [r["index"] for r in res] == [0, 1]
    concat = MH_INPUTS[0][0] + MH_INPUTS[1][0]
    jax_list = JMH.merge_prediction_lists(concat)
    want_merged = [p for i, p in enumerate(jax_list) if p["instr_id"] not in
                   {q["instr_id"] for q in jax_list[:i]}]
    want_weighted = JMH.weighted_mean_scalars(MH_INPUTS[0][1], 3.0)
    for r in res:
        assert r["merged"] == want_merged
        assert r["weighted"] == pytest.approx(want_weighted)
        assert all(np.isnan(v) for v in r["mean"].values())
    assert TMH.process_count() == 1 and TMH.process_index() == 0
    assert TMH.weighted_mean_scalars({"a": 1.0}, 0.0) == {"a": 1.0}
    assert TMH.merge_prediction_lists(concat) == JMH.merge_prediction_lists(
        concat)


def test_allocate_episodes_by_scene_matches_jax():
    rng = np.random.default_rng(0)
    eps = [{"scan": f"s{int(rng.integers(0, 7))}", "i": i}
           for i in range(40)]
    for n in (1, 2, 3, 5):
        assert TMH.allocate_episodes_by_scene(eps, n) == \
            JMH.allocate_episodes_by_scene(eps, n)


def test_ce_trainer_refuses_indivisible_envs(two_ranks):
    msg = two_ranks[0]["ce_refuses_indivisible_envs"]
    assert msg is not None and "not divisible by the data-axis size 2" in msg


# ------------------------------------------------------------ batch, mesh
def test_trajectory_batch_split_takes_dim_0_and_dim_1(nav):
    batch = nav["batch"][2]
    parts = [TM.shard_trajectory_batch(batch, r, 2) for r in range(2)]
    np.testing.assert_array_equal(
        np.concatenate([p.txt_ids for p in parts]), batch.txt_ids)
    for f in batch.steps._fields:
        np.testing.assert_array_equal(
            np.concatenate([getattr(p.steps, f) for p in parts], axis=1),
            getattr(batch.steps, f))
    with pytest.raises(ValueError, match="not divisible"):
        TM.shard_trajectory_batch(batch, 0, 3)


def test_make_mesh_at_world_one_and_its_divisibility_error():
    import torch.distributed as dist

    from gridmm_tpu_torch.config import MeshConfig

    assert TM.init_world("cpu")
    try:
        mesh = TM.make_mesh(MeshConfig(), "cpu")
        assert TM.mesh_shape(mesh) == (1, 1)
        assert mesh.mesh_dim_names == ("data", "model")
        assert TM.data_rank(mesh) == 0
        with pytest.raises(ValueError, match=r"mesh 0x2 != 1 devices"):
            TM.make_mesh(MeshConfig(mp_size=2), "cpu")
        assert not TM.init_world("cpu")  # joins the existing world
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ the dryrun
def test_dryrun_multichip_four_ranks_equals_one_process(capsys):
    """Flagship widths, depth cut; a (2, 2) mesh; the sharded step's loss
    equals one process's within 1e-5 (dryrun_multichip raises if not)."""
    out = dryrun_multichip(4, timeout=200)
    assert out["mesh"] == (2, 2) and np.isfinite(out["loss"])
    assert "mesh=(2x2)" in capsys.readouterr().out

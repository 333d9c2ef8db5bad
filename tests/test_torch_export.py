"""The serving bundle (utils/export.py, cli/export_serving.py,
NavServingEngine.from_bundle) and the pool's custom op, on the CPU at
tiny_config() width.

`gridmm::grid_pool_fwd` passes `torch.library.opcheck`. A saved and loaded
bundle reproduces the port's live step bit for bit (as
tests/test_export_serving.py holds the JAX bundle against the live JAX
step), agrees with the JAX live step within 1e-5 on the same weights,
serves weights other than the ones it was exported with, leaves the carry
it is given untouched, and a `from_bundle` engine gives the bits of a
`create` engine over admit/step/finish rounds. The manifest has the JAX
manifest's keys, with `torch_version` for `jax_version`."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gridmm_tpu.config as JC  # noqa: E402
import gridmm_tpu.train.step as JS  # noqa: E402
import gridmm_tpu_torch.ops.grid_pool as TP  # noqa: E402
import gridmm_tpu_torch.train.step as TS  # noqa: E402
from gridmm_tpu.serve.engine import serving_cfg as jserving_cfg  # noqa: E402
from gridmm_tpu_torch.cli import export_serving as TEXP  # noqa: E402
from gridmm_tpu_torch.models.navigator import init_navigator  # noqa: E402
from gridmm_tpu_torch.ops.cuda.grid_pool import GRID_POOL_FWD  # noqa: E402
from gridmm_tpu_torch.serve.engine import NavServingEngine  # noqa: E402
from gridmm_tpu_torch.serve.engine import serving_cfg  # noqa: E402
from gridmm_tpu_torch.utils import export as TX  # noqa: E402
from torch_parity import (assert_close, jax_navigator, port_config,  # noqa: E402
                          port_navigator, step_rows, to_torch)

BATCH = 2


def params_of(model):
    """The programs' parameter input: a plain dict in state_dict order."""
    return dict(model.state_dict())


OUT_FIELDS = ("gmap_embeds", "vp_embeds", "global_logits", "local_logits",
              "fused_logits", "grid_logits")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_grid_pool_op_passes_opcheck(dtype):
    rng = np.random.default_rng(0)
    b, n, d = 2, 300, 16
    g = torch.tensor(rng.standard_normal((b, n, d))).to(dtype)
    cells = torch.tensor(rng.integers(-1, 196, size=(b, n)).astype(np.int32))
    cells[1] = -1                      # an all-invalid row
    w = torch.tensor(rng.standard_normal((b, n)), dtype=torch.float32)
    torch.library.opcheck(torch.ops.gridmm.grid_pool_fwd.default,
                          (g, cells, w, 196))
    pooled, mask, denom, cmax = torch.ops.gridmm.grid_pool_fwd(g, cells, w,
                                                                196)
    want = TP.grid_scatter_pool_raw(g, cells, w)
    for got, ref in zip((pooled, mask, denom), want):
        assert torch.equal(got, ref)
    assert torch.equal(cmax, TP.cell_max(cells, w.to(pooled.dtype)))
    assert denom.is_contiguous() and tuple(denom.shape) == (b, TP.CELL_PAD)
    assert torch.isneginf(cmax[1]).all() and not mask[1].any()


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A tiny bundle exported at BATCH rows from seed-0 weights."""
    jcfg = JC.tiny_config()
    tcfg = port_config(jcfg)
    model = init_navigator(tcfg.model, seed=0, device="cpu")
    out = tmp_path_factory.mktemp("bundle")
    exports = TX.export_navigator_serving(model, tcfg, model.state_dict(),
                                          batch=BATCH, device="cpu")
    manifest = TX.save_serving_bundle(exports, str(out), cfg=tcfg,
                                      extra_manifest={"batch": BATCH})
    return jcfg, tcfg, out, manifest


def _programs(out):
    return (TX.load_exported(str(out / "language.pt2")).module(),
            TX.load_exported(str(out / "nav_step.pt2")).module())


def _inputs(jcfg, seed=1, steps=3):
    rng = np.random.default_rng(seed)
    t = jcfg.shapes.max_txt_len
    ids = rng.integers(1, 1000, size=(BATCH, t)).astype(np.int32)
    mask = np.arange(t)[None] < np.array([[7], [t]])
    rows = [step_rows(jcfg, rng, s, BATCH) for s in range(steps)]
    return ids, mask, rows


def _run_programs(lang, step, params, cfg, ids, mask, rows):
    """The loaded programs over the steps; returns (txt, [outputs], carry)."""
    with torch.inference_mode():
        txt = lang(params, torch.from_numpy(ids), torch.from_numpy(mask))
        carry = TX.carry_to_dict(TS.init_carry(cfg, BATCH, device="cpu"))
        outs = []
        for x in rows:
            carry, out = step(params, txt, torch.from_numpy(mask), carry,
                              to_torch(TS.StepInputs(*x))._asdict())
            outs.append(out)
    return txt, outs, carry


def _run_live(model, cfg, ids, mask, rows):
    with torch.inference_mode():
        txt = model("language", {"txt_ids": torch.from_numpy(ids),
                                 "txt_mask": torch.from_numpy(mask)})
        carry = TS.init_carry(cfg, BATCH, device="cpu")
        outs = []
        for x in rows:
            carry, out = TS.nav_device_step(
                model, cfg, txt, torch.from_numpy(mask), carry,
                to_torch(TS.StepInputs(*x)))
            outs.append(out)
    return txt, outs, carry


@pytest.mark.parametrize("seed", [0, 5])
def test_bundle_reproduces_live_step_bit_for_bit(bundle, seed):
    """Seed 0 is the weights the bundle was exported with; seed 5 weights
    it has never seen."""
    jcfg, tcfg, out, _ = bundle
    scfg = serving_cfg(tcfg)
    model = init_navigator(scfg.model, seed=seed, device="cpu")
    lang, step = _programs(out)
    ids, mask, rows = _inputs(jcfg)
    launches = GRID_POOL_FWD.launches
    txt_b, outs_b, carry_b = _run_programs(lang, step, params_of(model),
                                           scfg, ids, mask, rows)
    txt_l, outs_l, carry_l = _run_live(model, scfg, ids, mask, rows)
    assert torch.equal(txt_b, txt_l)
    for s, (ob, ol) in enumerate(zip(outs_b, outs_l)):
        assert sorted(ob) == sorted(OUT_FIELDS)
        for f in OUT_FIELDS:
            assert torch.equal(ob[f], getattr(ol, f)), (s, f)
    for f, t in TX.carry_to_dict(carry_l).items():
        assert torch.equal(carry_b[f], t), f
    assert carry_b["count"].tolist() == [3 * 588] * BATCH
    assert GRID_POOL_FWD.launches == launches  # CPU tensors: plain pool


def test_bundle_matches_jax_live_step(bundle):
    jcfg, tcfg, out, _ = bundle
    jcfg = jserving_cfg(jcfg)
    jmodel, params = jax_navigator(jcfg, seed=2)
    tmodel = port_navigator(serving_cfg(tcfg), params)
    lang, step = _programs(out)
    ids, mask, rows = _inputs(jcfg, seed=3)
    txt_b, outs_b, _ = _run_programs(lang, step, params_of(tmodel),
                                     serving_cfg(tcfg), ids, mask, rows)
    jtxt = jmodel.apply(params, "language", {"txt_ids": jnp.asarray(ids),
                                             "txt_mask": jnp.asarray(mask)})
    assert_close(txt_b, jtxt)
    jstep = jax.jit(lambda p, t, m, c, x: JS.nav_device_step(
        jmodel, jcfg, p, t, m, c, x))
    jcarry = JS.init_carry(jcfg, BATCH)
    for s, x in enumerate(rows):
        jcarry, jout = jstep(params, jtxt, jnp.asarray(mask), jcarry,
                             jax.tree.map(jnp.asarray, x))
        for f in OUT_FIELDS:
            assert_close(outs_b[s][f], getattr(jout, f), msg=f"step {s} {f}")


def test_bundle_step_leaves_the_given_carry_untouched(bundle):
    jcfg, tcfg, out, _ = bundle
    scfg = serving_cfg(tcfg)
    model = init_navigator(scfg.model, seed=0, device="cpu")
    lang, step = _programs(out)
    ids, mask, rows = _inputs(jcfg, seed=4, steps=2)
    _, _, carry = _run_programs(lang, step, params_of(model), scfg, ids,
                                mask, rows[:1])
    before = {k: v.clone() for k, v in carry.items()}
    with torch.inference_mode():
        txt = lang(params_of(model), torch.from_numpy(ids),
                   torch.from_numpy(mask))
        new, _ = step(params_of(model), txt, torch.from_numpy(mask), carry,
                      to_torch(TS.StepInputs(*rows[1]))._asdict())
    for k, v in carry.items():
        assert torch.equal(v, before[k]), k          # by value
        assert new[k].data_ptr() != v.data_ptr(), k  # no aliasing
    assert new["count"].tolist() == [2 * 588] * BATCH


def test_from_bundle_engine_equals_create_engine(bundle):
    """Both engines over other weights than the export's, staggered
    requests: admit, step, finish, admit again; every output equal."""
    jcfg, tcfg, out, _ = bundle
    model = init_navigator(tcfg.model, seed=7, device="cpu")
    live = NavServingEngine.create(model, tcfg, BATCH, device="cpu")
    served = NavServingEngine.from_bundle(str(out), tcfg,
                                          params_of(model), BATCH,
                                          device="cpu")
    assert served.model is None and served.graph_launches == {}
    rng = np.random.default_rng(8)
    t = jcfg.shapes.max_txt_len
    lengths = [2, 3, 1, 2]
    for r in range(len(lengths)):
        ids = rng.integers(1, 1000, size=t).astype(np.int32)
        m = np.arange(t) < rng.integers(3, t + 1)
        for eng in (live, served):
            eng.submit(r, ids, m)
    done = {r: 0 for r in range(len(lengths))}
    assert live.admit() == served.admit() == {0: 0, 1: 1}
    rounds = 0
    while live.active():
        active = live.active()
        assert active == served.active()
        rows = {slot: step_rows(jcfg, rng, done[r])
                for r, slot in active.items()}
        a, b = live.step(rows), served.step(rows)
        for f in OUT_FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), (rounds, f)
        for r in active:
            done[r] += 1
            if done[r] == lengths[r]:
                live.finish(r)
                served.finish(r)
        assert live.admit() == served.admit()
        rounds += 1
        assert rounds < 10
    assert done == dict(enumerate(lengths))
    for x, y in zip(TX.carry_to_dict(live._carry).values(),
                    TX.carry_to_dict(served._carry).values()):
        assert torch.equal(x, y)


def test_from_bundle_rejects_another_batch(bundle):
    _, tcfg, out, _ = bundle
    model = init_navigator(tcfg.model, seed=0, device="cpu")
    with pytest.raises(ValueError, match="batch"):
        NavServingEngine.from_bundle(str(out), tcfg, params_of(model),
                                     BATCH + 1, device="cpu")


def test_manifest_has_the_jax_manifest_keys(bundle, tmp_path):
    from gridmm_tpu.models.navigator import GridMMNavigator, init_navigator \
        as jinit
    from gridmm_tpu.utils.export import (export_navigator_serving,
                                         save_serving_bundle)

    jcfg, tcfg, out, manifest = bundle
    jmodel = GridMMNavigator(jcfg.model)
    jparams = jinit(jmodel, jcfg.shapes, jax.random.PRNGKey(0))
    jman = save_serving_bundle(
        export_navigator_serving(jmodel, jcfg, jparams, batch=BATCH),
        str(tmp_path), cfg=jcfg, extra_manifest={"batch": BATCH})
    assert set(manifest) == set(jman) - {"jax_version"} | {"torch_version"}
    assert set(manifest["artifacts"]) == set(jman["artifacts"])
    for name, art in manifest["artifacts"].items():
        assert set(art) == set(jman["artifacts"][name])
        assert art["platforms"] == ["cpu"] and art["nr_devices"] == 1
        assert (out / art["file"]).exists()
    assert manifest["model"] == jman["model"]
    assert json.loads((out / "manifest.json").read_text()) == manifest
    # the programs hold no weights
    ep = TX.load_exported(str(out / "nav_step.pt2"))
    assert len(ep.state_dict) == 0
    assert manifest["artifacts"]["nav_step"]["num_args"] > \
        len(init_navigator(tcfg.model, device="cpu").state_dict())


def test_bundle_rejects_wrong_shapes(bundle):
    jcfg, tcfg, out, _ = bundle
    lang, _ = _programs(out)
    model = init_navigator(tcfg.model, seed=0, device="cpu")
    t = jcfg.shapes.max_txt_len
    with pytest.raises(Exception, match="(?i)shape|size|expected"):
        lang(params_of(model), torch.zeros((BATCH + 1, t), dtype=torch.int32),
             torch.zeros((BATCH + 1, t), dtype=torch.bool))


def test_export_serving_cli_writes_a_bundle(tmp_path, capsys):
    man = TEXP.main(["--tiny", "--device", "cpu", "--batch", "1",
                     "--max_action_len", "3", "--out_dir",
                     str(tmp_path / "b")])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == man
    assert man["batch"] == 1 and man["config"] == "tiny" and not man["int8"]
    assert man["model"]["max_points"] == 3 * 588
    assert (tmp_path / "b" / "nav_step.pt2").exists()
    assert TEXP.parse_args(["--out_dir", "x"]).device == "cuda"


@pytest.mark.parametrize("argv,what", [
    (["--int8"], "ops/quant.py"),
    (["--navigator_ckpt", "grid_map.pt"], "import_torch_navigator"),
    (["--mesh", "auto"], "parallel/mesh.py"),
    (["--mp_size", "2"], "parallel/mesh.py"),
    (["--fsdp"], "parallel/mesh.py")])
def test_export_serving_cli_names_what_is_not_ported(tmp_path, argv, what):
    with pytest.raises(NotImplementedError, match=what):
        TEXP.main(argv + ["--tiny", "--device", "cpu", "--out_dir",
                          str(tmp_path)])

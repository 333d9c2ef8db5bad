"""Port vs JAX package: the pretraining model and its update steps on the
CPU, at tiny width (tiny_config() with image_prob_size=32, as
tests/test_pretrain.py sets it).

The synthetic pretraining batch array by array; the flax->torch converter
on the pretraining tree; the language branch of the cross-modal layers;
`encode` and the MLM/MRC/SAP/OG logits (OG with object tokens); each task's
loss and its gradients against `jax.grad`; one `make_pretrain_step` and one
accumulation window; the task multiplexer. The grid pool runs its plain
version on the CPU on both sides. Dropout is off on both sides (its masks
cannot match). Tolerances are stated at each test.
"""

import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import gridmm_tpu.config as JC  # noqa: E402
import gridmm_tpu.models.layers as JLY  # noqa: E402
import gridmm_tpu.train.pretrain as JPT  # noqa: E402
import gridmm_tpu.train.step as JS  # noqa: E402
import gridmm_tpu.train.synthetic as JSYN  # noqa: E402
import gridmm_tpu_torch.models.layers as TLY  # noqa: E402
import gridmm_tpu_torch.train.pretrain as TPT  # noqa: E402
import gridmm_tpu_torch.train.step as TS  # noqa: E402
import gridmm_tpu_torch.train.synthetic as TSYN  # noqa: E402
from gridmm_tpu.models.pretrain import GridMMPretrain as JPretrain  # noqa: E402
from gridmm_tpu.ops.masking import compaction_stray_count as j_stray  # noqa: E402
from gridmm_tpu_torch.convert import (flax_to_state_dict,  # noqa: E402
                                      load_flax_params, to_flax_tree)
from gridmm_tpu_torch.models.pretrain import GridMMPretrain  # noqa: E402
from gridmm_tpu_torch.ops.masking import compaction_stray_count  # noqa: E402
from torch_parity import (assert_close, port_config, to_numpy,  # noqa: E402
                          to_torch)

TASKS = ("mlm", "mrc", "sap", "og")


def pretrain_cfg(objects=False, **train):
    """tiny_config() with image_prob_size=32 and every dropout 0; with
    objects, object tokens (obj_feat_size = image_feat_size) and the og
    head, as cli/pretrain.py turns them on."""
    cfg = JC.tiny_config()
    m = dataclasses.replace(
        cfg.model, image_prob_size=32, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, feat_dropout=0.0,
        obj_feat_size=cfg.model.image_feat_size if objects else 0)
    return dataclasses.replace(cfg, model=m,
                               train=dataclasses.replace(cfg.train, **train))


def with_objects(batch):
    """The synthetic batch with object tokens at vp positions 2..4 of every
    item (the last step's tokens 1..3 become nav_type 2) and an OG label on
    each item: 3 and 2."""
    b = jax.tree.map(np.array, batch)
    b.traj_nav_types[:, :, 1:4] = 2
    b.vp_obj_mask[:, 2:5] = True
    return jax.tree.map(jnp.asarray,
                        b._replace(obj_labels=np.asarray([3, 2], np.int32)))


def _setup(objects):
    jcfg = pretrain_cfg(objects, adam_eps=1e-2)
    jmodel = JPretrain(jcfg.model)
    batch = JSYN.synthetic_pretrain_batch(jcfg, 2, 3, seed=0)
    if objects:
        batch = with_objects(batch)
    # jitted: one compile is faster than tracing every task eagerly
    params = jax.jit(lambda k: JPT.init_pretrain_params(
        jmodel, jcfg, k, batch))(jax.random.PRNGKey(0))
    batch2 = JSYN.synthetic_pretrain_batch(jcfg, 2, 3, seed=1)
    if objects:
        batch2 = with_objects(batch2)
    return jcfg, jmodel, params, batch, batch2


@pytest.fixture(scope="module")
def tiny():
    """(jax cfg, flax module, params, batch, batch2), no object tokens.
    adam_eps is 1e-2 for the update tests (see test_torch_train.py)."""
    return _setup(False)


@pytest.fixture(scope="module")
def tiny_obj():
    return _setup(True)


def port_model(jcfg, params):
    model = GridMMPretrain(port_config(jcfg).model)
    load_flax_params(model, jax.tree.map(np.asarray, params))
    return model.eval()


def port_batch(jbatch):
    return TPT.pretrain_batch_to_device(jax.tree.map(np.array, jbatch),
                                        "cpu")


def _leaf_errors(got_tree, want_tree):
    got = dict(jax.tree_util.tree_flatten_with_path(got_tree)[0])
    out = {}
    for path, want in jax.tree_util.tree_flatten_with_path(want_tree)[0]:
        want = np.asarray(want)
        out[jax.tree_util.keystr(path)] = (
            float(np.abs(np.asarray(got[path]) - want).max()),
            float(np.abs(want).max()))
    return out


def _assert_tree_close(got_tree, want_tree, rel, what):
    """Every leaf within `rel` of the leaf's own max, plus 1e-6 of the
    largest leaf's max: a gradient that is zero analytically (that of a
    head's output bias, added to every logit of a softmax) holds f32
    rounding noise only, on both sides."""
    errs = _leaf_errors(got_tree, want_tree)
    floor = 1e-6 * max(v[1] for v in errs.values())
    bad = {k: v for k, v in errs.items() if not v[0] <= rel * v[1] + floor}
    assert not bad, f"{what}: {len(bad)} leaves differ, e.g. " \
        f"{sorted(bad.items(), key=lambda kv: -kv[1][0])[:3]}"


# ------------------------------------------------------------------- batch
@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_pretrain_batch_equals_jax(seed):
    """The same numpy draws in the same order: every array equal, same
    dtype."""
    jcfg = pretrain_cfg()
    want = JSYN.synthetic_pretrain_batch(jcfg, 3, 4, seed=seed)
    got = TSYN.synthetic_pretrain_batch(port_config(jcfg), 3, 4, seed=seed,
                                        device="cpu")
    for f in TPT.PretrainBatch._fields:
        a, ref = to_numpy(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == ref.dtype, (f, a.dtype, ref.dtype)
        np.testing.assert_array_equal(a, ref, err_msg=f)


# --------------------------------------------------------------- converter
@pytest.mark.parametrize("objects", [False, True], ids=["r2r", "objects"])
def test_converter_takes_the_pretrain_tree_exactly(objects, tiny, tiny_obj):
    """Every flax leaf lands on a parameter of the port's module and every
    parameter is covered (og_head only with objects, the language branch
    only in the local encoder); a leftover leaf or a missing one raises."""
    jcfg, _, params, _, _ = tiny_obj if objects else tiny
    model = GridMMPretrain(port_config(jcfg).model)
    tree = jax.tree.map(np.asarray, params)
    sd = flax_to_state_dict(tree, model)
    assert set(sd) == set(model.state_dict())
    assert any(k.startswith("bert.og_head.") for k in sd) == objects
    assert any(".lang_ffn." in k for k in sd)
    assert not any(k.startswith("bert.grid_txt_encoder.") and ".lang_" in k
                   for k in sd)

    extra = jax.tree.map(np.asarray, params)
    extra["params"]["obj_classifier"] = {"net_0": {"bias": np.zeros(4)}}
    with pytest.raises(KeyError, match="obj_classifier"):
        flax_to_state_dict(extra, model)
    missing = jax.tree.map(np.asarray, params)
    del missing["params"]["mlm_head"]["bias"]
    with pytest.raises(KeyError, match="mlm_head.bias"):
        flax_to_state_dict(missing, model)


def test_mlm_decoder_is_tied_to_the_word_table(tiny):
    """The port's state dict has no MLM decoder weight (no (vocab, hidden)
    or (hidden, vocab) leaf under mlm_head), and a change to the word table
    moves the MLM logits."""
    jcfg, _, params, jbatch, _ = tiny
    model = port_model(jcfg, params)
    m = jcfg.model
    for name, t in model.state_dict().items():
        if name.startswith("mlm_head."):
            assert tuple(t.shape) not in ((m.vocab_size, m.hidden_size),
                                          (m.hidden_size, m.vocab_size)), name
    assert sorted(k for k in model.state_dict()
                  if k.startswith("mlm_head.")) == [
        "mlm_head.bias", "mlm_head.transform_LayerNorm.bias",
        "mlm_head.transform_LayerNorm.weight",
        "mlm_head.transform_dense.bias", "mlm_head.transform_dense.weight"]
    b = port_batch(jbatch)
    with torch.no_grad():
        before = model.forward_mlm_logits(b.txt_ids, b.txt_mask,
                                          TPT._enc_kwargs(b))
        # rows never looked up by the batch: only the decoder reads them
        unused = sorted(set(range(m.vocab_size))
                        - set(to_numpy(b.txt_ids).ravel().tolist()))[:5]
        # not a constant shift: LayerNorm's output sums to ~0, so a shift
        # of a row barely moves its logit
        model.bert.embeddings.word_embeddings.weight[unused] += torch.randn(
            len(unused), m.hidden_size,
            generator=torch.Generator().manual_seed(0))
        after = model.forward_mlm_logits(b.txt_ids, b.txt_mask,
                                         TPT._enc_kwargs(b))
    moved = (after - before).abs().amax(dim=(0, 1))
    assert (moved[unused] > 1e-3).all()
    others = torch.ones(m.vocab_size, dtype=torch.bool)
    others[unused] = False
    assert torch.equal(after[..., others], before[..., others])


# ------------------------------------------------------- language branch
def test_lang2visn_branch_matches_jax():
    """CrossmodalEncoder with the language branch on: lang2visn and the
    visual path within 1e-5 of the JAX layers (gridmm_tpu/models/
    layers.py:213-278), at 2 layers with masked keys on both sides."""
    mcfg = pretrain_cfg().model
    rng = np.random.default_rng(0)
    b, lt, lv, h = 2, 7, 9, mcfg.hidden_size
    txt = rng.standard_normal((b, lt, h)).astype(np.float32)
    visn = rng.standard_normal((b, lv, h)).astype(np.float32)
    tmask = np.arange(lt)[None] < np.array([[7], [4]])
    vmask = np.arange(lv)[None] < np.array([[6], [9]])
    jenc = JLY.CrossmodalEncoder(mcfg, 2)

    def both(mdl, t, tm, v, vm):
        return mdl(t, tm, v, vm), mdl.lang2visn(t, tm, v, vm)

    params = jenc.init(jax.random.PRNGKey(3), txt, tmask, visn, vmask,
                       method=both)
    want_v, want_l = jenc.apply(params, txt, tmask, visn, vmask, method=both)
    tenc = TLY.CrossmodalEncoder(port_config(pretrain_cfg()).model, 2,
                                 lang_branch=True)
    load_flax_params(tenc, jax.tree.map(np.asarray, params))
    args = to_torch((txt, tmask, visn, vmask))
    with torch.no_grad():
        got_v = tenc(*args)
        got_l = tenc.lang2visn(*args)
    assert_close(got_v, want_v, rtol=1e-5, atol=1e-5)
    assert_close(got_l, want_l, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ the model
@functools.lru_cache(maxsize=None)
def _jax_outputs(jmodel, objects):
    """The JAX package's trunk, encodings and the four tasks' logits,
    jitted once per module (one compile is faster than running eagerly)."""
    def run(params, jb):
        def ap(method, *a, **k):
            return jmodel.apply(params, *a, method=method, **k)

        jkw = JPT._enc_kwargs(jb)
        trunk = ap(JPretrain._encode_trunk, jb.txt_ids, jb.txt_mask, **jkw,
                   deterministic=True)
        enc = ap(JPretrain.encode, jb.txt_ids, jb.txt_mask, **jkw)
        mlm = ap(JPretrain.forward_mlm_logits, jb.txt_ids, jb.txt_mask, jkw)
        mrc = ap(JPretrain.forward_mrc_logits, enc)
        sap = ap(JPretrain.forward_sap_logits, enc, jb.gmap_mask,
                 jb.gmap_visited_mask, jb.vp_nav_mask, jb.fused_add_idx,
                 jb.cand_backtrack_mask)
        og = (ap(JPretrain.forward_og_logits, enc, jb.vp_obj_mask)
              if objects else None)
        return trunk, enc, mlm, mrc, sap, og

    return jax.jit(run)


@pytest.mark.parametrize("objects", [False, True], ids=["r2r", "objects"])
def test_encode_and_task_logits_match_jax(objects, tiny, tiny_obj):
    """encode's outputs and the MLM, MRC, SAP (four heads) and OG logits
    within 1e-5; the cell mask, vp mask and stray counts bit-exact (the
    stray token fires: the items occupy different cell counts)."""
    jcfg, jmodel, params, jbatch, _ = tiny_obj if objects else tiny
    model = port_model(jcfg, params)
    b = port_batch(jbatch)
    trunk, enc, want_mlm, want_mrc, want_sap, want_og = _jax_outputs(
        jmodel, objects)(params, jbatch)
    with torch.no_grad():
        got_trunk = model._encode_trunk(b.txt_ids, b.txt_mask,
                                        **TPT._enc_kwargs(b))
        got = model.encode(b.txt_ids, b.txt_mask, **TPT._enc_kwargs(b))
    for i, name in enumerate(("txt", "gmap", "vp", "vp_mask", "grid",
                              "cell_mask")):
        if name.endswith("mask"):
            np.testing.assert_array_equal(to_numpy(got_trunk[i]),
                                          np.asarray(trunk[i]), err_msg=name)
        else:
            assert_close(got_trunk[i], trunk[i], msg=name)
    want_stray = np.asarray(j_stray(trunk[5]))
    got_stray = to_numpy(compaction_stray_count(got_trunk[5]))
    np.testing.assert_array_equal(got_stray, want_stray)
    assert got_stray.dtype == want_stray.dtype
    for f in enc._fields:
        if f == "vp_mask":
            np.testing.assert_array_equal(to_numpy(got.vp_mask),
                                          np.asarray(enc.vp_mask))
        else:
            assert_close(getattr(got, f), getattr(enc, f), msg=f)

    sap_args = (jbatch.gmap_mask, jbatch.gmap_visited_mask,
                jbatch.vp_nav_mask, jbatch.fused_add_idx,
                jbatch.cand_backtrack_mask)
    with torch.no_grad():
        got_mlm = model.forward_mlm_logits(b.txt_ids, b.txt_mask,
                                           TPT._enc_kwargs(b))
        got_mrc = model.forward_mrc_logits(got)
        got_sap = model.forward_sap_logits(got, *to_torch(sap_args))
    assert_close(got_mlm, want_mlm, msg="mlm")
    assert_close(got_mrc, want_mrc, msg="mrc")
    for name, g_, w_ in zip(("global", "local", "fused", "grid"), got_sap,
                            want_sap):
        assert_close(g_, w_, msg=name)
    if objects:
        with torch.no_grad():
            got_og = model.forward_og_logits(got, b.vp_obj_mask)
        assert_close(got_og, want_og, msg="og")
        assert np.isfinite(to_numpy(got_og)).sum() == 6


@pytest.mark.parametrize("task", TASKS)
def test_task_loss_and_gradients_match_jax(task, tiny, tiny_obj):
    """Each task's loss within 1e-5 relative and every parameter's gradient
    within 1e-4 of the leaf's max, against jax.grad (OG with objects)."""
    jcfg, jmodel, params, jbatch, _ = tiny_obj if task == "og" else tiny
    model = port_model(jcfg, params)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: JPT.task_loss(jmodel, p, jbatch, task)))(params)
    model.zero_grad(set_to_none=True)
    loss = TPT.task_loss(model, port_batch(jbatch), task)
    loss.backward()
    got_grads = to_flax_tree({n: p.grad for n, p in model.named_parameters()},
                             params)
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    assert loss.item() > 0
    _assert_tree_close(got_grads, want_grads, 1e-4, f"{task} vs jax.grad")
    reached = [v[1] > 0 for v in _leaf_errors(got_grads, want_grads).values()]
    assert sum(reached) > 0.5 * len(reached)


def test_unknown_task_raises(tiny):
    jcfg, _, params, jbatch, _ = tiny
    with pytest.raises(ValueError, match="nav"):
        TPT.task_loss(port_model(jcfg, params), port_batch(jbatch), "nav")


def test_gmap_aggregation_drops_slots_past_the_gmap_like_jax():
    """_aggregate_gmap with slots past G and masked tokens: within 1e-6 of
    the JAX scatter-mean, which drops an out-of-range slot."""
    rng = np.random.default_rng(2)
    b, s, v, d, g = 2, 3, 5, 8, 6
    pano = rng.standard_normal((b, s, v, d)).astype(np.float32)
    mask = rng.random((b, s, v)) < 0.8
    vis = rng.integers(-1, g + 3, size=(b, s, v)).astype(np.int32)
    cand = rng.integers(-1, g + 3, size=(b, s, v)).astype(np.int32)
    want = JPretrain._aggregate_gmap(jnp.asarray(pano), jnp.asarray(mask),
                                     jnp.asarray(vis), jnp.asarray(cand), g)
    got = GridMMPretrain._aggregate_gmap(*to_torch((pano, mask, vis, cand)),
                                         g)
    assert_close(got, want, rtol=0, atol=1e-6)


# -------------------------------------------------------------- updates
def _params_tree(model, template):
    return to_flax_tree(dict(model.named_parameters()), template)


@pytest.mark.parametrize("task", ["sap", "mlm"])
def test_pretrain_step_matches_jax(task, tiny):
    """Two make_pretrain_step updates (AdamW, clip 40): loss and grad norm
    within 1e-5 relative, the parameters within 1e-6 of each leaf's max."""
    jcfg, jmodel, params, jbatch, jbatch2 = tiny
    tcfg = port_config(jcfg)
    model = port_model(jcfg, params)
    jstep = jax.jit(JPT.make_pretrain_step(jmodel, jcfg, task))
    jstate = JS.create_train_state(jcfg, params)
    tstate = TS.create_train_state(tcfg, model)
    tstep = TPT.make_pretrain_step(tcfg, task)
    for i, jb in enumerate((jbatch, jbatch2)):
        jstate, want = jstep(jstate, jb, jax.random.PRNGKey(0))
        got = tstep(tstate, port_batch(jb), seed=0)
        for k in (f"loss_{task}", "grad_norm"):
            assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5), \
                (i, k)
        _assert_tree_close(_params_tree(model, params), jstate.params, 1e-6,
                           f"parameters after update {i + 1}")
    assert tstate.step == 2 and int(jstate.step) == 2


def test_pretrain_accum_step_matches_jax(tiny):
    """One accumulation window of 2 microbatches (losses scaled by 1/2,
    gradients summed, one AdamW step): loss and grad norm within 1e-5
    relative, the parameters within 1e-6 of each leaf's max; a window of
    the wrong length raises."""
    jcfg, jmodel, params, jbatch, jbatch2 = tiny
    tcfg = port_config(jcfg)
    model = port_model(jcfg, params)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), jbatch, jbatch2)
    jstate, want = jax.jit(JPT.make_pretrain_accum_step(
        jmodel, jcfg, "mrc", accum=2))(JS.create_train_state(jcfg, params),
                                       stacked, jax.random.PRNGKey(0))
    tstate = TS.create_train_state(tcfg, model)
    step = TPT.make_pretrain_accum_step(tcfg, "mrc", accum=2)
    got = step(tstate, [port_batch(jbatch), port_batch(jbatch2)], seed=0)
    for k in ("loss_mrc", "grad_norm"):
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5), k
    _assert_tree_close(_params_tree(model, params), jstate.params, 1e-6,
                       "parameters after the window")
    with pytest.raises(ValueError, match="window of 2"):
        step(tstate, [port_batch(jbatch)], seed=0)


def test_accum_step_dropout_differs_per_microbatch(tiny):
    """With dropout on, two equal microbatches draw different masks (their
    losses differ), and a rerun from the same weights and seed repeats
    them."""
    jcfg, _, params, jbatch, _ = tiny
    cfg = port_config(JC.tiny_config())
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, image_prob_size=32))

    def run():
        model = GridMMPretrain(cfg.model)
        load_flax_params(model, jax.tree.map(np.asarray, params))
        state = TS.create_train_state(cfg, model.train())
        losses = []
        orig = TPT.task_loss

        def spy(*a):
            out = orig(*a)
            losses.append(out.item())
            return out

        TPT.task_loss = spy
        try:
            TPT.make_pretrain_accum_step(cfg, "sap", accum=2)(
                state, [port_batch(jbatch)] * 2, seed=5)
        finally:
            TPT.task_loss = orig
        return losses

    first, again = run(), run()
    assert first[0] != first[1]
    assert first == again


@pytest.mark.parametrize("accum", [1, 3])
def test_task_multiplexer_matches_jax(accum):
    """The first 64 tasks equal, with the accumulation window held."""
    tasks, mix = ["mlm", "mrc", "sap", "og"], [5, 2, 3, 1]
    want = JPT.TaskMultiplexer(tasks, mix, seed=11, accum_steps=accum)
    got = TPT.TaskMultiplexer(tasks, mix, seed=11, accum_steps=accum)
    wi, gi = iter(want), iter(got)
    seq = [next(gi) for _ in range(64)]
    assert seq == [next(wi) for _ in range(64)]
    assert set(seq) == set(tasks)
    for i in range(0, 64, accum):
        assert len(set(seq[i:i + accum])) == 1


def test_init_pretrain_params_builds_every_head(tiny_obj):
    """The port's init builds exactly the parameters the JAX package's init
    materializes by running every task, seeded: two inits with one seed are
    equal, another seed differs."""
    jcfg, _, params, _, _ = tiny_obj
    tcfg = port_config(jcfg)
    a = TPT.init_pretrain_params(tcfg.model, seed=3, device="cpu")
    b = TPT.init_pretrain_params(tcfg.model, seed=3, device="cpu")
    c = TPT.init_pretrain_params(tcfg.model, seed=4, device="cpu")
    sd = flax_to_state_dict(jax.tree.map(np.asarray, params), a)
    assert set(sd) == set(a.state_dict())
    assert not a.training
    w = "bert.embeddings.word_embeddings.weight"
    assert torch.equal(a.state_dict()[w], b.state_dict()[w])
    assert not torch.equal(a.state_dict()[w], c.state_dict()[w])

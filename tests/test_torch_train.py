"""Port vs JAX package: the training path on the CPU, at tiny width.

The pool's plain backward against the Pallas backward kernels (interpret
mode) and the XLA VJP; the losses; `stacked_point_state`; the synthetic
trajectory batch; the teacher-forced trajectory loss and its gradients
against `jax.grad`, leaf by leaf, with the weights carried by
gridmm_tpu_torch.convert; one `make_train_step` and one `make_dagger_step`
update. Dropout is off on both sides (its masks cannot match). Tolerances
are stated at each test.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import gridmm_tpu.config as JC  # noqa: E402
import gridmm_tpu.ops.geometry as JG  # noqa: E402
import gridmm_tpu.ops.grid_pool as JP  # noqa: E402
import gridmm_tpu.train.losses as JL  # noqa: E402
import gridmm_tpu.train.step as JS  # noqa: E402
import gridmm_tpu.train.synthetic as JSYN  # noqa: E402
import gridmm_tpu_torch.ops.geometry as TG  # noqa: E402
import gridmm_tpu_torch.ops.grid_pool as TP  # noqa: E402
import gridmm_tpu_torch.train.losses as TL  # noqa: E402
import gridmm_tpu_torch.train.step as TS  # noqa: E402
import gridmm_tpu_torch.train.synthetic as TSYN  # noqa: E402
from gridmm_tpu.ops.pallas.grid_pool_kernel import (  # noqa: E402
    pallas_grid_pool_bwd, pallas_grid_pool_raw)
from gridmm_tpu_torch.convert import to_flax_tree  # noqa: E402
from torch_parity import (assert_close, jax_navigator, port_config,  # noqa: E402
                          port_navigator, to_numpy, to_torch)


# ------------------------------------------------------------ pool backward
def bwd_case(b=3, n=3 * 588, d=128, seed=0):
    """Random cells with ~5% invalid; row 1 all-invalid; cell 7 of row 2
    holds one point (index 100); cells 0..49 of row 0 are empty. N = 3*588
    is the stacked buffer's length after three steps (not a multiple of
    512)."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((b, n, d)).astype(np.float32)
    cells = rng.integers(0, 196, size=(b, n)).astype(np.int32)
    cells[rng.random((b, n)) < 0.05] = -1
    w = rng.standard_normal((b, n)).astype(np.float32)
    cells[1] = -1
    cells[2][cells[2] == 7] = 8
    cells[2, 100] = 7
    cells[0][(cells[0] >= 0) & (cells[0] < 50)] = 60
    cot = rng.standard_normal((b, 196, d)).astype(np.float32)
    return g, cells, w, cot


def test_pool_bwd_plain_matches_pallas_interpret_and_xla_vjp():
    """f32 within 1e-5 absolute on O(1) inputs; the one-point cell's dw is 0
    within 1e-6; invalid points get exact zeros."""
    g, cells, w, cot = bwd_case()
    n = g.shape[1]
    tg, tc, tw, tcot = to_torch((g, cells, w, cot))
    _, _, denom = TP.grid_scatter_pool_raw(tg, tc, tw)
    got_dg, got_dw = TP.grid_pool_bwd_plain(tg, tc, tw, denom, tcot)

    # the Pallas pair, as the custom VJP drives it (ops/grid_pool._pallas_bwd)
    jf, jc, jw, chunk = JP._chunk_and_pad_cap(
        jnp.asarray(g), jnp.asarray(cells), jnp.asarray(w), 1024)
    _, _, jdenom = pallas_grid_pool_raw(jf, jc, jw, chunk=chunk,
                                        interpret=True)
    k_dg, k_dw = pallas_grid_pool_bwd(jf, jc, jw, jdenom, jnp.asarray(cot),
                                      chunk=chunk, interpret=True)
    assert_close(got_dg, k_dg[:, :n], rtol=0, atol=1e-5)
    assert_close(got_dw, k_dw[:, :n], rtol=0, atol=1e-5)

    # the XLA VJP of the plain JAX pool
    _, vjp = jax.vjp(lambda f, ww: JP.grid_scatter_pool(
        f, jnp.asarray(cells), ww)[0], jnp.asarray(g), jnp.asarray(w))
    x_dg, x_dw = vjp(jnp.asarray(cot))
    assert_close(got_dg, x_dg, rtol=0, atol=1e-5)
    assert_close(got_dw, x_dw, rtol=0, atol=1e-5)

    assert (got_dg[1] == 0).all() and (got_dw[1] == 0).all()
    invalid = tc < 0
    assert (got_dg[invalid] == 0).all() and (got_dw[invalid] == 0).all()
    assert abs(float(got_dw[2, 100])) <= 1e-6
    assert got_dg.dtype == torch.float32 and got_dw.dtype == torch.float32


def test_pool_function_matches_autograd_of_plain_forward():
    """GridPoolFunction on the CPU (analytic backward) against autograd
    through the plain forward: within 1e-5 absolute."""
    g, cells, w, cot = bwd_case(b=3, n=700, d=32, seed=1)
    tc, tcot = to_torch((cells, cot))
    grads = []
    for pool in (TP.grid_pool, TP.grid_scatter_pool):
        tg = torch.from_numpy(g).requires_grad_()
        tw = torch.from_numpy(w).requires_grad_()
        pooled, mask = pool(tg, tc, tw)
        assert not mask.requires_grad
        pooled.backward(tcot)
        grads.append((tg.grad, tw.grad))
    assert_close(grads[0][0], grads[1][0], rtol=0, atol=1e-5)
    assert_close(grads[0][1], grads[1][1], rtol=0, atol=1e-5)


def test_pool_function_gradcheck_f64():
    rng = np.random.default_rng(2)
    b, n, d, c = 2, 24, 3, 5
    g = torch.tensor(rng.standard_normal((b, n, d)), requires_grad=True)
    w = torch.tensor(rng.standard_normal((b, n)), requires_grad=True)
    cells = torch.tensor(rng.integers(-1, c, size=(b, n)).astype(np.int32))
    cells[1, :] = torch.where(cells[1] == 2, torch.tensor(3, dtype=torch.int32),
                              cells[1])      # an empty cell
    assert g.dtype == torch.float64
    assert torch.autograd.gradcheck(
        lambda f, ww: TP.grid_pool_raw(f, cells, ww, c)[0], (g, w),
        eps=1e-6, atol=1e-6)


def test_pool_bwd_bf16_features_give_bf16_gradient():
    g, cells, w, cot = bwd_case(b=3, n=600, d=32, seed=3)
    tg = torch.from_numpy(g).to(torch.bfloat16).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    pooled, _ = TP.grid_pool(tg, torch.from_numpy(cells), tw)
    assert pooled.dtype == torch.float32
    pooled.backward(torch.from_numpy(cot))
    assert tg.grad.dtype == torch.bfloat16 and tw.grad.dtype == torch.float32
    ref_g = tg.detach().float().requires_grad_()
    ref_w = torch.from_numpy(w).requires_grad_()
    TP.grid_pool(ref_g, torch.from_numpy(cells), ref_w)[0].backward(
        torch.from_numpy(cot))
    # the f32 gradient of the same bf16-valued features, rounded once
    assert torch.equal(tg.grad, ref_g.grad.to(torch.bfloat16))
    assert_close(tw.grad, ref_w.grad, rtol=0, atol=1e-6)


def test_pool_under_inference_mode_saves_nothing():
    g, cells, w, _ = bwd_case(b=3, n=600, d=32, seed=4)
    with torch.inference_mode():
        pooled, mask = TP.grid_pool(*to_torch((g, cells, w)))
    assert pooled.grad_fn is None and not pooled.requires_grad
    want, want_m = TP.grid_scatter_pool(*to_torch((g, cells, w)))
    assert torch.equal(pooled, want) and torch.equal(mask, want_m)


# -------------------------------------------------------------------- losses
def _logits_case(seed=0, b=6, n=9):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, n)).astype(np.float32) * 3.0
    logits[rng.random((b, n)) < 0.3] = -np.inf
    logits[:, 0] = rng.standard_normal(b)         # one finite slot per row
    logits[4] = -np.inf                           # a fully masked row
    targets = rng.integers(0, n, size=b).astype(np.int32)
    for i in range(b):                            # labels on finite slots
        targets[i] = int(np.flatnonzero(np.isfinite(logits[i]))[-1]) \
            if np.isfinite(logits[i]).any() else 0
    targets[1] = -100
    targets[4] = -100
    return logits, targets


@pytest.mark.parametrize("reduction", ["sum", "mean", "none"])
def test_cross_entropy_ignore_and_masked_log_softmax(reduction):
    """within 1e-6, with -inf logits, a fully masked row and ignored rows."""
    logits, targets = _logits_case()
    assert_close(TL.masked_log_softmax(torch.from_numpy(logits)),
                 JL.masked_log_softmax(jnp.asarray(logits)),
                 rtol=1e-6, atol=1e-6)
    got = TL.cross_entropy_ignore(torch.from_numpy(logits),
                                  torch.from_numpy(targets), -100, reduction)
    want = JL.cross_entropy_ignore(jnp.asarray(logits), jnp.asarray(targets),
                                   -100, reduction)
    assert_close(got, want, rtol=1e-6, atol=1e-6)
    all_ignored = np.full_like(targets, -100)
    got = TL.cross_entropy_ignore(torch.from_numpy(logits),
                                  torch.from_numpy(all_ignored), -100,
                                  reduction)
    assert float(got.abs().sum()) == 0.0


def test_cross_entropy_gradient_matches_jax():
    logits, targets = _logits_case(seed=1)
    t = torch.from_numpy(logits).requires_grad_()
    TL.cross_entropy_ignore(t, torch.from_numpy(targets)).backward()
    want = jax.grad(lambda x: JL.cross_entropy_ignore(
        x, jnp.asarray(targets)))(jnp.asarray(logits))
    assert np.isfinite(to_numpy(t.grad)).all()
    assert_close(t.grad, want, rtol=1e-6, atol=1e-6)


def test_mlm_mrc_and_sap_losses():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, size=(2, 7)).astype(np.int32)
    labels[rng.random((2, 7)) < 0.6] = -1
    assert_close(TL.mlm_loss(*to_torch((logits, labels))),
                 JL.mlm_loss(jnp.asarray(logits), jnp.asarray(labels)),
                 rtol=1e-6, atol=1e-6)
    labels[:] = -1                                 # nothing masked
    assert float(TL.mlm_loss(*to_torch((logits, labels)))) == 0.0

    pred = rng.standard_normal((3, 5, 8)).astype(np.float32)
    soft = rng.random((3, 5, 8)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    soft[0, 0] = 0.0
    soft[0, 0, 2] = 1.0                            # a hard label: log(0) terms
    mask = rng.random((3, 5)) < 0.5
    mask[0, 0] = True
    assert_close(TL.mrc_kl_loss(*to_torch((pred, soft, mask))),
                 JL.mrc_kl_loss(*map(jnp.asarray, (pred, soft, mask))),
                 rtol=1e-6, atol=1e-6)

    heads = [_logits_case(seed=s, b=8)[0] for s in range(4)]
    for h in heads:
        h[4] = heads[0][0]                         # no fully masked rows
    for acts in (np.array([0, 3, 0, 2, 1, 0, 5, 0], np.int32),
                 np.zeros(8, np.int32)):           # all stop: n_go == 0
        for h in heads:
            h[np.arange(8), acts] = 0.5            # labelled slots finite
        got = TL.sap_loss(*to_torch(heads), *to_torch((acts, acts)))
        want = JL.sap_loss(*map(jnp.asarray, heads), jnp.asarray(acts),
                           jnp.asarray(acts))
        assert_close(got, want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ geometry
def test_stacked_state_prefix_matches_incremental_buffer():
    """The append_panorama chain against a prefix of the stacked buffer, bit
    for bit inside the port; against the JAX stacked buffer every field is
    equal except xy, within 2e-6 m."""
    jcfg = JC.tiny_config()
    tcfg = port_config(jcfg)
    gc = tcfg.grid
    rng = np.random.default_rng(7)
    s, b, pp, d = 3, 2, gc.points_per_step, gc.feature_dim
    depth = rng.integers(0, 18000, size=(s, b, gc.num_views,
                                         gc.patches_per_view)
                         ).astype(np.float32)
    feats = rng.standard_normal((b, s * pp, d)).astype(np.float32)
    w = rng.standard_normal((b, s * pp)).astype(np.float32)
    pos = rng.uniform(-5, 5, size=(s, b, 2)).astype(np.float32)
    head = rng.uniform(-3, 3, size=(s, b)).astype(np.float32)

    stacked = TG.stacked_point_state(*to_torch((depth, feats, w, pos, head)),
                                     gc)
    want = JG.stacked_point_state(*map(jnp.asarray, (depth, feats, w, pos,
                                                     head)), jcfg.grid)
    for f in stacked._fields:
        if f == "xy":   # sin/cos and fused multiply-adds differ in the last bit
            assert_close(stacked.xy, want.xy, rtol=0, atol=2e-6)
            continue
        np.testing.assert_array_equal(to_numpy(getattr(stacked, f)),
                                      np.asarray(getattr(want, f)), err_msg=f)

    state = TG.PointCloudState.create(b, gc, s * pp, device="cpu")
    for t in range(s):
        state = TG.append_panorama(
            state, torch.from_numpy(depth[t]),
            torch.from_numpy(feats[:, t * pp:(t + 1) * pp]),
            torch.from_numpy(pos[t]), gc,
            torch.from_numpy(w[:, t * pp:(t + 1) * pp]),
            headings=torch.from_numpy(head[t]))
        k = (t + 1) * pp
        for f in ("xy", "features", "weights", "valid", "inserted"):
            assert torch.equal(getattr(state, f)[:, :k],
                               getattr(stacked, f)[:, :k]), (t, f)
        inc = TG.egocentric_grid_assignment(
            state, torch.from_numpy(pos[t]), torch.from_numpy(head[t]), gc)
        pre = TG.egocentric_grid_assignment(
            stacked, torch.from_numpy(pos[t]), torch.from_numpy(head[t]), gc,
            num_active=k)
        assert torch.equal(inc[0][:, :k], pre[0][:, :k])
        assert (pre[0][:, k:] == -1).all()
        assert torch.equal(inc[1], pre[1]) and torch.equal(inc[2], pre[2])

    # out of place: gradients reach the features and the weights
    tf = torch.from_numpy(feats).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    st = TG.stacked_point_state(torch.from_numpy(depth), tf, tw,
                                torch.from_numpy(pos), torch.from_numpy(head),
                                gc)
    (st.features.sum() + st.weights.sum()).backward()
    assert (tf.grad == 1).all() and (tw.grad == 1).all()


# ----------------------------------------------------------------- synthetic
def test_synthetic_trajectory_batch_equals_jax_batch():
    jcfg = JC.tiny_config()
    got = TSYN.synthetic_trajectory_batch(port_config(jcfg), 3, 4, seed=5,
                                          device="cpu")
    want = JSYN.synthetic_trajectory_batch(jcfg, 3, 4, seed=5)
    np.testing.assert_array_equal(to_numpy(got.txt_ids),
                                  np.asarray(want.txt_ids))
    np.testing.assert_array_equal(to_numpy(got.txt_mask),
                                  np.asarray(want.txt_mask))
    for f in TS.StepInputs._fields:
        a, ref = to_numpy(getattr(got.steps, f)), np.asarray(
            getattr(want.steps, f))
        assert a.dtype == ref.dtype, (f, a.dtype, ref.dtype)
        np.testing.assert_array_equal(a, ref, err_msg=f)


# --------------------------------------------------- trajectory loss, grads
def _no_dropout(jcfg, **train):
    """The config with every dropout probability 0 (make_train_step always
    hands the JAX loss a key) and the given train fields."""
    return dataclasses.replace(
        jcfg,
        model=dataclasses.replace(jcfg.model, hidden_dropout_prob=0.0,
                                  attention_probs_dropout_prob=0.0,
                                  feat_dropout=0.0),
        train=dataclasses.replace(jcfg.train, **train))


@pytest.fixture(scope="module")
def tiny():
    """(jax cfg, flax module, params, numpy-seeded batches). adam_eps is
    1e-2: with the default 1e-6 Adam's first update is lr * sign(g)
    wherever |g| >> eps, so f32 noise on an analytically zero gradient (the
    bias added to every logit of a softmax) would decide a whole +-lr."""
    jcfg = _no_dropout(JC.tiny_config(), adam_eps=1e-2)
    jmodel, params = jax_navigator(jcfg, seed=0)
    batches = [JSYN.synthetic_trajectory_batch(jcfg, 2, 3, seed=s)
               for s in (0, 1)]
    return jcfg, jmodel, params, batches


def _port_batch(jbatch):
    return TS.batch_to_device(jax.tree.map(np.array, jbatch), "cpu")


def _leaf_errors(got_tree, want_tree):
    """{path: (max|diff|, max|want|)} over the flax leaves."""
    got = dict(jax.tree_util.tree_flatten_with_path(got_tree)[0])
    out = {}
    for path, want in jax.tree_util.tree_flatten_with_path(want_tree)[0]:
        want = np.asarray(want)
        out[jax.tree_util.keystr(path)] = (
            float(np.abs(np.asarray(got[path]) - want).max()),
            float(np.abs(want).max()))
    return out


def _assert_tree_close(got_tree, want_tree, rel, what):
    """Every leaf within `rel` of the leaf's own max (plus 1e-8)."""
    bad = {k: v for k, v in _leaf_errors(got_tree, want_tree).items()
           if not v[0] <= rel * v[1] + 1e-8}
    assert not bad, f"{what}: {len(bad)} leaves differ, e.g. " \
        f"{sorted(bad.items(), key=lambda kv: -kv[1][0])[:3]}"


def _port_grads(model, tcfg, batch, template):
    model.zero_grad(set_to_none=True)
    loss = TS.trajectory_loss(model, tcfg, batch)
    loss.backward()
    grads = to_flax_tree({n: p.grad for n, p in model.named_parameters()},
                         template)
    return float(loss), grads


def test_trajectory_loss_and_gradients_match_jax(tiny):
    """Same weights, same batch, dropout off. Loss within 1e-5 relative;
    every parameter's gradient within 1e-4 of the leaf's max, against
    jax.grad (stacked) and between the port's stacked and incremental
    formulations, with and without per-step recomputation."""
    jcfg, jmodel, params, (jbatch, _) = tiny
    tcfg = port_config(jcfg)
    tmodel = port_navigator(tcfg, params)
    batch = _port_batch(jbatch)

    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: JS.trajectory_loss(jmodel, jcfg, p, jbatch)))(params)
    got_loss, got_grads = _port_grads(tmodel, tcfg, batch, params)
    assert got_loss == pytest.approx(float(want_loss), rel=1e-5)
    _assert_tree_close(got_grads, want_grads, 1e-4, "stacked vs jax.grad")
    errs = _leaf_errors(got_grads, want_grads)
    assert sum(v[1] > 0 for v in errs.values()) > 0.8 * len(errs)

    for train in (dict(stacked_replay=False),
                  dict(stacked_replay=False, remat_steps=False),
                  dict(remat_steps=False)):
        cfg2 = dataclasses.replace(
            tcfg, train=dataclasses.replace(tcfg.train, **train))
        loss2, grads2 = _port_grads(tmodel, cfg2, batch, params)
        assert loss2 == pytest.approx(got_loss, rel=1e-5), train
        _assert_tree_close(grads2, got_grads, 1e-4, f"{train} vs stacked")


@pytest.mark.parametrize("train", [dict(loss_norm="actions"),
                                   dict(stop_extra_ce=True),
                                   dict(loss_head="global")],
                         ids=["loss_norm_actions", "stop_extra_ce",
                              "global_head"])
def test_trajectory_loss_variants_match_jax(tiny, train):
    """loss within 1e-5 relative for the other normalisation (VLN-CE's
    per-action mean), RxR's doubled stop CE and another head; ml_weight."""
    jcfg, jmodel, params, (jbatch, _) = tiny
    jcfg = _no_dropout(jcfg, **train)
    tcfg = port_config(jcfg)
    tmodel = port_navigator(tcfg, params)
    batch = _port_batch(jbatch)
    for ml_weight in (None, 1.0):
        want = JS.trajectory_loss(jmodel, jcfg, params, jbatch,
                                  ml_weight=ml_weight)
        with torch.no_grad():
            got = TS.trajectory_loss(tmodel, tcfg, batch, ml_weight=ml_weight)
        assert float(got) == pytest.approx(float(want), rel=1e-5)


def test_ce_loss_head_raises_until_ported(tiny):
    jcfg, _, params, (jbatch, _) = tiny
    tcfg = port_config(_no_dropout(jcfg, loss_head="ce"))
    with pytest.raises(NotImplementedError, match="ce/device_step"):
        TS.trajectory_loss(port_navigator(tcfg, params), tcfg,
                           _port_batch(jbatch))


def test_buffer_overflow_raises(tiny):
    jcfg, _, params, _ = tiny
    tcfg = port_config(jcfg)
    steps = tcfg.shapes.max_points // tcfg.grid.points_per_step + 1
    batch = TSYN.synthetic_trajectory_batch(tcfg, 1, steps, device="cpu")
    with pytest.raises(ValueError, match="point buffer overflow"):
        TS.trajectory_loss(port_navigator(tcfg, params), tcfg, batch)


def _params_tree(model, template):
    return to_flax_tree(dict(model.named_parameters()), template)


def test_train_step_update_matches_jax(tiny):
    """Two make_train_step updates (AdamW, clip 40): loss and grad-norm
    within 1e-5 relative, updated parameters within 1e-5 of each leaf's
    max."""
    jcfg, jmodel, params, (jbatch, jbatch2) = tiny
    tcfg = port_config(jcfg)
    tmodel = port_navigator(tcfg, params)
    jstep = jax.jit(JS.make_train_step(jmodel, jcfg))
    jstate = JS.create_train_state(jcfg, params)
    tstate = TS.create_train_state(tcfg, tmodel)
    tstep = TS.make_train_step(tcfg)
    for i, jb in enumerate((jbatch, jbatch2)):
        jstate, want = jstep(jstate, jb, jax.random.PRNGKey(0))
        got = tstep(tstate, _port_batch(jb), seed=0)
        for k in ("loss", "grad_norm"):
            assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5), \
                (i, k)
        _assert_tree_close(_params_tree(tmodel, params), jstate.params, 1e-5,
                           f"parameters after update {i + 1}")
    assert tstate.step == 2 and int(jstate.step) == 2


def test_dagger_step_update_matches_jax(tiny):
    """One make_dagger_step update: teacher loss (ml_weight) + sample loss
    (weight 1) summed into one clipped AdamW update."""
    jcfg, jmodel, params, (jbatch, jbatch2) = tiny
    tcfg = port_config(jcfg)
    tmodel = port_navigator(tcfg, params)
    jstate, want = jax.jit(JS.make_dagger_step(jmodel, jcfg))(
        JS.create_train_state(jcfg, params), jbatch, jbatch2,
        jax.random.PRNGKey(0))
    tstate = TS.create_train_state(tcfg, tmodel)
    got = TS.make_dagger_step(tcfg)(tstate, _port_batch(jbatch),
                                    _port_batch(jbatch2), seed=0)
    for k in ("loss", "loss_teacher", "loss_sample", "grad_norm"):
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5), k
    _assert_tree_close(_params_tree(tmodel, params), jstate.params, 1e-5,
                       "parameters after the dagger update")


def test_train_step_dropout_is_seeded_and_replayed_under_remat(tiny):
    """With dropout on, the same (seed, step) gives the same loss and
    gradients (also with per-step recomputation, which must replay the
    masks), another seed gives another loss, and the caller's generator is
    left as it was."""
    jcfg, _, params, (jbatch, _) = tiny
    tcfg = port_config(JC.tiny_config())
    batch = _port_batch(jbatch)

    def run(seed, remat):
        cfg = dataclasses.replace(
            tcfg, train=dataclasses.replace(tcfg.train, remat_steps=remat))
        model = port_navigator(cfg, params).train()
        state = TS.create_train_state(cfg, model)
        before = torch.random.get_rng_state()
        out = TS.make_train_step(cfg)(state, batch, seed=seed)
        assert torch.equal(torch.random.get_rng_state(), before)
        return float(out["loss"]), float(out["grad_norm"])

    a, b, c, d = run(3, True), run(3, True), run(3, False), run(4, True)
    assert a == b
    assert a[0] == c[0] and a[1] == pytest.approx(c[1], rel=1e-5)
    assert a[0] != d[0]

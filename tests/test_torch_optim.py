"""Port vs JAX package: train/optimizers.py on the CPU.

The same numpy gradients go through the optax chains of the JAX package and
through the port's `ChainOptimizer`, on a small tree (Dense, LayerNorm,
Embed) with the weights carried by gridmm_tpu_torch.convert; parameters
must agree within 1e-6 after every update.
"""

import copy
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402
from torch import nn  # noqa: E402

import gridmm_tpu.config as JC  # noqa: E402
import gridmm_tpu.train.optimizers as JO  # noqa: E402
import gridmm_tpu.train.step as JS  # noqa: E402
import gridmm_tpu_torch.train.optimizers as TO  # noqa: E402
import gridmm_tpu_torch.train.step as TS  # noqa: E402
from gridmm_tpu_torch.convert import (_flatten, load_flax_params,  # noqa: E402
                                      to_flax_tree, torch_name)
from torch_parity import jax_navigator, port_config, port_navigator  # noqa: E402

UPDATES = 7   # past Lookahead's sync (6) and RAdam's rectification threshold


class Small(nn.Module):
    def __init__(self):
        super().__init__()
        self.dense = nn.Linear(5, 4)
        self.norm = nn.LayerNorm(4)
        self.emb = nn.Embedding(7, 4)


def _tree(rng, scale=1.0):
    def arr(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"dense": {"kernel": arr(5, 4), "bias": arr(4)},
            "norm": {"scale": arr(4), "bias": arr(4)},
            "emb": {"embedding": arr(7, 4)}}


def _set_grads(model, grads):
    named = dict(model.named_parameters())
    for path, g in _flatten(grads):
        g = g.T if path[-1] == "kernel" else g
        named[torch_name(path)].grad = torch.from_numpy(np.array(g))


def _assert_params(model, jparams, what):
    got = to_flax_tree(dict(model.named_parameters()), jparams)
    for (path, a), (_, ref) in zip(_flatten(got), _flatten(
            jax.tree.map(np.asarray, jparams))):
        np.testing.assert_allclose(a, ref, rtol=0, atol=1e-6,
                                   err_msg=f"{what}: {'/'.join(path)}")


def _cfg(lr=1e-2):
    base = JC.tiny_config()
    return dataclasses.replace(base, train=dataclasses.replace(
        base.train, lr=lr, weight_decay=0.05, grad_norm_clip=2.0))


@pytest.mark.parametrize("name", TO.RULES)
def test_build_optimizer_matches_optax_chain(name):
    """Seven updates of each rule with the clip active on some steps (the
    gradient norm alternates above and below it), a schedule for the
    learning rate, and for adamw the decay mask: within 1e-6."""
    # optax forms RAdam's rectification length ro = ro_inf - 2t b2^t/(1-b2^t)
    # in f32, where the two ~1999-sized terms cancel: at t = 6 it reads
    # 5.955 for 5.994, which moves r, and the whole update, by 1%. The port
    # forms it in f64. A smaller lr keeps that 1% under the 1e-6 bound.
    jcfg = _cfg(lr=1e-3 if name == "radam" else 1e-2)
    rng = np.random.default_rng(0)
    params = _tree(rng)
    model = load_flax_params(Small(), params)
    jsched = JO.warmup_linear_schedule(jcfg.train.lr, 3, 10)
    tsched = TO.warmup_linear_schedule(jcfg.train.lr, 3, 10)
    tx = JO.build_optimizer(name, jcfg.train, schedule=jsched)
    opt = TO.build_optimizer(name, port_config(jcfg).train, model,
                             schedule=tsched)
    jparams = jax.tree.map(jnp.asarray, params)
    state = tx.init(jparams)
    clipped = 0
    for i in range(UPDATES):
        grads = _tree(rng, scale=1.0 if i % 2 else 0.1)
        clipped += float(optax.global_norm(grads)) >= jcfg.train.grad_norm_clip
        updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state,
                                   jparams)
        jparams = optax.apply_updates(jparams, updates)
        _set_grads(model, grads)
        opt.step()
        assert float(opt.last_grad_norm) == pytest.approx(
            float(optax.global_norm(grads)), rel=1e-6)
        _assert_params(model, jparams, f"{name} update {i + 1}")
    assert 0 < clipped < UPDATES
    assert opt.count == UPDATES


def test_make_optimizer_decays_every_parameter():
    """step.py's optimizer: AdamW with NO decay mask, clip in front."""
    jcfg = _cfg()
    rng = np.random.default_rng(1)
    params = _tree(rng)
    model = load_flax_params(Small(), params)
    tx = JS.make_optimizer(jcfg)
    opt = TS.make_optimizer(port_config(jcfg), model)
    jparams = jax.tree.map(jnp.asarray, params)
    state = tx.init(jparams)
    for i in range(3):
        grads = _tree(rng, scale=1.0 if i % 2 else 0.1)
        updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state,
                                   jparams)
        jparams = optax.apply_updates(jparams, updates)
        _set_grads(model, grads)
        opt.step()
        _assert_params(model, jparams, f"update {i + 1}")


def test_missing_gradient_counts_as_zero():
    """A parameter the loss did not reach: zero gradient under jax.grad,
    None in torch. Weight decay and the moments must still apply."""
    jcfg = _cfg()
    rng = np.random.default_rng(2)
    params = _tree(rng)
    model = load_flax_params(Small(), params)
    tx = JS.make_optimizer(jcfg)
    opt = TS.make_optimizer(port_config(jcfg), model)
    grads = _tree(rng)
    grads["emb"]["embedding"][:] = 0.0
    jparams = jax.tree.map(jnp.asarray, params)
    updates, _ = tx.update(jax.tree.map(jnp.asarray, grads), tx.init(jparams),
                           jparams)
    jparams = optax.apply_updates(jparams, updates)
    _set_grads(model, grads)
    model.emb.weight.grad = None
    opt.step()
    _assert_params(model, jparams, "zero-gradient leaf")
    assert not np.array_equal(model.emb.weight.detach().numpy(),
                              params["emb"]["embedding"])


def test_warmup_linear_schedule_at_five_steps():
    lr, warm, total = 3e-4, 4, 12
    want = JO.warmup_linear_schedule(lr, warm, total)
    got = TO.warmup_linear_schedule(lr, warm, total)
    for count in (0, 2, 4, 8, 12, 20):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-6,
                                           abs=1e-12), count
    assert got(0) == 0.0 and got(4) == pytest.approx(lr) and got(12) == 0.0


def test_lookahead_syncs_on_the_period():
    """Across a sync step the fast weights restart from the slow ones:
    after update 6 the parameters equal slow + 0.5 (fast - slow)."""
    rng = np.random.default_rng(3)
    p = torch.tensor(rng.standard_normal(6).astype(np.float32),
                     requires_grad=True)
    start = p.detach().clone()
    opt = TO.ChainOptimizer([p], "rangerlars", lr=1e-2, clip=1e9)
    trail = []
    for _ in range(7):
        p.grad = torch.tensor(rng.standard_normal(6).astype(np.float32))
        opt.step()
        trail.append(p.detach().clone())
    slow = opt.state[p]["slow"]
    assert torch.equal(trail[5], slow)          # update 6: fast := slow
    assert not torch.equal(trail[4], slow) and not torch.equal(trail[6], slow)
    # the fast weights moved away from the start for five updates and the
    # sixth pulled them back half of the way (and a bit, its own step)
    assert (trail[5] - start).norm() < (trail[4] - start).norm()


def test_decay_mask_on_the_navigator_names():
    """Same split as the JAX mask mapped through the converter's names: no
    decay on biases and LayerNorm weights, decay on kernels and embeddings."""
    jcfg = JC.tiny_config()
    _, params = jax_navigator(jcfg, seed=0)
    tmodel = port_navigator(port_config(jcfg), params)
    got = TO.decay_mask(tmodel)
    want = {torch_name(path): bool(v)
            for path, v in _flatten(jax.tree.map(
                np.asarray, JO.decay_mask(params)["params"]))}
    assert got == want
    assert set(got) == {n for n, _ in tmodel.named_parameters()}
    assert got["img_embeddings.img_linear.weight"]
    assert got["embeddings.word_embeddings.weight"]
    assert not got["img_embeddings.img_linear.bias"]
    assert not got["img_embeddings.img_layer_norm.weight"]
    assert 0 < sum(got.values()) < len(got)


def test_unknown_rule_and_closure_raise():
    p = torch.zeros(3, requires_grad=True)
    with pytest.raises(ValueError, match="unknown optimizer"):
        TO.ChainOptimizer([p], "lamb", lr=1e-3, clip=1.0)
    opt = TO.ChainOptimizer([p], "sgd", lr=1e-3, clip=1.0)
    with pytest.raises(ValueError):
        opt.step(lambda: 0.0)


def test_optimizer_state_dict_round_trip():
    """The update count travels with the state: a restored optimizer takes
    the same next step (bias correction and schedule depend on it)."""
    rng = np.random.default_rng(4)
    grads = [torch.tensor(rng.standard_normal(5).astype(np.float32))
             for _ in range(3)]

    def fresh():
        p = torch.ones(5, requires_grad=True)
        return p, TO.ChainOptimizer(
            [p], "adamw", lr=TO.warmup_linear_schedule(1e-2, 2, 8), clip=1.0,
            weight_decay=0.01)

    p1, o1 = fresh()
    for g in grads[:2]:
        p1.grad = g
        o1.step()
    p2, o2 = fresh()
    # load_state_dict keeps the tensors it is given: copy, as a file would
    o2.load_state_dict(copy.deepcopy(o1.state_dict()))
    with torch.no_grad():
        p2.copy_(p1)
    for p, o in ((p1, o1), (p2, o2)):
        p.grad = grads[2]
        o.step()
    assert o2.count == 3 and torch.equal(p1, p2)

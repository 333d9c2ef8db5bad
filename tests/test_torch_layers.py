"""Port vs JAX package: every block of models/layers.py on the CPU.

Each flax block is initialised, its tree is carried into the torch block by
gridmm_tpu_torch.convert (strict both ways), and both run the same inputs;
outputs agree within 1e-5 absolute and relative."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import gridmm_tpu.models.layers as JL  # noqa: E402
import gridmm_tpu_torch.models.layers as TL  # noqa: E402
from gridmm_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from gridmm_tpu_torch.config import ModelConfig as TModelConfig  # noqa: E402
from gridmm_tpu_torch.convert import load_flax_params  # noqa: E402
from torch_parity import assert_close, to_torch  # noqa: E402

KW = dict(hidden_size=64, num_attention_heads=4, intermediate_size=96,
          vocab_size=50, max_position_embeddings=32)
JCFG, TCFG = JModelConfig(**KW), TModelConfig(**KW)
B, LQ, LK, H = 2, 7, 11, 64


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _mask(rng, length, lo):
    m = np.arange(length)[None] < rng.integers(lo, length + 1, size=(B, 1))
    return m


def _check(jmod, tmod, args, jfn=None, tfn=None, seed=0):
    """Init jmod on args (through jfn(module, *args) when given), load the
    tree into tmod, compare jfn vs tfn outputs."""
    jfn = jfn or (lambda m, *a: m(*a))
    tfn = tfn or (lambda m, *a: m(*a))
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    params = jmod.init(jax.random.PRNGKey(seed), *jargs, method=jfn)
    load_flax_params(tmod, jax.tree.map(np.asarray, params))
    want = jmod.apply(params, *jargs, method=jfn)
    with torch.no_grad():
        got = tfn(tmod.eval(), *to_torch(tuple(args)))
    if not isinstance(want, tuple):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert_close(g, w)


def test_gelu_and_layernorm():
    rng = np.random.default_rng(0)
    x = _rand(rng, B, LQ, H) * 3
    assert_close(TL.gelu_erf(torch.from_numpy(x)), JL.gelu_erf(jnp.asarray(x)))
    _check(JL.LayerNorm(1e-12), TL.LayerNorm(H, 1e-12), (x + 2.0,))


@pytest.mark.parametrize("block", ["mha", "attn_out", "bert_attention",
                                   "cross_attention", "ffn", "bert_layer"])
def test_bert_blocks(block):
    rng = np.random.default_rng(1)
    x, ctx = _rand(rng, B, LQ, H), _rand(rng, B, LK, H)
    bias = np.asarray(
        (1.0 - _mask(rng, LK, 3).astype(np.float32)) * -10000.0
    )[:, None, None, :]
    self_bias = np.asarray(
        (1.0 - _mask(rng, LQ, 2).astype(np.float32)) * -10000.0
    )[:, None, None, :]
    cases = {
        "mha": (JL.MultiHeadAttention(JCFG), TL.MultiHeadAttention(TCFG),
                (x, ctx, bias)),
        "attn_out": (JL.AttentionOutput(JCFG), TL.AttentionOutput(TCFG),
                     (x, _rand(rng, B, LQ, H))),
        "bert_attention": (JL.BertAttention(JCFG), TL.BertAttention(TCFG),
                           (x, self_bias)),
        "cross_attention": (JL.BertCrossAttention(JCFG),
                            TL.BertCrossAttention(TCFG), (x, ctx, bias)),
        "ffn": (JL.BertFFN(JCFG), TL.BertFFN(TCFG), (x,)),
        "bert_layer": (JL.BertLayer(JCFG), TL.BertLayer(TCFG),
                       (x, self_bias)),
    }
    jmod, tmod, args = cases[block]
    _check(jmod, tmod, args)


def test_bert_embeddings():
    rng = np.random.default_rng(2)
    ids = rng.integers(0, KW["vocab_size"], size=(B, LQ)).astype(np.int32)
    tok = _rand(rng, 1, 1, H)
    _check(JL.BertEmbeddings(JCFG), TL.BertEmbeddings(TCFG), (ids, tok))


@pytest.mark.parametrize("sprels", [False, True])
def test_graph_lxrt_layer_both_directions(sprels):
    rng = np.random.default_rng(3)
    lang, visn = _rand(rng, B, LK, H), _rand(rng, B, LQ, H)
    lb = ((1.0 - _mask(rng, LK, 4)) * -10000.0)[:, None, None, :]
    vb = ((1.0 - _mask(rng, LQ, 2)) * -10000.0)[:, None, None, :]
    lb, vb = lb.astype(np.float32), vb.astype(np.float32)
    sp = _rand(rng, B, 1, LQ, LQ) if sprels else None

    def jfn(m, lang, lb, visn, vb, sp):
        return m(lang, lb, visn, vb, sp), m.lang2visn(lang, lb, visn, vb)

    def tfn(m, lang, lb, visn, vb, sp):
        return m(lang, lb, visn, vb, sp), m.lang2visn(lang, lb, visn, vb)

    _check(JL.GraphLXRTXLayer(JCFG), TL.GraphLXRTXLayer(TCFG),
           (lang, lb, visn, vb, sp), jfn, tfn)


def test_crossmodal_encoder_with_key_biases():
    rng = np.random.default_rng(4)
    txt, img = _rand(rng, B, LK, H), _rand(rng, B, LQ, H)
    tm, im = _mask(rng, LK, 4), _mask(rng, LQ, 2)
    tkb, ikb = _rand(rng, B, LK), _rand(rng, B, LQ)

    def jfn(m, txt, tm, img, im, tkb, ikb):
        return (m(txt, tm, img, im, txt_key_bias=tkb, img_key_bias=ikb),
                m.lang2visn(txt, tm, img, im))

    def tfn(m, txt, tm, img, im, tkb, ikb):
        return (m(txt, tm, img, im, txt_key_bias=tkb, img_key_bias=ikb),
                m.lang2visn(txt, tm, img, im))

    _check(JL.CrossmodalEncoder(JCFG, 2), TL.CrossmodalEncoder(TCFG, 2),
           (txt, tm, img, im, tkb, ikb), jfn, tfn)


@pytest.mark.parametrize("with_key_bias", [False, True])
def test_prenorm_encoder(with_key_bias):
    rng = np.random.default_rng(5)
    x, mask = _rand(rng, B, LQ, H), _mask(rng, LQ, 2)
    kb = _rand(rng, B, LQ) if with_key_bias else None

    def jfn(m, x, mask, kb):
        return m(x, mask, key_bias=kb)

    def tfn(m, x, mask, kb):
        return m(x, mask, key_bias=kb)

    _check(JL.PreNormEncoder(JCFG, 2), TL.PreNormEncoder(TCFG, 2),
           (x, mask, kb), jfn, tfn)
    _check(JL.PreNormEncoderLayer(JCFG), TL.PreNormEncoderLayer(TCFG),
           (x, None))


def test_cls_prediction():
    rng = np.random.default_rng(6)
    x = _rand(rng, B, LQ, 2 * H)
    _check(JL.ClsPrediction(JCFG), TL.ClsPrediction(TCFG, input_size=2 * H),
           (x,))


@pytest.mark.parametrize("seed", [0, 1])
def test_gather_fixed_order_matches_torch_gather(seed):
    """The fused logits' gather (models/navigator.py, models/pretrain.py):
    the values of torch.gather, and its gradient on indices with repeats
    (clamp(min=0) sends every non-candidate slot to index 0), with -inf
    among the gathered logits as masked slots give them. The gradient of a
    repeated index is a sum taken in another order than scatter_add's:
    within 1e-6 (a few ulps of the ~5-wide sums)."""
    from gridmm_tpu_torch.models.layers import gather_fixed_order

    rng = np.random.default_rng(seed)
    src = rng.standard_normal((6, 40)).astype(np.float32)
    src[:, 30:] = -np.inf
    idx = rng.integers(-2, 12, size=(6, 64))
    grad = rng.standard_normal((6, 64)).astype(np.float32)
    got, want = (torch.tensor(src, requires_grad=True) for _ in range(2))
    index = torch.from_numpy(idx).clamp(min=0)
    out = gather_fixed_order(got, index)
    ref = torch.gather(want, 1, index)
    assert torch.equal(out, ref)
    out.backward(torch.from_numpy(grad))
    ref.backward(torch.from_numpy(grad))
    assert (index == 0).sum() > 6 and got.grad.shape == want.grad.shape
    torch.testing.assert_close(got.grad, want.grad, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("vocab", [3, 512])
def test_embedding_gradient_sums_repeats_like_nn_embedding(vocab):
    """models/layers.Embedding (the word, position, token-type, nav-type and
    step tables): the values of nn.Embedding, and its gradient, whose rows
    of a repeated id are a segment sum over the ids sorted stably, within
    1e-6 of nn.Embedding's (rows a table never sees stay 0)."""
    rng = np.random.default_rng(vocab)
    ids = torch.from_numpy(rng.integers(0, min(vocab, 40), size=(12, 39)))
    grad = torch.from_numpy(rng.standard_normal((12, 39, 16)).astype(
        np.float32))
    ours = TL.Embedding(vocab, 16)
    ref = torch.nn.Embedding(vocab, 16)
    ref.load_state_dict(ours.state_dict())
    out, want = ours(ids), ref(ids)
    assert torch.equal(out, want)
    out.backward(grad)
    want.backward(grad)
    torch.testing.assert_close(ours.weight.grad, ref.weight.grad, rtol=1e-6,
                               atol=1e-6)
    assert (ours.weight.grad[40:] == 0).all()

"""Port vs JAX package: the released-checkpoint importers on the CPU, at tiny
width.

For every importer, a reference-layout state dict synthesized by the JAX
package's `synthesize_torch_state_dict` (no released file is needed) goes
into both packages: the two reports must be equal (leaves named by their
flax paths), the port's state dict must load with strict=True and equal the
JAX package's imported tree as the converter carries it, and the logits of
the two imported models must agree within 1e-5 x max|logit|. A rule applied
without the port's second transpose would get square matrices wrong without
a shape error; the logits catch it. Also: the port synthesizes the same
dicts, both released fine-tune nestings, the wrong-key-space error and the
pretrain-to-navigator projection.
"""

import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import torch  # noqa: E402

import gridmm_tpu.config as JC  # noqa: E402
import gridmm_tpu.train.pretrain as JPT  # noqa: E402
import gridmm_tpu.train.synthetic as JSYN  # noqa: E402
import gridmm_tpu.utils.checkpoint as JCK  # noqa: E402
import gridmm_tpu_torch.train.pretrain as TPT  # noqa: E402
import gridmm_tpu_torch.utils.checkpoint as TCK  # noqa: E402
from gridmm_tpu.models.pretrain import GridMMPretrain as JPretrain  # noqa: E402
from gridmm_tpu_torch.convert import (flax_paths,  # noqa: E402
                                      flax_to_state_dict, load_flax_params)
from gridmm_tpu_torch.models.navigator import GridMMNavigator  # noqa: E402
from gridmm_tpu_torch.models.pretrain import GridMMPretrain  # noqa: E402
from tests.test_pretrain_init import _hf_bert_sd, _lxmert_sd  # noqa: E402
from torch_parity import (jax_navigator, nav_batch, port_config,  # noqa: E402
                          to_torch)


def cfg_for(objects):
    cfg = JC.tiny_config()
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, image_prob_size=32,
        obj_feat_size=cfg.model.image_feat_size if objects else 0))


def kw_for(cfg):
    m = cfg.model
    return dict(num_l_layers=m.num_l_layers, num_x_layers=m.num_x_layers,
                num_pano_layers=m.num_pano_layers,
                has_obj=m.obj_feat_size > 0)


@functools.lru_cache(maxsize=None)
def _nav(objects):
    cfg = cfg_for(objects)
    model, params = jax_navigator(cfg, seed=0)
    return cfg, model, params


@pytest.fixture(scope="module", params=[False, True], ids=["r2r", "objects"])
def nav(request):
    """(jax cfg, flax navigator, its init params) with and without object
    tokens."""
    return _nav(request.param)


@pytest.fixture(scope="module", params=[False, True], ids=["r2r", "objects"])
def pre(request):
    """(jax cfg, flax pretrain model, params, batch)."""
    cfg = cfg_for(request.param)
    model = JPretrain(cfg.model)
    batch = JSYN.synthetic_pretrain_batch(cfg, 2, 3, seed=0)
    params = jax.jit(lambda k: JPT.init_pretrain_params(
        model, cfg, k, batch))(jax.random.PRNGKey(0))
    return cfg, model, params, batch


def _port(cls, cfg, params):
    """The port's module carrying the JAX template's weights: a partial
    import keeps the rest of the template on both sides."""
    model = cls(port_config(cfg).model)
    if params is not None:
        load_flax_params(model, jax.tree.map(np.asarray, params))
    return model.eval()


def port_nav(cfg, params=None):
    return _port(GridMMNavigator, cfg, params)


def port_pre(cfg, params=None):
    return _port(GridMMPretrain, cfg, params)


def assert_same_import(jparams, tmodel, tsd, jreport, treport):
    """Equal reports; the port's dict loads strictly and equals the JAX
    package's imported tree, tensor for tensor."""
    assert treport == jreport
    tmodel.load_state_dict(tsd, strict=True)
    want = flax_to_state_dict(jax.tree.map(np.asarray, jparams), tmodel)
    assert set(want) == set(tsd)
    for k, w in want.items():
        assert torch.equal(tsd[k], w), k


@functools.lru_cache(maxsize=None)
def _jax_nav_fn(jmodel):
    """The JAX navigation forward, jitted once per module (one compile is
    faster than running it eagerly)."""
    return jax.jit(lambda p, b: jmodel.apply(p, "navigation", b))


@functools.lru_cache(maxsize=None)
def _jax_pre_fn(jmodel):
    """(MLM logits, fused SAP logits) of the JAX pretrain model, jitted."""
    def run(p, jb):
        jkw = JPT._enc_kwargs(jb)
        mlm = jmodel.apply(p, jb.txt_ids, jb.txt_mask, jkw,
                           method=JPretrain.forward_mlm_logits)
        enc = jmodel.apply(p, jb.txt_ids, jb.txt_mask,
                           method=JPretrain.encode, **jkw)
        sap = jmodel.apply(
            p, enc, jb.gmap_mask, jb.gmap_visited_mask, jb.vp_nav_mask,
            jb.fused_add_idx, jb.cand_backtrack_mask,
            method=JPretrain.forward_sap_logits)[2]
        return mlm, sap

    return jax.jit(run)


def nav_logits_close(cfg, jmodel, jparams, tmodel, seed=0):
    """Fused, global, local and grid logits of the two imported navigators
    on one random batch: within 1e-5 x max|logit|."""
    batch = nav_batch(cfg, np.random.default_rng(seed))
    want = _jax_nav_fn(jmodel)(jparams, batch)
    with torch.no_grad():
        got = tmodel("navigation", to_torch(batch))
    for f in ("fused_logits", "global_logits", "local_logits",
              "grid_logits"):
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), fin, err_msg=f)
        tol = 1e-5 * np.abs(w[fin]).max()
        np.testing.assert_allclose(g[fin], w[fin], rtol=0, atol=tol,
                                   err_msg=f)


def pre_logits_close(cfg, jmodel, jparams, tmodel, jbatch):
    """MLM and fused SAP logits of the two imported pretrain models: within
    1e-5 x max|logit|."""
    b = TPT.pretrain_batch_to_device(jax.tree.map(np.array, jbatch), "cpu")
    want_mlm, want_sap = _jax_pre_fn(jmodel)(jparams, jbatch)
    with torch.no_grad():
        got_mlm = tmodel.forward_mlm_logits(b.txt_ids, b.txt_mask,
                                            TPT._enc_kwargs(b))
        genc = tmodel.encode(b.txt_ids, b.txt_mask, **TPT._enc_kwargs(b))
        got_sap = tmodel.forward_sap_logits(
            genc, b.gmap_mask, b.gmap_visited_mask, b.vp_nav_mask,
            b.fused_add_idx, b.cand_backtrack_mask)[2]
    for name, g, w in (("mlm", got_mlm, want_mlm), ("sap", got_sap,
                                                     want_sap)):
        w, g = np.asarray(w), g.numpy()
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), fin, err_msg=name)
        np.testing.assert_allclose(g[fin], w[fin], rtol=0,
                                   atol=1e-5 * np.abs(w[fin]).max(),
                                   err_msg=name)


# ------------------------------------------------------------- synthesis
def test_flax_paths_invert_torch_name(pre):
    """Every parameter of the pretrain module has a flax path that names it
    back, and the paths are the JAX tree's leaves."""
    cfg, _, params, _ = pre
    model = port_pre(cfg)
    paths = flax_paths(model)
    assert set(paths) == set(model.state_dict())
    assert sorted(paths.values()) == sorted(
        JCK._leaf_paths(params["params"]))


def _synthesized_equal(rules, trules, params, model):
    assert trules == rules
    want = JCK.synthesize_torch_state_dict(rules, params, seed=4)
    got = TCK.synthesize_torch_state_dict(rules, model, seed=4)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_synthesizes_the_jax_navigator_dict(nav):
    """The port's synthesize_torch_state_dict on its navigator equals the
    JAX package's on the flax tree: the same keys, the same arrays."""
    cfg, _, params = nav
    _synthesized_equal(JCK.navigator_rules(**kw_for(cfg)),
                       TCK.navigator_rules(**kw_for(cfg)), params,
                       port_nav(cfg))


def test_port_synthesizes_the_jax_pretrain_dict(pre):
    cfg, _, params, _ = pre
    _synthesized_equal(JCK.pretrain_rules(**kw_for(cfg)),
                       TCK.pretrain_rules(**kw_for(cfg)), params,
                       port_pre(cfg))


# -------------------------------------------------------------- navigator
@pytest.mark.parametrize("prefix", ["", "module."])
def test_import_torch_navigator_matches_jax(nav, prefix):
    cfg, jmodel, params = nav
    kw = kw_for(cfg)
    sd = JCK.synthesize_torch_state_dict(JCK.navigator_rules(**kw), params,
                                         seed=1)
    sd = {prefix + k: torch.from_numpy(v) for k, v in sd.items()}
    sd["module.critic.fc.weight"] = torch.zeros(2, 2)   # not the navigator's
    jparams, jreport = JCK.import_torch_navigator(sd, params, **kw)
    tmodel = port_nav(cfg, params)
    tsd, treport = TCK.import_torch_navigator(sd, tmodel, **kw)
    assert treport["unfilled_flax_leaves"] == []
    assert treport["unused_torch_keys"] == ["critic.fc.weight"]
    assert_same_import(jparams, tmodel, tsd, jreport, treport)
    nav_logits_close(cfg, jmodel, jparams, tmodel)


def test_import_shape_mismatch_raises(nav):
    cfg, _, params = nav
    tmodel = port_nav(cfg)
    sd = TCK.synthesize_torch_state_dict(
        TCK.navigator_rules(**kw_for(cfg)), tmodel)
    sd["text_proj.weight"] = np.zeros((3, 5), np.float32)
    with pytest.raises(ValueError, match="shape mismatch text_proj.weight"):
        TCK.import_torch_navigator(sd, tmodel, **kw_for(cfg))


@pytest.mark.parametrize("nesting", ["finetune", "grid_map", "ce_epoch"])
def test_remap_ce_released_nestings_match_jax(nav, nesting):
    """grid_map.pt / best_val_unseen ({'vln_bert': {'state_dict': ...}},
    'module.vln_bert.' or 'vln_bert.' keys) and CE ckpt.{epoch}.pth
    ({'state_dict': 'net.module.vln_bert.' keys}): the same bare keys as
    the JAX package, then the same import."""
    cfg, jmodel, params = nav
    kw = kw_for(cfg)
    sd = JCK.synthesize_torch_state_dict(JCK.navigator_rules(**kw), params,
                                         seed=2)
    pre = {"finetune": "module.vln_bert.", "grid_map": "vln_bert.",
           "ce_epoch": "net.module.vln_bert."}[nesting]
    inner = {pre + k: torch.from_numpy(v) for k, v in sd.items()}
    ckpt = ({"state_dict": inner, "epoch": 2} if nesting == "ce_epoch" else
            {"vln_bert": {"epoch": 1, "state_dict": inner, "optimizer": {}},
             "critic": {"state_dict": {}}})
    want = JCK.remap_ce_released(ckpt)
    got = TCK.remap_ce_released(ckpt)
    assert list(got) == list(want) == list(sd)
    jparams, jreport = JCK.import_torch_navigator(want, params, **kw)
    tmodel = port_nav(cfg, params)
    tsd, treport = TCK.import_torch_navigator(got, tmodel, **kw)
    TCK.require_navigator_coverage(treport)
    assert_same_import(jparams, tmodel, tsd, jreport, treport)


def test_wrong_key_space_raises_in_both(nav):
    """A checkpoint in another key space matches no rule: both coverage
    checks raise the same error."""
    cfg, _, params = nav
    sd = {"who.knows.weight": torch.zeros(3, 3)}
    _, jreport = JCK.import_torch_navigator(sd, params, **kw_for(cfg))
    _, treport = TCK.import_torch_navigator(sd, port_nav(cfg), **kw_for(cfg))
    assert treport == jreport
    with pytest.raises(ValueError, match="unfilled") as want:
        JCK.require_navigator_coverage(jreport)
    with pytest.raises(ValueError, match="unfilled") as got:
        TCK.require_navigator_coverage(treport)
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------- pretrain
def test_import_torch_pretrain_matches_jax(pre):
    cfg, jmodel, params, batch = pre
    kw = kw_for(cfg)
    sd = JCK.synthesize_torch_state_dict(JCK.pretrain_rules(**kw), params,
                                         seed=5)
    sd = {"module." + k: v for k, v in sd.items()}
    jparams, jreport = JCK.import_torch_pretrain(sd, params, **kw)
    tmodel = port_pre(cfg, params)
    tsd, treport = TCK.import_torch_pretrain(sd, tmodel, **kw)
    assert treport["unfilled_flax_leaves"] == []
    assert_same_import(jparams, tmodel, tsd, jreport, treport)
    pre_logits_close(cfg, jmodel, jparams, tmodel, batch)


@pytest.mark.parametrize("fill,tt_rows", [(False, 2), (True, 2),
                                          (False, 1)],
                         ids=["bert", "fill_lang_encoder", "xlmr_doubling"])
def test_import_hf_bert_pretrain_matches_jax(pre, fill, tt_rows):
    """--init_pretrained bert: the embedding stack only (the reference drops
    encoder.layer.* silently), the layers too with fill_lang_encoder, and
    the xlm-roberta one-row token-type table doubled."""
    cfg, jmodel, params, batch = pre
    kw = kw_for(cfg)
    sd = _hf_bert_sd(params, kw, token_type_rows=tt_rows)
    jparams, jreport = JCK.import_hf_bert_pretrain(
        sd, params, fill_lang_encoder=fill, **kw)
    tmodel = port_pre(cfg, params)
    tsd, treport = TCK.import_hf_bert_pretrain(
        sd, tmodel, fill_lang_encoder=fill, **kw)
    assert "pooler.dense.weight" in treport["unused_torch_keys"]
    assert_same_import(jparams, tmodel, tsd, jreport, treport)
    pre_logits_close(cfg, jmodel, jparams, tmodel, batch)


def test_import_lxmert_pretrain_matches_jax(pre):
    """--init_pretrained lxmert: embeddings, language layers, the local
    x-layers (the other two fan-out targets stay unused) and the MLM
    head."""
    cfg, jmodel, params, batch = pre
    kw = kw_for(cfg)
    sd = _lxmert_sd(params, kw)
    jparams, jreport = JCK.import_lxmert_pretrain(sd, params, **kw)
    tmodel = port_pre(cfg, params)
    tsd, treport = TCK.import_lxmert_pretrain(sd, tmodel, **kw)
    assert any("global_encoder.encoder.x_layers" in k
               for k in treport["unused_torch_keys"])
    assert_same_import(jparams, tmodel, tsd, jreport, treport)
    pre_logits_close(cfg, jmodel, jparams, tmodel, batch)


def test_remap_pretrain_to_navigator_matches_jax(pre):
    """A reference pretrain dict: 'bert.' stripped, the wrapper heads kept,
    mlm_head / image_classifier / obj_classifier dropped, as the JAX
    package does; then it imports as a navigator and covers it."""
    cfg, _, params, _ = pre
    kw = kw_for(cfg)
    sd = JCK.synthesize_torch_state_dict(JCK.pretrain_rules(**kw), params,
                                         seed=6)
    sd["obj_classifier.net.0.weight"] = np.zeros((2, 2), np.float32)
    want = JCK.remap_pretrain_to_navigator({"module." + k: v
                                            for k, v in sd.items()})
    got = TCK.remap_pretrain_to_navigator({"module." + k: v
                                           for k, v in sd.items()})
    assert list(got) == list(want)
    assert not any(k.startswith(("mlm_head.", "image_classifier.",
                                 "obj_classifier.")) for k in got)
    _, report = TCK.import_torch_navigator(got, port_nav(cfg), **kw)
    TCK.require_navigator_coverage(report, what="pretrain navigator")


def test_pretrain_params_to_navigator_matches_jax(pre):
    """One pretrain tree in both packages, projected onto the navigator:
    the language branch dropped, the port's dict loads strictly, and the
    two navigators' logits agree within 1e-5 x max|logit|. A missing
    navigator leaf and a dict without a 'bert.' scope raise."""
    cfg, _, params, _ = pre
    _, jnav, nav_template = _nav(cfg.model.obj_feat_size > 0)
    want = JCK.pretrain_params_to_navigator(params, nav_template)
    tpre = port_pre(cfg)
    tpre.load_state_dict(flax_to_state_dict(
        jax.tree.map(np.asarray, params), tpre), strict=True)
    tnav = port_nav(cfg)
    got = TCK.pretrain_params_to_navigator(tpre.state_dict(), tnav)
    assert not any(".lang_" in k for k in got)
    assert_same_import(want, tnav, got, {}, {})
    nav_logits_close(cfg, jnav, want, tnav, seed=3)

    full = TCK.pretrain_params_to_navigator(tpre.state_dict())
    assert any(".lang_ffn." in k for k in full)
    short = {k: v for k, v in tpre.state_dict().items()
             if not k.startswith("bert.text_proj.")}
    with pytest.raises(ValueError, match="text_proj"):
        TCK.pretrain_params_to_navigator(short, tnav)
    with pytest.raises(ValueError, match="no 'bert.' scope"):
        TCK.pretrain_params_to_navigator(tnav.state_dict(), tnav)


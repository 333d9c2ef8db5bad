"""Checkpoint persistence and import (twin of part of
gridmm_tpu/utils/checkpoint.py).

`save_checkpoint` / `AsyncSaver` / `restore_checkpoint` stand in for the JAX
package's orbax calls, with `torch.save` files written to a temporary name
and renamed into place.

The importers map the reference's PyTorch key spaces (pretrain ModelSaver
files, fine-tune best/latest dicts with `module.` fixups, CE
ckpt.{epoch}.pth; adapters at map_nav_src/models/vlnbert_init.py:19-27 and
VLN_CE/.../gridmap/vlnbert_init.py:15-33) onto the port's modules. The rules
are the JAX package's: (torch key, flax path, transform), where "T"
transposes a reference Linear weight into a flax (in, out) kernel and
Q/K/V split an in_proj weight. The port's Dense is an nn.Linear, so a rule
that lands on a kernel is transposed back (convert.torch_name names the
parameter); the report names leaves by their flax paths, as the JAX
package's does. Each import returns a state dict the module takes with
`load_state_dict(strict=True)`, and that report. OpenAI CLIP's visual
tower, timm's ViT-B/16 (the CE view tower) and the CE waypoint predictor
are imported too.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from gridmm_tpu_torch.convert import flax_paths, torch_name
from gridmm_tpu_torch.models.clip_vit import ClipVisionTransformer


def _host_copy(tree):
    """Tensors of a nested dict/list/tuple copied to host memory; anything
    else as it is."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree


def _write(path: str, host_state) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(host_state, tmp)
    os.replace(tmp, path)       # a reader never sees a half-written file


def save_checkpoint(path: str, state) -> None:
    """Write `state` (a state_dict, or any nested dict/list of tensors and
    plain values) to the file `path`, atomically."""
    _write(path, _host_copy(state))


class AsyncSaver:
    """Background checkpoint writes overlapping training compute.

    save() copies the tensors to host memory before it returns, so the
    caller may update them in place at once, and serializes and writes in a
    background thread that renames the file into place (the reference's
    torch.save blocks the step loop, agent_base.py:213-228). One write is
    outstanding at a time. wait() makes the last save durable and raises
    what the writer raised; close() at shutdown. The files are read by
    `restore_checkpoint`.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path: str, state) -> None:
        self.wait()
        host_state = _host_copy(state)

        def run():
            try:
                _write(path, host_state)
            except Exception as e:   # raised in the caller by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=False)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def restore_checkpoint(path: str, model: Optional[torch.nn.Module] = None):
    """Read a checkpoint file onto the host. With `model`, load it as that
    module's state_dict (strict) and return the module; else return the
    stored tree."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if model is None:
        return state
    model.load_state_dict(state, strict=True)
    return model


def _strip_prefixes(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Drop DDP 'module.' wrappers (agent_base.py:230-262, save.py:23-45)."""
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in state_dict.items()}


def _t(x) -> np.ndarray:
    arr = np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x)
    return arr.astype(np.float32)


def _bert_layer_rules(src: str, dst: str) -> List[Tuple[str, str, str]]:
    """(torch key suffix, flax path, transform) for one BertLayer."""
    return [
        (f"{src}.attention.self.query.weight", f"{dst}/attention/self/query/kernel", "T"),
        (f"{src}.attention.self.query.bias", f"{dst}/attention/self/query/bias", ""),
        (f"{src}.attention.self.key.weight", f"{dst}/attention/self/key/kernel", "T"),
        (f"{src}.attention.self.key.bias", f"{dst}/attention/self/key/bias", ""),
        (f"{src}.attention.self.value.weight", f"{dst}/attention/self/value/kernel", "T"),
        (f"{src}.attention.self.value.bias", f"{dst}/attention/self/value/bias", ""),
        (f"{src}.attention.output.dense.weight", f"{dst}/attention/output/dense/kernel", "T"),
        (f"{src}.attention.output.dense.bias", f"{dst}/attention/output/dense/bias", ""),
        (f"{src}.attention.output.LayerNorm.weight", f"{dst}/attention/output/LayerNorm/ln/scale", ""),
        (f"{src}.attention.output.LayerNorm.bias", f"{dst}/attention/output/LayerNorm/ln/bias", ""),
        (f"{src}.intermediate.dense.weight", f"{dst}/ffn/intermediate_dense/kernel", "T"),
        (f"{src}.intermediate.dense.bias", f"{dst}/ffn/intermediate_dense/bias", ""),
        (f"{src}.output.dense.weight", f"{dst}/ffn/output_dense/kernel", "T"),
        (f"{src}.output.dense.bias", f"{dst}/ffn/output_dense/bias", ""),
        (f"{src}.output.LayerNorm.weight", f"{dst}/ffn/output_LayerNorm/ln/scale", ""),
        (f"{src}.output.LayerNorm.bias", f"{dst}/ffn/output_LayerNorm/ln/bias", ""),
    ]


def _xattention_rules(src: str, dst: str) -> List[Tuple[str, str, str]]:
    """BertXAttention (vilmodel.py:370-379)."""
    return [
        (f"{src}.att.query.weight", f"{dst}/att/query/kernel", "T"),
        (f"{src}.att.query.bias", f"{dst}/att/query/bias", ""),
        (f"{src}.att.key.weight", f"{dst}/att/key/kernel", "T"),
        (f"{src}.att.key.bias", f"{dst}/att/key/bias", ""),
        (f"{src}.att.value.weight", f"{dst}/att/value/kernel", "T"),
        (f"{src}.att.value.bias", f"{dst}/att/value/bias", ""),
        (f"{src}.output.dense.weight", f"{dst}/output/dense/kernel", "T"),
        (f"{src}.output.dense.bias", f"{dst}/output/dense/bias", ""),
        (f"{src}.output.LayerNorm.weight", f"{dst}/output/LayerNorm/ln/scale", ""),
        (f"{src}.output.LayerNorm.bias", f"{dst}/output/LayerNorm/ln/bias", ""),
    ]


def _attn_block_rules(src: str, dst: str) -> List[Tuple[str, str, str]]:
    """BertAttention (self) used standalone (visn/lang_self_att)."""
    return [
        (f"{src}.self.query.weight", f"{dst}/self/query/kernel", "T"),
        (f"{src}.self.query.bias", f"{dst}/self/query/bias", ""),
        (f"{src}.self.key.weight", f"{dst}/self/key/kernel", "T"),
        (f"{src}.self.key.bias", f"{dst}/self/key/bias", ""),
        (f"{src}.self.value.weight", f"{dst}/self/value/kernel", "T"),
        (f"{src}.self.value.bias", f"{dst}/self/value/bias", ""),
        (f"{src}.output.dense.weight", f"{dst}/output/dense/kernel", "T"),
        (f"{src}.output.dense.bias", f"{dst}/output/dense/bias", ""),
        (f"{src}.output.LayerNorm.weight", f"{dst}/output/LayerNorm/ln/scale", ""),
        (f"{src}.output.LayerNorm.bias", f"{dst}/output/LayerNorm/ln/bias", ""),
    ]


def _xlayer_rules(src: str, dst: str) -> List[Tuple[str, str, str]]:
    """GraphLXRTXLayer (vilmodel.py:381-427)."""
    rules = _xattention_rules(f"{src}.visual_attention", f"{dst}/visual_attention")
    rules += _attn_block_rules(f"{src}.visn_self_att", f"{dst}/visn_self_att")
    rules += [
        (f"{src}.visn_inter.dense.weight", f"{dst}/visn_ffn/intermediate_dense/kernel", "T"),
        (f"{src}.visn_inter.dense.bias", f"{dst}/visn_ffn/intermediate_dense/bias", ""),
        (f"{src}.visn_output.dense.weight", f"{dst}/visn_ffn/output_dense/kernel", "T"),
        (f"{src}.visn_output.dense.bias", f"{dst}/visn_ffn/output_dense/bias", ""),
        (f"{src}.visn_output.LayerNorm.weight", f"{dst}/visn_ffn/output_LayerNorm/ln/scale", ""),
        (f"{src}.visn_output.LayerNorm.bias", f"{dst}/visn_ffn/output_LayerNorm/ln/bias", ""),
    ]
    rules += _attn_block_rules(f"{src}.lang_self_att", f"{dst}/lang_self_att")
    rules += [
        (f"{src}.lang_inter.dense.weight", f"{dst}/lang_ffn/intermediate_dense/kernel", "T"),
        (f"{src}.lang_inter.dense.bias", f"{dst}/lang_ffn/intermediate_dense/bias", ""),
        (f"{src}.lang_output.dense.weight", f"{dst}/lang_ffn/output_dense/kernel", "T"),
        (f"{src}.lang_output.dense.bias", f"{dst}/lang_ffn/output_dense/bias", ""),
        (f"{src}.lang_output.LayerNorm.weight", f"{dst}/lang_ffn/output_LayerNorm/ln/scale", ""),
        (f"{src}.lang_output.LayerNorm.bias", f"{dst}/lang_ffn/output_LayerNorm/ln/bias", ""),
    ]
    return rules


def _prenorm_layer_rules(src: str, dst: str) -> List[Tuple[str, str, str]]:
    """torch TransformerEncoderLayer (models/transformer.py) -> PreNormEncoderLayer.
    in_proj is split into q/k/v by the importer (transform 'QKV<i>')."""
    return [
        (f"{src}.self_attn.in_proj_weight", f"{dst}/self_attn/query/kernel", "Q"),
        (f"{src}.self_attn.in_proj_weight", f"{dst}/self_attn/key/kernel", "K"),
        (f"{src}.self_attn.in_proj_weight", f"{dst}/self_attn/value/kernel", "V"),
        (f"{src}.self_attn.in_proj_bias", f"{dst}/self_attn/query/bias", "Qb"),
        (f"{src}.self_attn.in_proj_bias", f"{dst}/self_attn/key/bias", "Kb"),
        (f"{src}.self_attn.in_proj_bias", f"{dst}/self_attn/value/bias", "Vb"),
        (f"{src}.self_attn.out_proj.weight", f"{dst}/attn_out/kernel", "T"),
        (f"{src}.self_attn.out_proj.bias", f"{dst}/attn_out/bias", ""),
        (f"{src}.linear1.weight", f"{dst}/linear1/kernel", "T"),
        (f"{src}.linear1.bias", f"{dst}/linear1/bias", ""),
        (f"{src}.linear2.weight", f"{dst}/linear2/kernel", "T"),
        (f"{src}.linear2.bias", f"{dst}/linear2/bias", ""),
        (f"{src}.norm1.weight", f"{dst}/norm1/ln/scale", ""),
        (f"{src}.norm1.bias", f"{dst}/norm1/ln/bias", ""),
        (f"{src}.norm2.weight", f"{dst}/norm2/ln/scale", ""),
        (f"{src}.norm2.bias", f"{dst}/norm2/ln/bias", ""),
    ]


def _linear_ln_rules(src_linear, src_ln, dst_dense, dst_ln):
    """nn.Sequential(Linear, LayerNorm) heads like vp_pos_embeddings."""
    return [
        (f"{src_linear}.weight", f"{dst_dense}/kernel", "T"),
        (f"{src_linear}.bias", f"{dst_dense}/bias", ""),
        (f"{src_ln}.weight", f"{dst_ln}/ln/scale", ""),
        (f"{src_ln}.bias", f"{dst_ln}/ln/bias", ""),
    ]


def _cls_head_rules(src: str, dst: str) -> List[Tuple[str, str, str]]:
    """ClsPrediction net.{0,2,3} (vilmodel.py:663-674)."""
    return [
        (f"{src}.net.0.weight", f"{dst}/net_0/kernel", "T"),
        (f"{src}.net.0.bias", f"{dst}/net_0/bias", ""),
        (f"{src}.net.2.weight", f"{dst}/net_2/ln/scale", ""),
        (f"{src}.net.2.bias", f"{dst}/net_2/ln/bias", ""),
        (f"{src}.net.3.weight", f"{dst}/net_3/kernel", "T"),
        (f"{src}.net.3.bias", f"{dst}/net_3/bias", ""),
    ]


def navigator_rules(num_l_layers=9, num_x_layers=4, num_pano_layers=2,
                    has_obj=False) -> List[Tuple[str, str, str]]:
    """Full key map for GlocalTextPathNavCMT -> GridMMNavigator."""
    r: List[Tuple[str, str, str]] = [
        ("embeddings.word_embeddings.weight",
         "embeddings/word_embeddings/embedding", ""),
        ("embeddings.position_embeddings.weight",
         "embeddings/position_embeddings/embedding", ""),
        ("embeddings.token_type_embeddings.weight",
         "token_type_embeddings/embedding", ""),
        ("embeddings.LayerNorm.weight", "embeddings/LayerNorm/ln/scale", ""),
        ("embeddings.LayerNorm.bias", "embeddings/LayerNorm/ln/bias", ""),
    ]
    for i in range(num_l_layers):
        r += _bert_layer_rules(f"lang_encoder.layer.{i}",
                               f"lang_encoder/layer_{i}")
    # ImageEmbeddings
    r += [
        ("img_embeddings.img_linear.weight", "img_embeddings/img_linear/kernel", "T"),
        ("img_embeddings.img_linear.bias", "img_embeddings/img_linear/bias", ""),
        ("img_embeddings.img_layer_norm.weight", "img_embeddings/img_layer_norm/ln/scale", ""),
        ("img_embeddings.img_layer_norm.bias", "img_embeddings/img_layer_norm/ln/bias", ""),
        ("img_embeddings.loc_linear.weight", "img_embeddings/loc_linear/kernel", "T"),
        ("img_embeddings.loc_linear.bias", "img_embeddings/loc_linear/bias", ""),
        ("img_embeddings.loc_layer_norm.weight", "img_embeddings/loc_layer_norm/ln/scale", ""),
        ("img_embeddings.loc_layer_norm.bias", "img_embeddings/loc_layer_norm/ln/bias", ""),
        ("img_embeddings.nav_type_embedding.weight", "img_embeddings/nav_type_embedding/embedding", ""),
        ("img_embeddings.layer_norm.weight", "img_embeddings/layer_norm/ln/scale", ""),
        ("img_embeddings.layer_norm.bias", "img_embeddings/layer_norm/ln/bias", ""),
    ]
    if has_obj:
        r += [
            ("img_embeddings.obj_linear.weight", "img_embeddings/obj_linear/kernel", "T"),
            ("img_embeddings.obj_linear.bias", "img_embeddings/obj_linear/bias", ""),
            ("img_embeddings.obj_layer_norm.weight", "img_embeddings/obj_layer_norm/ln/scale", ""),
            ("img_embeddings.obj_layer_norm.bias", "img_embeddings/obj_layer_norm/ln/bias", ""),
        ]
    for i in range(num_pano_layers):
        r += _prenorm_layer_rules(f"img_embeddings.pano_encoder.layers.{i}",
                                  f"img_embeddings/pano_encoder/layers_{i}")
    r += [
        ("img_embeddings.pano_encoder.norm.weight", "img_embeddings/pano_encoder/norm/ln/scale", ""),
        ("img_embeddings.pano_encoder.norm.bias", "img_embeddings/pano_encoder/norm/ln/bias", ""),
    ]
    # local branch
    r += _linear_ln_rules("local_encoder.vp_pos_embeddings.0",
                          "local_encoder.vp_pos_embeddings.1",
                          "vp_pos_dense", "vp_pos_ln")
    for i in range(num_x_layers):
        r += _xlayer_rules(f"local_encoder.encoder.x_layers.{i}",
                           f"local_encoder/x_layers_{i}")
    # global branch
    r += _linear_ln_rules("global_encoder.gmap_pos_embeddings.0",
                          "global_encoder.gmap_pos_embeddings.1",
                          "gmap_pos_dense", "gmap_pos_ln")
    r += [("global_encoder.gmap_step_embeddings.weight",
           "gmap_step_embeddings/embedding", "")]
    # grid branch
    r += _prenorm_layer_rules("grid_encoder.layers.0", "grid_encoder/layers_0")
    r += [
        ("grid_encoder.norm.weight", "grid_encoder/norm/ln/scale", ""),
        ("grid_encoder.norm.bias", "grid_encoder/norm/ln/bias", ""),
    ]
    r += _xlayer_rules("grid_txt_encoder.x_layers.0", "grid_txt_encoder/x_layers_0")
    r += _linear_ln_rules("grid_pos_embeddings.0", "grid_pos_embeddings.1",
                          "grid_pos_dense", "grid_pos_ln")
    r += [
        ("text_proj.weight", "text_proj/kernel", "T"),
        ("text_proj.bias", "text_proj/bias", ""),
        ("grid_proj.weight", "grid_proj/kernel", "T"),
        ("grid_proj.bias", "grid_proj/bias", ""),
    ]
    # heads
    r += _cls_head_rules("global_sap_head", "global_sap_head")
    r += _cls_head_rules("local_sap_head", "local_sap_head")
    r += _cls_head_rules("grid_sap_head", "grid_sap_head")
    r += _cls_head_rules("sap_fuse_linear", "sap_fuse_linear")
    if has_obj:
        r += _cls_head_rules("og_head", "og_head")
    return r


def _apply_transform(arr: np.ndarray, tf: str) -> np.ndarray:
    if tf == "":
        return arr
    if tf == "T":
        return arr.T
    if arr.ndim == 2:  # in_proj_weight (3D, D)
        q, k, v = np.split(arr, 3, axis=0)
        return {"Q": q.T, "K": k.T, "V": v.T}[tf]
    q, k, v = np.split(arr, 3, axis=0)  # in_proj_bias (3D,)
    return {"Qb": q, "Kb": k, "Vb": v}[tf]


def _flax_shape(tensor: torch.Tensor, path: str) -> Tuple[int, ...]:
    """The flax layout's shape of a port parameter: a kernel is (in, out)."""
    shape = tuple(tensor.shape)
    return shape[::-1] if path.endswith("/kernel") else shape


def _leaf(params: Dict[str, torch.Tensor], path: str) -> Optional[str]:
    """The key of the flax path `path` in the state dict `params`, or
    None."""
    key = torch_name(path.split("/"))
    return key if key in params else None


def synthesize_torch_state_dict(rules, model: nn.Module,
                                seed: int = 0) -> Dict[str, np.ndarray]:
    """A random reference-layout state dict covering every rule whose
    destination `model` has, with source shapes derived from the model's
    parameters (testing utility: import paths run against the released key
    spaces without the released files). The same draws in the same order
    as the JAX package's, so a module with the same leaves gets the same
    dict from the same seed."""
    sd: Dict[str, np.ndarray] = {}
    rng = np.random.default_rng(seed)
    params = model.state_dict()
    for src, dst, tf in rules:
        key = _leaf(params, dst)
        if key is None:
            continue
        shape = _flax_shape(params[key], dst)
        if tf == "T":
            shape = shape[::-1]
        elif tf in ("Q", "K", "V"):
            shape = (3 * shape[1], shape[0])
        elif tf in ("Qb", "Kb", "Vb"):
            shape = (3 * shape[0],)
        if src not in sd:
            sd[src] = rng.standard_normal(shape).astype(np.float32) * 0.02
    return sd


def _apply_rules(sd: Dict[str, Any], rules, model: nn.Module,
                 strict: bool = False
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, List[str]]]:
    """Apply (torch key, flax path, transform) rules onto a copy of
    `model`'s state dict. Returns (state_dict, report): the report lists the
    source keys not consumed and the flax leaves not filled (kept from the
    model)."""
    out = {k: v.detach().clone() for k, v in model.state_dict().items()}
    paths = flax_paths(model)
    used, filled = set(), set()
    for src, dst, tf in rules:
        if src not in sd:
            continue
        key = _leaf(out, dst)
        if key is None:
            continue
        val = _apply_transform(_t(sd[src]), tf)
        want = _flax_shape(out[key], dst)
        if tuple(val.shape) != want:
            raise ValueError(
                f"shape mismatch {src} -> {dst}: {val.shape} vs {want}")
        if dst.endswith("/kernel"):
            val = val.T       # flax (in, out) -> nn.Linear (out, in)
        out[key] = torch.from_numpy(np.ascontiguousarray(val)).to(
            out[key].dtype)
        used.add(src)
        filled.add(dst)
    report = {
        "unused_torch_keys": sorted(set(sd) - used),
        "unfilled_flax_leaves": sorted(set(paths.values()) - filled),
    }
    if strict and report["unfilled_flax_leaves"]:
        raise ValueError(f"unfilled leaves: {report['unfilled_flax_leaves']}")
    return out, report


def import_torch_navigator(
    state_dict: Dict[str, Any], model: nn.Module,
    num_l_layers=9, num_x_layers=4, num_pano_layers=2, has_obj=False,
    strict: bool = False,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, List[str]]]:
    """A reference GlocalTextPathNavCMT state_dict onto the port's
    GridMMNavigator `model` (gridmm_tpu/utils/checkpoint.py:546-556).
    Returns (state_dict for `model`, report)."""
    sd = _strip_prefixes(state_dict)
    rules = navigator_rules(num_l_layers, num_x_layers, num_pano_layers,
                            has_obj)
    return _apply_rules(sd, rules, model, strict)


def remap_pretrain_to_navigator(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Adapt a PRETRAIN checkpoint's key space to the fine-tune layout before
    import (map_nav_src/models/vlnbert_init.py:19-27): strip the 'bert.'
    trunk prefix, keep '*_head'/fusion keys as-is, drop pretrain-only heads
    (mlm_head, image_classifier — the fine-tune model doesn't own them)."""
    out = {}
    for k, v in _strip_prefixes(state_dict).items():
        if k.startswith(("mlm_head.", "image_classifier.", "obj_classifier.")):
            continue
        if k.startswith("bert."):
            k = k[len("bert."):]
        out[k] = v
    return out


def remap_ce_released(ckpt) -> Dict[str, Any]:
    """Normalize a released CE navigator checkpoint to bare trunk keys,
    replicating VLN_CE/.../gridmap/vlnbert_init.py:17-33 exactly.

    Two released nestings exist:
      grid_map.pt       {'vln_bert': {'epoch', 'state_dict', 'optimizer'}, ...}
                        (the discrete fine-tune save, agent_base.py:213-228);
                        inner keys carry 'vln_bert.' (VLNBert wrapper attr)
                        and possibly 'module.' (DDP) prefixes.
      ckpt.{epoch}.pth  {'state_dict': policy.state_dict(), ...}
                        (ss_trainer_GridMap.py:65-75); inner keys carry
                        'net.' (ILPolicy attr) + 'module.' + 'vln_bert.'.
    Pretrain-style 'bert.' trunk prefixes are stripped the same way."""
    if isinstance(ckpt, dict) and isinstance(ckpt.get("vln_bert"), dict):
        ckpt = ckpt["vln_bert"].get("state_dict", ckpt["vln_bert"])
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    out = {}
    for k, v in ckpt.items():
        if k.startswith("net."):
            k = k[len("net."):]
        if k.startswith("module."):
            k = k[len("module."):]
        if k.startswith("bert."):
            k = k[len("bert."):]
        elif k.startswith("vln_bert."):
            k = k[len("vln_bert."):]
        out[k] = v
    return out


# leaves the released grid_map.pt genuinely lacks: the lang2visn branch of the
# x-layers is pretrain-only (never trained or saved by the fine-tune stage)
_PRETRAIN_ONLY_LEAF_MARKERS = ("lang_ffn", "lang_self_att")


def require_navigator_coverage(report: Dict[str, List[str]],
                               what: str = "navigator") -> None:
    """Raise unless the import actually filled the navigator trunk.

    A checkpoint in the wrong key space silently matches zero rules
    (_apply_rules skips absent source keys); this turns that into a hard
    error so a released-weights run can never proceed on random init."""
    unfilled = [p for p in report["unfilled_flax_leaves"]
                if not any(m in p for m in _PRETRAIN_ONLY_LEAF_MARKERS)]
    if unfilled:
        raise ValueError(
            f"{what} import left {len(unfilled)} parameter leaves unfilled "
            f"(checkpoint key space mismatch?). First few: {unfilled[:8]}. "
            f"Unused torch keys (first few): "
            f"{report['unused_torch_keys'][:8]}")


def pretrain_params_to_navigator(pretrain_state: Dict[str, Any],
                                 navigator: Optional[nn.Module] = None
                                 ) -> Dict[str, torch.Tensor]:
    """A GridMMPretrain state dict -> the fine-tune navigator's
    (gridmm_tpu/utils/checkpoint.py:447-472).

    GridMMPretrain holds the whole navigator trunk and heads under `bert.`;
    the pretrain-only heads beside it (mlm_head, image_classifier) are
    dropped, the port's counterpart of the torch remap at
    map_nav_src/models/vlnbert_init.py:19-27. The `bert.` scope is a strict
    superset of the navigator: MLM runs the local encoder's language branch
    (lang_self_att, lang_ffn), which navigation never builds. With
    `navigator`, the result is projected onto exactly its keys (the
    language branch goes) and a navigator key the pretrain dict lacks
    raises."""
    bert = {k[len("bert."):]: v for k, v in pretrain_state.items()
            if k.startswith("bert.")}
    if not bert:
        raise ValueError(f"not a pretrain state dict (no 'bert.' scope): "
                         f"{sorted(pretrain_state)[:6]}")
    if navigator is None:
        return bert
    out = {}
    for k in navigator.state_dict():
        if k not in bert:
            raise ValueError(f"pretrain state dict is missing navigator "
                             f"leaf 'bert.{k}' (have: {sorted(bert)[:8]})")
        out[k] = bert[k]
    return out


# heads the PreTraining wrapper owns directly (pretrain_cmt.py:44-63) — their
# torch keys carry NO 'bert.' prefix even though our tree scopes them inside
# the navigator (models/navigator.py keeps all heads on the trunk)
_WRAPPER_HEAD_PREFIXES = ("global_sap_head.", "local_sap_head.",
                          "grid_sap_head.", "sap_fuse_linear.", "og_head.")


def pretrain_rules(num_l_layers=9, num_x_layers=4, num_pano_layers=2,
                   has_obj=False) -> List[Tuple[str, str, str]]:
    """Key map for GlocalTextPathCMTPreTraining -> GridMMPretrain.

    The trunk is the navigator map under the 'bert.' torch scope
    (pretrain_cmt.py:41 `self.bert = GlocalTextPathCMT(config)`), except the
    SAP/OG heads which the wrapper owns at top level (pretrain_cmt.py:44-63).
    The MLM decoder weight is tied to the word embeddings in both stacks
    (vilmodel.py:274-306 / models/pretrain.py MLMHead) so only the
    transform + output bias carry independent state; RegionClassification is
    net.{0 Linear, 2 LayerNorm, 3 Linear} (pretrain_cmt.py:12-22)."""
    r: List[Tuple[str, str, str]] = []
    for src, dst, tf in navigator_rules(num_l_layers, num_x_layers,
                                        num_pano_layers, has_obj):
        if not src.startswith(_WRAPPER_HEAD_PREFIXES):
            src = "bert." + src
        r.append((src, "bert/" + dst, tf))
    r += [
        ("mlm_head.predictions.transform.dense.weight",
         "mlm_head/transform_dense/kernel", "T"),
        ("mlm_head.predictions.transform.dense.bias",
         "mlm_head/transform_dense/bias", ""),
        ("mlm_head.predictions.transform.LayerNorm.weight",
         "mlm_head/transform_LayerNorm/ln/scale", ""),
        ("mlm_head.predictions.transform.LayerNorm.bias",
         "mlm_head/transform_LayerNorm/ln/bias", ""),
        ("mlm_head.predictions.bias", "mlm_head/bias", ""),
    ]
    for head in ("image_classifier", "obj_classifier"):
        r += [
            (f"{head}.net.0.weight", f"{head}/net_0/kernel", "T"),
            (f"{head}.net.0.bias", f"{head}/net_0/bias", ""),
            (f"{head}.net.2.weight", f"{head}/net_2/ln/scale", ""),
            (f"{head}.net.2.bias", f"{head}/net_2/ln/bias", ""),
            (f"{head}.net.3.weight", f"{head}/net_3/kernel", "T"),
            (f"{head}.net.3.bias", f"{head}/net_3/bias", ""),
        ]
    return r


def import_torch_pretrain(
    state_dict: Dict[str, Any], model: nn.Module,
    num_l_layers=9, num_x_layers=4, num_pano_layers=2, has_obj=False,
    strict: bool = False,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, List[str]]]:
    """Reference pretrain checkpoint (ModelSaver model_step_N.pt, consumed by
    train_r2r.py:106-108 `--checkpoint`) onto a GridMMPretrain `model`, for
    CONTINUING pretraining (the fine-tune handoff is
    remap_pretrain_to_navigator + import_torch_navigator)."""
    sd = _strip_prefixes(state_dict)
    rules = pretrain_rules(num_l_layers, num_x_layers, num_pano_layers,
                           has_obj)
    return _apply_rules(sd, rules, model, strict)


def remap_hf_bert_init(state_dict: Dict[str, Any],
                       double_token_type: bool = False) -> Dict[str, Any]:
    """HF `AutoModel('bert-base')` named_parameters -> pretrain key space.

    Replicates what the reference's `--init_pretrained bert` ACTUALLY loads
    (train_r2r.py:109-118 feeding `from_pretrained(state_dict=...)`): HF
    prepends the 'bert.' base-model prefix, after which only 'embeddings.*'
    matches a GlocalTextPathCMT attribute path — 'encoder.layer.*' does not
    exist there (the language trunk is 'lang_encoder.layer.*',
    vilmodel.py:645) and 'pooler.*' is absent, so both are dropped as
    unexpected keys. The reference BERT init therefore fills ONLY the text
    embedding stack; `import_hf_bert_pretrain(fill_lang_encoder=True)` is
    the beyond-reference opt-in that also reaches the encoder layers.

    ``double_token_type`` replicates the xlm-roberta-base branch
    (train_r2r.py:112-116): the 1-row token-type table is concatenated with
    itself so row 1 can serve image embeddings."""
    out: Dict[str, Any] = {}
    for k, v in state_dict.items():
        if k.startswith("bert."):  # full BertModel/BertForMaskedLM dumps
            k = k[len("bert."):]
        if not k.startswith("embeddings."):
            continue
        arr = _t(v)
        if double_token_type and k == "embeddings.token_type_embeddings.weight":
            arr = np.concatenate([arr, arr], axis=0)
        out["bert." + k] = arr
    return out


def import_hf_bert_pretrain(
    state_dict: Dict[str, Any], model: nn.Module,
    double_token_type: bool = None,
    fill_lang_encoder: bool = False,
    num_l_layers=9, num_x_layers=4, num_pano_layers=2, has_obj=False,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, List[str]]]:
    """`--init_pretrained bert` (train_r2r.py:109-118): start pretraining
    from a released BERT/XLM-R language model.

    ``double_token_type=None`` auto-detects the xlm-roberta case: the source
    table is doubled exactly when its row count is half the model's (the
    reference keys the same branch off lang_bert_name == 'xlm-roberta-base').
    ``fill_lang_encoder=True`` additionally maps encoder.layer.{i} onto
    lang_encoder.layer.{i} for the first num_l_layers, what the reference
    init intends but never achieves (see remap_hf_bert_init)."""
    sd_raw = _strip_prefixes(state_dict)
    if double_token_type is None:
        src_tt = next((v for k, v in sd_raw.items()
                       if k.endswith("embeddings.token_type_embeddings.weight")),
                      None)
        tpl_tt = model.state_dict()["bert.token_type_embeddings.weight"]
        double_token_type = (src_tt is not None
                             and 2 * int(np.shape(src_tt)[0])
                             == int(tpl_tt.shape[0]))
    sd = remap_hf_bert_init(sd_raw, double_token_type)
    mapped = set()
    for k in sd_raw:
        base = k[len("bert."):] if k.startswith("bert.") else k
        if base.startswith("embeddings."):
            mapped.add(k)
    if fill_lang_encoder:
        for k, v in sd_raw.items():
            base = k[len("bert."):] if k.startswith("bert.") else k
            if base.startswith("encoder.layer."):
                sd["bert.lang_encoder.layer."
                   + base[len("encoder.layer."):]] = _t(v)
                mapped.add(k)
    rules = pretrain_rules(num_l_layers, num_x_layers, num_pano_layers,
                           has_obj)
    out, report = _apply_rules(sd, rules, model)
    # surface the keys from_pretrained would drop silently (encoder.layer.*,
    # pooler.*) so the import report is diagnosable
    report["unused_torch_keys"] = sorted(
        set(report["unused_torch_keys"]) | (set(sd_raw) - mapped))
    return out, report


def remap_lxmert_init(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """LXMERT `model_LXRT.pth` -> pretrain key space, transcribing
    train_r2r.py:120-141 exactly — including its two silent no-ops:

      - 'module.' stripped; bert.encoder.layer.* -> bert.lang_encoder.layer.*
        (LXMERT's 9 language layers line up with num_l_layers=9);
      - bert.encoder.x_layers.* fanned out to three targets, of which only
        'bert.local_encoder.encoder.x_layers.*' is a real attribute path:
        the pretrain GlobalMapEncoder has no '.encoder'
        (pretrain_src vilmodel.py:566-576) and grid_txt_encoder is a bare
        CrossmodalEncoder whose layers live at '.x_layers', not
        '.encoder.x_layers' (vilmodel.py:439-445,656) — both extra copies
        are dropped as unexpected keys by from_pretrained, so LXMERT
        x-layers initialize ONLY the local branch. We emit the same dead
        keys and let no rule consume them.
      - cls.predictions.* -> mlm_head.predictions.* (decoder.weight stays
        tied to the word embeddings, as HF tie_weights re-asserts);
      - everything else verbatim (bert.embeddings.* lands on the trunk;
        LXMERT-only keys like visn_fc / pooler are dropped)."""
    out: Dict[str, Any] = {}
    for k, v in state_dict.items():
        k = k.replace("module.", "")
        if "bert.encoder.layer" in k:
            out[k.replace("bert.encoder.layer", "bert.lang_encoder.layer")] = v
        elif "bert.encoder.x_layers" in k:
            for tgt in ("bert.local_encoder.encoder.x_layers",
                        "bert.global_encoder.encoder.x_layers",
                        "bert.grid_txt_encoder.encoder.x_layers"):
                out[k.replace("bert.encoder.x_layers", tgt)] = v
        elif "cls.predictions" in k:
            out[k.replace("cls.predictions", "mlm_head.predictions")] = v
        else:
            out[k] = v
    return out


def import_lxmert_pretrain(
    state_dict: Dict[str, Any], model: nn.Module,
    num_l_layers=9, num_x_layers=4, num_pano_layers=2, has_obj=False,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, List[str]]]:
    """`--init_pretrained lxmert` (train_r2r.py:120-141): start pretraining
    from a released LXMERT checkpoint. Fills embeddings, the 9 language
    layers, the first num_x_layers local cross-layers (LXMERT ships 5; the
    5th is dropped like the reference model drops it) and the MLM head."""
    sd = remap_lxmert_init(state_dict)
    rules = pretrain_rules(num_l_layers, num_x_layers, num_pano_layers,
                           has_obj)
    return _apply_rules(sd, rules, model)


def import_torch_clip_visual(state_dict: Dict[str, Any],
                             model: ClipVisionTransformer
                             ) -> ClipVisionTransformer:
    """OpenAI CLIP 'visual.' tower -> the port's ClipVisionTransformer, in
    place; returns the model (gridmm_tpu/utils/checkpoint.py:800-845).

    conv1 (width, 3, p, p) becomes the patchify Linear, whose input is the
    (ph, pw, channel)-ordered patch. Keys the tower has no use for
    (`visual.proj`, the text tower) are left alone; a missing key raises.
    """
    sd = {k[len("visual."):]: v for k, v in _strip_prefixes(state_dict).items()
          if k.startswith("visual.")}
    width = model.cfg.width

    def t(key):
        return torch.as_tensor(sd[key]).detach().to(torch.float32)

    out = {
        "conv1.weight": t("conv1.weight").permute(0, 2, 3, 1).reshape(
            width, -1),
        "class_embedding": t("class_embedding"),
        "positional_embedding": t("positional_embedding"),
        "ln_pre.weight": t("ln_pre.weight"),
        "ln_pre.bias": t("ln_pre.bias"),
        "ln_post.weight": t("ln_post.weight"),
        "ln_post.bias": t("ln_post.bias"),
    }
    for i in range(model.cfg.layers):
        s, d = f"transformer.resblocks.{i}", f"resblock.{i}"
        out.update({
            f"{d}.attn_in_proj.weight": t(f"{s}.attn.in_proj_weight"),
            f"{d}.attn_in_proj.bias": t(f"{s}.attn.in_proj_bias"),
            f"{d}.attn_out_proj.weight": t(f"{s}.attn.out_proj.weight"),
            f"{d}.attn_out_proj.bias": t(f"{s}.attn.out_proj.bias"),
            f"{d}.mlp_c_fc.weight": t(f"{s}.mlp.c_fc.weight"),
            f"{d}.mlp_c_fc.bias": t(f"{s}.mlp.c_fc.bias"),
            f"{d}.mlp_c_proj.weight": t(f"{s}.mlp.c_proj.weight"),
            f"{d}.mlp_c_proj.bias": t(f"{s}.mlp.c_proj.bias"),
        })
        for ln in ("ln_1", "ln_2"):
            out[f"{d}.{ln}.weight"] = t(f"{s}.{ln}.weight")
            out[f"{d}.{ln}.bias"] = t(f"{s}.{ln}.bias")
    with torch.no_grad():
        model.load_state_dict(out, strict=True)
    return model


def waypoint_rules(num_layers: int = 2,
                   use_rgb: bool = True) -> List[Tuple[str, str, str]]:
    """Key map for the frozen waypoint-predictor checkpoints
    (VLN_CE/waypoint_prediction/TRM_net.py BinaryDistPredictor_TRM /
    DepthDistPredictor_TRM, loaded at base_il_trainer.py:96-117; the state
    dict lives under ckpt['predictor']['state_dict'])."""
    r: List[Tuple[str, str, str]] = [
        # nn.Sequential(Flatten, Linear, ReLU) -> Linear at index 1
        ("visual_fc_depth.1.weight", "visual_fc_depth/kernel", "T"),
        ("visual_fc_depth.1.bias", "visual_fc_depth/bias", ""),
    ]
    if use_rgb:
        r += [
            ("visual_fc_rgb.1.weight", "visual_fc_rgb/kernel", "T"),
            ("visual_fc_rgb.1.bias", "visual_fc_rgb/bias", ""),
            ("visual_merge.0.weight", "visual_merge/kernel", "T"),
            ("visual_merge.0.bias", "visual_merge/bias", ""),
        ]
    for i in range(num_layers):
        r += _bert_layer_rules(f"waypoint_TRM.bert.encoder.layer.{i}",
                               f"layer_{i}")
    r += [
        ("vis_classifier.0.weight", "cls_hidden/kernel", "T"),
        ("vis_classifier.0.bias", "cls_hidden/bias", ""),
        ("vis_classifier.2.weight", "cls_out/kernel", "T"),
        ("vis_classifier.2.bias", "cls_out/bias", ""),
    ]
    return r


def import_torch_waypoint(
    state_dict: Dict[str, Any], model: nn.Module,
    num_layers: int = 2, use_rgb: bool = True, strict: bool = False,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, List[str]]]:
    """A released waypoint checkpoint (TRM_net key space) onto the port's
    WaypointPredictor `model` (gridmm_tpu/utils/checkpoint.py:783). Pass
    ckpt['predictor']['state_dict'] for the released files. The depth-only
    (RxR) checkpoint also carries visual_merge / mergefeats_LayerNorm
    weights the reference forward never applies: they are reported unused,
    not errors. Returns (state_dict for `model`, report)."""
    sd = _strip_prefixes(state_dict)
    return _apply_rules(sd, waypoint_rules(num_layers, use_rgb), model,
                        strict)


def import_timm_vit(state_dict: Dict[str, Any],
                    model: ClipVisionTransformer) -> Dict[str, torch.Tensor]:
    """timm vit_base_patch16_224 state_dict -> a strict state dict for the
    port's ClipVisionTransformer built with `vit_b16_timm()`
    (gridmm_tpu/utils/checkpoint.py:848), the CE policy's live view encoder
    (vit_base_p16_224.pth; gridmap/vilmodel.py:631). patch_embed.proj
    (width, 3, p, p) becomes the patchify Linear, whose input is the
    (ph, pw, channel)-ordered patch; a missing key raises."""
    sd = _strip_prefixes(state_dict)
    # some timm checkpoints nest under 'model'
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items()
              if k.startswith("model.")}
    width = model.cfg.width

    def t(key):
        return torch.as_tensor(sd[key]).detach().to(torch.float32)

    out = {
        "conv1.weight": t("patch_embed.proj.weight").permute(
            0, 2, 3, 1).reshape(width, -1),
        "conv1.bias": t("patch_embed.proj.bias"),
        "class_embedding": t("cls_token").reshape(width),
        "positional_embedding": t("pos_embed").reshape(-1, width),
        "ln_post.weight": t("norm.weight"),
        "ln_post.bias": t("norm.bias"),
    }
    for i in range(model.cfg.layers):
        s, d = f"blocks.{i}", f"resblock.{i}"
        out.update({
            f"{d}.attn_in_proj.weight": t(f"{s}.attn.qkv.weight"),
            f"{d}.attn_in_proj.bias": t(f"{s}.attn.qkv.bias"),
            f"{d}.attn_out_proj.weight": t(f"{s}.attn.proj.weight"),
            f"{d}.attn_out_proj.bias": t(f"{s}.attn.proj.bias"),
            f"{d}.mlp_c_fc.weight": t(f"{s}.mlp.fc1.weight"),
            f"{d}.mlp_c_fc.bias": t(f"{s}.mlp.fc1.bias"),
            f"{d}.mlp_c_proj.weight": t(f"{s}.mlp.fc2.weight"),
            f"{d}.mlp_c_proj.bias": t(f"{s}.mlp.fc2.bias"),
            f"{d}.ln_1.weight": t(f"{s}.norm1.weight"),
            f"{d}.ln_1.bias": t(f"{s}.norm1.bias"),
            f"{d}.ln_2.weight": t(f"{s}.norm2.weight"),
            f"{d}.ln_2.bias": t(f"{s}.norm2.bias"),
        })
    return strict_state_dict(model, out, "timm ViT import")


def strict_state_dict(model: nn.Module, out: Dict[str, torch.Tensor],
                      what: str) -> Dict[str, torch.Tensor]:
    """`out` when it fills every parameter of `model` with a tensor of the
    parameter's shape and holds no other key; raises otherwise."""
    want = model.state_dict()
    missing = sorted(set(want) - set(out))
    extra = sorted(set(out) - set(want))
    if missing or extra:
        raise KeyError(f"{what}: parameters not filled {missing}; keys "
                       f"without a parameter {extra}")
    for k, v in out.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(f"{what}: shape mismatch at {k}: "
                             f"{tuple(v.shape)} vs {tuple(want[k].shape)}")
    return out

"""Serving artifacts for the navigator via `torch.export` (twin of
gridmm_tpu/utils/export.py).

Two per-episode serving graphs are exported as `torch.export`
programs (`.pt2` files):

  * ``language`` - the instruction encoder, run once per admission;
  * ``nav_step`` - the per-step graph (panorama encode, point-buffer append
    and egocentric grid assignment, node aggregation, navigation forward),
    the one call the interactive agent makes per action.

Parameters stay a runtime input (a dict keyed like the navigator's
`state_dict`), so one bundle serves every checkpoint of the same
architecture, and a program is called WITHOUT the model code: loading needs
only `gridmm_tpu_torch.ops.grid_pool`, which registers the custom op
`gridmm::grid_pool_fwd` that the step graph calls. The bundle holds no
weights.

Calling convention (plain dicts and tensors, so that no class of this
package is needed to load a program; ``params`` is a plain `dict` of the
navigator's `state_dict` entries, in `state_dict` order):

  * ``language(params, txt_ids (B, T) int32, txt_mask (B, T) bool)
    -> txt_embeds (B, T, H)``;
  * ``nav_step(params, txt_embeds, txt_mask, carry, x) -> (carry, outputs)``
    with ``carry`` and ``x`` dicts of the `NavCarry` / `StepInputs` fields
    (`carry_to_dict`) and ``outputs`` a dict of the non-None `NavOutputs`
    fields. The step returns the new carry by value and leaves the carry it
    was given untouched (the JAX artifact has no donation either): it
    copies the point buffer before it appends this step's points.

A program is traced for one device type and one batch; the manifest
records both.

`export_navigator_serving_sharded` is the multi-device export: one pair of
programs per rank of a (data, model) mesh (`<name>_r<rank>.pt2`), each
over the rank's share of the batch and its shards of the parameters (the
parallel/mesh.py rules), with the tensor-parallel sums (and, with fsdp,
the all-gathers over `data`; with int8, the absmax MAXes) inside the
program as functional collectives. The manifest records the mesh, each parameter's placement
and the collectives' process-group names; `from_bundle` runs such a
bundle on every rank of the same mesh, and raises under any other.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch


def zero_step_inputs(cfg, batch: int, device="cuda"):
    """Zero-filled StepInputs at the static serving caps (B, ...)."""
    from gridmm_tpu_torch.train.step import StepInputs

    sh, mc, gc = cfg.shapes, cfg.model, cfg.grid
    b, v, g = batch, sh.max_vp_len, sh.max_gmap_len
    d = mc.image_feat_size
    f32, i32, bool_ = torch.float32, torch.int32, torch.bool

    def z(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(shape, value):
        return torch.full(shape, value, dtype=i32, device=device)

    return StepInputs(
        view_img_fts=z(b, v - 1, d),
        loc_fts=z(b, v - 1, mc.angle_feat_size + 3),
        nav_types=z(b, v - 1, dtype=i32),
        view_mask=z(b, v - 1, dtype=bool_),
        depth=z(b, gc.num_views, gc.patches_per_view),
        patch_fts=z(b, gc.points_per_step, d),
        pos_xy=z(b, 2),
        heading=z(b),
        gmap_step_ids=z(b, g, dtype=i32),
        gmap_pos_fts=z(b, g, mc.angle_feat_size + 3),
        gmap_mask=z(b, g, dtype=bool_),
        gmap_visited_mask=z(b, g, dtype=bool_),
        cur_node_idx=z(b, dtype=i32),
        cand_gmap_idx=full((b, v - 1), -1),
        vp_pos_fts=z(b, v, 2 * mc.angle_feat_size + 6),
        vp_nav_mask=z(b, v, dtype=bool_),
        fused_add_idx=full((b, g), -2),
        cand_backtrack_mask=z(b, v, dtype=bool_),
        target=z(b, dtype=i32),
        grid_target=z(b, dtype=i32),
        vp_obj_mask=z(b, v, dtype=bool_),
        obj_target=z(b, dtype=i32),
    )


def carry_to_dict(carry) -> Dict[str, torch.Tensor]:
    """NavCarry -> the flat dict of the programs' calling convention."""
    return {**carry.point_state._asdict(), "gmap_sum": carry.gmap_sum,
            "gmap_cnt": carry.gmap_cnt}


def dict_to_carry(d):
    """The flat carry dict -> NavCarry."""
    from gridmm_tpu_torch.ops.geometry import PointCloudState
    from gridmm_tpu_torch.train.step import NavCarry

    return NavCarry(PointCloudState(*(d[f] for f in PointCloudState._fields)),
                    d["gmap_sum"], d["gmap_cnt"])


class _Bound:
    """The navigator called with parameters given at call time
    (`torch.func.functional_call`); what `nav_device_step` calls."""

    def __init__(self, model, params):
        self.model = model
        self.params = params

    def __call__(self, mode, batch):
        return torch.func.functional_call(self.model, self.params,
                                          (mode, batch))


class _Language(torch.nn.Module):
    def __init__(self, model, gather=None):
        super().__init__()
        # kept out of the module tree: parameters come in as an input
        self._model = [model]
        self._gather = gather

    def forward(self, params, txt_ids, txt_mask):
        if self._gather is not None:
            params = self._gather(params)
        return _Bound(self._model[0], params)(
            "language", {"txt_ids": txt_ids, "txt_mask": txt_mask})


class _NavStep(torch.nn.Module):
    def __init__(self, model, cfg, gather=None):
        super().__init__()
        self._model = [model]
        self.cfg = cfg
        self._gather = gather

    def forward(self, params, txt_embeds, txt_mask, carry, x):
        from gridmm_tpu_torch.train.step import StepInputs, nav_device_step

        if self._gather is not None:
            params = self._gather(params)
        # by value: append_panorama writes the point buffer in place, so
        # the step appends into a copy and the caller's carry stays intact
        carry = dict_to_carry({k: v.clone() for k, v in carry.items()})
        new, out = nav_device_step(_Bound(self._model[0], params), self.cfg,
                                   txt_embeds, txt_mask, carry,
                                   StepInputs(**x))
        return carry_to_dict(new), {k: v for k, v in out._asdict().items()
                                    if v is not None}


def export_navigator_serving(model, cfg, state_dict, batch: int = 1,
                             device="cuda"):
    """Export {language, nav_step} as `torch.export.ExportedProgram`s,
    traced under `torch.no_grad()` on `serving_cfg(cfg)` at `batch` rows on
    `device` with `zero_step_inputs`-shaped example inputs. `state_dict`
    (the navigator's, on `device`) gives the parameters' shapes and types;
    the programs take parameters as their first input and keep none."""
    from gridmm_tpu_torch.serve.engine import serving_cfg

    cfg = serving_cfg(cfg)  # exported graphs keep rows batch-independent
    with torch.device("meta"):
        served = type(model)(cfg.model)
    served.eval()
    return _export(served, cfg, dict(state_dict), batch, device)


def _export(served, cfg, params, batch, device, gather=None):
    """torch.export of {language, nav_step} on `served` (a meta module
    whose parameters come in as `params`) at `batch` rows."""
    from gridmm_tpu_torch.train.step import init_carry

    t = cfg.shapes.max_txt_len
    txt_ids = torch.zeros((batch, t), dtype=torch.int32, device=device)
    txt_mask = torch.zeros((batch, t), dtype=torch.bool, device=device)
    carry = carry_to_dict(init_carry(cfg, batch, device=device))
    x = zero_step_inputs(cfg, batch, device)._asdict()
    txt_embeds = torch.zeros((batch, t, cfg.model.hidden_size),
                             device=device)
    with torch.no_grad():
        lang = torch.export.export(_Language(served, gather),
                                   (params, txt_ids, txt_mask))
        step = torch.export.export(_NavStep(served, cfg, gather),
                                   (params, txt_embeds, txt_mask, carry, x))
    for ep in (lang, step):
        ep.example_inputs = None  # saved with the program otherwise
    return {"language": lang, "nav_step": step}


def export_navigator_serving_sharded(model, cfg, state_dict, mesh,
                                     batch: int, fsdp: bool = False,
                                     device="cuda"):
    """This rank's {language, nav_step} programs over a (data, model)
    mesh (every rank calls it, with the same full `state_dict`): its share
    of `batch` (batch / dp rows; `batch % dp` raises), its parameter shards
    by the parallel/mesh.py rules (fsdp also over `data`, all-gathered in
    the program), the tensor-parallel sums in the program. Returns
    (exports, the manifest's "mesh" entry)."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    from gridmm_tpu_torch.parallel.mesh import (local_slice, mesh_shape,
                                                placements,
                                                set_int8_batch_group,
                                                set_tp_roles)
    from gridmm_tpu_torch.serve.engine import serving_cfg

    dp, mp = mesh_shape(mesh)
    if batch % dp:
        raise ValueError(f"serving batch {batch} not divisible by data-axis "
                         f"size {dp}")
    dp_rank, mp_rank = mesh.get_local_rank(0), mesh.get_local_rank(1)
    data_group, model_group = mesh.get_group(0), mesh.get_group(1)
    cfg = serving_cfg(cfg)
    with torch.device("meta"):
        served = type(model)(cfg.model)
    served.eval()
    pls = placements(served, dp, mp, fsdp)
    if mp > 1:
        set_tp_roles(served, pls, model_group, mp, mp_rank)
    # int8 (an int8 config): each activation's absmax over the whole batch
    set_int8_batch_group(served, data_group)
    params = {k: local_slice(v, pls[k], dp, mp, dp_rank, mp_rank)
              if k in pls else v for k, v in state_dict.items()}
    gathered = {k: pl[0] for k, pl in pls.items()
                if pl[0] is not None and dp > 1}

    def gather(p):
        """fsdp: each data-sharded parameter all-gathered over `data`."""
        return {k: funcol.all_gather_tensor(v, gathered[k], data_group)
                if k in gathered else v for k, v in p.items()}

    exports = _export(served, cfg, params, batch // dp, device,
                      gather if gathered else None)
    # a process group's name is the calling process's own (each rank
    # names the groups it is in), so the manifest keeps every rank's
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, {"data": data_group.group_name,
                                   "model": model_group.group_name})
    entry = {"data": dp, "model": mp, "fsdp": fsdp,
             "placements": {k: list(v) for k, v in pls.items()},
             "groups": names}
    return exports, entry


def save_serving_bundle(exports: dict, out_dir: str, cfg=None,
                        extra_manifest: Optional[dict] = None,
                        rank: Optional[int] = None,
                        world: int = 1) -> dict:
    """Write `<out_dir>/<name>.pt2` for each program and a manifest.json
    with the keys of the JAX bundle's (`torch_version` in the place of
    `jax_version`). A rank of a sharded export writes `<name>_r<rank>.pt2`
    (the manifest names the file pattern and `world` devices); only rank 0
    writes the manifest, after every rank's files, and every rank returns
    once it is written."""
    os.makedirs(out_dir, exist_ok=True)
    manifest = {"torch_version": torch.__version__, "artifacts": {}}
    for name, ep in exports.items():
        fname = f"{name}.pt2" if rank is None else f"{name}_r{rank}.pt2"
        torch.export.save(ep, os.path.join(out_dir, fname))
        user = set(ep.graph_signature.user_inputs)
        devices = sorted({n.meta["val"].device.type for n in ep.graph.nodes
                          if n.op == "placeholder" and n.name in user
                          and isinstance(n.meta.get("val"), torch.Tensor)})
        manifest["artifacts"][name] = {
            "file": fname if rank is None else f"{name}_r{{rank}}.pt2",
            "platforms": devices,
            "num_args": len(ep.graph_signature.user_inputs),
            "nr_devices": world,
        }
    if cfg is not None:
        manifest["model"] = {
            "hidden_size": cfg.model.hidden_size,
            "num_l_layers": cfg.model.num_l_layers,
            "num_x_layers": cfg.model.num_x_layers,
            "image_feat_size": cfg.model.image_feat_size,
            "max_txt_len": cfg.shapes.max_txt_len,
            "max_gmap_len": cfg.shapes.max_gmap_len,
            "max_vp_len": cfg.shapes.max_vp_len,
            "max_points": cfg.shapes.max_points,
        }
    if extra_manifest:
        manifest.update(extra_manifest)
    if rank is None:
        _write_manifest(out_dir, manifest)
        return manifest
    import torch.distributed as dist

    # every rank's programs are on disk before the manifest names them,
    # and the manifest is before any rank returns (to load the bundle)
    dist.barrier()
    if rank == 0:
        _write_manifest(out_dir, manifest)
    dist.barrier()
    return manifest


def _write_manifest(out_dir: str, manifest: dict) -> None:
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)


def load_exported(path: str):
    """Load one program; call it through `.module()`. Needs no model code:
    importing the pool module registers the op the step graph calls."""
    import gridmm_tpu_torch.ops.grid_pool  # noqa: F401

    return torch.export.load(path)

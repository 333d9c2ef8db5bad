"""Device mesh, partition rules and the sharded parameters (twin of
gridmm_tpu/parallel/mesh.py).

The JAX package runs one controller over N devices and lets XLA shard the
program (SPMD). Here, as in the reference (map_nav_src/utils/
distributed.py, DDP over NCCL), one process runs on each device:

  * `make_mesh` lays the launched world (torchrun or env://; a bare process
    is a world of 1 on its device) out as a `DeviceMesh` of shape (dp, mp)
    with dims (`data`, `model`), and keeps the JAX divisibility error;
  * the partition rules are the JAX regexes verbatim, matched against each
    parameter's flax path (`convert.flax_paths`), and `placements`
    translates them to the torch layout: `P(None, "model")` on an (in, out)
    kernel is dim 0 of the (out, in) Linear weight (column-parallel),
    `P("model", None)` dim 1 (row-parallel), column-parallel biases dim 0,
    the word embeddings dim 0 (the vocabulary);
  * `ShardedParams` makes each parameter a `DTensor` over the mesh with
    those placements. The modules compute on plain local tensors
    (`compute_params`): a parameter sharded over `data` (fsdp) is
    all-gathered, one sharded over `model` stays the rank's shard and the
    module runs the Megatron collectives itself (parallel/tp.py). After the
    backward, `reduce_grads` sums every gradient over `data`: one flat
    all-reduce of the gradients of the parameters that `data` leaves whole
    (what DDP does), one flat reduce-scatter of those that fsdp shards over
    `data`, of which each rank keeps its slice (what FSDP does).

fsdp=True shards each kernel over `data` on the dim JAX picks, the first
one the model rules leave whole, and leaves it whole where dp does not
divide it (`param_shardings`, mesh.py:65-104); biases, LayerNorms and
embeddings stay replicated, as in JAX. Its parameters are gathered once
for a whole update and its gradients exist in full until `reduce_grads`:
fsdp lowers what a rank holds between updates (parameters, optimizer
state), not an update's peak, where XLA may gather each use on its own.
FSDP2's `fully_shard` shards differently (always dim 0, every parameter,
padded where dp does not divide) and gathers in module hooks that fire on
`forward` only.

The data-parallel reduction is written out rather than left to DDP,
`replicate` or FSDP2, whose hooks follow the module's `forward`: the
pretraining tasks call the model's methods (`encode`,
`forward_mlm_logits`, ...), which no forward hook sees, and an update
calls the navigator through several modes and steps, so that DDP as it
is built leaves buckets unreduced.
tests/test_torch_parallel.py `test_ddp_does_not_reduce_the_port_updates`
holds both. The numbers are the same either way: the gradients are the
global batch's, summed exactly once, and the losses divide by the global
counts.

The JAX module's `commit_state`, `commit_and_pin` and
`prepare_train_step` only keep XLA from recompiling a step whose input
shardings drift (mesh.py:129-174); eager torch compiles nothing, so the
port has no counterpart.
"""

from __future__ import annotations

import contextlib
import math
import os
import re
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from gridmm_tpu_torch.config import MeshConfig
from gridmm_tpu_torch.parallel.tp import TensorParallel

# Parameter partition rules: (regex on the flax path) -> spec over the flax
# (in, out) kernel, verbatim from the JAX package. Sharding the out dim of
# the up-projections and the in dim of the down-projections over `model`
# gives Megatron-style TP with one sum per block.
_PARAM_RULES = [
    (r"intermediate_dense.*kernel$", (None, "model")),
    (r"linear1.*kernel$", (None, "model")),
    (r"output_dense.*kernel$", ("model", None)),
    (r"linear2.*kernel$", ("model", None)),
    (r"(query|key|value).*kernel$", (None, "model")),
    (r"attn_out.*kernel$", ("model", None)),
    # BERT-style attention out-projections take the model-sharded heads:
    # row-parallel (the FFN out-projection is output_dense, above)
    (r"output/dense/kernel$", ("model", None)),
    # column-parallel biases live on the sharded out dim; the biases of
    # row-parallel projections stay replicated (added after the sum)
    (r"(query|key|value)/bias$", ("model",)),
    (r"intermediate_dense.*bias$", ("model",)),
    (r"linear1.*bias$", ("model",)),
    (r"word_embeddings.*embedding$", ("model", None)),
]

Spec = Tuple[Optional[str], ...]
# (dim sharded over `data` or None, dim sharded over `model` or None), in
# the torch layout
Placement = Tuple[Optional[int], Optional[int]]


def param_spec(path: str, fsdp: bool = False) -> Spec:
    """The JAX `param_spec`: the spec of a flax path, () = replicated."""
    for pattern, spec in _PARAM_RULES:
        if re.search(pattern, path):
            if fsdp:
                # ZeRO-3 style: also shard the first dim left whole over
                # `data`
                dims = list(spec)
                for i, d in enumerate(dims):
                    if d is None:
                        dims[i] = "data"
                        break
                return tuple(dims)
            return spec
    if fsdp and path.endswith("kernel"):
        return ("data",)
    return ()


def _torch_dim(path: str, ndim: int, flax_dim: int) -> int:
    """A flax dim of a leaf in the torch layout: a Dense kernel (in, out)
    is the (out, in) weight, a Conv kernel HWIO is OIHW."""
    if not path.endswith("kernel"):
        return flax_dim
    if ndim == 4:
        return (2, 3, 1, 0)[flax_dim]
    return ndim - 1 - flax_dim


def placements(model: nn.Module, dp: int, mp: int, fsdp: bool = False
               ) -> Dict[str, Placement]:
    """{parameter name: (data dim, model dim)} of every parameter, in the
    torch layout, by the JAX rules. Where fsdp's `data` dim does not divide
    by dp the fsdp sharding is dropped, as JAX `param_shardings` does;
    where the `model` dim does not divide by mp this raises (GSPMD pads
    such a shard; the port's modules need equal shards)."""
    from gridmm_tpu_torch.convert import flax_paths

    paths = flax_paths(model)
    out: Dict[str, Placement] = {}
    for name, p in model.named_parameters():
        path = paths[name]
        # the flax shape: a kernel's dims in flax order
        shape = tuple(p.shape)
        if path.endswith("kernel"):
            shape = tuple(shape[_torch_dim(path, p.ndim, i)]
                          for i in range(p.ndim))
        spec = param_spec(path, fsdp)
        if fsdp and "data" in spec:
            i = spec.index("data")
            if i >= len(shape) or shape[i] % dp:
                spec = param_spec(path, False)
        dims = {}
        for i, axis in enumerate(spec):
            if axis is not None:
                dims[axis] = _torch_dim(path, p.ndim, i)
        if "model" in dims and p.shape[dims["model"]] % mp:
            raise ValueError(
                f"{name}: dim {dims['model']} of size "
                f"{p.shape[dims['model']]} is not divisible by the model "
                f"axis size {mp} (tensor parallelism needs equal shards)")
        out[name] = (dims.get("data"), dims.get("model"))
    return out


def local_slice(full: torch.Tensor, pl: Placement, dp: int, mp: int,
                dp_rank: int, mp_rank: int) -> torch.Tensor:
    """The slice of a full tensor of a parameter's shape that rank
    (dp_rank, mp_rank) of a (dp, mp) mesh holds under placement `pl`."""
    d, m = pl
    if m is not None:
        full = full.chunk(mp, dim=m)[mp_rank]
    if d is not None:
        full = full.chunk(dp, dim=d)[dp_rank]
    return full


def set_tp_roles(model: nn.Module, pls: Dict[str, Placement], group,
                 mp: int, mp_rank: int) -> None:
    """Give every module whose parameters `pls` shards over `model` its
    tensor-parallel role (parallel/tp.py): a Dense column- or row-parallel,
    the word embeddings vocabulary-parallel; raise where a module has no
    such form or an attention's heads do not divide by mp."""
    from gridmm_tpu_torch.models.layers import (Dense, Embedding,
                                                MultiHeadAttention)

    by_module: Dict[str, Dict[str, Placement]] = {}
    for name, pl in pls.items():
        mod, _, leaf = name.rpartition(".")
        by_module.setdefault(mod, {})[leaf] = pl
    for mod_name, leaves in by_module.items():
        dims = {leaf: pl[1] for leaf, pl in leaves.items()
                if pl[1] is not None}
        if not dims:
            continue
        mod = model.get_submodule(mod_name)
        kind = None
        if isinstance(mod, Dense) and "weight" in dims:
            kind = "col" if dims["weight"] == 0 else "row"
            want = {"weight": dims["weight"], **(
                {"bias": 0} if kind == "col" and mod.bias is not None
                else {})}
            if dims != want:
                kind = None
        elif isinstance(mod, Embedding) and dims == {"weight": 0}:
            kind = "vocab"
        if kind is None:
            raise ValueError(f"{mod_name} ({type(mod).__name__}): no "
                             f"tensor-parallel form for {dims}")
        mod.tp = TensorParallel(kind, group, mp, mp_rank)
    for name, mod in model.named_modules():
        if isinstance(mod, MultiHeadAttention):
            if mod.query.tp is None or mod.query.tp.kind != "col":
                raise ValueError(f"{name}: q/k/v must be column-parallel")
            h = mod.cfg.num_attention_heads
            if h % mp:
                raise ValueError(
                    f"{name}: {h} attention heads are not divisible by "
                    f"the model axis size {mp}")


def set_int8_batch_group(model: nn.Module, group) -> None:
    """Give every int8 layer (models/layers.Int8Dense) the process group
    that splits the batch, over which it takes its activation's absmax."""
    from gridmm_tpu_torch.models.layers import Int8Dense

    for mod in model.modules():
        if isinstance(mod, Int8Dense):
            mod.batch_group = group


# ------------------------------------------------------------ the world
def init_world(device: str = "cuda", multihost: bool = False) -> bool:
    """Join the launched world if there is none yet: from the environment
    (torchrun's RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) when it names
    one or when `multihost` asks for it, else a world of 1. NCCL on the
    card, gloo on the CPU. Returns True if this call made the process
    group (the caller then ends it with `dist.destroy_process_group`)."""
    if dist.is_initialized():
        return False
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(local_device(device))
    backend = "nccl" if cuda else "gloo"
    if multihost or "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return True


def local_device(device: str = "cuda") -> torch.device:
    """This rank's device: on the card the one LOCAL_RANK names (torchrun
    starts one process per card), else `device` as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        n = torch.cuda.device_count()
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % n)
    return dev


def make_mesh(cfg: MeshConfig, device: str = "cuda"):
    """A (dp, mp) DeviceMesh over the process group's world, dims named
    (cfg.data_axis, cfg.model_axis). dp defaults to world // mp; the JAX
    error where dp * mp is not the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    mp = max(1, cfg.mp_size)
    dp = cfg.dp_size if cfg.dp_size > 0 else n // mp
    if dp * mp != n:
        raise ValueError(f"mesh {dp}x{mp} != {n} devices")
    return init_device_mesh(torch.device(device).type, (dp, mp),
                            mesh_dim_names=(cfg.data_axis, cfg.model_axis))


def mesh_shape(mesh) -> Tuple[int, int]:
    """(dp, mp) of a mesh."""
    return mesh.size(0), mesh.size(1)


def data_rank(mesh) -> int:
    """This rank's coordinate on the `data` dim: the shard of the batch it
    holds (ranks of one `model` group hold the same one)."""
    return mesh.get_local_rank(0)


# ------------------------------------------------------------ the batch
def shard_batch(tree, rank: int, n: int, dim: int = 0):
    """The rank's 1/n slice of every array of a batch (an array or nested
    NamedTuples of arrays) along `dim`; raises where n does not divide
    it."""
    if isinstance(tree, tuple):
        return type(tree)(*(shard_batch(v, rank, n, dim) for v in tree))
    size = tree.shape[dim]
    if size % n:
        raise ValueError(f"batch dim {dim} of size {size} is not divisible "
                         f"by the data axis size {n}")
    k = size // n
    idx = (slice(None),) * dim + (slice(rank * k, (rank + 1) * k),)
    return tree[idx]


def shard_trajectory_batch(batch, rank: int, n: int):
    """A TrajectoryBatch's rank slice: the text arrays are (B, ...), the
    step arrays (S, B, ...) (the JAX `trajectory_batch_shardings`)."""
    return type(batch)(shard_batch(batch.txt_ids, rank, n),
                       shard_batch(batch.txt_mask, rank, n),
                       shard_batch(batch.steps, rank, n, dim=1))


# ------------------------------------------------------------ parameters
def _slots(model: nn.Module) -> Iterator[Tuple[nn.Module, str, str]]:
    """(module, attribute, full name) of every parameter registration."""
    for mod_name, mod in model.named_modules(remove_duplicate=False):
        for leaf in list(mod._parameters):
            if mod._parameters[leaf] is not None:
                yield mod, leaf, f"{mod_name}.{leaf}" if mod_name else leaf


class ShardedParams:
    """`model`'s parameters as DTensors over `mesh` (dims data, model) by
    the JAX rules, and the module roles that tensor parallelism needs.

    Make it before the optimizer: the parameters are replaced. Every rank
    must hold the same full weights when it is made (the same seed or
    checkpoint); each keeps its slices."""

    def __init__(self, model: nn.Module, mesh, fsdp: bool = False):
        from torch.distributed.tensor import DTensor, Replicate, Shard

        from gridmm_tpu_torch.models.layers import Int8Dense

        if any(isinstance(m, Int8Dense) for m in model.modules()):
            # an update through round() has no gradient; the int8 trunk is
            # sharded for serving by utils/export.py
            raise ValueError("int8_matmuls is a serving path: export it "
                             "over a mesh with export_serving --int8 "
                             "--mesh auto; the parallel layer's updates "
                             "and rollouts shard f32 only")
        self.model, self.mesh, self.fsdp = model, mesh, fsdp
        self.dp, self.mp = mesh_shape(mesh)
        self.dp_rank = mesh.get_local_rank(0)
        self.mp_rank = mesh.get_local_rank(1)
        self.data_group = mesh.get_group(0)
        self.model_group = mesh.get_group(1)
        self.placements = placements(model, self.dp, self.mp, fsdp)

        if self.mp > 1:
            set_tp_roles(model, self.placements, self.model_group, self.mp,
                         self.mp_rank)

        def spec(name):
            # a dim of size 1 holds the whole tensor: Replicate, so that
            # no collective runs over it
            d, m = self.placements[name]
            return [Replicate() if d is None or self.dp == 1 else Shard(d),
                    Replicate() if m is None or self.mp == 1 else Shard(m)]

        sharded: Dict[int, nn.Parameter] = {}
        self._names: Dict[int, str] = {}
        for mod, leaf, name in list(_slots(model)):
            p = mod._parameters[leaf]
            if id(p) not in sharded:
                local = self._local_slice(p.detach(), self.placements[name])
                dt = DTensor.from_local(local.contiguous().clone(), mesh,
                                        spec(name), run_check=False)
                new = nn.Parameter(dt, requires_grad=p.requires_grad)
                sharded[id(p)] = new
                self._names[id(new)] = name
            mod._parameters[leaf] = sharded[id(p)]
        # the DTensor parameters, in named_parameters order
        self.params: List[nn.Parameter] = list(model.parameters())
        self._leaves: Optional[Dict[int, torch.Tensor]] = None

    # ---- layouts
    def _local_slice(self, full: torch.Tensor, pl: Placement
                     ) -> torch.Tensor:
        return local_slice(full, pl, self.dp, self.mp, self.dp_rank,
                           self.mp_rank)

    def full_tensor(self, p: nn.Parameter, local: torch.Tensor
                    ) -> torch.Tensor:
        """A tensor laid out like parameter `p`'s local shard, gathered to
        the full shape (a collective: every rank calls it)."""
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(local, self.mesh, p.placements,
                                  run_check=False).full_tensor()

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state dict with full tensors: the file one rank
        writes (every rank calls it)."""
        from torch.distributed.tensor import DTensor

        return {k: v.full_tensor() if isinstance(v, DTensor) else v
                for k, v in self.model.state_dict().items()}

    def load_state_dict(self, full: Dict[str, torch.Tensor]) -> None:
        """Load a full state dict (the file one rank writes): each rank
        keeps its slices. Strict, as `load_state_dict(strict=True)`."""
        differ = set(full) ^ set(self.model.state_dict())
        if differ:
            raise KeyError(f"state dict and model differ in {sorted(differ)}")
        own = dict(self.model.named_parameters())
        with torch.no_grad():
            for name, p in own.items():
                local = self._local_slice(full[name], self.placements[name])
                p.to_local().copy_(local)
            for name, b in self.model.named_buffers():
                if name in full:
                    b.copy_(full[name])

    def full_optimizer_state(self, optimizer) -> dict:
        """`optimizer.state_dict()` with every per-parameter tensor of the
        shard's shape gathered to the full shape (every rank calls it)."""
        sd = optimizer.state_dict()
        params = [p for g in optimizer.param_groups for p in g["params"]]
        for i, st in sd["state"].items():
            p = params[i]
            shape = p.to_local().shape
            sd["state"][i] = {
                k: self.full_tensor(p, v) if isinstance(v, torch.Tensor)
                and v.shape == shape and v.ndim else v
                for k, v in st.items()}
        return sd

    def load_optimizer_state(self, optimizer, full: dict) -> None:
        """The inverse of `full_optimizer_state`: each rank keeps its
        slices."""
        params = [p for g in optimizer.param_groups for p in g["params"]]
        state = {}
        for i, st in full["state"].items():
            p = params[int(i)]
            pl = self.placements[self._names[id(p)]]
            state[i] = {k: self._local_slice(v, pl).clone()
                        if isinstance(v, torch.Tensor)
                        and tuple(v.shape) == tuple(p.shape) and v.ndim
                        else v for k, v in st.items()}
        optimizer.load_state_dict({**full, "state": state})

    def unshard(self) -> None:
        """Make the module one process's again: full, plain parameters on
        every rank (a collective) and no tensor-parallel roles."""
        with torch.no_grad():
            full = {id(p): nn.Parameter(p.full_tensor(),
                                        requires_grad=p.requires_grad)
                    for p in self.params}
        for mod, leaf, _ in list(_slots(self.model)):
            mod._parameters[leaf] = full[id(mod._parameters[leaf])]
        for mod in self.model.modules():
            vars(mod).pop("tp", None)
        self.params = []

    # ---- the forward's view
    @contextlib.contextmanager
    def compute_params(self, grad: bool = False):
        """Within: every DTensor parameter of the model is the plain tensor
        the modules compute with (gathered over `data` where fsdp shards
        it, the rank's shard over `model`). grad=True makes each a leaf
        whose gradient `reduce_grads` collects."""
        from torch.distributed.tensor import Replicate

        if self._leaves is not None:
            raise RuntimeError("compute_params is already active")
        slots = list(_slots(self.model))
        views: Dict[int, torch.Tensor] = {}
        originals: List[Tuple[nn.Module, str, nn.Parameter]] = []
        for mod, leaf, _ in slots:
            p = mod._parameters[leaf]
            if id(p) not in views:
                if p.placements[0].is_shard():
                    t = p.redistribute(self.mesh, [Replicate(),
                                                   p.placements[1]])
                    t = t.to_local()
                else:
                    t = p.to_local()
                t = t.detach()
                if grad and p.requires_grad:
                    t.requires_grad_(True)
                views[id(p)] = t
            originals.append((mod, leaf, p))
            mod._parameters[leaf] = views[id(p)]
        self._leaves = views
        # an update's batch-coupled max (the stray-key count's max_cell_num)
        # is the whole batch's; rollouts and evaluation keep their own
        # batch's, as the JAX hosts' local steps do
        coupled = [m for m in self.model.modules()
                   if hasattr(type(m), "batch_max")] if grad else []
        for m in coupled:
            m.batch_max = self.global_max
        try:
            yield
        finally:
            for mod, leaf, p in originals:
                mod._parameters[leaf] = p
            for m in coupled:
                del m.batch_max
            self._leaves = None

    def reduce_grads(self) -> None:
        """Inside `compute_params(grad=True)`, after the backward: each
        parameter's gradient summed over `data` (None counts as zero, as
        under jax.grad) and set as `p.grad`, a DTensor of p's placements.
        The gradients of parameters whole over `data` go through one flat
        all-reduce; those of parameters fsdp shards over `data` through one
        flat reduce-scatter, each rank receiving the sum of its slice."""
        from torch.distributed.tensor import DTensor

        if self._leaves is None:
            raise RuntimeError("reduce_grads runs inside compute_params")
        params = [p for p in self.params if p.requires_grad]
        grads = []
        for p in params:
            leaf = self._leaves[id(p)]
            grads.append(leaf.grad if leaf.grad is not None
                         else torch.zeros_like(leaf))
        dims = [self.placements[self._names[id(p)]][0] for p in params]
        if self.dp > 1:
            whole = [i for i, d in enumerate(dims) if d is None]
            split = [i for i, d in enumerate(dims) if d is not None]
            if whole:
                flat = torch.cat([grads[i].reshape(-1) for i in whole])
                dist.all_reduce(flat, group=self.data_group)
                for i, f in zip(whole, flat.split(
                        [grads[i].numel() for i in whole])):
                    grads[i] = f.view(grads[i].shape)
            if split:
                # each gradient's data dim first, cut into dp rows: row r
                # of the concatenation is the part data rank r keeps
                front = [grads[i].movedim(dims[i], 0) for i in split]
                rows = torch.cat([g.reshape(self.dp, -1) for g in front],
                                 dim=1)
                mine = rows.new_empty(rows.shape[1])
                dist.reduce_scatter_tensor(mine, rows.reshape(-1),
                                           group=self.data_group)
                for i, g, f in zip(split, front, mine.split(
                        [g.numel() // self.dp for g in front])):
                    grads[i] = f.view(g.shape[0] // self.dp,
                                      *g.shape[1:]).movedim(0, dims[i])
        for p, g in zip(params, grads):
            p.grad = DTensor.from_local(g.contiguous(), self.mesh,
                                        p.placements, run_check=False)

    def global_max(self, x: torch.Tensor) -> torch.Tensor:
        """x's max over the `data` group (a new tensor; no autograd). It
        runs at every dp, so a mesh of one rank runs it too."""
        x = x.detach().clone()
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.data_group)
        return x

    def global_sum(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the `data` group (a new tensor; no autograd). It
        runs at every dp, so a mesh of one rank runs it too."""
        x = x.detach().clone()
        dist.all_reduce(x, group=self.data_group)
        return x


def replicas(p) -> int:
    """How many ranks hold the same shard of a DTensor parameter: the
    product of the mesh dims it is replicated over (1 for a plain
    tensor)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(p, DTensor):
        return 1
    return math.prod(p.device_mesh.size(i)
                     for i, pl in enumerate(p.placements) if pl.is_replicate())

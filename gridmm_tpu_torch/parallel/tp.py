"""Tensor parallelism inside the modules (Megatron-style), over the `model`
dimension of the mesh.

The JAX package shards the matmul weights by regex (parallel/mesh.py) and
GSPMD inserts the collectives. Here the modules hold their local shards as
plain tensors and call the collectives themselves, with the Megatron
identities:

  * column-parallel Linear (out features sharded): the input is the same on
    every rank; the forward is local, the input's gradient is summed over
    the group (`copy_to`);
  * row-parallel Linear (in features sharded): the partial products are
    summed over the group in the forward (`reduce_from`), the bias added
    after the sum;
  * vocabulary-parallel embedding: each rank looks up the ids of its rows
    of the table, zeros the others, and the group sums;
  * the tied MLM head: logits over the rank's vocabulary rows, gathered
    along the last dim (`gather_last`).

Activations outside these layers are the same on every rank of the group,
so replicated parameters get the same gradient on every rank with no
reduction. The pool kernels (K1, K5a, K5b) see only such plain tensors.

Without autograd (rollouts, evaluation, serving) the forward sums run as
functional collectives (`torch.distributed._functional_collectives`),
which `torch.export` traces into a program: the sharded serving bundle
(utils/export.py) carries them.

An int8 layer (models/layers.Int8Dense) takes the absmax of its whole
activation and of each weight row, which GSPMD reduces across the devices
in the JAX program: here they are MAX all-reduces (`all_max`), the
activation's over the group that splits the batch and, in a row-parallel
layer, over `model` too, where the weight row's is taken as well. A
row-parallel layer sums its int32 products over `model` before it
rescales them, so the sum is exact.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F


class _CopyTo(torch.autograd.Function):
    """Identity forward; the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    """Sum over the group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    """All-gather along the last dim forward; the rank's slice backward
    (the gradient of the gathered tensor is the same on every rank)."""

    @staticmethod
    def forward(ctx, x, group, size, rank):
        ctx.rank, ctx.width = rank, x.shape[-1]
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.width
        return g[..., lo:lo + ctx.width].contiguous(), None, None, None


def all_max(x, group):
    """x's elementwise max over the group, as a functional collective (no
    autograd; `torch.export` traces it)."""
    return funcol.wait_tensor(funcol.all_reduce(x, "max", group))


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """A module's role in the `model` group: kind is "col", "row" or
    "vocab"; size and rank are the group's."""

    kind: str
    group: object
    size: int
    rank: int

    def copy_to(self, x):
        return _CopyTo.apply(x, self.group) if torch.is_grad_enabled() else x

    def reduce_from(self, x):
        if torch.is_grad_enabled():
            return _ReduceFrom.apply(x, self.group)
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", self.group))

    def gather_last(self, x):
        return _GatherLast.apply(x, self.group, self.size, self.rank)

    def linear(self, x, weight, bias):
        """F.linear over the local shard of a column- or row-parallel
        weight; the result of a row-parallel one is the full sum."""
        if self.kind == "col":
            return F.linear(self.copy_to(x), weight, bias)
        y = self.reduce_from(F.linear(x, weight))
        return y if bias is None else y + bias

    def embedding(self, ids, weight):
        """Lookup in the rank's rows [rank*V/size, (rank+1)*V/size) of a
        vocabulary-sharded table; ids elsewhere give zero before the sum."""
        rows = weight.shape[0]
        local = ids - self.rank * rows
        outside = (local < 0) | (local >= rows)
        emb = F.embedding(local.clamp(0, rows - 1), weight)
        return self.reduce_from(emb.masked_fill(outside[..., None], 0.0))

    def tied_logits(self, x, weight):
        """x @ table.T over a vocabulary-sharded table, gathered to the
        full vocabulary."""
        return self.gather_last(F.linear(self.copy_to(x), weight))

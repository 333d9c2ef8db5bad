"""Instruction-relevance grid scatter-pool (twin of gridmm_tpu/ops/grid_pool.py).

Replaces the reference's O(B * 196 * N) python cell-pooling loop
(map_nav_src/models/vilmodel.py:788-824) with a batched op:

    weight[b, i] = max_t f[b, i] . text_proj(txt[b, t])      (vilmodel.py:793-798)
    pooled[b, c] = sum_{i in c} softmax_cell(weight)[i] * grid_proj(f)[b, i]
    mask[b, c]   = any point landed in cell c                 (vilmodel.py:802-806)

`grid_pool` dispatches by device: a CUDA tensor goes through the hand-written
kernels (ops/cuda/grid_pool.py; csrc/grid_pool_fwd.cu forward, one launch
that also writes the mask, the denominator and the cell max;
csrc/grid_pool_bwd.cu backward), a CPU tensor through `grid_scatter_pool_raw`
and `grid_pool_bwd_plain`, the plain PyTorch versions of the same contract
and the kernels' oracles (`cell_max` and `_finalize` are parts of the plain
version only). The forward is the custom op `gridmm::grid_pool_fwd`
(`grid_pool_fwd_op`), whose fake body lets `torch.export` trace it; both
devices go through one `GridPoolFunction`, so the pool is differentiable in
`point_fts` and `weights` everywhere.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# cells are padded to 256 in the denominator output (the JAX kernel's
# CELL_PAD); the backward pass consumes it
CELL_PAD = 256


def instruction_relevance(
    point_fts: torch.Tensor,      # (B, N, D) raw grid point features (f32)
    projected_txt: torch.Tensor,  # (B, T, D) text_proj(txt_embeds)
    txt_mask: Optional[torch.Tensor] = None,  # (B, T) bool; None = all tokens
) -> torch.Tensor:
    """Per-point relevance: max over text tokens of the dot product
    (vilmodel.py:793-798). The reference takes the max over the PADDED text
    without masking; txt_mask=None reproduces that quirk exactly."""
    scores = torch.einsum("bnd,btd->bnt", point_fts.float(),
                          projected_txt.float())
    if txt_mask is not None:
        scores = scores.masked_fill(~txt_mask[:, None, :], float("-inf"))
    return scores.amax(dim=-1)


def _acc_dtype(point_fts):
    """Sums are f32; f64 inputs (numerical gradient checks) stay f64."""
    return (torch.float64 if point_fts.dtype == torch.float64
            else torch.float32)


def grid_scatter_pool_raw(
    point_fts: torch.Tensor,  # (B, N, D) f32 or bf16 projected features
    cell_ids: torch.Tensor,   # (B, N) int32 in [-1, num_cells); -1 invalid
    weights: torch.Tensor,    # (B, N) f32 relevance logits
    num_cells: int = 196,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch segment-softmax pool; returns (pooled (B, C, D) f32,
    cell_mask (B, C) bool, denom (B, 256) f32).

    Per point e_i = exp(w_i - cellmax[c_i]); numer[c] = sum e_i g_i and
    denom[c] = sum e_i over the cell; pooled = numer / denom, empty cells 0
    with mask False. Ids outside [0, num_cells) vanish. Accumulates in f32
    (f64 for f64 features).
    """
    b, n, d = point_fts.shape
    dev = point_fts.device
    acc = _acc_dtype(point_fts)
    valid = (cell_ids >= 0) & (cell_ids < num_cells)
    seg = torch.where(valid, cell_ids, torch.full_like(cell_ids, num_cells)
                      ).long()
    w = weights.to(acc).masked_fill(~valid, float("-inf"))
    cmax = cell_max(cell_ids, weights.to(acc), num_cells)
    e = torch.exp(w - cmax.gather(1, seg.clamp(max=num_cells - 1))
                  ).masked_fill(~valid, 0.0)

    denom = torch.zeros((b, CELL_PAD + 1), dtype=acc, device=dev
                        ).scatter_add(1, seg, e)
    rows = (torch.arange(b, device=dev)[:, None] * (num_cells + 1) + seg)
    numer = torch.zeros((b * (num_cells + 1), d), dtype=acc, device=dev
                        ).index_add_(
        0, rows.reshape(-1), (e[..., None] * point_fts.to(acc)).reshape(-1, d))
    numer = numer.view(b, num_cells + 1, d)[:, :num_cells]
    denom = denom[:, :CELL_PAD]
    return _finalize(numer, denom, num_cells)


def cell_max(cell_ids, weights, num_cells: int = 196):
    """(B, num_cells) per-cell max of the weights, -inf for empty cells: the
    softmax stabilizer `_prep_inputs` computes outside the Pallas body
    (grid_pool_kernel.py:65-87), in the weights' dtype. The backward kernels
    read it as a residual of the forward."""
    b = cell_ids.shape[0]
    valid = (cell_ids >= 0) & (cell_ids < num_cells)
    seg = torch.where(valid, cell_ids,
                      torch.full_like(cell_ids, num_cells)).long()
    cmax = torch.full((b, num_cells + 1), float("-inf"), dtype=weights.dtype,
                      device=cell_ids.device).scatter_reduce(
        1, seg, weights.masked_fill(~valid, float("-inf")), "amax")
    return cmax[:, :num_cells].contiguous()


def _finalize(numer, denom_pad, num_cells):
    """pooled = numer / denom with empty cells -> 0 (grid_pool_kernel.py
    :135-141); the CUDA forward does this inside its one launch."""
    denom = denom_pad[:, :num_cells]
    cell_mask = denom > 0
    safe = torch.where(cell_mask, denom, torch.ones_like(denom))
    pooled = (numer / safe[..., None]).masked_fill(~cell_mask[..., None], 0.0)
    return pooled, cell_mask, denom_pad


def grid_scatter_pool(point_fts, cell_ids, weights, num_cells: int = 196):
    """Plain pool, (pooled, cell_mask) — gridmm_tpu grid_scatter_pool."""
    pooled, cell_mask, _ = grid_scatter_pool_raw(point_fts, cell_ids,
                                                 weights, num_cells)
    return pooled, cell_mask


def grid_pool_bwd_terms(point_fts, cell_ids, weights, denom_pad, cot):
    """Plain PyTorch backward of the pool with its intermediates:
    (d point_fts, d weights, s (B, N), S (B, 256)).

    With G = `cot` (B, C, D), the cotangent of the pooled cells, and the
    in-cell softmax p_i = exp(w_i - cellmax[c_i]) / denom[c_i] (0 for ids
    outside [0, C) and for empty cells, where s_i is 0 too):
        dg_i = p_i G[c_i],  s_i = <g_i, G[c_i]>,  S_c = sum_{j in c} p_j s_j,
        dw_i = p_i (s_i - S[c_i])
    (gridmm_tpu/ops/pallas/grid_pool_kernel.py:154-161). `denom_pad` is the
    forward's (B, 256) denominator. d point_fts comes back in the features'
    dtype, the rest in f32; sums are f32. A one-point cell has dw = 0.
    """
    b, n, d = point_fts.shape
    num_cells = cot.shape[1]
    acc = _acc_dtype(point_fts)
    valid = (cell_ids >= 0) & (cell_ids < num_cells)
    idx = torch.where(valid, cell_ids, torch.zeros_like(cell_ids)).long()
    w = weights.to(acc).masked_fill(~valid, float("-inf"))
    cmax = torch.full((b, num_cells), float("-inf"), dtype=acc,
                      device=w.device).scatter_reduce(1, idx, w, "amax")
    den = denom_pad[:, :num_cells].to(acc).gather(1, idx)
    live = valid & (den > 0)
    p = torch.exp(w - cmax.gather(1, idx)) / torch.where(
        live, den, torch.ones_like(den))
    p = p.masked_fill(~live, 0.0)

    rows = cot.to(acc).gather(1, idx[..., None].expand(b, n, d))  # G[c_i]
    d_fts = (p[..., None] * rows).to(point_fts.dtype)
    s = (point_fts.to(acc) * rows).sum(dim=-1).masked_fill(~live, 0.0)
    big_s = torch.zeros((b, CELL_PAD), dtype=acc, device=w.device
                        ).scatter_add(1, idx, p * s)
    d_w = p * (s - big_s.gather(1, idx))
    return d_fts, d_w, s, big_s


def grid_pool_bwd_plain(point_fts, cell_ids, weights, denom_pad, cot):
    """Plain PyTorch backward of the pool: (d point_fts, d weights); see
    `grid_pool_bwd_terms`. The backward kernels' oracle and the CPU path."""
    return grid_pool_bwd_terms(point_fts, cell_ids, weights, denom_pad,
                               cot)[:2]


@torch.library.custom_op("gridmm::grid_pool_fwd", mutates_args=(),
                         device_types="cpu")
def grid_pool_fwd_op(point_fts: torch.Tensor, cell_ids: torch.Tensor,
                     weights: torch.Tensor, num_cells: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """The pool's forward as the custom op `gridmm::grid_pool_fwd`:
    (pooled (B, C, D), cell_mask (B, C) bool, denom (B, 256), cmax (B, C)),
    all fresh tensors, f32 (f64 for f64 features on the CPU).

    The CPU body is the plain version; CUDA tensors launch the forward
    kernel (ops/cuda/grid_pool.GridPoolFwd, which counts each call); the
    fake body gives shapes and types to `torch.export`, which cannot trace
    the kernel's ctypes launch (a fake tensor has no data pointer)."""
    acc = _acc_dtype(point_fts)
    pooled, cell_mask, denom = grid_scatter_pool_raw(point_fts, cell_ids,
                                                     weights, num_cells)
    return (pooled, cell_mask, denom.contiguous(),
            cell_max(cell_ids, weights.to(acc), num_cells))


@grid_pool_fwd_op.register_kernel("cuda")
def _grid_pool_fwd_cuda(point_fts, cell_ids, weights, num_cells):
    from gridmm_tpu_torch.ops.cuda.grid_pool import grid_pool_fwd

    return grid_pool_fwd(point_fts, cell_ids, weights, num_cells)


@grid_pool_fwd_op.register_fake
def _grid_pool_fwd_fake(point_fts, cell_ids, weights, num_cells):
    b, _, d = point_fts.shape
    acc = _acc_dtype(point_fts)
    return (point_fts.new_empty((b, num_cells, d), dtype=acc),
            point_fts.new_empty((b, num_cells), dtype=torch.bool),
            point_fts.new_empty((b, CELL_PAD), dtype=acc),
            point_fts.new_empty((b, num_cells), dtype=acc))


class GridPoolFunction(torch.autograd.Function):
    """The dispatching pool with its analytic backward.

    forward: `gridmm::grid_pool_fwd`, i.e. the CUDA forward kernel for
    tensors on the card (one launch: pooled, mask, denominator and cell
    max), the plain version for tensors on the CPU; returns (pooled,
    cell_mask, denom), of which only `pooled`
    is differentiable. backward: the two CUDA backward kernels on the card,
    which read the forward's cell max and denominator, `grid_pool_bwd_plain`
    on the CPU. `cell_ids` gets no gradient. Neither side gives way to the
    other when a kernel fails.
    """

    @staticmethod
    def forward(ctx, point_fts, cell_ids, weights, num_cells):
        pooled, cell_mask, denom, cmax = grid_pool_fwd_op(
            point_fts, cell_ids, weights, num_cells)
        ctx.save_for_backward(point_fts, cell_ids, weights, denom, cmax)
        ctx.mark_non_differentiable(cell_mask, denom)
        return pooled, cell_mask, denom

    @staticmethod
    def backward(ctx, cot, _cell_mask_cot, _denom_cot):
        point_fts, cell_ids, weights, denom, cmax = ctx.saved_tensors
        if point_fts.device.type == "cpu":
            d_fts, d_w = grid_pool_bwd_plain(point_fts, cell_ids, weights,
                                             denom, cot)
        else:
            from gridmm_tpu_torch.ops.cuda.grid_pool import grid_pool_bwd

            d_fts, d_w, _, _ = grid_pool_bwd(
                point_fts, cell_ids, weights, cmax, denom,
                cot.float().contiguous())
        return d_fts, None, d_w.to(weights.dtype), None


def grid_pool_raw(point_fts, cell_ids, weights, num_cells: int = 196):
    """Dispatching, differentiable pool: the CUDA kernels for tensors on the
    card, the plain versions for tensors on the CPU. Returns (pooled,
    cell_mask, denom)."""
    return GridPoolFunction.apply(point_fts, cell_ids, weights, num_cells)


def grid_pool(point_fts, cell_ids, weights, num_cells: int = 196):
    """Dispatching pool, (pooled, cell_mask)."""
    pooled, cell_mask, _ = grid_pool_raw(point_fts, cell_ids, weights,
                                         num_cells)
    return pooled, cell_mask


def relevance_weighted_grid(
    point_fts, cell_ids, txt_embeds,
    text_proj_w, text_proj_b,   # (D, D) in x @ W layout, (D,)
    grid_proj_w, grid_proj_b,
    txt_mask=None, num_cells: int = 196,
):
    """Full contract: text projection -> relevance -> projection -> pool
    (vilmodel.py:793-807 end to end). Weights use the JAX (in, out) layout."""
    f = point_fts.float()
    proj_txt = txt_embeds.float() @ text_proj_w.float() + text_proj_b.float()
    w = instruction_relevance(f, proj_txt, txt_mask)
    g = f @ grid_proj_w.float() + grid_proj_b.float()
    return grid_pool(g, cell_ids, w, num_cells)

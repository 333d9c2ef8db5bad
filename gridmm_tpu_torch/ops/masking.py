"""Mask utilities (twin of gridmm_tpu/ops/masking.py).

Every sequence lives in a fixed-capacity buffer and masks are plain (B, L)
bool tensors (the reference builds them from python-int lengths,
map_nav_src/models/ops.py:36-68).
"""

from __future__ import annotations

import torch

# BERT-style additive mask value (models/ops.py:33 uses -10000.0).
NEG_MASK = -10000.0
# Exact -inf for logit masking, matching the reference's masked_fill_
# (vilmodel.py:868-877). Consumers must be -inf-safe.
NEG_INF = float("-inf")


def seq_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_len) bool (models/ops.py gen_seq_masks)."""
    return (torch.arange(max_len, device=lengths.device)[None, :]
            < lengths[:, None])


def attn_bias_from_mask(mask: torch.Tensor, dtype=torch.float32,
                        neg: float = NEG_MASK) -> torch.Tensor:
    """(B, Lk) bool key mask -> (B, 1, 1, Lk) additive bias
    (models/ops.py extend_neg_masks)."""
    return ((1.0 - mask.to(dtype)) * neg)[:, None, None, :]


def mask_logits(logits: torch.Tensor, mask: torch.Tensor,
                neg: float = NEG_INF) -> torch.Tensor:
    """Set logits to `neg` where mask is False (masked_fill_ equivalent)."""
    return logits.masked_fill(~mask, neg)


def compaction_stray_count(cell_mask: torch.Tensor) -> torch.Tensor:
    """Per-item count of the reference's stray compaction keys.

    The reference's max_cell_num compaction loop mutates grid_masks[b] through
    an aliased view (vilmodel.py:816-820), so positions
    p in [cnt, min(cnt+K, max_cell_num)) with an original occupied bit keep
    mask=1 while their embedding rows are zero padding (K = occupied bits at
    positions >= cnt). Released checkpoints were trained under this, and the
    navigator reproduces it as one zero token with a log(count) key bias.

    cell_mask: (B, C) bool occupied-cell mask. Returns (B,) int32.
    """
    m = cell_mask.to(torch.int32)
    cnt = m.sum(dim=1)                                   # (B,)
    max_cell = cnt.max()                                 # batch max_cell_num
    idx = torch.arange(cell_mask.shape[1], device=cell_mask.device)[None, :]
    ge = m * (idx >= cnt[:, None])
    k = ge.sum(dim=1)                                    # ones at p >= cnt
    hi = torch.minimum(cnt + k, max_cell)[:, None]
    return (ge * (idx < hi)).sum(dim=1).to(torch.int32)

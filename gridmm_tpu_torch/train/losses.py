"""Loss functions (twin of gridmm_tpu/train/losses.py): teacher-forced
imitation and the pretraining proxy tasks.

Reference: cross-entropy with ignore_index=-100 over fused logits per step
(map_nav_src/r2r/agent.py:357-371), SAP multi-head CE with stop-reweighting
(pretrain_src/model/pretrain_cmt.py:273-289), MLM CE, MRC KL-divergence on
soft labels (pretrain_cmt.py:161-212).
"""

from __future__ import annotations

import torch


def masked_log_softmax(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """log_softmax tolerant of -inf entries (fully-masked slots -> -inf)."""
    mx = logits.amax(dim=dim, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    shifted = logits - mx
    sumexp = torch.where(torch.isfinite(shifted), torch.exp(shifted),
                         torch.zeros_like(shifted)).sum(dim=dim, keepdim=True)
    return shifted - torch.log(torch.clamp(sumexp, min=1e-30))


def cross_entropy_ignore(
    logits: torch.Tensor,   # (B, L) action logits (-inf at masked slots)
    targets: torch.Tensor,  # (B,) int labels; ignore_id entries contribute 0
    ignore_id: int = -100,
    reduction: str = "sum",
) -> torch.Tensor:
    """F.cross_entropy(ignore_index=) with -inf-tolerant log-softmax."""
    valid = targets != ignore_id
    safe_t = torch.where(valid, targets, torch.zeros_like(targets)).long()
    logp = masked_log_softmax(logits.float())
    nll = -torch.gather(logp, 1, safe_t[:, None])[:, 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    if reduction == "sum":
        return nll.sum()
    if reduction == "mean":
        return nll.sum() / torch.clamp(valid.sum(), min=1)
    return nll


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor,
             ignore_id: int = -1) -> torch.Tensor:
    """Masked-LM CE over (B, T, vocab) with labels == ignore_id skipped
    (pretrain_cmt.py forward_mlm)."""
    b, t, v = logits.shape
    return cross_entropy_ignore(logits.reshape(b * t, v),
                                labels.reshape(b * t), ignore_id, "mean")


def mrc_kl_loss(pred_logits: torch.Tensor, soft_targets: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """KL(target || softmax(pred)) over masked view tokens
    (pretrain_cmt.py:195-205 uses F.kl_div(log_softmax, soft_label))."""
    logp = torch.log_softmax(pred_logits.float(), dim=-1)
    kl = (soft_targets * (torch.log(torch.clamp(soft_targets, min=1e-12))
                          - logp)).sum(dim=-1)
    kl = torch.where(mask, kl, torch.zeros_like(kl))
    return kl.sum() / torch.clamp(mask.sum(), min=1)


def sap_loss(global_logits, local_logits, fused_logits, grid_logits,
             global_act, local_act) -> torch.Tensor:
    """Four-head single-action-prediction CE with stop-rate reweighting
    (pretrain_cmt.py:273-289): per-example CE; examples whose teacher action
    is [stop] (label 0) are divided by stop_rate = #stop / #non-stop;
    global/fused/grid heads use global labels, local uses local labels.
    Returns per-example summed losses (the caller means over the batch)."""

    def ce(logits, labels):
        return cross_entropy_ignore(logits, labels, ignore_id=-100,
                                    reduction="none")

    g = ce(global_logits, global_act)
    lo = ce(local_logits, local_act)
    f = ce(fused_logits, global_act)
    gr = ce(grid_logits, global_act)

    is_stop_g = global_act == 0
    is_stop_l = local_act == 0
    n_stop = is_stop_g.sum()
    n_go = (~is_stop_g).sum()
    stop_rate = torch.where(n_go > 0, n_stop / torch.clamp(n_go, min=1),
                            torch.ones((), device=g.device))
    stop_rate = torch.clamp(stop_rate, min=1e-8).to(g.dtype)

    g = torch.where(is_stop_g, g / stop_rate, g)
    f = torch.where(is_stop_g, f / stop_rate, f)
    gr = torch.where(is_stop_g, gr / stop_rate, gr)
    lo = torch.where(is_stop_l, lo / stop_rate, lo)
    return g + lo + f + gr

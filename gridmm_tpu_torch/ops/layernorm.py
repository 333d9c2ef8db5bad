"""LayerNorm with f32 statistics (twin of gridmm_tpu/ops/pallas/layernorm.py).

`layernorm` dispatches by device: a CUDA tensor goes through the hand-written
kernel (ops/cuda/layernorm.py, csrc/layernorm_fwd.cu), a CPU tensor through
`layernorm_plain`, the plain PyTorch version of the same contract and the
kernel's oracle. Both take any C: the JAX wrapper's `C % 128` fallback is a
TPU lane-tiling rule with no counterpart here.
"""

from __future__ import annotations

import torch


def layernorm_plain(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the last axis, statistics in f32 with the centred
    variance (as `_ln_kernel` computes them), result in x.dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    """Dispatching LayerNorm: the CUDA kernel for tensors on the card, the
    plain version for tensors on the CPU."""
    if x.device.type == "cpu":
        return layernorm_plain(x, scale, bias, eps)
    from gridmm_tpu_torch.ops.cuda.layernorm import LAYERNORM_FWD

    return LAYERNORM_FWD(x.contiguous(), scale, bias, eps)

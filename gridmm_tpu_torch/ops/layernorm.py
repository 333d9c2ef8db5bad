"""LayerNorm with f32 statistics (twin of gridmm_tpu/ops/pallas/layernorm.py).

`layernorm` dispatches by device: a CUDA tensor goes through the hand-written
kernel (ops/cuda/layernorm.py, csrc/layernorm_fwd.cu), a CPU tensor through
`layernorm_plain`, the plain PyTorch version of the same contract and the
kernel's oracle. Both take any C: the JAX wrapper's `C % 128` fallback is a
TPU lane-tiling rule with no counterpart here.

On the card the kernel is reached through the custom op
`gridmm::layernorm_fwd`, whose fake body lets `torch.export` and
`torch.compile` trace it. It has no autograd formula (nor has the Pallas
kernel): a backward through it raises instead of dropping the gradient.
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


@torch.library.custom_op("gridmm::layernorm_fwd", mutates_args=(),
                         device_types="cpu")
def layernorm_fwd_op(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm as the custom op `gridmm::layernorm_fwd`: the plain version
    on the CPU, the kernel (ops/cuda/layernorm.LAYERNORM_FWD, which counts
    each launch) on the card."""
    return layernorm_plain(x, scale, bias, eps)


@layernorm_fwd_op.register_kernel("cuda")
def _layernorm_fwd_cuda(x, scale, bias, eps):
    from gridmm_tpu_torch.ops.cuda.layernorm import LAYERNORM_FWD

    return LAYERNORM_FWD(x, scale, bias, eps)


@layernorm_fwd_op.register_fake
def _layernorm_fwd_fake(x, scale, bias, eps):
    return torch.empty_like(x)


def layernorm(x, scale, bias, eps: float = 1e-5):
    """Dispatching LayerNorm: the CUDA kernel for tensors on the card, the
    plain version for tensors on the CPU."""
    if x.device.type == "cpu":
        return layernorm_plain(x, scale, bias, eps)
    return layernorm_fwd_op(x.contiguous(), scale, bias, eps)

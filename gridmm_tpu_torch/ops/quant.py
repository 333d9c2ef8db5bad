"""Int8 matmuls for serving (twin of gridmm_tpu/ops/quant.py).

Dynamic per-tensor activation quantization and per-output-channel weight
quantization; the product accumulates in int32 and is rescaled in f32. The
JAX package leaves the product to XLA (a `dot_general` into int32, no Pallas
kernel); here it is `torch._int_mm`, cuBLASLt's int8 GEMM on the card. The
quantize and dequantize steps are plain torch ops.

One absmax over the WHOLE activation tensor sets its scale, so the rows of a
batch are coupled: one serving slot's int8 result depends on the other
slots' activations, in the JAX package as here. Compare int8 outputs batch
for batch, never row for row.

Weights are in the torch layout (out, in); the flax kernel is (in, out), so
the per-channel absmax runs over dim 1 here where JAX takes axis 0.

Over a mesh (the sharded serving bundle), a rank holds part of the
activation or of the weight's `in` dim. Each absmax is then a MAX over
the ranks that hold the other parts (`amax`, given by
models/layers.Int8Dense), so every rank quantizes with the scales of the
whole tensors, as the JAX program does under GSPMD.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F


def _over_127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 rounded as IEEE division rounds it, on any device: divided
    by a tensor on t's device. A Python scalar divisor is a product with
    its reciprocal on the card, an ulp off the quotient for some t, which
    moves every value quantized with that scale across a rounding
    boundary that it sits on."""
    return t / torch.full((), 127.0, dtype=t.dtype, device=t.device)


# a MAX over the ranks that hold the rest of a tensor (parallel/tp.all_max
# over the right groups), or None where the rank holds all of it
Amax = Optional[Callable[[torch.Tensor], torch.Tensor]]


def quantize_per_channel(w: torch.Tensor, amax: Amax = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) float weight -> (int8 weight (out, in), f32 scale (out,)).
    `amax` completes each row's absmax where the rank holds part of `in`."""
    w = w.float()
    absmax = w.abs().amax(dim=1, keepdim=True)
    if amax is not None:
        absmax = amax(absmax)
    scale = _over_127(torch.clamp(absmax, min=1e-8))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale.reshape(-1)


def _int_mm(xq: torch.Tensor, wq_t: torch.Tensor) -> torch.Tensor:
    """(m, k) int8 @ (k, n) int8 -> (m, n) int32. On the card cuBLASLt
    takes m > 16 and k, n multiples of 8: the rows are zero-padded (a zero
    row leaves the other rows and the absmax unchanged) and any other shape
    raises; nothing falls back to a float product."""
    m, k = xq.shape
    n = wq_t.shape[1]
    if xq.device.type != "cuda":
        return torch._int_mm(xq, wq_t)
    if k % 8 or n % 8:
        raise ValueError(f"int8 matmul on the card needs in and out features "
                         f"that are multiples of 8, got in={k}, out={n}")
    rows = max(m, 17)
    rows += (-rows) % 8
    if rows != m:
        xq = F.pad(xq, (0, 0, 0, rows - m))
    return torch._int_mm(xq, wq_t)[:m]


def int8_dense_q(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, amax: Amax = None,
                 acc_sum: Optional[Callable[[torch.Tensor], torch.Tensor]]
                 = None) -> torch.Tensor:
    """y = x @ W.T + bias with W given quantized (`quantize_per_channel`):
    x (..., in) float; the result in x's dtype. The activation scale stays a
    device tensor (no host sync), so the call can be captured in a CUDA
    graph. Over a mesh, `amax` completes the activation's absmax and
    `acc_sum` sums the int32 products of a rank's part of `in` with the
    other ranks' (before the rescale and the bias)."""
    in_dtype = x.dtype
    xf = x.float()
    x_absmax = xf.abs().amax()
    if amax is not None:
        x_absmax = amax(x_absmax)
    x_scale = _over_127(torch.clamp(x_absmax, min=1e-8))
    xq = torch.clamp(torch.round(xf / x_scale), -127, 127).to(torch.int8)
    lead = xq.shape[:-1]
    acc = _int_mm(xq.reshape(-1, xq.shape[-1]), wq.t())
    if acc_sum is not None:
        acc = acc_sum(acc)
    y = acc.float() * (x_scale * w_scale)
    if bias is not None:
        y = y + bias.float()
    return y.reshape(*lead, -1).to(in_dtype)


def int8_dense(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`int8_dense_q` with the (out, in) float weight quantized in the
    call, as the JAX `int8_dense` does."""
    wq, w_scale = quantize_per_channel(weight)
    return int8_dense_q(x, wq, w_scale, bias)

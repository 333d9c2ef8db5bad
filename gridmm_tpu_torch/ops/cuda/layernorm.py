"""ctypes wrapper of the LayerNorm kernel (csrc/layernorm_fwd.cu).

Replaces the TPU kernel `_ln_kernel` (gridmm_tpu/ops/pallas/layernorm.py:24).
The wrapper checks its inputs, allocates the output in x's type and
launches on the current stream. `LAYERNORM_FWD.launches` counts the
launches.
"""

from __future__ import annotations

import ctypes

import torch

from gridmm_tpu_torch.ops.cuda import build

SOURCE = "layernorm_fwd"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class LayerNormFwd:
    """Launcher with a launch count (one per kernel launch)."""

    name = "layernorm_fwd"
    source = "gridmm_tpu_torch/csrc/layernorm_fwd.cu"
    replaces = "gridmm_tpu/ops/pallas/layernorm.py:24"
    symbol = "gridmm_layernorm_fwd"
    # x, dtype code, scale, bias, y, rows, C, eps, stream
    argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_void_p]

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _function(self):
        if self._fn is None:
            self._fn = build.function(SOURCE, self.symbol, self.argtypes)
        return self._fn

    def __call__(self, x, scale, bias, eps: float = 1e-5):
        """(..., C) f32|bf16 x, (C,) scale and bias -> (..., C) in x.dtype."""
        if x.device.type != "cuda":
            raise ValueError(f"layernorm_fwd needs CUDA tensors, got {x.device}")
        if x.dtype not in _DTYPE_CODE:
            raise TypeError(f"x dtype {x.dtype} not in (float32, bfloat16)")
        if x.dim() < 1 or x.numel() == 0:
            raise ValueError(f"x must be a non-empty (..., C), got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError("layernorm_fwd needs a contiguous x")
        c = x.shape[-1]
        rows = x.numel() // c
        for name, t in (("scale", scale), ("bias", bias)):
            if tuple(t.shape) != (c,):
                raise ValueError(f"{name} must be ({c},), got "
                                 f"{tuple(t.shape)}")
            if t.device != x.device:
                raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if rows >= 2 ** 31:
            raise ValueError("layernorm_fwd counts rows with 32-bit ints")
        scale = scale.to(torch.float32).contiguous()
        bias = bias.to(torch.float32).contiguous()
        y = torch.empty_like(x)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        with torch.cuda.device(x.device):
            err = self._function()(
                x.data_ptr(), _DTYPE_CODE[x.dtype], scale.data_ptr(),
                bias.data_ptr(), y.data_ptr(), rows, c, float(eps), stream)
        if err != 0:
            raise RuntimeError(f"layernorm_fwd launch failed: cudaError {err}")
        self.launches += 1
        return y


LAYERNORM_FWD = LayerNormFwd()


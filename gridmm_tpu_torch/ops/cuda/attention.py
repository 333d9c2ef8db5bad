"""ctypes wrappers of the two attention kernels.

  * `ATTENTION_QKV_FWD` (csrc/attention_qkv_fwd.cu) replaces `_attn_qkv_kernel`
    (gridmm_tpu/ops/pallas/attention_qkv.py:37): packed (B, L, 3W) qkv,
    head_dim 64, context (B, L, W);
  * `ATTENTION_FWD` (csrc/attention_fwd.cu) replaces `_attn_kernel`
    (gridmm_tpu/ops/pallas/attention.py:26): (BH, L, hd) q, k, v with any
    hd from 1 to 256, padded on chip.

Both keep K and V of one head in shared memory, so L is capped by the
232,448 bytes a block may use (`_smem_bytes` mirrors each body's layout).
The wrappers raise above it and on anything else the kernels do not take.
Each counts its launches in `.launches`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from gridmm_tpu_torch.ops.cuda import build

MAX_SMEM = 232448
QKV_HEAD_DIM = 64
MAX_HEAD_DIM = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_common(name, tensors):
    """Device, dtype, contiguity and 16-byte alignment of tensors that must
    share one device and dtype; returns the dtype code."""
    t0 = tensors[0]
    if t0.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {t0.device}")
    if t0.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {t0.dtype} not in (float32, bfloat16)")
    for t in tensors:
        if t.device != t0.device or t.dtype != t0.dtype:
            raise ValueError(f"{name}: inputs must share device and dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous inputs")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} needs 16-byte aligned inputs")
    return _DTYPE_CODE[t0.dtype]


def _smem_bytes(length, hd, dtype, packed=False):
    """Shared memory of the smallest launch the kernel body makes for this
    shape (csrc/attention_qkv_mma.cuh, attention_core.cuh,
    attention_head_mma.cuh, attention_head_f32.cuh)."""
    lp16 = -(-length // 16) * 16
    if packed:
        if dtype == torch.bfloat16:      # 64-row Q tile, K, V; 144-byte rows
            return (2 * lp16 + 64) * (QKV_HEAD_DIM + 8) * 2
        return 2 * length * QKV_HEAD_DIM * 4
    if dtype == torch.bfloat16:
        # hd padded to 16, or above 128 to 32, where a work item does half
        # the output columns and four warps stage 16-row Q tiles; one stage
        # of K and V; rows padded by 8 elements
        if hd <= 128:
            hdp = -(-hd // 16) * 16
            return lp16 * 2 * (hdp + 8) * 2
        hdp = -(-hd // 32) * 32
        return (4 * 16 * (hdp + 8) + lp16 * (hdp + 8 + hdp // 2 + 8)) * 2
    # f32: hd padded to 16 or to 32; at the least one warp's 4 query and
    # score rows and K and V of 32 keys (the whole slice below 32), rows
    # padded by 4
    hdp = 16 if hd <= 16 else -(-hd // 32) * 32
    return (4 * (hdp + -(-length // 32) * 32)
            + 2 * min(length, 32) * (hdp + 4)) * 4


def _check_len(name, length, hd, dtype, packed=False):
    smem = _smem_bytes(length, hd, dtype, packed)
    if smem > MAX_SMEM:
        raise ValueError(f"{name}: L={length} at head_dim {hd} needs {smem} "
                         f"bytes of shared memory, more than {MAX_SMEM}")


class AttentionQkvFwd:
    """Launcher of the packed-qkv kernel, with a launch count."""

    name = "attention_qkv_fwd"
    source = "gridmm_tpu_torch/csrc/attention_qkv_fwd.cu"
    replaces = "gridmm_tpu/ops/pallas/attention_qkv.py:37"

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _function(self):
        if self._fn is None:
            self._fn = build.function(
                "attention_qkv_fwd", "gridmm_attention_qkv_fwd", [
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                    ctypes.c_void_p])
        return self._fn

    def __call__(self, qkv, heads: int):
        """(B, L, 3W) f32|bf16 packed projection -> (B, L, W) context."""
        code = _check_common(self.name, [qkv])
        if qkv.dim() != 3 or qkv.shape[-1] % 3:
            raise ValueError(f"qkv must be (B, L, 3W), got {tuple(qkv.shape)}")
        b, length, w3 = qkv.shape
        width = w3 // 3
        if heads < 1 or width != heads * QKV_HEAD_DIM:
            raise ValueError(f"{self.name} needs head_dim {QKV_HEAD_DIM}, got "
                             f"width {width} over {heads} heads")
        _check_len(self.name, length, QKV_HEAD_DIM, qkv.dtype, packed=True)
        if b * heads >= 2 ** 31:
            raise ValueError(f"{self.name}: more (image, head) blocks than "
                             "a grid holds")
        out = torch.empty((b, length, width), dtype=qkv.dtype,
                          device=qkv.device)
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        with torch.cuda.device(qkv.device):
            err = self._function()(
                qkv.data_ptr(), code, out.data_ptr(), b, length, heads,
                1.0 / math.sqrt(QKV_HEAD_DIM), stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: cudaError {err}")
        self.launches += 1
        return out


class AttentionFwd:
    """Launcher of the per-head kernel, with a launch count."""

    name = "attention_fwd"
    source = "gridmm_tpu_torch/csrc/attention_fwd.cu"
    replaces = "gridmm_tpu/ops/pallas/attention.py:26"
    symbol = "gridmm_attention_fwd"
    # q, k, v, dtype code, o, BH, L, hd, scale, stream
    argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_float, ctypes.c_void_p]

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _function(self):
        if self._fn is None:
            self._fn = build.function("attention_fwd", self.symbol,
                                      self.argtypes)
        return self._fn

    def __call__(self, q, k, v):
        """(BH, L, hd) f32|bf16 q, k, v -> (BH, L, hd)."""
        if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
            raise ValueError("q, k, v must share one (BH, L, hd) shape, got "
                             f"{tuple(q.shape)}, {tuple(k.shape)}, "
                             f"{tuple(v.shape)}")
        bh, length, hd = q.shape
        if not 1 <= hd <= MAX_HEAD_DIM:
            raise ValueError(f"{self.name}: head_dim {hd} not in "
                             f"[1, {MAX_HEAD_DIM}]")
        code = _check_common(self.name, [q, k, v])
        _check_len(self.name, length, hd, q.dtype)
        if bh >= 2 ** 31:
            raise ValueError(f"{self.name}: more slices than a grid holds")
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        with torch.cuda.device(q.device):
            err = self._function()(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), code,
                out.data_ptr(), bh, length, hd, 1.0 / math.sqrt(hd), stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: cudaError {err}")
        self.launches += 1
        return out


ATTENTION_QKV_FWD = AttentionQkvFwd()
ATTENTION_FWD = AttentionFwd()

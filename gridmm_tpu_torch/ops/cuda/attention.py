"""ctypes wrappers of the two attention kernels.

  * `ATTENTION_QKV_FWD` (csrc/attention_qkv_fwd.cu) replaces `_attn_qkv_kernel`
    (gridmm_tpu/ops/pallas/attention_qkv.py:37): packed (B, L, 3W) qkv,
    head_dim 64, context (B, L, W);
  * `ATTENTION_FWD` (csrc/attention_fwd.cu) replaces `_attn_kernel`
    (gridmm_tpu/ops/pallas/attention.py:26): (BH, L, hd) q, k, v with any
    hd, padded on chip.

Both stream K and V through a ring of key tiles in shared memory whose size
depends on head_dim and the type alone (`_smem_bytes`; the C functions
`gridmm_attention_*_smem` give the launchers' own), so they take any L; the
only limits left are device memory and the grid's 2^31 blocks, which the
launchers refuse. The wrappers raise on anything else the kernels do not
take. Each counts its launches in `.launches`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from gridmm_tpu_torch.ops.cuda import build

MAX_SMEM = 232448                 # bytes a block may use on sm_90
TWO_BLOCK_SMEM = 115712           # a block's share where two fit an SM
THREE_BLOCK_SMEM = 76800          # ... where three do
QKV_HEAD_DIM = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_CUDA_ERROR_INVALID_VALUE = 1


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


def _check_launch(name, err):
    """Raise on a launcher's cudaError_t. The inputs were checked before, so
    cudaErrorInvalidValue means a grid of 2^31 blocks or more."""
    if err == _CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"{name}: cudaErrorInvalidValue, more blocks or "
                         "work items than a grid holds")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _smem_bytes(length, hd, dtype, packed=False):
    """Shared memory of one block of the launch at this length, hd and type:
    the ring of K and V tiles, whose size does not depend on the length.
    Mirrors the
    launchers (csrc/attention_qkv_mma.cuh kSmemBytes, attention_core.cuh
    kSmemBytes, attention_head_mma.cuh smem_bytes and kWideSmemBytes,
    attention_head_f32.cuh smem_bytes and kWideSmemBytes)."""
    bf16 = dtype == torch.bfloat16
    if packed:    # two slots of 64 keys x 72 bf16, or of 32 keys x 64 f32
        return 2 * 2 * 64 * 72 * 2 if bf16 else 2 * 2 * 32 * 64 * 4
    if hd > 256:  # four slots of 128 columns
        return (4 * 64 * 136 * 2 if bf16
                else (8 * 4 * (32 + 128) + 4 * 32 * 132) * 4)
    if bf16:
        # slots of 64 keys of K and V (rows padded by 8 elements), beside
        # four 16-row Q tiles above hdp 128: the most, up to 8, that leave
        # three blocks an SM if that is 4 or more, else two blocks if 3 or
        # more, else one
        hdp = -(-hd // 16) * 16 if hd <= 128 else -(-hd // 32) * 32
        out = hdp if hdp <= 128 else hdp // 2
        slot = 64 * (hdp + 8 + out + 8) * 2
        q = 0 if hdp <= 128 else 4 * 16 * (hdp + 8) * 2
        for budget, least in ((THREE_BLOCK_SMEM, 4), (TWO_BLOCK_SMEM, 3),
                              (MAX_SMEM, 2)):
            n = (budget - q) // slot
            if n >= least:
                return q + min(n, 8) * slot
        return q + slot
    # f32: each warp's probability and query rows, then four slots (or the
    # most that fit) of 32 keys of K and V, hdp + 4 floats a row
    hdp = 16 if hd <= 16 else -(-hd // 32) * 32
    fixed = (8 if hdp > 128 else 16) * 4 * (32 + hdp) * 4
    slot = 2 * 32 * (hdp + 4) * 4
    return fixed + min(4, (MAX_SMEM - fixed) // slot) * slot


class AttentionQkvFwd:
    """Launcher of the packed-qkv kernel, with a launch count."""

    name = "attention_qkv_fwd"
    source = "gridmm_tpu_torch/csrc/attention_qkv_fwd.cu"
    replaces = "gridmm_tpu/ops/pallas/attention_qkv.py:37"
    symbol = "gridmm_attention_qkv_fwd"
    # qkv, dtype code, out, batch, L, heads, scale, stream
    argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _function(self):
        if self._fn is None:
            self._fn = build.function("attention_qkv_fwd", self.symbol,
                                      self.argtypes)
        return self._fn

    def __call__(self, qkv, heads: int):
        """(B, L, 3W) f32|bf16 packed projection -> (B, L, W) context."""
        code = _check_common(self.name, [qkv])
        if qkv.dim() != 3 or qkv.shape[-1] % 3:
            raise ValueError(f"qkv must be (B, L, 3W), got {tuple(qkv.shape)}")
        b, length, w3 = qkv.shape
        if b < 1 or length < 1:
            raise ValueError(f"{self.name}: empty shape {tuple(qkv.shape)}")
        width = w3 // 3
        if heads < 1 or width != heads * QKV_HEAD_DIM:
            raise ValueError(f"{self.name} needs head_dim {QKV_HEAD_DIM}, got "
                             f"width {width} over {heads} heads")
        out = torch.empty((b, length, width), dtype=qkv.dtype,
                          device=qkv.device)
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        with torch.cuda.device(qkv.device):
            err = self._function()(
                qkv.data_ptr(), code, out.data_ptr(), b, length, heads,
                1.0 / math.sqrt(QKV_HEAD_DIM), stream)
        _check_launch(self.name, err)
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
        if hd < 1 or length < 1 or bh < 1:
            raise ValueError(f"{self.name}: empty shape {tuple(q.shape)}")
        code = _check_common(self.name, [q, k, v])
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        with torch.cuda.device(q.device):
            err = self._function()(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), code,
                out.data_ptr(), bh, length, hd, 1.0 / math.sqrt(hd), stream)
        _check_launch(self.name, err)
        self.launches += 1
        return out


ATTENTION_QKV_FWD = AttentionQkvFwd()
ATTENTION_FWD = AttentionFwd()

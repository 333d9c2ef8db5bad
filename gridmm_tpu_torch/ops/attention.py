"""Attention of the ViT towers (twin of gridmm_tpu/ops/pallas/attention_qkv.py
and gridmm_tpu/ops/pallas/attention.py, and of the einsum path in
gridmm_tpu/models/clip_vit.py:162-192).

  * `attention_qkv(qkv, heads)` takes the packed (B, L, 3W) projection and
    returns the context (B, L, W);
  * `attention(q, k, v)` takes (BH, L, hd) tensors.

Each dispatches by device. On a CPU tensor the plain PyTorch version runs.
On a CUDA tensor a kernel always runs, chosen as the JAX package chooses:
head_dim 64 goes to the packed-qkv kernel (csrc/attention_qkv_fwd.cu, the
only head_dim `fused_attention_qkv` takes), every other head_dim is split
into (B*H, L, hd) and goes to the per-head kernel (csrc/attention_fwd.cu).
Both kernels run bf16 inputs on the tensor cores (bf16 products, f32
accumulators) and f32 inputs on the CUDA cores; the per-head kernel takes
any head_dim from 1 to 256. Both kernels keep scores
and softmax in f32 on chip, so `scores_f32` (the JAX `attn_scores_f32` knob,
which trades score precision for bytes moved) only changes the plain version.

On the card each kernel is reached through a custom op,
`gridmm::attention_qkv_fwd` and `gridmm::attention_fwd`, whose fake bodies
give `torch.export` and `torch.compile` the output's shape and type. The ops
have no autograd formula (neither have the Pallas kernels): a backward
through them raises instead of dropping the gradient. A CPU tensor calls
the plain version directly, which differentiates as the JAX tower's einsum
path does.
"""

from __future__ import annotations

import math

import torch


def split_heads(qkv, heads: int):
    """(B, L, 3W) packed projection -> q, k, v, each (B*H, L, hd)
    contiguous."""
    b, length, w3 = qkv.shape
    hd = w3 // 3 // heads
    t = qkv.reshape(b, length, 3, heads, hd).permute(2, 0, 3, 1, 4)
    return tuple(t[i].reshape(b * heads, length, hd).contiguous()
                 for i in range(3))


def merge_heads(ctx, batch: int):
    """(B*H, L, hd) -> (B, L, H*hd)."""
    bh, length, hd = ctx.shape
    heads = bh // batch
    return ctx.reshape(batch, heads, length, hd).transpose(1, 2).reshape(
        batch, length, heads * hd)


def attention_qkv_plain(qkv, heads: int, scores_f32: bool = True):
    """Plain version: split the projection, per-head scores, softmax in f32,
    probabilities in the input type, context accumulated in f32 and
    returned in the input type (clip_vit.py:162-192)."""
    b, length, w3 = qkv.shape
    width = w3 // 3
    hd = width // heads
    dt = qkv.dtype
    q, k, v = (t.reshape(b, length, heads, hd)
               for t in qkv.split(width, dim=-1))
    if scores_f32:
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        scores = scores / math.sqrt(hd)
    else:
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.tensor(
            hd ** 0.5, dtype=dt)
    probs = torch.softmax(scores.float(), dim=-1).to(dt)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(dt)
    return ctx.reshape(b, length, width)


def attention_plain(q, k, v):
    """Plain version of the per-head kernel: softmax(q k^T / sqrt(hd)) v with
    f32 scores, probabilities in v's type, f32 accumulation
    (ops/pallas/attention.py:26-45)."""
    hd = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (
        1.0 / math.sqrt(hd))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


@torch.library.custom_op("gridmm::attention_fwd", mutates_args=(),
                         device_types="cpu")
def attention_fwd_op(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """The per-head attention as the custom op `gridmm::attention_fwd`: the
    plain version on the CPU, the kernel (ops/cuda/attention.ATTENTION_FWD,
    which counts each launch) on the card."""
    return attention_plain(q, k, v)


@attention_fwd_op.register_kernel("cuda")
def _attention_fwd_cuda(q, k, v):
    from gridmm_tpu_torch.ops.cuda.attention import ATTENTION_FWD

    return ATTENTION_FWD(q, k, v)


@attention_fwd_op.register_fake
def _attention_fwd_fake(q, k, v):
    return torch.empty_like(q)


@torch.library.custom_op("gridmm::attention_qkv_fwd", mutates_args=(),
                         device_types="cpu")
def attention_qkv_fwd_op(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """The packed-qkv attention as the custom op `gridmm::attention_qkv_fwd`:
    the plain version on the CPU, the kernel
    (ops/cuda/attention.ATTENTION_QKV_FWD) on the card."""
    return attention_qkv_plain(qkv, heads)


@attention_qkv_fwd_op.register_kernel("cuda")
def _attention_qkv_fwd_cuda(qkv, heads):
    from gridmm_tpu_torch.ops.cuda.attention import ATTENTION_QKV_FWD

    return ATTENTION_QKV_FWD(qkv, heads)


@attention_qkv_fwd_op.register_fake
def _attention_qkv_fwd_fake(qkv, heads):
    b, length, w3 = qkv.shape
    return qkv.new_empty((b, length, w3 // 3))


def attention(q, k, v):
    """Dispatching (BH, L, hd) attention: the per-head kernel on the card,
    the plain version on the CPU."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    return attention_fwd_op(q, k, v)


def attention_qkv(qkv, heads: int, scores_f32: bool = True):
    """Dispatching packed-qkv attention (see the module docstring)."""
    if qkv.device.type == "cpu":
        return attention_qkv_plain(qkv, heads, scores_f32)
    from gridmm_tpu_torch.ops.cuda.attention import QKV_HEAD_DIM

    qkv = qkv.contiguous()
    if qkv.shape[-1] == 3 * heads * QKV_HEAD_DIM:
        return attention_qkv_fwd_op(qkv, heads)
    return merge_heads(attention(*split_heads(qkv, heads)), qkv.shape[0])

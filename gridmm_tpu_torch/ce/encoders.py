"""RGB/depth stand-in encoders feeding the waypoint predictor (twin of
gridmm_tpu/ce/encoders.py).

Compact strided-conv stand-ins for the reference's frozen ResNet towers
(models/resnet.py) at smoke scale. They follow flax's conventions exactly:

  * `padding="SAME"` with a stride pads max((ceil(n/s) - 1)*s + k - n, 0) in
    total, the smaller half first (3x3 stride 2 on 56 px pads (0, 1)), which
    `nn.Conv2d` cannot express: `same_pad` pads explicitly;
  * the adaptive pool is `jax.image.resize(method="linear")`, a triangle
    filter that antialiases when it shrinks: `F.interpolate(mode="bilinear",
    align_corners=False, antialias=True)` is the same filter (identity at the
    factory's sizes, 7 -> 7 and 4 -> 4);
  * the RGB tower's per-cell Dense and both flattens are in HWC order.

Channels-last (B, H, W, C) in, as the env hands images over; NCHW inside.
Module names are flax's automatic ones (`Conv_0` is `Conv.0`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def same_pad(x, kernel: int, stride: int):
    """flax/XLA "SAME" padding of an NCHW tensor for a square kernel."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad takes the last dim first
        out = -(-n // stride)
        total = max((out - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def resize_linear(x, size: int):
    """jax.image.resize(..., method="linear") of an NCHW tensor to
    (size, size)."""
    if tuple(x.shape[2:]) == (size, size):
        return x
    return F.interpolate(x, size=(size, size), mode="bilinear",
                         align_corners=False, antialias=True)


class DepthTower(nn.Module):
    """(B, H, W, 1) depth -> (B, out_ch*4*4) features. The strides follow the
    input size (4 while the side exceeds 16, then 2), as in the JAX
    package."""

    def __init__(self, out_ch: int = 128):
        super().__init__()
        chans = (1, 32, 64, 64, out_ch)
        self.Conv = nn.ModuleList(
            nn.Conv2d(chans[i], chans[i + 1], 4) for i in range(4))

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).float()
        for conv in self.Conv:
            s = 4 if x.shape[2] > 16 else 2
            x = F.relu(F.conv2d(same_pad(x, 4, s), conv.weight, conv.bias,
                                stride=s))
        x = resize_linear(x, 4)
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class RgbTower(nn.Module):
    """(B, H, W, 3) uint8 rgb -> (B, grid*grid*out_ch) features (stand-in
    for ResNet50's 2048*7*7)."""

    def __init__(self, out_ch: int = 2048, grid: int = 7):
        super().__init__()
        self.grid = grid
        chans = (3, 32, 64, 128, 256)
        self.Conv = nn.ModuleList(
            nn.Conv2d(chans[i], chans[i + 1], 3) for i in range(4))
        self.Dense = nn.ModuleList([nn.Linear(256, out_ch)])

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).float() / 255.0
        g = self.grid
        for conv in self.Conv:
            s = 2 if x.shape[2] // 2 >= g else 1
            x = F.relu(F.conv2d(same_pad(x, 3, s), conv.weight, conv.bias,
                                stride=s))
        x = resize_linear(x, g).permute(0, 2, 3, 1)   # (B, g, g, C)
        x = self.Dense[0](x)
        return x.reshape(x.shape[0], -1)

"""Frozen visual towers of the continuous-env (VLN-CE) stack (twin of
gridmm_tpu/models/resnet.py).

The reference feeds the waypoint predictor two frozen feature extractors
(VLN_CE/vlnce_baselines/models/encoders/resnet_encoders.py):

  * RGB: TorchVision ResNet50 (ImageNet), truncated before avgpool ->
    (B, 2048, 7, 7) at 224x224 input (TorchVisionResNet50, :120-210);
  * depth: habitat ddppo ResNetEncoder (GroupNorm ResNet50, baseplanes 32)
    with a 3x3 compression conv -> (B, 128, 4, 4) at 256x256 input
    (VlnResnetDepthEncoder, :13-105).

The towers take the env's channels-last images at their boundary and run
NCHW inside: the convolutions are `F.conv2d`, the norms an affine with
imported running statistics (BatchNorm in eval mode) or `F.group_norm`, as
the JAX package leaves them to XLA outside any Pallas kernel. Features come
back flattened in CHW order, the layout the released waypoint predictor's
Linear weights consume. Module and parameter names are the flax tree's
(`layer1_0` is `layer1.0`, a conv's `kernel` its `weight`), so
`gridmm_tpu_torch.convert` carries a JAX tree across.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gridmm_tpu_torch.utils.checkpoint import strict_state_dict

# ImageNet normalization used by TorchVisionResNet50.rgb_transform
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _conv(cin: int, cout: int, kernel: int, stride: int = 1,
          padding: int = 0) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)


class FrozenBatchNorm(nn.Module):
    """BatchNorm in eval mode: scale, bias and the running statistics are
    imported and never trained."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features), requires_grad=False)
        self.mean = nn.Parameter(torch.zeros(features), requires_grad=False)
        self.var = nn.Parameter(torch.ones(features), requires_grad=False)

    def forward(self, x):  # (B, C, H, W)
        inv = self.weight * torch.rsqrt(self.var + self.eps)
        shift = self.bias - self.mean * inv
        return x * inv[:, None, None] + shift[:, None, None]


class BottleneckBN(nn.Module):
    """TorchVision Bottleneck: 1x1 -> 3x3(stride) -> 1x1(x4) + residual."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride, 1)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = FrozenBatchNorm(planes * 4)
        if downsample:
            self.downsample_conv = _conv(inplanes, planes * 4, 1, stride)
            self.downsample_bn = FrozenBatchNorm(planes * 4)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if hasattr(self, "downsample_conv"):
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + x)


class ResNet50Backbone(nn.Module):
    """TorchVision resnet50 truncated before avgpool/fc: (B, 3, H, W)
    normalized float -> (B, 2048, H/32, W/32)."""

    def __init__(self, layers: Tuple[int, ...] = (3, 4, 6, 3)):
        super().__init__()
        self.layers = tuple(layers)
        self.conv1 = _conv(3, 64, 7, 2, 3)
        self.bn1 = FrozenBatchNorm(64)
        inplanes = 64
        for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                  self.layers)):
            stride = 1 if li == 0 else 2
            stage = []
            for bi in range(blocks):
                stage.append(BottleneckBN(inplanes, planes,
                                          stride if bi == 0 else 1,
                                          downsample=bi == 0))
                inplanes = planes * 4
            setattr(self, f"layer{li + 1}", nn.ModuleList(stage))

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for li in range(len(self.layers)):
            for block in getattr(self, f"layer{li + 1}"):
                x = block(x)
        return x


class RgbResNet50Tower(nn.Module):
    """TorchVisionResNet50 contract: (B, H, W, 3) uint8 RGB -> flattened
    (2048*7*7) features in CHW order."""

    def __init__(self, layers: Tuple[int, ...] = (3, 4, 6, 3)):
        super().__init__()
        self.backbone = ResNet50Backbone(layers)
        # buffers, not weights: they follow the module to the card once,
        # and a step copies nothing from the host for them
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN)[
            :, None, None], persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD)[
            :, None, None], persistent=False)

    def forward(self, images_u8):
        x = images_u8.permute(0, 3, 1, 2).float() / 255.0
        x = self.backbone((x - self.mean) / self.std)
        return x.reshape(x.shape[0], -1)


class BottleneckGN(nn.Module):
    """ddppo Bottleneck: the GroupNorm variant (habitat resnet.py)."""

    def __init__(self, inplanes: int, planes: int, ngroups: int,
                 stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.gn1 = nn.GroupNorm(ngroups, planes, eps=1e-5)
        self.conv2 = _conv(planes, planes, 3, stride, 1)
        self.gn2 = nn.GroupNorm(ngroups, planes, eps=1e-5)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.gn3 = nn.GroupNorm(ngroups, planes * 4, eps=1e-5)
        if downsample:
            self.downsample_conv = _conv(inplanes, planes * 4, 1, stride)
            self.downsample_gn = nn.GroupNorm(ngroups, planes * 4, eps=1e-5)

    def forward(self, x):
        out = F.relu(self.gn1(self.conv1(x)))
        out = F.relu(self.gn2(self.conv2(out)))
        out = self.gn3(self.conv3(out))
        if hasattr(self, "downsample_conv"):
            x = self.downsample_gn(self.downsample_conv(x))
        return F.relu(out + x)


def ddppo_final_spatial(size: int, num_stages: int = 4) -> int:
    """Spatial side of the ddppo backbone's output for a size x size input:
    avg-pool /2, the stride-2 stem, the stride-2 max-pool, then one stride-2
    stage per stage after the first (each rounding up, as a padded conv
    does)."""
    s = size // 2
    s = (s + 2 * 3 - 7) // 2 + 1
    s = (s + 2 - 3) // 2 + 1
    for _ in range(num_stages - 1):
        s = (s + 2 - 3) // 2 + 1
    return s


class DdppoDepthEncoder(nn.Module):
    """habitat ddppo ResNetEncoder (GroupNorm resnet50, baseplanes 32):
    (B, H, W, 1) depth in [0, 1] -> flattened (128*4*4) features (CHW order)
    at 256x256 input. Forward: avg-pool /2, 7x7 stem, 4 bottleneck stages,
    3x3 compression conv to round(2048 / final_spatial^2) channels. The
    compression width depends on the input size, as in the JAX package,
    which sizes it at its first call: `input_size` gives it here."""

    def __init__(self, baseplanes: int = 32, ngroups: int = 16,
                 layers: Tuple[int, ...] = (3, 4, 6, 3),
                 input_size: int = 256):
        super().__init__()
        self.layers = tuple(layers)
        self.stem_conv = _conv(1, baseplanes, 7, 2, 3)
        self.stem_gn = nn.GroupNorm(ngroups, baseplanes, eps=1e-5)
        inplanes, planes = baseplanes, baseplanes
        for li, blocks in enumerate(self.layers):
            stride = 1 if li == 0 else 2
            stage = []
            for bi in range(blocks):
                stage.append(BottleneckGN(inplanes, planes, ngroups,
                                          stride if bi == 0 else 1,
                                          downsample=bi == 0))
                inplanes = planes * 4
            setattr(self, f"layer{li + 1}", nn.ModuleList(stage))
            planes *= 2
        fs = ddppo_final_spatial(input_size, len(self.layers))
        comp = int(round(2048 / (fs * fs)))
        self.compression_conv = _conv(inplanes, comp, 3, 1, 1)
        self.compression_gn = nn.GroupNorm(1, comp, eps=1e-5)

    def forward(self, depth):
        x = F.avg_pool2d(depth.permute(0, 3, 1, 2).float(), 2, 2)
        x = F.relu(self.stem_gn(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for li in range(len(self.layers)):
            for block in getattr(self, f"layer{li + 1}"):
                x = block(x)
        x = F.relu(self.compression_gn(self.compression_conv(x)))
        return x.reshape(x.shape[0], -1)


def init_tower(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init in the JAX package's scheme for the towers: conv and
    dense kernels ~ N(0, 1/fan_in) (flax's lecun_normal, untruncated here),
    biases 0, norms scale 1 / shift 0, running mean 0 and variance 1."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=generator)
                m.weight.copy_(w / math.sqrt(fan_in))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.GroupNorm, FrozenBatchNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
    return module


# ----------------------------------------------------------------- importers
def _t(x) -> torch.Tensor:
    return torch.as_tensor(
        x.detach().cpu() if hasattr(x, "detach") else x).to(torch.float32)


def import_torchvision_resnet50(state_dict: Dict[str, Any],
                                model: nn.Module) -> Dict[str, torch.Tensor]:
    """torchvision.models.resnet50 state_dict -> a strict state dict for
    `model` (a ResNet50Backbone, or an RgbResNet50Tower around one);
    fc/avgpool keys are ignored, as the reference truncates them too
    (gridmm_tpu/models/resnet.py:197). A torch conv weight is already the
    port's layout."""
    prefix = "backbone." if isinstance(model, RgbResNet50Tower) else ""
    backbone = model.backbone if prefix else model
    sd = dict(state_dict)
    out: Dict[str, torch.Tensor] = {}

    def bn(src, dst):
        out[f"{prefix}{dst}.weight"] = _t(sd[f"{src}.weight"])
        out[f"{prefix}{dst}.bias"] = _t(sd[f"{src}.bias"])
        out[f"{prefix}{dst}.mean"] = _t(sd[f"{src}.running_mean"])
        out[f"{prefix}{dst}.var"] = _t(sd[f"{src}.running_var"])

    out[f"{prefix}conv1.weight"] = _t(sd["conv1.weight"])
    bn("bn1", "bn1")
    for li, blocks in enumerate(backbone.layers):
        for bi in range(blocks):
            s = d = f"layer{li + 1}.{bi}"
            for ci in (1, 2, 3):
                out[f"{prefix}{d}.conv{ci}.weight"] = _t(
                    sd[f"{s}.conv{ci}.weight"])
                bn(f"{s}.bn{ci}", f"{d}.bn{ci}")
            if f"{s}.downsample.0.weight" in sd:
                out[f"{prefix}{d}.downsample_conv.weight"] = _t(
                    sd[f"{s}.downsample.0.weight"])
                bn(f"{s}.downsample.1", f"{d}.downsample_bn")
    return strict_state_dict(model, out, "torchvision resnet50 import")


def import_ddppo_depth_encoder(state_dict: Dict[str, Any],
                               model: DdppoDepthEncoder
                               ) -> Dict[str, torch.Tensor]:
    """habitat ddppo visual_encoder state_dict -> a strict state dict for
    `model` (gridmm_tpu/models/resnet.py:231).

    Expects keys already stripped to the visual_encoder scope the reference
    produces (VlnResnetDepthEncoder, resnet_encoders.py:38-48):
    `backbone.conv1.{0,1}.*`, `backbone.layer{L}.{i}.convs.{0,1,3,4,6,7}.*`,
    `backbone.layer{L}.{i}.downsample.{0,1}.*`, `compression.{0,1}.*`."""
    sd = dict(state_dict)
    out: Dict[str, torch.Tensor] = {}

    def gn(src, dst):
        out[f"{dst}.weight"] = _t(sd[f"{src}.weight"])
        out[f"{dst}.bias"] = _t(sd[f"{src}.bias"])

    out["stem_conv.weight"] = _t(sd["backbone.conv1.0.weight"])
    gn("backbone.conv1.1", "stem_gn")
    # ddppo Bottleneck.convs: Sequential(conv,GN,ReLU,conv,GN,ReLU,conv,GN)
    conv_slots = {1: 0, 2: 3, 3: 6}
    for li, blocks in enumerate(model.layers):
        for bi in range(blocks):
            s = f"backbone.layer{li + 1}.{bi}"
            d = f"layer{li + 1}.{bi}"
            for ci, slot in conv_slots.items():
                out[f"{d}.conv{ci}.weight"] = _t(sd[f"{s}.convs.{slot}.weight"])
                gn(f"{s}.convs.{slot + 1}", f"{d}.gn{ci}")
            if f"{s}.downsample.0.weight" in sd:
                out[f"{d}.downsample_conv.weight"] = _t(
                    sd[f"{s}.downsample.0.weight"])
                gn(f"{s}.downsample.1", f"{d}.downsample_gn")
    out["compression_conv.weight"] = _t(sd["compression.0.weight"])
    gn("compression.1", "compression_gn")
    return strict_state_dict(model, out, "ddppo depth encoder import")

"""Per-sensor observation transforms, habitat-free (a copy of
gridmm_tpu/ce/obs_transforms.py: the port keeps its own).

Re-implements the reference's VLN-CE observation transformers
(habitat_extensions/obs_transformers.py): CenterCropperPerSensor (:20-91)
and ResizerPerSensor (:93-175, torch F.interpolate mode='area' ==
adaptive average pooling with integer box edges). Pure numpy, channels-last,
applied host-side to observation dicts before features enter the device
pipeline.
"""

from __future__ import annotations

import math
import numbers
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

SizeLike = Union[int, Tuple[int, int]]


def _pair(size: SizeLike) -> Tuple[int, int]:
    if isinstance(size, numbers.Number):
        return (int(size), int(size))
    assert len(size) == 2, "size must be (h, w)"
    return (int(size[0]), int(size[1]))


def center_crop(img: np.ndarray, size: SizeLike) -> np.ndarray:
    """Center crop over the (..., H, W, C) spatial dims (channels last)."""
    h, w = _pair(size)
    in_h, in_w = img.shape[-3], img.shape[-2]
    top = max((in_h - h) // 2, 0)
    left = max((in_w - w) // 2, 0)
    return img[..., top: top + h, left: left + w, :]


def _area_bins(out_size: int, in_size: int):
    """(out, in) binary box-membership matrix + per-bin counts of
    adaptive_avg_pool1d: output bin i covers input
    [floor(i*in/out), ceil((i+1)*in/out))."""
    wm = np.zeros((out_size, in_size), np.float64)
    counts = np.zeros((out_size,), np.float64)
    for i in range(out_size):
        start = math.floor(i * in_size / out_size)
        end = math.ceil((i + 1) * in_size / out_size)
        wm[i, start:end] = 1.0
        counts[i] = end - start
    return wm, counts


def resize_area(img: np.ndarray, size: SizeLike) -> np.ndarray:
    """torch F.interpolate(mode='area') equivalent over (..., H, W, C).

    Box sums are exact (binary membership matmul) with a single division, so
    integer inputs whose box mean is exactly integral stay integral; integer
    dtypes then truncate toward zero like the reference's float->uint8
    .to(dtype) cast (obs_transformers.py:155-160), NOT round."""
    h, w = _pair(size)
    in_h, in_w = img.shape[-3], img.shape[-2]
    if (in_h, in_w) == (h, w):
        return img
    wh, ch = _area_bins(h, in_h)
    ww, cw = _area_bins(w, in_w)
    x = img.astype(np.float64)
    x = np.einsum("oi,...iwc->...owc", wh, x)
    x = np.einsum("oj,...hjc->...hoc", ww, x)
    x = x / (ch[:, None] * cw[None, :])[..., None]
    if np.issubdtype(img.dtype, np.integer):
        x = np.trunc(x)
    return x.astype(img.dtype)


class CenterCropperPerSensor:
    """obs dict -> obs dict with listed sensors center-cropped
    (obs_transformers.py:20-91)."""

    def __init__(self, sensor_crops: Sequence[Tuple[str, SizeLike]]):
        self.sensor_crops: Dict[str, Tuple[int, int]] = {
            k: _pair(v) for k, v in dict(sensor_crops).items()}

    def __call__(self, observations: Dict[str, np.ndarray]):
        observations.update({
            s: center_crop(np.asarray(observations[s]), size)
            for s, size in self.sensor_crops.items() if s in observations})
        return observations


class ResizerPerSensor:
    """obs dict -> obs dict with listed sensors area-resized
    (obs_transformers.py:93-175)."""

    def __init__(self, sizes: Sequence[Tuple[str, SizeLike]]):
        self.sensor_resizes: Dict[str, Tuple[int, int]] = {
            k: _pair(v) for k, v in dict(sizes).items()}

    def __call__(self, observations: Dict[str, np.ndarray]):
        observations.update({
            s: resize_area(np.asarray(observations[s]), size)
            for s, size in self.sensor_resizes.items() if s in observations})
        return observations


def apply_obs_transforms(observations: Dict[str, np.ndarray],
                         transforms: List) -> Dict[str, np.ndarray]:
    for t in transforms:
        observations = t(observations)
    return observations

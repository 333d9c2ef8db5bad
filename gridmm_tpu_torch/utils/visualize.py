"""Grid-memory visualization (twin of gridmm_tpu/utils/visualize.py: debug
scaffolding the reference left commented out, JPEG dumps of the map,
Policy_ViewSelection_GridMap.py:700-725)."""

from __future__ import annotations

import numpy as np


def grid_occupancy_image(cell_mask: np.ndarray, cell_scores=None,
                         grid_w: int = 14, scale: int = 16) -> np.ndarray:
    """(196,) occupancy (+ optional per-cell scores) -> (H, W, 3) uint8 image.

    Occupied cells render grey (or a red heat ramp when scores are given);
    the agent cell (center of the egocentric window) is marked blue."""
    g = grid_w
    img = np.zeros((g, g, 3), np.uint8)
    occ = np.asarray(cell_mask).reshape(g, g).astype(bool)
    img[occ] = (160, 160, 160)
    if cell_scores is not None:
        s = np.asarray(cell_scores, np.float64).reshape(g, g)
        s = np.where(occ, s, np.nan)
        if np.isfinite(s).any():
            lo, hi = np.nanmin(s), np.nanmax(s)
            norm = np.nan_to_num((s - lo) / (hi - lo + 1e-9))
            heat = (norm * 255).astype(np.uint8)
            img[occ, 0] = heat[occ]
            img[occ, 1] = 60
            img[occ, 2] = 60
    c = g // 2
    img[c - 1: c + 1, c - 1: c + 1] = (40, 90, 220)
    return np.kron(img, np.ones((scale, scale, 1), np.uint8))


def save_grid_png(path: str, cell_mask, cell_scores=None) -> None:
    save_png(path, grid_occupancy_image(cell_mask, cell_scores))


def save_episode_video(path: str, frames, fps: int = 4) -> str:
    """Write an eval episode's RGB frames as an animated GIF (the
    base_il_trainer.py:631-644 generate_video equivalent; habitat's mp4
    writer needs moviepy/ffmpeg which this environment lacks).

    Falls back to a horizontal filmstrip PNG when imageio is unavailable.
    Returns the path actually written."""
    frames = [np.asarray(f, np.uint8) for f in frames]
    try:
        import imageio

        if not path.endswith(".gif"):
            path += ".gif"
        imageio.mimsave(path, frames, duration=1.0 / fps, loop=0)
        return path
    except ImportError:
        strip = np.concatenate(frames, axis=1)
        if not path.endswith(".png"):
            path += ".png"
        save_png(path, strip)
        return path


def _draw_line(img: np.ndarray, p0, p1, color) -> None:
    """Bresenham-ish line via dense interpolation (no deps)."""
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1)) * 2
    for t in np.linspace(0.0, 1.0, n + 1):
        r = int(round(p0[0] + (p1[0] - p0[0]) * t))
        c = int(round(p0[1] + (p1[1] - p0[1]) * t))
        if 0 <= r < img.shape[0] and 0 <= c < img.shape[1]:
            img[r, c] = color


def _mark(img: np.ndarray, p, color, r: int = 2) -> None:
    r0, c0 = int(round(p[0])), int(round(p[1]))
    img[max(r0 - r, 0): r0 + r + 1, max(c0 - r, 0): c0 + r + 1] = color


def top_down_trajectory_image(gt_path, pred_path, size: int = 256,
                              margin: int = 12) -> np.ndarray:
    """Top-down episode map: GT path (green) vs prediction (red), start
    marked blue, GT goal green square, final prediction red square.

    Equivalent of the reference's TopDownMapVLNCE measure + maps.py drawing
    (habitat_extensions/measures.py, maps.py) without habitat: paths are
    (N, 2) world-xy arrays; the canvas auto-fits their joint bounding box.
    Returns (size, size, 3) uint8."""
    gt = np.asarray(gt_path, np.float64).reshape(-1, 2)
    pred = np.asarray(pred_path, np.float64).reshape(-1, 2)
    pts = np.concatenate([gt, pred], axis=0)
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    span = np.maximum(hi - lo, 1e-6)
    scale = (size - 2 * margin) / span.max()

    def to_px(p):
        # world x -> col, world y -> row (flipped so +y is up)
        col = margin + (p[0] - lo[0]) * scale
        row = size - margin - (p[1] - lo[1]) * scale
        return (row, col)

    img = np.full((size, size, 3), 30, np.uint8)
    for a, b in zip(gt[:-1], gt[1:]):
        _draw_line(img, to_px(a), to_px(b), (60, 200, 60))
    for a, b in zip(pred[:-1], pred[1:]):
        _draw_line(img, to_px(a), to_px(b), (220, 60, 60))
    _mark(img, to_px(gt[-1]), (60, 200, 60), r=3)
    _mark(img, to_px(pred[-1]), (220, 60, 60), r=3)
    _mark(img, to_px(gt[0]), (40, 90, 220), r=3)
    return img


def save_png(path: str, img: np.ndarray) -> None:
    """Write any (H, W, 3) uint8 image (PIL if present, pure-python fallback)."""
    try:
        from PIL import Image

        Image.fromarray(img).save(path)
    except ImportError:
        import struct
        import zlib

        h, w, _ = img.shape
        raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

        def chunk(tag, data):
            c = tag + data
            return struct.pack(">I", len(data)) + c + struct.pack(
                ">I", zlib.crc32(c))

        png = (b"\x89PNG\r\n\x1a\n"
               + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
               + chunk(b"IDAT", zlib.compress(raw))
               + chunk(b"IEND", b""))
        with open(path, "wb") as f:
            f.write(png)

"""Offline preprocessing: panorama CLIP features, depth patches, viewpoint
info (twin of gridmm_tpu/data/preprocess.py).

Covers the reference's preprocess stage (get_map_feature.py:61-194 CLIP view
features, get_depth.py:42-159 depth maps, get_viewpoint_info.py:56-79 world
positions). One process drives the card with a double-buffered pipeline: a
background thread renders or loads panoramas while the card encodes, and
batch k+1 is launched before batch k is drained.

The renderer is pluggable: MatterSim when installed (the same 36-view sweep,
keeping the 12 horizon views ix 12..24, get_map_feature.py:106-127), or any
iterable of (scan, viewpoint, images (12, H, W, 3) uint8, depth (12, 128, 128)).
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from gridmm_tpu_torch.models.clip_vit import (ClipVisionConfig,
                                              ClipVisionTransformer, clip_b32,
                                              init_clip_vision,
                                              normalize_images)

PanoRecord = Tuple[str, str, np.ndarray, np.ndarray]  # scan, vp, rgb, depth


def load_viewpoint_ids(connectivity_dir: str):
    """scans.txt + per-scan connectivity -> [(scan, viewpoint)]
    (preprocess/utils.py:5-14 contract)."""
    out = []
    with open(os.path.join(connectivity_dir, "scans.txt")) as f:
        scans = [x.strip() for x in f if x.strip()]
    for scan in scans:
        with open(os.path.join(connectivity_dir,
                               f"{scan}_connectivity.json")) as f:
            for item in json.load(f):
                if item["included"]:
                    out.append((scan, item["image_id"]))
    return out


def synthetic_renderer(viewpoints: Iterable[Tuple[str, str]],
                       resolution: int = 224,
                       seed: int = 0) -> Iterator[PanoRecord]:
    """Deterministic stand-in for MatterSim rendering (tests, benchmarks):
    the same bits as the JAX package's for the same seed."""
    import hashlib

    for scan, vp in viewpoints:
        h = int.from_bytes(
            hashlib.sha256(f"{scan}_{vp}".encode()).digest()[:8], "little")
        rng = np.random.default_rng(h ^ seed)
        rgb = rng.integers(0, 256, (12, resolution, resolution, 3),
                           dtype=np.uint8)
        depth = rng.integers(500, 20000, (12, 128, 128)).astype(np.uint16)
        yield scan, vp, rgb, depth


def mattersim_renderer(viewpoints, connectivity_dir: str,
                       scan_data_dir: Optional[str] = None,
                       resolution: int = 224) -> Iterator[PanoRecord]:
    """Real MatterSim sweep (get_map_feature.py:94-127, get_depth.py:42-88):
    36 discretized views, horizon slice ix 12..24 kept."""
    import math

    import MatterSim  # external C++ simulator

    sim = MatterSim.Simulator()
    if scan_data_dir:
        sim.setDatasetPath(scan_data_dir)
    sim.setNavGraphPath(connectivity_dir)
    sim.setRenderingEnabled(True)
    sim.setDepthEnabled(True)
    sim.setDiscretizedViewingAngles(True)
    sim.setCameraResolution(resolution, resolution)
    sim.setCameraVFOV(math.radians(60))
    sim.setBatchSize(1)
    sim.initialize()

    for scan, vp in viewpoints:
        rgbs, depths = [], []
        for ix in range(36):
            if ix == 0:
                sim.newEpisode([scan], [vp], [0], [math.radians(-30)])
            elif ix % 12 == 0:
                sim.makeAction([0], [1.0], [1.0])
            else:
                sim.makeAction([0], [1.0], [0])
            state = sim.getState()[0]
            if 12 <= ix < 24:
                rgbs.append(np.array(state.rgb, copy=True)[..., ::-1])  # BGR->RGB
                depths.append(np.array(state.depth, copy=True)[..., 0])
        yield scan, vp, np.stack(rgbs), np.stack(depths).astype(np.uint16)


class _ProducerError:
    """Carries an exception from the render thread to the encode loop."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class ClipFeatureExtractor:
    """Batched, double-buffered panorama encoder on one device."""

    def __init__(self, cfg: Optional[ClipVisionConfig] = None,
                 model: Optional[ClipVisionTransformer] = None,
                 batch_panos: int = 8, device="cuda", seed: int = 0):
        self.cfg = cfg or clip_b32()
        self.device = torch.device(device)
        if model is None:
            model = init_clip_vision(self.cfg, seed=seed, device=self.device)
        self.model = model.to(self.device).eval()
        self.batch_panos = batch_panos

    def encode(self, images_u8: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 on the device -> tokens (B, T, W) in the
        tower's compute dtype."""
        with torch.inference_mode():
            return self.model(normalize_images(images_u8))

    def _launch(self, rgb: np.ndarray):
        """Start encoding one batch; returns (host f32 tokens, event) where
        the event (None on the CPU) marks the device-to-host copy done."""
        host = torch.from_numpy(rgb)
        if self.device.type != "cuda":
            return self.encode(host.to(self.device)).float(), None
        images = host.pin_memory().to(self.device, non_blocking=True)
        tokens = self.encode(images).float()
        out = torch.empty(tokens.shape, dtype=torch.float32, pin_memory=True)
        out.copy_(tokens, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return out, done

    def run(self, records: Iterable[PanoRecord],
            sink: Callable[[str, str, np.ndarray, np.ndarray], None],
            prefetch: int = 2) -> int:
        """Encode panoramas, overlapping host rendering with device compute.

        sink(scan, vp, clip_tokens (12, T, W) float32, depth (12, H, H)) is
        called for every viewpoint, in input order. Returns the number of
        panoramas processed. An exception in the renderer is raised here."""
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        done_marker = object()
        stop = threading.Event()

        def put(item) -> bool:
            # bounded waits: when the encode loop leaves early (the sink
            # raised), this thread sees `stop` within a tick instead of
            # blocking on the full queue, holding its rendered panoramas
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                batch = []
                for rec in records:
                    batch.append(rec)
                    if len(batch) == self.batch_panos:
                        if not put(batch):
                            return
                        batch = []
                if batch and not put(batch):
                    return
                put(done_marker)
            except BaseException as exc:  # handed to the encode loop
                put(_ProducerError(exc))

        threading.Thread(target=producer, daemon=True,
                         name="clip_extractor").start()

        count = 0
        pending = None  # (metas, (host tokens, event), depths)
        try:
            while True:
                item = q.get()
                if item is done_marker:
                    break
                if isinstance(item, _ProducerError):
                    raise item.exc
                metas = [(s, v) for s, v, _, _ in item]
                rgb = np.concatenate([r for _, _, r, _ in item])
                depths = [d for _, _, _, d in item]
                launched = self._launch(rgb)
                if pending is not None:
                    self._drain(pending, sink)
                    count += len(pending[0])
                pending = (metas, launched, depths)
            if pending is not None:
                self._drain(pending, sink)
                count += len(pending[0])
        finally:
            stop.set()
            while True:  # release the queued panoramas now
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
        return count

    @staticmethod
    def _drain(pending, sink):
        metas, (tokens, done), depths = pending
        if done is not None:
            done.synchronize()
        tokens = tokens.numpy()
        t, w = tokens.shape[-2:]
        tokens = tokens.reshape(len(metas), 12, t, w)
        for (scan, vp), tok, dep in zip(metas, tokens, depths):
            sink(scan, vp, tok, dep)


class Hdf5Sink:
    """Writes the reference's artifact contracts: clip grid features
    ({scan}_{vp}: (12, tokens, width) f16) and depth ((12, H, H) u16).
    Imports h5py only when built, since not every machine has it."""

    def __init__(self, clip_path: str, depth_path: str):
        import h5py

        self.fc = h5py.File(clip_path, "w")
        self.fd = h5py.File(depth_path, "w")

    def __call__(self, scan, vp, tokens, depth):
        key = f"{scan}_{vp}"
        self.fc.create_dataset(key, data=tokens.astype(np.float16))
        self.fd.create_dataset(key, data=depth.astype(np.uint16))

    def close(self):
        self.fc.close()
        self.fd.close()


def extract_viewpoint_info(graphs) -> Dict[str, Dict[str, float]]:
    """viewpoint_info.json content (get_viewpoint_info.py:56-72)."""
    out = {}
    for scan, g in graphs.items():
        for vp, pos in g.positions.items():
            out[f"{scan}_{vp}"] = {"x": float(pos[0]), "y": float(pos[1]),
                                   "z": float(pos[2])}
    return out

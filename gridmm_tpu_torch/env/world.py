"""World data providers: panorama features, depth, grid features, positions (a copy of the JAX-free
gridmm_tpu/env/world.py, so the port needs nothing of the JAX package).

The reference reads these from HDF5 stores produced by its preprocess stage
(depth.hdf5 36x128x128 uint16, clip_p32.hdf5 12x50x768 fp16, per-view
pth_vit_base_patch16 36x768 — map_nav_src/r2r/env.py:80-113,166-168 and
utils/data.py:10-76). Here the store is a protocol with three backends:
HDF5 (data-compatible with the reference artifacts), in-memory, and a
deterministic synthetic world for tests/benchmarks.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Iterable, Optional, Protocol, Sequence, Tuple

import numpy as np

from gridmm_tpu_torch.env.nav_graph import NavGraph

VIEWS_PER_PANO = 36
HORIZON_VIEWS = 12
DEPTH_PATCHES = 49
# 7x7 depth patch centers of a 128x128 depth map (env.py:279-281)
DEPTH_PATCH_CENTERS = np.asarray([9 + i * 18 for i in range(7)])


def _depth_to_patches(d: np.ndarray) -> np.ndarray:
    """Normalize any stored depth layout to (12, 49) patch centers.

    Accepts the reference's 36-view store (rows 12..24 are the horizon sweep,
    r2r/env.py:281-289), our own Hdf5Sink's 12-row store, or records already
    sliced to patch centers (convert_store --slice-depth-patches)."""
    if d.ndim == 2 and d.shape == (HORIZON_VIEWS, DEPTH_PATCHES):
        return d
    if d.shape[0] == VIEWS_PER_PANO:
        d = d[HORIZON_VIEWS: 2 * HORIZON_VIEWS]
    elif d.shape[0] != HORIZON_VIEWS:
        raise ValueError(f"unrecognized depth layout {d.shape}")
    d = d[:, DEPTH_PATCH_CENTERS][:, :, DEPTH_PATCH_CENTERS]
    return d.reshape(HORIZON_VIEWS, DEPTH_PATCHES)


class WorldProvider(Protocol):
    """Everything the discrete environment needs about a (scan, viewpoint)."""

    def view_features(self, scan: str, vp: str) -> np.ndarray:
        """(36, D) per-view visual features."""
        ...

    def depth_patches(self, scan: str, vp: str) -> np.ndarray:
        """(12, 49) raw horizon-view depth patch centers (uint16 counts)."""
        ...

    def grid_features(self, scan: str, vp: str) -> np.ndarray:
        """(12*49, D) CLIP patch features for the 12 horizon views."""
        ...

    def position(self, scan: str, vp: str) -> Tuple[float, float, float]:
        ...


class Hdf5World:
    """Reads the reference's preprocess artifacts (lazy, with in-RAM cache).

    File contracts: keys "{scan}_{vp}";
      view_ft_file: (36, >=D) f32/f16      (utils/data.py:29)
      depth_file:   (36, 128, 128) uint16  (r2r/env.py:166, get_depth.py)
      grid_ft_file: (12, 50, 768) f16      (r2r/env.py:167, 50 = cls + 7x7)
      viewpoint_info: json {scan_vp: {x,y,z}} (r2r/env.py:168)
    """

    def __init__(self, view_ft_file: str, depth_file: str, grid_ft_file: str,
                 viewpoint_info: Dict[str, Dict[str, float]],
                 image_feat_size: int = 768):
        import h5py  # gated: only needed for real data

        self._h5py = h5py
        self.view_ft_file = view_ft_file
        self.depth_file = depth_file
        self.grid_ft_file = grid_ft_file
        self.viewpoint_info = viewpoint_info
        self.image_feat_size = image_feat_size
        self._cache: Dict[str, Dict[str, np.ndarray]] = {
            "view": {}, "depth": {}, "grid": {}}

    def _read(self, kind: str, file: str, key: str) -> np.ndarray:
        cache = self._cache[kind]
        if key not in cache:
            with self._h5py.File(file, "r") as f:
                cache[key] = f[key][...]
        return cache[key]

    def view_features(self, scan, vp):
        key = f"{scan}_{vp}"
        ft = self._read("view", self.view_ft_file, key)
        return ft[:, : self.image_feat_size].astype(np.float32)

    def view_probs(self, scan, vp):
        """(36, prob_size) soft class labels for MRC; the reference view
        feature files append prob columns after the features
        (pretrain image_prob_size contract). None when absent."""
        key = f"{scan}_{vp}"
        ft = self._read("view", self.view_ft_file, key)
        if ft.shape[1] <= self.image_feat_size:
            return None
        return ft[:, self.image_feat_size:].astype(np.float32)

    def depth_patches(self, scan, vp):
        key = f"{scan}_{vp}"
        d = self._read("depth", self.depth_file, key)
        return _depth_to_patches(d)

    def grid_features(self, scan, vp):
        key = f"{scan}_{vp}"
        g = self._read("grid", self.grid_ft_file, key)  # (12, 50, 768)
        return g[:, 1:].reshape(-1, g.shape[-1]).astype(np.float32)

    def position(self, scan, vp):
        info = self.viewpoint_info[f"{scan}_{vp}"]
        return (info["x"], info["y"], info["z"])


class Hdf5ObjectReader:
    """REVERIE/SOON object features from the reference's object HDF5.

    Store contract (reverie/data_utils.py:9-53): keyed "{scan}_{vp}" with
    per-object feature rows and attrs `directions` (heading, elevation),
    `sizes` (w, h), `obj_ids`. Objects are exposed as {obj_id, feature,
    loc_fts=[angle4 | h/H, w/W, area], heading, elevation}.

    SOON stores carry `bboxes` (x0,y0,x1,y1) instead of `sizes` — sizes are
    derived and normalized by the 600x600 SOON image
    (SoonTextPathData.get_scanvp_feature, pretrain_src/data/dataset.py:868-884;
    image_hw defaults to REVERIE's 480x640)."""

    def __init__(self, obj_ft_file: str, max_objects: int = 20,
                 angle_feat_size: int = 4,
                 image_hw: Tuple[float, float] = (480.0, 640.0)):
        import h5py

        self._h5py = h5py
        self.obj_ft_file = obj_ft_file
        self.max_objects = max_objects
        self.angle_feat_size = angle_feat_size
        self.image_hw = image_hw
        self._cache: Dict[str, list] = {}

    def objects(self, scan, vp):
        from gridmm_tpu_torch.env.graph import angle_features

        key = f"{scan}_{vp}"
        if key not in self._cache:
            with self._h5py.File(self.obj_ft_file, "r") as f:
                if key not in f:
                    self._cache[key] = []
                else:
                    fts = f[key][...].astype(np.float32)[: self.max_objects]
                    attrs = {k: np.asarray(v)[: self.max_objects]
                             for k, v in f[key].attrs.items()}
                    if "sizes" not in attrs and "bboxes" in attrs:
                        bb = attrs["bboxes"].astype(np.float32)
                        attrs["sizes"] = np.stack(
                            [bb[:, 2] - bb[:, 0], bb[:, 3] - bb[:, 1]], -1)
                    img_h, img_w = self.image_hw
                    out = []
                    for k in range(len(fts)):
                        heading, elevation = attrs["directions"][k][:2]
                        w, h = attrs["sizes"][k][:2]
                        loc = np.concatenate([
                            angle_features(float(heading), float(elevation),
                                           self.angle_feat_size),
                            np.asarray([h / img_h, w / img_w,
                                        (h / img_h) * (w / img_w)],
                                       np.float32)])
                        oid = attrs["obj_ids"][k]
                        out.append({
                            "obj_id": (oid.decode() if isinstance(oid, bytes)
                                       else str(oid)),
                            "feature": fts[k],
                            "loc_fts": loc,
                            # raw direction kept for SOON det scoring
                            "heading": float(heading),
                            "elevation": float(elevation),
                        })
                    self._cache[key] = out
        return self._cache[key]


class Hdf5ObjectWorld(Hdf5World):
    """Hdf5World + REVERIE/SOON object features (Hdf5ObjectReader)."""

    def __init__(self, *args, obj_ft_file: str, max_objects: int = 20,
                 angle_feat_size: int = 4,
                 image_hw: Tuple[float, float] = (480.0, 640.0), **kwargs):
        super().__init__(*args, **kwargs)
        self._obj_reader = Hdf5ObjectReader(obj_ft_file, max_objects,
                                            angle_feat_size,
                                            image_hw=image_hw)

    def objects(self, scan, vp):
        return self._obj_reader.objects(scan, vp)


class ObjectWorld:
    """Attach an object reader to ANY WorldProvider (e.g. GmmStoreWorld) —
    base features from one backend, objects from the reference HDF5."""

    def __init__(self, base: WorldProvider, obj_reader: Hdf5ObjectReader):
        self._base = base
        self._obj_reader = obj_reader

    def __getattr__(self, name):
        return getattr(self._base, name)

    def objects(self, scan, vp):
        return self._obj_reader.objects(scan, vp)


class GmmStoreWorld:
    """WorldProvider over gmmstore files (data/store.py): C++ mmap reads with
    async prefetch instead of per-key h5py opens — the read path SURVEY §6
    flags as the preprocessing bottleneck. Stores are produced by
    cli/convert_store.py from the reference HDF5 artifacts."""

    def __init__(self, view_store: str, depth_store: str, grid_store: str,
                 viewpoint_info: Dict[str, Dict[str, float]],
                 image_feat_size: int = 768, prefer_native: bool = True):
        from gridmm_tpu_torch.data.store import open_store

        self._view = open_store(view_store, prefer_native)
        self._depth = open_store(depth_store, prefer_native)
        self._grid = open_store(grid_store, prefer_native)
        self.viewpoint_info = viewpoint_info
        self.image_feat_size = image_feat_size

    def view_features(self, scan, vp):
        ft = self._view.get(f"{scan}_{vp}")
        return ft[:, : self.image_feat_size].astype(np.float32)

    def view_probs(self, scan, vp):
        ft = self._view.get(f"{scan}_{vp}")
        if ft.shape[1] <= self.image_feat_size:
            return None
        return ft[:, self.image_feat_size:].astype(np.float32)

    def depth_patches(self, scan, vp):
        return _depth_to_patches(self._depth.get(f"{scan}_{vp}"))

    def grid_features(self, scan, vp):
        g = self._grid.get(f"{scan}_{vp}")  # (12, 50, W) incl. cls token
        return g[:, 1:].reshape(-1, g.shape[-1]).astype(np.float32)

    def position(self, scan, vp):
        info = self.viewpoint_info[f"{scan}_{vp}"]
        return (info["x"], info["y"], info["z"])

    def prefetch(self, scan_vps: Iterable[Tuple[str, str]]) -> None:
        """Queue async page-ins for upcoming viewpoints (native reader only)."""
        keys = [f"{s}_{v}" for s, v in scan_vps]
        for reader in (self._view, self._depth, self._grid):
            reader.prefetch(keys)

    def close(self):
        for reader in (self._view, self._depth, self._grid):
            reader.close()


class AugmentedViewWorld:
    """Training-time view augmentation: each view independently swapped with
    its EnvEdit-augmented counterpart with p=0.5 (utils/data.py:22-39).
    Wraps any WorldProvider; `aug_view_features` supplies the aug bank."""

    def __init__(self, base: WorldProvider, aug_view_features, seed: int = 0):
        self._base = base
        self._aug = aug_view_features  # callable (scan, vp) -> (36, D)
        self._rng = np.random.default_rng(seed)

    def view_features(self, scan, vp):
        fts = self._base.view_features(scan, vp).copy()
        aug = self._aug(scan, vp)
        swap = self._rng.random(fts.shape[0]) > 0.5
        fts[swap] = aug[swap]
        return fts

    def depth_patches(self, scan, vp):
        return self._base.depth_patches(scan, vp)

    def grid_features(self, scan, vp):
        return self._base.grid_features(scan, vp)

    def position(self, scan, vp):
        return self._base.position(scan, vp)

    def objects(self, scan, vp):
        if hasattr(self._base, "objects"):
            return self._base.objects(scan, vp)
        return []


def _seeded(key: str, *shape: int) -> np.ndarray:
    seed = int.from_bytes(hashlib.sha256(key.encode()).digest()[:8], "little")
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


class SyntheticWorld:
    """Deterministic procedurally generated world: a planar proximity graph per
    scan, hash-seeded features, and geometry-consistent depth (distance to the
    window boundary of the scan)."""

    def __init__(self, num_scans: int = 2, nodes_per_scan: int = 12,
                 feat_dim: int = 768, seed: int = 0):
        self.feat_dim = feat_dim
        self.graphs: Dict[str, NavGraph] = {}
        rng = np.random.default_rng(seed)
        for s in range(num_scans):
            scan = f"scan{s:02d}"
            g = NavGraph()
            pos = rng.uniform(-8, 8, size=(nodes_per_scan, 2))
            z = rng.uniform(0, 0.2, size=nodes_per_scan)
            vps = [f"vp{n:03d}" for n in range(nodes_per_scan)]
            for vp, p, zz in zip(vps, pos, z):
                g.add_node(vp, (p[0], p[1], zz))
            # connect each node to its 3 nearest neighbors
            for i, vp in enumerate(vps):
                d = np.linalg.norm(pos - pos[i], axis=1)
                for j in np.argsort(d)[1:4]:
                    g.add_edge(vp, vps[j])
            self.graphs[scan] = g

    def scans(self) -> Sequence[str]:
        return list(self.graphs)

    def view_features(self, scan, vp):
        return _seeded(f"view/{scan}/{vp}", VIEWS_PER_PANO, self.feat_dim) * 0.4

    def view_probs(self, scan, vp, prob_size: int = 1000):
        logits = _seeded(f"probs/{scan}/{vp}", VIEWS_PER_PANO, prob_size)
        e = np.exp(logits - logits.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)

    def depth_patches(self, scan, vp):
        rng_d = np.abs(_seeded(f"depth/{scan}/{vp}",
                               HORIZON_VIEWS, DEPTH_PATCHES))
        d = (2000 + 6000 * rng_d).astype(np.uint16)
        holes = np.abs(_seeded(f"holes/{scan}/{vp}",
                               HORIZON_VIEWS, DEPTH_PATCHES)) < 0.1
        d[holes] = 0
        return d

    def grid_features(self, scan, vp):
        return _seeded(f"grid/{scan}/{vp}",
                       HORIZON_VIEWS * DEPTH_PATCHES, self.feat_dim) * 0.4

    def position(self, scan, vp):
        return tuple(self.graphs[scan].positions[vp])

    @staticmethod
    def _stable_int(key: str, mod: int) -> int:
        import hashlib

        return int.from_bytes(
            hashlib.sha256(key.encode()).digest()[:4], "little") % mod

    def objects(self, scan, vp):
        """Deterministic synthetic objects (REVERIE-style): 0..3 per viewpoint
        with stable ids shared across nearby viewpoints. (sha256-keyed —
        builtin hash() is randomized per process.)"""
        h = self._stable_int(f"objn/{scan}/{vp}", 4)
        out = []
        for j in range(h):
            obj_id = f"obj{self._stable_int(f'objid/{scan}/{vp}/{j}', 20):02d}"
            heading = (self._stable_int(f"objh/{scan}/{vp}/{obj_id}", 360)
                       - 180) * math.pi / 180.0
            elevation = (self._stable_int(f"obje/{scan}/{vp}/{obj_id}", 90)
                         - 45) * math.pi / 180.0
            out.append({
                "obj_id": obj_id,
                "feature": _seeded(f"obj/{scan}/{obj_id}", self.feat_dim) * 0.4,
                "loc_fts": _seeded(f"objloc/{scan}/{vp}/{obj_id}", 7) * 0.2,
                "heading": heading,
                "elevation": elevation,
            })
        return out

"""Host-side topological map structures (a copy of the JAX-free
gridmm_tpu/env/graph.py, so the port needs nothing of the JAX package).

Replaces map_nav_src/models/graph_utils.py (FloydGraph/GraphMap). These stay on
host by design: they are tiny (tens of nodes), string-keyed, and updated once
per env step; the tensor-shaped views of them (index maps, pos features) are
assembled per step and shipped to the device (SURVEY.md §7 step 6).
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MAX_DIST = 30.0
MAX_STEP = 10.0
_INF = 1e18


def position_distance(a: Sequence[float], b: Sequence[float]) -> float:
    return math.sqrt((b[0] - a[0]) ** 2 + (b[1] - a[1]) ** 2 + (b[2] - a[2]) ** 2)


def rel_pos_features(
    a: Sequence[float], b: Sequence[float],
    base_heading: float = 0.0, base_elevation: float = 0.0,
) -> Tuple[float, float, float]:
    """Relative heading/elevation/distance between two positions, with the
    simulator's transposed x-y convention (graph_utils.py:15-32)."""
    dx, dy, dz = b[0] - a[0], b[1] - a[1], b[2] - a[2]
    xy = max(math.sqrt(dx * dx + dy * dy), 1e-8)
    xyz = max(math.sqrt(dx * dx + dy * dy + dz * dz), 1e-8)
    heading = math.asin(max(-1.0, min(1.0, dx / xy)))
    if dy < 0:
        heading = math.pi - heading
    heading -= base_heading
    elevation = math.asin(max(-1.0, min(1.0, dz / xyz))) - base_elevation
    return heading, elevation, xyz


def angle_features(heading: float, elevation: float,
                   angle_feat_size: int = 4) -> np.ndarray:
    base = [math.sin(heading), math.cos(heading),
            math.sin(elevation), math.cos(elevation)]
    return np.asarray(base * (angle_feat_size // 4), np.float32)


class IncrementalShortestPaths:
    """All-pairs shortest paths over an incrementally revealed graph.

    Functional twin of the reference's FloydGraph (graph_utils.py:43-92): edges
    are added as nodes are observed; relaxing through a node happens when the
    agent visits it. Paths are reconstructed through the recorded via-points.
    """

    def __init__(self):
        self._dist: Dict[str, Dict[str, float]] = defaultdict(
            lambda: defaultdict(lambda: _INF))
        self._via: Dict[str, Dict[str, str]] = defaultdict(
            lambda: defaultdict(str))
        self._visited = set()

    def distance(self, x: str, y: str) -> float:
        return 0.0 if x == y else self._dist[x][y]

    def add_edge(self, x: str, y: str, d: float) -> None:
        if d < self._dist[x][y]:
            self._dist[x][y] = self._dist[y][x] = d
            self._via[x][y] = self._via[y][x] = ""

    def visit(self, k: str) -> None:
        """Relax all pairs through newly visited node k."""
        for x in list(self._dist):
            if x == k:
                continue
            dxk = self._dist[x][k]
            if dxk >= _INF:
                continue
            for y in list(self._dist):
                if y in (x, k):
                    continue
                cand = dxk + self._dist[k][y]
                if cand < self._dist[x][y]:
                    self._dist[x][y] = self._dist[y][x] = cand
                    self._via[x][y] = self._via[y][x] = k
        self._visited.add(k)

    def visited(self, k: str) -> bool:
        return k in self._visited

    def path(self, x: str, y: str) -> List[str]:
        """Node sequence from x to y, excluding x, including y."""
        if x == y:
            return []
        k = self._via[x][y]
        if k == "":
            return [y]
        return self.path(x, k) + self.path(k, y)


class TopoMap:
    """Per-episode topological memory (reference GraphMap, graph_utils.py:95-148).

    Tracks node positions, visitation, per-node step ids, and produces the
    7-dim relative-position features for gmap/vp tokens."""

    def __init__(self, start_vp: str):
        self.start_vp = start_vp
        self.node_positions: Dict[str, Tuple[float, float, float]] = {}
        self.graph = IncrementalShortestPaths()
        self.node_step_ids: Dict[str, int] = {}
        self.node_stop_scores: Dict[str, float] = {}

    def update(self, viewpoint: str, position, candidates) -> None:
        """candidates: iterable of (viewpointId, position)."""
        self.node_positions[viewpoint] = tuple(position)
        for cand_vp, cand_pos in candidates:
            self.node_positions[cand_vp] = tuple(cand_pos)
            self.graph.add_edge(
                viewpoint, cand_vp, position_distance(position, cand_pos))
        self.graph.visit(viewpoint)

    def visited_and_frontier(self) -> Tuple[List[str], List[str]]:
        visited, frontier = [], []
        for vp in self.node_positions:
            (visited if self.graph.visited(vp) else frontier).append(vp)
        return visited, frontier

    def pos_features(
        self, cur_vp: str, vpids: Sequence[Optional[str]],
        cur_heading: float, cur_elevation: float, angle_feat_size: int = 4,
    ) -> np.ndarray:
        """(len(vpids), angle_feat_size+3): angle fts + [line_dist/30,
        shortest_dist/30, path_steps/10] (graph_utils.py:127-148)."""
        out = np.zeros((len(vpids), angle_feat_size + 3), np.float32)
        cur_pos = self.node_positions[cur_vp]
        for i, vp in enumerate(vpids):
            if vp is None:
                # the reference computes angle features of (0, 0):
                # sin=0, cos=1 (graph_utils.py:133-134 -> get_angle_fts)
                out[i, :angle_feat_size] = angle_features(0.0, 0.0, angle_feat_size)
                continue
            h, e, d = rel_pos_features(
                cur_pos, self.node_positions[vp], cur_heading, cur_elevation)
            out[i, :angle_feat_size] = angle_features(h, e, angle_feat_size)
            out[i, angle_feat_size + 0] = d / MAX_DIST
            out[i, angle_feat_size + 1] = self.graph.distance(cur_vp, vp) / MAX_DIST
            out[i, angle_feat_size + 2] = len(self.graph.path(cur_vp, vp)) / MAX_STEP
        return out

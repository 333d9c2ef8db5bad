"""Continuous-environment boundary, VLN-CE / Habitat (a copy of
gridmm_tpu/ce/env.py: the port keeps its own).

The reference drives habitat-sim through VectorEnv workers with RPC helpers
(VLN_CE/vlnce_baselines/environments.py:14-125: get_agent_info,
cand_dist_to_goal, change_current_path; movement via the MoveHighToLow actions,
habitat_extensions/nav.py:27-172 — set rotation, k x 0.25 m forward steps).

Here the boundary is a Protocol; `HabitatContinuousEnv` adapts habitat when
installed, and `SyntheticContinuousEnv` is a deterministic free-space world for
tests/benchmarks: the agent teleport-moves by (heading, distance), observations
are hash-seeded RGB-D panoramas, and geodesic == euclidean distance.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, List, Optional, Protocol, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class CEStepObs:
    """Per-env observation bundle."""

    position: np.ndarray          # (2,) world x, y
    heading: float
    rgb: np.ndarray               # (12, H, W, 3) uint8, clockwise panorama
    depth: np.ndarray             # (12, Hd, Wd) float metres
    instruction_ids: np.ndarray   # (T,) int32
    episode_id: str
    gt_path: np.ndarray           # (L, 2) reference path positions
    goal: np.ndarray              # (2,)
    # habitat y (vertical) of the agent; the reference's positional features
    # use full (x, height, z) triples (calculate_vp_rel_pos_fts dz term) so
    # slopes/stairs produce nonzero elevation features. Synthetic arenas are
    # flat (0.0).
    height: float = 0.0


class ContinuousEnv(Protocol):
    num_envs: int

    def reset(self) -> List[CEStepObs]: ...

    def step_to(self, i: int, heading: float, distance: float) -> None:
        """Rotate to `heading` then move `distance` metres (may be cut short
        by collisions)."""
        ...

    def observations(self) -> List[CEStepObs]: ...

    def cand_dist_to_goal(self, i: int, heading: float,
                          distance: float) -> float:
        """Oracle: geodesic distance to goal after a hypothetical move
        (environments.py:54-72)."""
        ...

    def dist_to_goal(self, i: int) -> float: ...


class SyntheticContinuousEnv:
    """Free-space 8x8 m arena; deterministic pseudo-renders.

    num_episodes=None draws an unbounded stream of unique episodes; an int
    makes the env a finite "split" whose episode iterator CYCLES (habitat's
    behavior when a split is exhausted), each episode identical on every
    revisit — this is what lets full-split eval detect wraparound.
    """

    def __init__(self, num_envs: int = 2, episode_len: int = 6, seed: int = 0,
                 image_size: int = 224, depth_size: int = 256,
                 num_episodes: Optional[int] = None):
        self.num_envs = num_envs
        self.image_size = image_size
        self.depth_size = depth_size
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._episode_counter = 0
        self.episode_len = episode_len
        # 0 means unbounded, matching run_ce --num_episodes 0 (a literal 0
        # would hit `% num_episodes` at reset)
        self.num_episodes = num_episodes or None
        self.pos = np.zeros((num_envs, 2), np.float64)
        self.heading = np.zeros((num_envs,), np.float64)
        self.goal = np.zeros((num_envs, 2), np.float64)
        self.gt_paths: List[np.ndarray] = [None] * num_envs
        self.instr: List[np.ndarray] = [None] * num_envs
        self.eid: List[str] = [""] * num_envs
        self.paths: List[List[np.ndarray]] = [[] for _ in range(num_envs)]

    # ------------------------------------------------------------- rendering
    def _render(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        key = f"{self.eid[i]}_{self.pos[i, 0]:.2f}_{self.pos[i, 1]:.2f}"
        h = int.from_bytes(hashlib.sha256(key.encode()).digest()[:8], "little")
        rng = np.random.default_rng(h)
        rgb = rng.integers(0, 256, (12, self.image_size, self.image_size, 3),
                           dtype=np.uint8)
        depth = rng.uniform(0.5, 6.0, (12, self.depth_size, self.depth_size)
                            ).astype(np.float32)
        return rgb, depth

    def _obs(self, i: int) -> CEStepObs:
        rgb, depth = self._render(i)
        return CEStepObs(
            position=self.pos[i].copy(), heading=float(self.heading[i]),
            rgb=rgb, depth=depth, instruction_ids=self.instr[i],
            episode_id=self.eid[i], gt_path=self.gt_paths[i],
            goal=self.goal[i].copy())

    # -------------------------------------------------------------- protocol
    def reset(self) -> List[CEStepObs]:
        for i in range(self.num_envs):
            self._episode_counter += 1
            if self.num_episodes is None:
                idx, rng = self._episode_counter, self._rng
            else:
                # cycling split: episode `idx` is regenerated bit-identically
                # from (seed, idx) on every revisit
                idx = (self._episode_counter - 1) % self.num_episodes + 1
                rng = np.random.default_rng((self._seed, idx))
            self.eid[i] = f"ep{idx:05d}"
            start = rng.uniform(-4, 4, 2)
            goal = rng.uniform(-4, 4, 2)
            while np.linalg.norm(goal - start) < 3.0:
                goal = rng.uniform(-4, 4, 2)
            n = self.episode_len
            ts = np.linspace(0, 1, n)[:, None]
            wiggle = rng.normal(0, 0.3, (n, 2))
            wiggle[0] = wiggle[-1] = 0
            self.gt_paths[i] = start[None] + ts * (goal - start)[None] + wiggle
            self.pos[i] = start
            self.goal[i] = goal
            self.heading[i] = rng.uniform(-math.pi, math.pi)
            self.instr[i] = np.asarray(
                [101] + list(rng.integers(1000, 20000, 12)) + [102],
                np.int32)
            self.paths[i] = [start.copy()]
        return self.observations()

    def observations(self) -> List[CEStepObs]:
        return [self._obs(i) for i in range(self.num_envs)]

    def _move_endpoint(self, i: int, heading: float, distance: float):
        # arena walls clip the move (stand-in for collision cut-off)
        d = np.array([math.sin(heading), math.cos(heading)])
        end = self.pos[i] + d * distance
        return np.clip(end, -6.0, 6.0)

    def step_to(self, i: int, heading: float, distance: float) -> None:
        self.pos[i] = self._move_endpoint(i, heading, distance)
        self.heading[i] = heading
        self.paths[i].append(self.pos[i].copy())

    def cand_dist_to_goal(self, i: int, heading: float,
                          distance: float) -> float:
        end = self._move_endpoint(i, heading, distance)
        return float(np.linalg.norm(end - self.goal[i]))

    def dist_to_goal(self, i: int) -> float:
        return float(np.linalg.norm(self.pos[i] - self.goal[i]))


def ce_episode_metrics(path: Sequence[np.ndarray], gt_path: np.ndarray,
                       success_dist: float = 3.0,
                       stopped: Optional[bool] = None,
                       dists: Optional[Sequence[float]] = None,
                       collisions: Optional[Sequence[bool]] = None,
                       ) -> Dict[str, float]:
    """Position-based CE metrics, matching base_il_trainer.py:583-611:

    * `dists` = distance-to-goal at each recorded position (the reference's
      Position measure series, geodesic under habitat); when absent it falls
      back to euclidean distance to gt_path[-1] — exact for the synthetic
      arena where geodesic == euclidean and gt ends at the goal.
      Cadence: ONE sample per macro HIGHTOLOW action, matching the reference
      exactly — Position.update_metric runs only from Env.step()
      (measures.py:47-58); the MoveHighToLow sub-steps call
      sim.step_without_obs directly (nav.py:100-106) and never touch
      measures, so the reference's `distance` array is also per-macro-step
    * success requires final distance <= success_dist AND the episode ending
      on the agent's own STOP action (:598, `env_actions[...] == 0`);
      stopped=None (unknown) drops the stop requirement
    * oracle success scans the whole distance series (:599-600)
    * SPL's reference length is the STARTING distance-to-goal `distance[0]`
      (:603-606), not the gt path's arc length
    * nDTW = exp(-dtw / (len(gt) * success_dist)) (:607-609)
    * `collisions` (eval-mode sub-step flags) reduce to their mean (:602)
    """
    path = np.asarray(path)
    if dists is None:
        dists = np.linalg.norm(path - np.asarray(gt_path)[-1][None], axis=1)
    dists = np.asarray(dists, np.float64)
    ne = float(dists[-1])
    tl = float(np.sum(np.linalg.norm(np.diff(path, axis=0), axis=1))) \
        if len(path) > 1 else 0.0
    sr = float(ne <= success_dist and (stopped is None or stopped))
    oracle = float((dists <= success_dist).any())
    gt_length = float(dists[0])
    denom = max(gt_length, tl)
    spl = sr * gt_length / denom if denom > 0 else sr
    # DTW
    n, m = len(path), len(gt_path)
    dtw = np.full((n + 1, m + 1), np.inf)
    dtw[0, 0] = 0
    for a in range(1, n + 1):
        for b in range(1, m + 1):
            cost = np.linalg.norm(path[a - 1] - gt_path[b - 1])
            dtw[a, b] = cost + min(dtw[a - 1, b], dtw[a, b - 1],
                                   dtw[a - 1, b - 1])
    ndtw = float(np.exp(-dtw[n, m] / (success_dist * m)))
    # steps_taken mirrors habitat_extensions/measures.py StepsTaken (one per
    # executed env action; reset position is step 0)
    out = {"sr": sr, "spl": spl, "ne": ne, "tl": tl, "nDTW": ndtw,
           "oracle_sr": oracle, "sdtw": sr * ndtw,
           "steps_taken": float(len(path) - 1)}
    if collisions is not None and len(collisions):
        out["collisions"] = float(np.mean(np.asarray(collisions, np.float64)))
    return out

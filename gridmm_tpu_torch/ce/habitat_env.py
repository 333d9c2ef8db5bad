"""Habitat-sim adapter for the ContinuousEnv protocol (a copy of
gridmm_tpu/ce/habitat_env.py: the port keeps its own).

Binds habitat / habitat_baselines when installed (optional dependencies;
the synthetic arena in ce/env.py runs without them). Mirrors the reference's
environment surface (VLN_CE/vlnce_baselines/environments.py:14-125 +
habitat_extensions/nav.py:27-172):

  * 12 RGB + 12 DEPTH cameras injected at 30-degree offsets
    (ss_trainer_GridMap.py:518-538, utils.get_camera_orientations)
  * movement = set rotation, then k x 0.25 m forward steps, intermediate
    frames skipped (step_without_obs, habitat_simulator.py:49-100)
  * oracle helpers geodesic_distance-based (environments.py:54-72)
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

from gridmm_tpu_torch.ce.env import CEStepObs

try:
    import habitat  # noqa: F401
    HABITAT_AVAILABLE = True
except ImportError:
    HABITAT_AVAILABLE = False


def get_camera_orientations(num_views: int = 12) -> dict:
    """utils.get_camera_orientations (VLN_CE/vlnce_baselines/utils.py:155-163):
    keys are degree strings str(360/num_views * k); the radian step is
    HARDCODED pi/6 regardless of num_views (only consistent at 12) — kept
    faithfully. The base sensor itself covers angle 0 (range starts at 1)."""
    base_deg = 360 / num_views
    base_rad = math.pi / 6
    return {str(base_deg * k): [0.0, base_rad * k, 0.0]
            for k in range(1, num_views)}


def inject_panoramic_cameras(cfg, num_views: int = 12):
    """Clone the base RGB/DEPTH sensors at the num_views-1 extra yaw
    orientations and register them on AGENT_0, exactly as the reference
    trainer does at config time (ss_trainer_GridMap.py:518-538): sensor
    node name f"{TYPE}_{deg}", UUID lowercased, ORIENTATION from
    get_camera_orientations, appended to AGENT_0.SENSORS; per-sensor
    resizer sizes mirrored when the habitat_baselines RL node exists.
    Idempotent: skips if the panoramic sensors are already registered
    (e.g. a config file that defines them explicitly). Mutates and
    returns cfg."""
    import copy as _copy

    task = cfg.TASK_CONFIG if hasattr(cfg, "TASK_CONFIG") else cfg
    sim = getattr(task, "SIMULATOR", None)
    if sim is None or not hasattr(sim, "RGB_SENSOR"):
        return cfg
    orients = get_camera_orientations(num_views)
    first = f"RGB_{next(iter(orients))}"
    if first in getattr(sim.AGENT_0, "SENSORS", []):
        return cfg
    try:
        resize = cfg.RL.POLICY.OBS_TRANSFORMS.RESIZER_PER_SENSOR.SIZES
    except AttributeError:
        resize = None
    for sensor_type in ("RGB", "DEPTH"):
        sensor = getattr(sim, f"{sensor_type}_SENSOR")
        size = (dict(resize)[sensor_type.lower()]
                if resize is not None else None)
        for action, orient in orients.items():
            template = f"{sensor_type}_{action}"
            cam = _copy.deepcopy(sensor)
            cam.ORIENTATION = orient
            cam.UUID = template.lower()
            setattr(sim, template, cam)
            sim.AGENT_0.SENSORS.append(template)
            if resize is not None:
                resize.append((template.lower(), size))
    return cfg


class HabitatContinuousEnv:
    """ContinuousEnv over a habitat-sim instance (one env per slot)."""

    def __init__(self, config_path: str, num_envs: int = 1,
                 step_size: float = 0.25, eval_mode: bool = False,
                 episodes_allowed=None):
        """eval_mode records every 0.25 m sub-step position + collision flag
        (MoveHighToLowEval/Infer semantics, habitat_extensions/nav.py:27-172)
        so path_length/nDTW and the inference writer see the true walked
        path; train mode records one point per macro step like
        MoveHighToLow.

        episodes_allowed: episode-id whitelist threaded into the dataset
        config's EPISODES_ALLOWED purge filter (construct_envs,
        env_utils.py:59-61; habitat_extensions/task.py:97-106) — the hook
        the scene-balanced per-rank train allocation
        (ce.dataset.allocate_episodes_by_scene) plugs into."""
        if not HABITAT_AVAILABLE:
            raise ImportError(
                "habitat-sim is not installed; use SyntheticContinuousEnv or "
                "install habitat per the reference README")
        import habitat

        self.num_envs = num_envs
        self.step_size = step_size
        self.eval_mode = eval_mode
        cfg = habitat.get_config(config_path)
        if hasattr(cfg, "defrost"):  # yacs config (real habitat)
            cfg.defrost()
        if episodes_allowed is not None:
            ids = [str(i) for i in episodes_allowed]
            if hasattr(cfg, "TASK_CONFIG"):
                cfg.TASK_CONFIG.DATASET.EPISODES_ALLOWED = ids
            else:  # mapping-shaped test doubles
                cfg["EPISODES_ALLOWED"] = ids
        # the 12-angle panorama cameras (ss_trainer_GridMap.py:518-538)
        inject_panoramic_cameras(cfg)
        if hasattr(cfg, "freeze"):
            cfg.freeze()
        self.episodes_allowed = episodes_allowed
        self._envs = [habitat.Env(cfg) for _ in range(num_envs)]
        # advertised split size, used to derive batches_per_epoch =
        # ceil(dataset_length / batch_size) (ss_trainer_GridMap.py:606-607)
        self.num_episodes = (
            len(episodes_allowed) if episodes_allowed is not None
            else len(getattr(self._envs[0], "episodes", []) or []) or None)
        self.paths: List[List[np.ndarray]] = [[] for _ in range(num_envs)]
        self.collisions: List[List[bool]] = [[] for _ in range(num_envs)]
        # leaderboard get_info records (habitat_extensions/nav.py:127-137):
        # 3D position + heading + the hardcoded stop=False, one per recorded
        # path point — the inference writer emits them verbatim
        self.path_infos: List[List[dict]] = [[] for _ in range(num_envs)]
        self._obs = [None] * num_envs

    def _get_info(self, env) -> dict:
        """nav.py:127-137 get_info: habitat 3D position, polar heading,
        stop always False (the reference never flips it)."""
        state = env.sim.get_agent_state()
        import quaternion

        fwd = quaternion.rotate_vectors(state.rotation,
                                        np.asarray([0.0, 0.0, -1.0]))
        heading = math.atan2(fwd[0], -fwd[2])
        return {"position": [float(c) for c in state.position],
                "heading": float(heading), "stop": False}

    # -- protocol ------------------------------------------------------------
    def reset(self) -> List[CEStepObs]:
        out = []
        for i, env in enumerate(self._envs):
            raw = env.reset()
            self.paths[i] = [self._pos(env)]
            self.path_infos[i] = [self._get_info(env)]
            self.collisions[i] = []
            self._obs[i] = raw
            out.append(self._to_obs(i, raw))
        return out

    def observations(self) -> List[CEStepObs]:
        return [self._to_obs(i, self._obs[i]) for i in range(self.num_envs)]

    def step_to(self, i: int, heading: float, distance: float) -> None:
        env = self._envs[i]
        sim = env.sim
        agent_state = sim.get_agent_state()
        # set rotation directly (nav.py:41-54), then forward steps; use an
        # axis-angle y-rotation (euler zyz conventions are ambiguous here)
        import quaternion  # habitat dependency

        rot = quaternion.from_rotation_vector([0.0, -heading, 0.0])
        sim.set_agent_state(agent_state.position, rot)
        steps = max(int(round(distance / self.step_size)), 1)
        for k in range(steps - 1):
            sim.step_without_obs(1)  # MOVE_FORWARD, no rendering (nav.py:96)
            if self.eval_mode:
                # per-sub-step position + collision flag
                # (MoveHighToLowEval, nav.py:112-140)
                self.paths[i].append(self._pos(env))
                self.path_infos[i].append(self._get_info(env))
                self.collisions[i].append(
                    bool(getattr(sim, "previous_step_collided", False)))
        self._obs[i] = env.step(1)
        self.paths[i].append(self._pos(env))
        self.path_infos[i].append(self._get_info(env))
        if self.eval_mode:
            self.collisions[i].append(
                bool(getattr(env.sim, "previous_step_collided", False)))

    def cand_dist_to_goal(self, i: int, heading: float,
                          distance: float) -> float:
        env = self._envs[i]
        sim = env.sim
        pos = np.asarray(sim.get_agent_state().position)
        d = np.asarray([math.sin(heading), 0.0, -math.cos(heading)])
        cand = pos + d * distance
        goal = env.current_episode.goals[0].position
        return float(sim.geodesic_distance(cand, goal))

    def dist_to_goal(self, i: int) -> float:
        env = self._envs[i]
        pos = self._pos3(env)
        goal = env.current_episode.goals[0].position
        return float(env.sim.geodesic_distance(pos, goal))

    # -- helpers -------------------------------------------------------------
    @staticmethod
    def _pos3(env):
        return np.asarray(env.sim.get_agent_state().position)

    def _pos(self, env):
        p = self._pos3(env)
        return np.asarray([p[0], p[2]])  # habitat y is up

    @staticmethod
    def _angle_sorted(raw, prefix):
        """Sensor UUIDs are 'rgb', 'rgb_30.0', ... 'rgb_330.0'
        (ss_trainer_GridMap.py:521-535); lexicographic sort would scramble the
        angular order — sort by the numeric suffix, then REVERSE into the
        reference's clockwise frame order (Policy:301-308: clockwise view j
        takes sensor (12-j)%12; habitat's positive yaw turns counter-
        clockwise, so ascending sensor angles are CCW). The agent's heatmap
        bins, view sectors and back-projection all assume clockwise views."""

        def angle_of(k):
            parts = k.split("_", 1)
            return float(parts[1]) if len(parts) > 1 else 0.0

        keys = [k for k in raw if k == prefix or k.startswith(prefix + "_")]
        ccw = [raw[k] for k in sorted(keys, key=angle_of)]
        nv = len(ccw)
        return [ccw[(nv - j) % nv] for j in range(nv)]

    def _to_obs(self, i: int, raw) -> CEStepObs:
        env = self._envs[i]
        # gather the 12 per-angle sensors injected by camera config, in
        # angular order
        rgbs = self._angle_sorted(raw, "rgb")
        depths = [d[..., 0] for d in self._angle_sorted(raw, "depth")]
        ep = env.current_episode
        instr = ep.instruction.instruction_tokens \
            if hasattr(ep.instruction, "instruction_tokens") else []
        gt = np.asarray([[p[0], p[2]] for p in
                         getattr(ep, "reference_path", [ep.goals[0].position])])
        state = env.sim.get_agent_state()
        import quaternion

        # derive heading by rotating the forward vector — euler-angle
        # readback is sign-ambiguous for negative y-rotations
        fwd = quaternion.rotate_vectors(state.rotation,
                                        np.asarray([0.0, 0.0, -1.0]))
        heading = math.atan2(fwd[0], -fwd[2])
        return CEStepObs(
            position=self._pos(env), heading=float(heading),
            height=float(state.position[1]),
            rgb=np.stack(rgbs), depth=np.stack(depths).astype(np.float32),
            instruction_ids=np.asarray(instr, np.int32),
            episode_id=str(ep.episode_id), gt_path=gt,
            goal=np.asarray([ep.goals[0].position[0],
                             ep.goals[0].position[2]]))

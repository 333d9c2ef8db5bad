"""VLN-CE episode datasets + ground-truth trajectory loaders, habitat-free
(a copy of gridmm_tpu/ce/dataset.py: the port keeps its own).

Honors the reference's on-disk contracts so released data files load directly:

  * VLN-CE-v1 (habitat_extensions/task.py:48-133): `{split}.json.gz` with
    {"episodes": [...], "instruction_vocab": {"word_list": [...]}}; episode
    fields episode_id/scene_id/start_position/start_rotation/goals/
    reference_path/instruction/trajectory_id; scene filtering via
    CONTENT_SCENES and EPISODES_ALLOWED purge semantics.
  * RxR-VLN-CE-v1 (task.py:135-210): per-role files
    `{split}_{role}.json.gz`, plus language filtering over the episode's
    instruction.language.
  * gt paths (base_il_trainer.collect_val_traj, :748-789): gzipped json
    {episode_id: {"locations": [...], "actions": [...], "forward_steps": N}},
    per-role for RxR; rank-strided trajectory split `keys[rank::world]`.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import os
import random
from typing import Dict, List, Optional, Sequence

ALL_SCENES_MASK = "*"
ALL_LANGUAGES_MASK = "*"
ALL_ROLES_MASK = "*"
RXR_ANNOTATION_ROLES = ("guide", "follower")
RXR_LANGUAGES = ("en-US", "en-IN", "hi-IN", "te-IN")
DEFAULT_SCENE_PATH_PREFIX = "data/scene_datasets/"


@dataclasses.dataclass
class VLNCEEpisode:
    episode_id: str
    scene_id: str
    start_position: List[float]
    start_rotation: List[float]
    instruction: Dict
    goals: Optional[List[Dict]] = None
    reference_path: Optional[List[List[float]]] = None
    trajectory_id: Optional[str] = None
    info: Optional[Dict] = None
    extra: Optional[Dict] = None  # fields beyond the known schema

    @property
    def scene(self) -> str:
        """Scene name from scene_id path (task.py _scene_from_episode)."""
        return os.path.splitext(os.path.basename(self.scene_id))[0]

    @property
    def language(self) -> Optional[str]:
        return (self.instruction or {}).get("language")


def _episode_from_json(raw: dict, scenes_dir: Optional[str]) -> VLNCEEpisode:
    known = {f.name for f in dataclasses.fields(VLNCEEpisode)} - {"extra"}
    kwargs = {k: v for k, v in raw.items() if k in known}
    extra = {k: v for k, v in raw.items() if k not in known}
    ep = VLNCEEpisode(**kwargs, extra=extra or None)
    if scenes_dir is not None:
        sid = ep.scene_id
        if sid.startswith(DEFAULT_SCENE_PATH_PREFIX):
            sid = sid[len(DEFAULT_SCENE_PATH_PREFIX):]
        ep.scene_id = os.path.join(scenes_dir, sid)
    return ep


def _parse_dataset_json(text: str, scenes_dir: Optional[str]):
    data = json.loads(text)
    episodes = [_episode_from_json(e, scenes_dir) for e in data["episodes"]]
    vocab = (data.get("instruction_vocab") or {}).get("word_list")
    return episodes, vocab


def _filter(episodes: List[VLNCEEpisode],
            content_scenes: Sequence[str] = (ALL_SCENES_MASK,),
            episodes_allowed: Optional[Sequence] = None,
            languages: Optional[Sequence[str]] = None) -> List[VLNCEEpisode]:
    if ALL_SCENES_MASK not in content_scenes:
        keep = set(content_scenes)
        episodes = [e for e in episodes if e.scene in keep]
    if languages is not None and ALL_LANGUAGES_MASK not in languages:
        keep_l = set(languages)
        episodes = [e for e in episodes if e.language in keep_l]
    if episodes_allowed is not None:
        # purge semantics (task.py:98-106): ids present before minus allowed
        allowed = {str(i) for i in episodes_allowed}
        episodes = [e for e in episodes if str(e.episode_id) in allowed]
    return episodes


def load_vlnce_dataset(
    data_path: str,
    split: str,
    content_scenes: Sequence[str] = (ALL_SCENES_MASK,),
    episodes_allowed: Optional[Sequence] = None,
    scenes_dir: Optional[str] = None,
    shuffle_seed: Optional[int] = 0,
):
    """VLN-CE-v1 loader. data_path may contain `{split}`.

    Returns (episodes, vocab_word_list). The reference shuffles episodes at
    load time with random.seed(0) (task.py:17,133); pass shuffle_seed=None to
    keep file order."""
    path = data_path.format(split=split)
    with gzip.open(path, "rt") as f:
        episodes, vocab = _parse_dataset_json(f.read(), scenes_dir)
    episodes = _filter(episodes, content_scenes, episodes_allowed)
    if shuffle_seed is not None:
        random.Random(shuffle_seed).shuffle(episodes)
    return episodes, vocab


def load_rxr_dataset(
    data_path: str,
    split: str,
    roles: Sequence[str] = (ALL_ROLES_MASK,),
    languages: Sequence[str] = (ALL_LANGUAGES_MASK,),
    content_scenes: Sequence[str] = (ALL_SCENES_MASK,),
    episodes_allowed: Optional[Sequence] = None,
    scenes_dir: Optional[str] = None,
):
    """RxR-VLN-CE-v1 loader: per-role files + language filter
    (task.py:135-210). data_path contains `{split}` and `{role}`."""
    if ALL_ROLES_MASK in roles:
        roles = RXR_ANNOTATION_ROLES
    else:
        unknown = set(roles) - set(RXR_ANNOTATION_ROLES)
        if unknown:
            raise ValueError(f"unknown RxR roles {sorted(unknown)}")
    episodes: List[VLNCEEpisode] = []
    vocab = None
    for role in roles:
        with gzip.open(data_path.format(split=split, role=role), "rt") as f:
            eps, v = _parse_dataset_json(f.read(), scenes_dir)
        episodes += eps
        vocab = vocab or v
    episodes = _filter(episodes, content_scenes, episodes_allowed,
                       languages=languages)
    return episodes, vocab


def scenes_to_load(episodes: List[VLNCEEpisode]) -> List[str]:
    """Sorted unique scene names (task.py get_scenes_to_load)."""
    return sorted({e.scene for e in episodes})


def load_gt_trajectories(
    gt_path: str,
    split: str,
    roles: Optional[Sequence[str]] = None,
) -> Dict[str, dict]:
    """GT path records keyed by episode id (collect_val_traj,
    base_il_trainer.py:748-786). gt_path may contain `{split}` and, for RxR,
    `{role}` — then every requested role's file is merged."""
    if "{role}" in gt_path:
        roles = roles or RXR_ANNOTATION_ROLES
        out: Dict[str, dict] = {}
        for role in roles:
            with gzip.open(gt_path.format(split=split, role=role), "rt") as f:
                out.update(json.load(f))
        return out
    with gzip.open(gt_path.format(split=split), "rt") as f:
        return json.load(f)


def strided_trajectory_split(gt_data: Dict[str, dict], rank: int,
                             world_size: int) -> List[str]:
    """Per-rank eval allocation: keys[rank::world_size]
    (base_il_trainer.py:787)."""
    return list(gt_data.keys())[rank::world_size]


def allocate_episodes_by_scene(episodes: List[VLNCEEpisode],
                               world_size: int) -> List[List]:
    """Scene-balanced per-rank TRAIN episode allocation
    (ss_trainer_GridMap.py:77-139 allocate_allowed_episode_by_scene).

    Greedy bin-packing: the single largest scene (ties: last in data order)
    is held back as filler; every other scene goes — whole, largest first,
    ties in reverse data order — to the currently lightest rank (first rank
    on ties); then each rank is topped up from the filler scene until it
    holds exactly len(episodes)//world_size episodes. Rank groups therefore
    hold (mostly) whole scenes — each habitat worker keeps a small resident
    scene set — and equal episode counts. Filler episodes beyond
    world_size*average are dropped, as in the reference.

    Returns world_size lists of episode ids (pass list[rank] as
    episodes_allowed).
    """
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    if not episodes:
        return [[] for _ in range(world_size)]
    average_length = len(episodes) // world_size

    by_scene: Dict[str, List] = {}
    for ep in episodes:
        by_scene.setdefault(ep.scene, []).append(ep.episode_id)

    # size -> scenes with that size, in insertion order; assignment pops
    # from the END (the reference's values_to_scenes[v].pop())
    values_to_scenes: Dict[int, List[str]] = {}
    values: List[int] = []
    for scene, eps in by_scene.items():
        values.append(len(eps))
        values_to_scenes.setdefault(len(eps), []).append(scene)
    values.sort(reverse=True)

    filler = list(by_scene[values_to_scenes[values[0]].pop()])
    values = values[1:]

    load_totals = [0] * world_size
    groups: List[List] = [[] for _ in range(world_size)]
    for v in values:
        idx = load_totals.index(min(load_totals))  # np.argmin: first min
        load_totals[idx] += v
        groups[idx] += by_scene[values_to_scenes[v].pop()]

    for grp in groups:
        add_number = average_length - len(grp)
        # replicated verbatim: a group already larger than average keeps its
        # overflow AND takes all-but-|add_number| filler (negative slice) —
        # unreachable with realistic scene distributions
        grp += filler[:add_number]
        filler = filler[add_number:]
    return groups

"""Configuration tree of the PyTorch port (twin of gridmm_tpu/config.py).

The same frozen dataclasses and presets as the JAX package, field for field,
except the two TPU dispatch flags (`use_pallas_attention`,
`use_pallas_grid_pool`): the port dispatches by device instead — a CUDA
tensor always goes through the hand-written kernel, a CPU tensor through the
plain PyTorch version. `ModelConfig.dtype` returns a `torch.dtype`.

Default values replicate the reference's released configs
(pretrain_src/config/r2r_model_config.json and map_nav_src/r2r/parser.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Cross-modal navigator hyper-parameters.

    Mirrors pretrain_src/config/r2r_model_config.json in the reference.
    """

    vocab_size: int = 30522
    hidden_size: int = 768
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    feat_dropout: float = 0.4  # visual-feature dropout (models/model.py:18,29-31)
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02

    # encoder depths (reference: num_l_layers=9, num_x_layers=4, num_pano_layers=2)
    num_l_layers: int = 9
    num_x_layers: int = 4
    num_pano_layers: int = 2

    # feature sizes
    image_feat_size: int = 768
    angle_feat_size: int = 4
    obj_feat_size: int = 0
    image_prob_size: int = 1000  # MRC soft-label classes
    obj_prob_size: int = 0

    max_action_steps: int = 100  # gmap step-id embedding table size

    glocal_fuse: bool = True
    # reproduce the reference's compaction-alias stray keys: its max_cell_num
    # compaction loop (vilmodel.py:816-820) mutates grid_masks[b] through a
    # view, leaving up to max_cell-cnt zero-embedding rows attendable for
    # every item with fewer occupied cells than the batch max — released
    # checkpoints were trained under this, so it is on by default
    # (ops/masking.compaction_stray_count; exact via one zero token with a
    # log(count) key bias). False restores the clean masked semantics.
    compaction_stray_keys: bool = True
    graph_sprels: bool = True
    use_lang2visn_attn: bool = True
    update_lang_bert: bool = True
    fix_lang_embedding: bool = False
    fix_pano_embedding: bool = False
    fix_local_branch: bool = False

    # The reference's instruction-relevance max runs over the PADDED text
    # length (vilmodel.py:793-798 applies no mask before .max) — pad-position
    # BERT outputs participate, and released checkpoints were trained under
    # that function. False (default) reproduces it everywhere (rollout,
    # replay training, pretrain, CE, serving); True excludes pad tokens —
    # cleaner semantics, but NOT checkpoint-compatible with released weights.
    mask_txt_relevance: bool = False

    # Candidate gmap-slot embedding semantics. True = the discrete GraphMap
    # accumulates candidate view embeddings across steps (running average,
    # map_nav_src agent.py:312-320). False = VLN-CE semantics: candidate
    # tokens are EPHEMERAL per-step pano embeddings, rebuilt fresh every step
    # (Policy:522-537 batch_traj_img_embeds = [stop] + pano_embeds[:L-1] +
    # reversed traj averages — no cross-step candidate state).
    frontier_accumulate: bool = True

    # knobs with no reference equivalent
    compute_dtype: str = "float32"
    # serving-only int8 projections/FFN in the transformer trunk, same
    # parameters (models/layers.Int8Dense, ops/quant.py)
    int8_matmuls: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Grid-memory-map geometry constants.

    One parameterized geometry module covers the reference's three copies of the
    grid-build algorithm (map_nav_src/r2r/env.py:267-374 "discrete",
    pretrain_src/data/dataset.py:351-473 "offline",
    VLN_CE/.../Policy_ViewSelection_GridMap.py:689-807 "continuous") whose
    constants/sign conventions differ.
    """

    grid_width: int = 14
    grid_height: int = 14
    num_views: int = 12              # horizon views per panorama (ix 12..24)
    patches_per_view: int = 49       # 7x7 depth patch centers
    feature_dim: int = 768
    max_steps: int = 15              # max episode length (r2r/parser.py max_action_len)

    # depth decoding: metres = raw_uint16 / depth_scale (env.py:116)
    depth_scale: float = 4000.0
    # half horizontal FOV: discrete MatterSim 60deg VFOV -> tan(pi/6);
    # continuous Habitat HFOV 90deg -> tan(pi/4) (Policy_ViewSelection_GridMap.py:632-641)
    tan_half_hfov: float = 0.5773502691896257  # tan(pi/6)
    # egocentric window scale: half_len = window_scale * max extent (env.py:331)
    window_scale: float = 2.0 / 3.0
    # cell-center distance normalizer for gridmap_pos_fts (env.py:256, MAX_DIST=30)
    max_dist: float = 30.0
    # step-count normalizer for node positional features: discrete MAX_STEP=10
    # (map_nav_src/models/graph_utils.py:5); CE R2R MAX_STEP=20, RxR 30
    # (Policy_ViewSelection_GridMap.py:274-286)
    pos_step_norm: float = 10.0
    # heading sign convention. discrete: angle = -heading (env.py:337);
    # continuous: angle = -heading + pi with map_x negated
    # (Policy_ViewSelection_GridMap.py:785,797)
    heading_sign: float = -1.0
    heading_offset: float = 0.0
    map_x_sign: float = 1.0
    # continuous variant: view azimuths are agent-heading-relative
    # (ix*pi/6 - heading, Policy:779) and global_y = pos_y - rel_y (Policy:782)
    view_angles_relative: bool = False
    y_sign: float = 1.0
    # gridmap_pos_fts axis convention: "discrete" = map_nav's (x, y, z)
    # unpacking; "ce" = VLN_CE's (x, z, y) unpacking, which degenerates cell
    # heading to +/-pi/2 and routes cy into elevation
    # (models/utils.py:125-144; ops/geometry.gridmap_pos_fts docstring)
    pos_fts_convention: str = "discrete"
    # habitat depth sensors emit NORMALIZED [0, 1] maps; the reference scales
    # them to metres for the grid build with a column-max substitution for
    # zero pixels (GridMap.preprocess_depth, Policy:225-247: zeros take the
    # max of their image column, then d -> min + d*(max-min)). The waypoint
    # towers keep consuming the raw normalized maps.
    depth_normalized: bool = False
    min_depth: float = 0.0   # R2R-CE 0..10 m; RxR-CE 0.5..5 m (Policy:228-233)
    max_depth: float = 10.0
    # point-buffer storage dtype: bf16 halves the bytes the grid pool reads;
    # the reference stores grid features as fp16 (r2r/env.py:111), so reduced
    # precision is reference-consistent. f32 default for gradient fidelity.
    feature_dtype: str = "float32"

    @property
    def num_cells(self) -> int:
        return self.grid_width * self.grid_height

    @property
    def points_per_step(self) -> int:
        return self.num_views * self.patches_per_view  # 588

    @property
    def max_points(self) -> int:
        return self.max_steps * self.points_per_step


@dataclasses.dataclass(frozen=True)
class NavigatorShapes:
    """Static padded shapes for the per-step navigation graph.

    The reference pads dynamically to per-batch maxima (models/ops.py
    pad_tensors_wgrad); the port keeps the JAX package's fixed caps, so every
    step sees the same shapes.
    """

    max_txt_len: int = 200      # run_r2r.sh/run_reverie.sh --max_instr_len
                                # 200 (the shipped training recipe; the
                                # parser default 80 is never used); soon 100,
                                # rxr 250 — presets below set each
    max_gmap_len: int = 64      # [stop] + visited + frontier nodes
    max_vp_len: int = 40        # [stop] + <=36 views (+ objects)
    max_obj_len: int = 0
    num_cells: int = 196
    max_points: int = 8832      # >= GridConfig.max_points, multiple of 128


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout (data-parallel axis plus an optional tensor-sharding
    `model` axis). Kept for field parity with the JAX package; the port's
    parallel layer is a later slice.
    """

    data_axis: str = "data"
    model_axis: str = "model"
    dp_size: int = -1  # -1: infer from device count / mp_size
    mp_size: int = 1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Fine-tune / pretrain optimization settings (r2r/parser.py defaults)."""

    lr: float = 1e-5
    weight_decay: float = 0.0
    optim: str = "adamw"
    # finetune optimizers are built with torch defaults — agent_base.py:135
    # passes ONLY lr, so betas/eps are torch.optim.AdamW's (0.9, 0.999)/1e-8
    betas: Tuple[float, float] = (0.9, 0.999)
    adam_eps: float = 1e-8
    # the pretrain driver overrides both: parser.py:69 betas (0.9, 0.98) and
    # the vendored optim/adamw.py eps default 1e-6 (cli/pretrain.py applies
    # these when building its optimizer)
    pretrain_betas: Tuple[float, float] = (0.9, 0.98)
    pretrain_adam_eps: float = 1e-6
    grad_norm_clip: float = 40.0   # agent_base.py:205
    ml_weight: float = 0.2
    feedback: str = "sample"
    expl_max_ratio: float = 0.6  # expl_sample: explore when rand > ratio
    expert_policy: str = "spl"  # 'spl' shortest-dist oracle | 'ndtw' follow GT path
    max_action_len: int = 15
    # scan-length buckets: episodes pad to the smallest bucket >= their real
    # length instead of always max_action_len, reclaiming compute on short
    # episodes at the cost of one compiled fwd+bwd graph per bucket
    # (None = single max_action_len graph)
    scan_buckets: Optional[Tuple[int, ...]] = None
    ignoreid: int = -100
    # the R2R recipe (run_r2r.sh): 20k iters, eval every 500, global batch
    # 4 x 4 GPUs = 16; other flavors' presets override below
    iters: int = 20000
    log_every: int = 500
    batch_size: int = 16
    seed: int = 0
    feat_dropout: float = 0.4      # models/model.py:18
    remat_steps: bool = True       # jax.checkpoint per scan step (memory/flops)
    # replay loss formulation: True = stacked (point buffer precomputed once,
    # out of the scan carry — saves the per-step whole-buffer residuals);
    # False = incremental (the same per-step graph the rollout uses)
    stacked_replay: bool = True
    loss_head: str = "fused"       # CE trains on 'ce' = global+local over
                                   # [stop]+candidates (gridmap/vilmodel.py
                                   # :788-800)
    # replay-loss scaling: 'batch' = ml_weight/batch_size (discrete agent.py
    # :447); 'actions' = 1/total-action-count, no ml_weight (VLN-CE
    # ss_trainer_GridMap.py:284,493) — the CE presets set 'actions'
    loss_norm: str = "batch"
    # RxR's agent adds a second CE over the examples whose teacher action is
    # [stop] — stop decisions weighted twice (rxr/agent.py:367-373); absent
    # from r2r/reverie/soon
    stop_extra_ce: bool = False
    dagger_sum: bool = False       # True = sum teacher+sample losses per iter
                                   # (reference agent_base.py:164-196 shape)
    # pretrain (pretrain_src/config/r2r_pretrain.json)
    warmup_steps: int = 10000
    num_train_steps: int = 100000
    mrc_mask_prob: float = 0.15
    mlm_prob: float = 0.15


@dataclasses.dataclass(frozen=True)
class GridMMConfig:
    """Top-level bundle."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    grid: GridConfig = dataclasses.field(default_factory=GridConfig)
    shapes: NavigatorShapes = dataclasses.field(default_factory=NavigatorShapes)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


def r2r_config() -> GridMMConfig:
    """Discrete R2R preset (map_nav_src/scripts/run_r2r.sh)."""
    return GridMMConfig()


def reverie_config() -> GridMMConfig:
    """REVERIE preset: object grounding enabled (map_nav_src/reverie/parser.py)."""
    base = GridMMConfig()
    return dataclasses.replace(
        base,
        model=dataclasses.replace(base.model, obj_feat_size=768, obj_prob_size=0),
        shapes=dataclasses.replace(base.shapes, max_vp_len=60, max_obj_len=20),
        # run_reverie.sh: 100k iters, global batch 2 x 1 GPU
        train=dataclasses.replace(base.train, iters=100000, batch_size=2),
    )


def soon_config() -> GridMMConfig:
    """SOON preset: object grounding with bbox-polygon detection metrics
    (map_nav_src/soon/*); longer instructions than R2R."""
    base = reverie_config()
    return dataclasses.replace(
        base,
        # 20-step episodes need a 20x588-point buffer (11760 -> 11776 x128)
        shapes=dataclasses.replace(base.shapes, max_txt_len=100,
                                   max_points=11776),
        grid=dataclasses.replace(base.grid, max_steps=20),
        # run_soon.sh: lr 5e-5, 10k iters, eval every 100, global batch
        # 1 x 2 GPUs, 20-step episodes, --max_instr_len 100
        train=dataclasses.replace(base.train, lr=5e-5, iters=10000,
                                  log_every=100, batch_size=2,
                                  max_action_len=20),
    )


def rxr_config() -> GridMMConfig:
    """RxR preset: xlm-roberta vocab, longer instructions (map_nav_src/rxr/parser.py)."""
    base = GridMMConfig()
    return dataclasses.replace(
        base,
        model=dataclasses.replace(base.model, vocab_size=250002, max_position_embeddings=512),
        # run_rxr.sh --max_instr_len 250 (the agent's extra [:500] clamp,
        # rxr/agent.py:47-49, never binds); 20-step episodes need a
        # 20x588-point buffer (11760 -> 11776 x128)
        shapes=dataclasses.replace(base.shapes, max_txt_len=250,
                                   max_points=11776),
        grid=dataclasses.replace(base.grid, max_steps=20),
        # run_rxr.sh: 100k iters, eval every 4000, global batch 2 x 3 GPUs,
        # 20-step episodes; + the stop-CE doubling (rxr/agent.py:367-373)
        train=dataclasses.replace(base.train, stop_extra_ce=True,
                                  iters=100000, log_every=4000,
                                  batch_size=6, max_action_len=20),
    )


def tiny_config() -> GridMMConfig:
    """Smoke-scale dims for tests, CLI dry runs, and the synthetic world."""
    model = ModelConfig(
        vocab_size=30522, hidden_size=128, num_attention_heads=4,
        intermediate_size=256, num_l_layers=2, num_x_layers=2,
        num_pano_layers=1, image_feat_size=128, max_position_embeddings=64)
    grid = GridConfig(feature_dim=128, max_steps=4)
    shapes = NavigatorShapes(
        max_txt_len=24, max_gmap_len=16, max_vp_len=40, max_points=4 * 588)
    train = TrainConfig(batch_size=3, max_action_len=4, lr=1e-4)
    return GridMMConfig(model=model, grid=grid, shapes=shapes,
                        mesh=MeshConfig(), train=train)


def r2r_ce_config() -> GridMMConfig:
    """Continuous R2R-CE preset: Habitat HFOV 90deg, heading offset
    (VLN_CE/.../Policy_ViewSelection_GridMap.py:632-641,785)."""
    base = GridMMConfig()
    return dataclasses.replace(
        base,
        # CE episodes run to IL.max_traj_len = 20 (run_GridMap.yaml:23,
        # ss_trainer_GridMap.py:54): the point buffer must hold 20x588
        # (dynamic_update_slice clamps, so an undersized buffer silently
        # overwrites the tail window instead of erroring)
        shapes=dataclasses.replace(base.shapes, max_points=11776),
        model=dataclasses.replace(base.model, frontier_accumulate=False),
        train=dataclasses.replace(base.train, max_action_len=20,
                                  loss_norm="actions", loss_head="ce"),
        grid=dataclasses.replace(
            base.grid,
            max_steps=20,
            tan_half_hfov=1.0,           # tan(pi/4), HFOV=90
            patches_per_view=49,
            depth_scale=1.0,             # habitat depth already metres
            # CE R2R normalizers: MAX_DIST 25 / MAX_STEP 20 (Policy:272-286;
            # both the node pos fts and get_gridmap_pos_fts read the global)
            max_dist=25.0,
            pos_step_norm=20.0,
            heading_sign=-1.0,
            heading_offset=3.141592653589793,
            map_x_sign=-1.0,
            view_angles_relative=True,
            y_sign=-1.0,
            pos_fts_convention="ce",
            depth_normalized=True,
            min_depth=0.0,
            max_depth=10.0,
        ),
    )


def rxr_ce_config() -> GridMMConfig:
    """RxR-CE preset: the r2r_ce geometry with RxR normalizers MAX_DIST 40 /
    MAX_STEP 30 (Policy_ViewSelection_GridMap.py:280-286), xlm-roberta text
    stack, and the depth-only waypoint predictor convention
    (base_il_trainer.py:100-117 DepthDistPredictor for RxR)."""
    base = r2r_ce_config()
    return dataclasses.replace(
        base,
        model=dataclasses.replace(base.model, vocab_size=250002,
                                  max_position_embeddings=512),
        shapes=dataclasses.replace(base.shapes, max_txt_len=256),
        grid=dataclasses.replace(base.grid, max_dist=40.0,
                                 pos_step_norm=30.0,
                                 min_depth=0.5, max_depth=5.0,
                                 # RxR cameras: HFOV 79 deg (Policy:637-638
                                 # tan(pi*79/360) in the depth back-projection)
                                 tan_half_hfov=0.8243363858174957),
    )

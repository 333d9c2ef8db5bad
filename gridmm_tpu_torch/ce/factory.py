"""Construction helpers for the continuous-env stack (twin of
gridmm_tpu/ce/factory.py)."""

from __future__ import annotations

import dataclasses

import torch

from gridmm_tpu_torch.ce.agent import CEAgent
from gridmm_tpu_torch.ce.encoders import DepthTower, RgbTower
from gridmm_tpu_torch.config import (ModelConfig, NavigatorShapes,
                                     TrainConfig, r2r_ce_config,
                                     rxr_ce_config)
from gridmm_tpu_torch.models.clip_vit import (ClipVisionConfig, clip_b32,
                                              init_clip_vision, vit_b16_timm)
from gridmm_tpu_torch.models.layers import init_weights
from gridmm_tpu_torch.models.navigator import init_navigator
from gridmm_tpu_torch.models.resnet import (DdppoDepthEncoder,
                                            RgbResNet50Tower, init_tower)
from gridmm_tpu_torch.models.waypoint import WaypointConfig, WaypointPredictor


def tiny_ce_configs(preset: str = "r2r", waypoint_rgb: bool = True):
    """(GridMMConfig, WaypointConfig, CLIP config) of the smoke-scale agent,
    the JAX factory's tiny widths."""
    base = rxr_ce_config() if preset == "rxr" else r2r_ce_config()
    cfg = dataclasses.replace(
        base,
        model=ModelConfig(
            vocab_size=30522, hidden_size=64, num_attention_heads=4,
            intermediate_size=128, num_l_layers=1, num_x_layers=1,
            num_pano_layers=1, image_feat_size=64,
            max_position_embeddings=32),
        grid=dataclasses.replace(base.grid, feature_dim=64, max_steps=4),
        shapes=NavigatorShapes(max_txt_len=16, max_gmap_len=16,
                               max_vp_len=20, max_points=4 * 588),
        train=TrainConfig(max_action_len=4, loss_norm="actions"),
    )
    # the stand-in RGB tower has 2048*7*7 // 49 // 49 = 41 channels per
    # cell: 49 x 41 = 2009 features (the JAX Dense infers that width)
    wp_cfg = WaypointConfig(hidden_dim=64, num_heads=4, num_layers=1,
                            rgb_feat_dim=49 * (2048 * 7 * 7 // 49 // 49),
                            depth_feat_dim=128 * 16, use_rgb=waypoint_rgb)
    # 7x7 patches + cls = 50 tokens feed the 49-points/view contract
    clip_cfg = ClipVisionConfig(input_resolution=56, patch_size=8, width=64,
                                layers=1, heads=4, compute_dtype="float32")
    return cfg, wp_cfg, clip_cfg


def build_ce_agent(img: int = 56, depth_sz: int = 256, tiny: bool = True,
                   seed: int = 0, waypoint_rgb: bool = True,
                   view_tower: bool = False, preset: str = "r2r",
                   device="cuda"):
    """Assemble a CEAgent with fresh seeded parameters on `device`.

    tiny=True uses smoke-scale dims (tests, the synthetic arena); tiny=False
    the full r2r_ce preset with the ResNet50/ddppo towers and ViT-B/32 grid
    features at 224 px. waypoint_rgb=False builds the depth-only waypoint
    predictor (RxR-CE, DepthDistPredictor_TRM). view_tower=True adds the
    timm ViT-B/16 view encoder (gridmap/vilmodel.py:631; cls token per
    view); without it view tokens fall back to CLIP cls features.
    preset='rxr' swaps in the RxR-CE normalizers + xlm-roberta text dims
    (Policy:280-286). `img` is the JAX signature's: the towers here take
    the env's image size as it comes, and only the ddppo encoder's
    compression width depends on `depth_sz`. Returns (cfg, agent)."""
    if tiny:
        cfg, wp_cfg, clip_cfg = tiny_ce_configs(preset, waypoint_rgb)
    else:
        cfg = rxr_ce_config() if preset == "rxr" else r2r_ce_config()
        wp_cfg = WaypointConfig(use_rgb=waypoint_rgb)
        clip_cfg = clip_b32()
    device = torch.device(device)

    def gen(k):
        return torch.Generator().manual_seed(seed * 1000 + k)

    navigator = init_navigator(cfg.model, seed=seed, device=device)
    waypoint = WaypointPredictor(wp_cfg)
    init_weights(waypoint, gen(3), 0.02)
    if tiny:
        rgb_tower = RgbTower(out_ch=wp_cfg.rgb_feat_dim // 49, grid=7)
        depth_tower = DepthTower(out_ch=128)
    else:
        # the reference's frozen towers: TorchVision ResNet50 (2048*7*7) and
        # ddppo GroupNorm ResNet50 (128*4*4), models/resnet.py
        rgb_tower = RgbResNet50Tower()
        depth_tower = DdppoDepthEncoder(input_size=depth_sz)
    init_tower(rgb_tower, gen(1))
    init_tower(depth_tower, gen(2))
    clip = init_clip_vision(clip_cfg, seed=seed * 1000 + 4, device=device)
    view_encoder = None
    if view_tower:
        view_cfg = (dataclasses.replace(clip_cfg, gelu="erf", ln_pre=False,
                                        conv_bias=True)
                    if tiny else vit_b16_timm())
        view_encoder = init_clip_vision(view_cfg, seed=seed * 1000 + 5,
                                        device=device)
    agent = CEAgent(cfg, navigator, waypoint.to(device).eval(), clip,
                    rgb_tower.to(device).eval(),
                    depth_tower.to(device).eval(), view_encoder)
    return cfg, agent


def load_ce_released_weights(agent: CEAgent, waypoint_ckpt=None,
                             navigator_ckpt=None, clip_ckpt=None,
                             rgb_resnet_sd=None, ddppo_sd=None,
                             vit_ckpt=None) -> CEAgent:
    """Import the released-artifact set the reference trainer assembles
    (base_il_trainer.py:80-117 + gridmap/vlnbert_init.py:11-65):

      waypoint_ckpt   check_val_best_avg_wayscore (R2R) /
                      check_cwp_bestdist_hfov79 (RxR depth-only), a loaded
                      dict or a path; state_dict nested under
                      ['predictor']['state_dict']
      navigator_ckpt  grid_map.pt state_dict (fine-tuned GridMM navigator)
      clip_ckpt       ViT-B-32.pt visual tower state_dict
      rgb_resnet_sd   torchvision resnet50 state_dict
      ddppo_sd        gibson ddppo visual_encoder state_dict (already
                      stripped to the visual_encoder scope)
      vit_ckpt        vit_base_p16_224.pth timm state_dict (the live view
                      encoder; needs build_ce_agent(view_tower=True))

    Any argument left None keeps that component's current weights. Loads in
    place and returns the agent."""
    from gridmm_tpu_torch.models.resnet import (import_ddppo_depth_encoder,
                                                import_torchvision_resnet50)
    from gridmm_tpu_torch.utils import checkpoint as CK

    def _load(obj):
        if isinstance(obj, str):
            return torch.load(obj, map_location="cpu", weights_only=False)
        return obj

    def _put(module, sd):
        with torch.no_grad():
            module.load_state_dict(sd, strict=True)

    if waypoint_ckpt is not None:
        ckpt = _load(waypoint_ckpt)
        sd = ckpt.get("predictor", {}).get("state_dict", ckpt) \
            if isinstance(ckpt, dict) else ckpt
        # the rgb/depth-only flavor follows the model the agent was built
        # with; a depth-only model has no rgb leaves
        wcfg = agent.waypoint.cfg
        sd, report = CK.import_torch_waypoint(
            sd, agent.waypoint, num_layers=wcfg.num_layers,
            use_rgb=wcfg.use_rgb)
        if report["unfilled_flax_leaves"]:
            raise ValueError(f"waypoint import left leaves unfilled: "
                             f"{report['unfilled_flax_leaves']}")
        _put(agent.waypoint, sd)
    if navigator_ckpt is not None:
        # released nesting: grid_map.pt = {'vln_bert': {'state_dict': ...}}
        # with 'vln_bert.'/'module.' key prefixes; CE ckpt.{epoch}.pth =
        # {'state_dict': ...} with 'net.module.vln_bert.' prefixes
        # (gridmap/vlnbert_init.py:17-33)
        sd = CK.remap_ce_released(_load(navigator_ckpt))
        m = agent.cfg.model
        sd, report = CK.import_torch_navigator(
            sd, agent.navigator, num_l_layers=m.num_l_layers,
            num_x_layers=m.num_x_layers, num_pano_layers=m.num_pano_layers,
            has_obj=m.obj_feat_size > 0)
        # a wrong key space matches zero rules and must raise, not no-op
        CK.require_navigator_coverage(report, what="grid_map navigator")
        _put(agent.navigator, sd)
    if clip_ckpt is not None:
        CK.import_torch_clip_visual(_load(clip_ckpt), agent.clip)
    if rgb_resnet_sd is not None:
        _put(agent.rgb_tower,
             import_torchvision_resnet50(_load(rgb_resnet_sd),
                                         agent.rgb_tower))
    if ddppo_sd is not None:
        _put(agent.depth_tower,
             import_ddppo_depth_encoder(_load(ddppo_sd), agent.depth_tower))
    if vit_ckpt is not None:
        if agent.view_encoder is None:
            raise ValueError("vit_ckpt given but the agent was built without "
                             "view_tower=True")
        _put(agent.view_encoder,
             CK.import_timm_vit(_load(vit_ckpt), agent.view_encoder))
    return agent

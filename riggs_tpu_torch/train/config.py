"""Typed configuration: the reference's dataclasses with a JSON round-trip.

A copy of ``riggs_tpu/train/config.py`` (``ModelConfig``, ``PipelineConfig``,
``OptimizationConfig``, ``Config``; the port keeps its own copy rather than
import the JAX package). Field defaults are the reference's, and JSON written
by either package loads in the other. ``data_device`` defaults to ``cuda``.
``add_config_args`` and ``config_from_args`` (the reference's ``:190-217``)
reflect every field into a command-line flag for the CLI twins.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path


@dataclass
class ModelConfig:
    # arguments/__init__.py:50-98
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    data_device: str = "cuda"
    eval: bool = True
    load2device_on_the_fly: bool = False
    is_blender: bool = True
    is_6dof: bool = False
    deform_type: str = "node"
    node_num: int = 512
    hyper_dim: int = 8
    local_frame: bool = False
    use_isotropic_gs: bool = False
    init_isotropic_gs_with_all_colmap_pcl: bool = False
    gs_with_motion_mask: bool = False
    pretrain_model_path: str = ""
    use_skinning_weight_mlp: bool = False
    use_template_offsets: bool = False
    skeleton_gs_sample_num: int = 512
    d_rot_as_res: bool = True
    # capacity of the padded Gaussian arrays (static shapes)
    capacity: int = 65536


@dataclass
class PipelineConfig:
    # arguments/__init__.py:101-106
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False
    rasterizer: str = "tiled"  # tiled | oracle
    max_per_tile: int = 1024
    # count-adaptive per-tile window ladder (render/ladder.py): probe frames
    # fit it, counted overflow refits it
    use_tile_ladder: bool = True
    ladder_buckets: int = 4
    ladder_margin: float = 1.3
    ladder_check_every: int = 100  # overflow-check cadence (each check syncs host<->device)
    # tiered bbox enumeration (render/binning.py): 2x2 primary window with
    # mid (4x4-cell) and giant second passes, exact cell unions; the training
    # steps render with these tiers
    max_tiles_per_gaussian: int = 4
    mid_cap: int = 8192
    mid_side: int = 4


@dataclass
class OptimizationConfig:
    # arguments/__init__.py:109-190
    iterations: int = 80_000
    # stage-2 budget; None = reuse `iterations` (the reference trains both
    # stages 80k/100k with separate flags — a shared field was a footgun:
    # run_refpoint.py used to mutate `iterations` between stages)
    iterations_stage2: int | None = None
    warm_up: int = 3_000
    dynamic_color_warm_up: int = 20_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    deform_lr_max_steps: int = 40_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.001
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 70_000
    densify_grad_threshold: float = 0.0002
    oneupSHdegree_step: int = 1000
    random_bg_color: bool = False
    deform_lr_scale: float = 1.0
    deform_downsamp_strategy: str = "samp_hyper"
    node_enable_densify_prune: bool = False
    node_densification_interval: int = 5000
    node_densify_from_iter: int = 1000
    node_densify_until_iter: int = 25_000
    node_force_densify_prune_step: int = 10_000
    node_max_num_ratio_during_init: int = 16
    node_warm_up: int = 2_000
    iterations_node_sampling: int = 7500
    iterations_node_rendering: int = 10000
    progressive_train: bool = False
    progressive_train_node: bool = False
    progressive_stage_ratio: float = 0.2
    progressive_stage_steps: int = 3000
    lambda_optical_landmarks: tuple = (1e-1, 1e-1, 1e-3, 0)
    lambda_optical_steps: tuple = (0, 15_000, 25_000, 25_001)
    lambda_motion_mask_landmarks: tuple = (5e-1, 1e-2, 0)
    lambda_motion_mask_steps: tuple = (0, 10_000, 10_001)
    no_motion_mask_loss: bool = False
    gt_alpha_mask_as_scene_mask: bool = False
    gt_alpha_mask_as_dynamic_mask: bool = False
    no_arap_loss: bool = False
    with_temporal_smooth_loss: bool = False
    # stage-2 (skeleton)
    skeleton_weight_knn: int = -1
    skeleton_warm_up: int = 1_000
    gs_densification_iterations: int = 5000
    deform_mlp_lr_init: float = 1e-4
    deform_mlp_lr_final: float = 1e-5
    deform_mlp_lr_delay_mult: float = 0.01
    deform_mlp_lr_max_steps: int = 60_000
    skeleton_gs_position_lr: float = 0.0000016
    num_gs_sample: int = 0
    lambda_template_offsets: float = 1.0
    lambda_rendering_image: float = 1.0
    lambda_template_fixed: float = 100.0
    lambda_deformed_node_prjection: float = 1e-3
    optimize_template_offsets_iters: int = 15000
    manually_key_frame: int = -1
    # skeleton-extraction thresholds (reference literals at
    # extract_skeleton_utils.py:319-423,257-301, exposed as knobs): leaf
    # chains shorter than leaf_prune_hops are dropped, junctions within
    # junction_merge_hops pass-through nodes are merged, and chains are
    # polyline-simplified at simplify_dist_thres x avg-edge-length
    skeleton_max_candidates: int = 200
    skeleton_leaf_prune_hops: int = 4
    skeleton_junction_merge_hops: int = 3
    skeleton_simplify_dist_thres: float = 1.0
    skeleton_simplify_max_edges: int = 3


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    pipe: PipelineConfig = field(default_factory=PipelineConfig)
    opt: OptimizationConfig = field(default_factory=OptimizationConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        d = json.loads(s)

        def build(dc, sub):
            fields = {f.name: f for f in dataclasses.fields(dc)}
            kwargs = {}
            for k, v in sub.items():
                if k in fields:
                    if isinstance(v, list):
                        v = tuple(v)
                    kwargs[k] = v
            return dc(**kwargs)

        return cls(
            model=build(ModelConfig, d.get("model", {})),
            pipe=build(PipelineConfig, d.get("pipe", {})),
            opt=build(OptimizationConfig, d.get("opt", {})),
        )

    def save(self, path: str | Path):
        Path(path).write_text(self.to_json())

    @classmethod
    def load(cls, path: str | Path) -> "Config":
        return cls.from_json(Path(path).read_text())


def add_config_args(parser: argparse.ArgumentParser, cfg: Config | None = None) -> argparse.ArgumentParser:
    """Every config field as a ``--flag`` with its default (booleans as
    ``store_true``, tuples as ``nargs="+"`` floats)."""
    cfg = cfg or Config()
    for group_name in ("model", "pipe", "opt"):
        group = getattr(cfg, group_name)
        for f in dataclasses.fields(group):
            name = f"--{f.name}"
            default = getattr(group, f.name)
            if isinstance(default, bool):
                parser.add_argument(name, action="store_true", default=default)
            elif isinstance(default, tuple):
                parser.add_argument(name, nargs="+", type=float, default=default)
            else:
                parser.add_argument(name, type=type(default), default=default)
    return parser


def config_from_args(args: argparse.Namespace) -> Config:
    cfg = Config()
    for group_name in ("model", "pipe", "opt"):
        group = getattr(cfg, group_name)
        for f in dataclasses.fields(group):
            if hasattr(args, f.name):
                v = getattr(args, f.name)
                if isinstance(v, list):
                    v = tuple(v)
                setattr(group, f.name, v)
    return cfg

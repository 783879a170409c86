"""Typed configuration for the BundleFusion engine.

The reference drives ~150 knobs through two text parameter files parsed into
X-macro singletons (``GlobalAppState.h:24-104``, ``GlobalBundlingState.h:9-68``,
``zParametersDefault.txt``, ``zParametersBundlingDefault.txt``). Here the same
contract is folded into two frozen dataclasses with the same knob names (minus
the ``s_`` prefix) and the same defaults, so behavior-parity comparisons are
knob-for-knob. A small text parser accepts the reference's ``key = value;``
file format for drop-in config reuse.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class AppConfig:
    """Reconstruction-side config (mirrors GlobalAppState / zParametersDefault.txt)."""

    # sensor / sequence
    sensor_idx: int = 8                       # 8 = offline .sens reader (SensorDataReader)
    num_solve_frames_before_exit: int = 30    # extra solve-only frames after sequence end
    sensor_depth_max: float = 4.0
    sensor_depth_min: float = 0.1
    render_depth_max: float = 4.0
    render_depth_min: float = 0.1

    # working resolutions
    input_width: int = 640
    input_height: int = 480
    integration_width: int = 320              # s_integrationWidth
    integration_height: int = 240
    raycast_width: int = 320
    raycast_height: int = 240

    # trajectory manager / re-integration budget (zParametersDefault.txt:25-27)
    max_frame_fixes: int = 10                 # max de/re-integration ops per frame
    top_n_active: int = 30                    # max active entries in reintegrate list
    # Pose-delta threshold for re-integration (s_minPoseDistSqrt). The
    # reference default is 0.0 ("reintegrate everything"), which keeps the
    # GPU busy re-fusing frames whose solved pose moved by micrometers. Here
    # the default is 1/4 voxel in the combined translation+2*rotation
    # metric: deltas far below the voxel size cannot change the TSDF, and
    # skipping them frees the chip for real work. Set to 0.0 for exact
    # reference-parity scheduling.
    min_pose_dist_sqrt: float = 0.0025

    # TSDF volume (zParametersDefault.txt:39-56)
    sdf_voxel_size: float = 0.010
    sdf_marching_cube_thresh_factor: float = 10.0
    sdf_truncation: float = 0.06
    sdf_truncation_scale: float = 0.02        # truncation growth per meter depth
    sdf_max_integration_distance: float = 3.0
    sdf_integration_weight_sample: float = 1.0
    sdf_integration_weight_max: float = 99999999.0
    sdf_block_size: int = 8                   # SDF_BLOCK_SIZE (8^3 voxels per block)
    hash_num_sdf_blocks: int = 200000         # block capacity (voxel-data slots)
    # key-table capacity; this design uses a sorted key table, not buckets,
    # so this is simply >= hash_num_sdf_blocks (the reference used 800K buckets)
    hash_key_capacity: int = 262144

    # raycast (zParametersDefault.txt:59-63)
    sdf_ray_increment_factor: float = 0.8     # step = factor * truncation
    sdf_ray_thres_sample_dist_factor: float = 50.5
    sdf_ray_thres_dist_factor: float = 50.0

    # depth preprocessing (GlobalAppState; bundling file overrides for SIFT path)
    depth_sigma_d: float = 2.0
    depth_sigma_r: float = 0.1
    depth_filter: bool = False
    color_sigma_d: float = 2.0
    color_sigma_r: float = 0.1
    color_filter: bool = False

    # toggles
    integration_enabled: bool = True
    tracking_enabled: bool = True
    garbage_collection_enabled: bool = True
    garbage_collection_starve: int = 0        # weight decay every n-th frame (0 = off)
    streaming_enabled: bool = False           # host paging of cold blocks
    streaming_radius: float = 4.0             # page out blocks beyond this (m)
    streaming_every: int = 10                 # full page sweep cadence (frames)
    streaming_blocked_cap: int = 65536        # max tracked paged-out blocks
    reconstruction_enabled: bool = True

    # mesh export
    marching_cubes_max_num_triangles: int = 3000000

    # capacity knobs specific to this design (fixed shapes under jit)
    max_frames: int = 12000                   # total frames retained for re-integration
    alloc_max_new_blocks_per_frame: int = 32768
    # frustum-active rows per pass of a TSDF op batch; more active rows run
    # more passes, so the value trades padding against per-pass cost and
    # never changes the result (PERF.md, "Kernel decisions")
    visible_blocks_cap: int = 4096


@dataclass(frozen=True)
class BundlingConfig:
    """Bundling-side config (mirrors GlobalBundlingState / zParametersBundlingDefault.txt)."""

    verbose: bool = False
    erode_sift_depth: bool = True

    # SIFT detection (zParametersBundlingDefault.txt:13-18)
    width_sift: int = 640
    height_sift: int = 480
    min_key_scale: float = 3.0
    max_num_keys_per_image: int = 1024        # s_maxNumKeysPerImage
    feature_count_threshold: int = 150        # detector target (Bundler.cpp:61)

    # descriptor matching (zParametersBundlingDefault.txt:16-18, GlobalDefines.h:8-9)
    sift_match_thresh: float = 0.7
    sift_match_ratio_max_local: float = 0.8
    sift_match_ratio_max_global: float = 0.8
    max_matches_per_image_pair_raw: int = 128
    max_matches_per_image_pair_filtered: int = 25

    # match filter cascade
    max_kabsch_residual2: float = 0.0004      # s_maxKabschResidual2
    surf_area_pca_thresh: float = 0.032
    proj_corr_dist_thres: float = 0.15
    proj_corr_normal_thres: float = 0.97
    proj_corr_color_thresh: float = 0.1
    verify_sift_err_thresh: float = 0.075
    verify_sift_corr_thresh: float = 0.02
    min_num_matches_local: int = 5
    min_num_matches_global: int = 5

    # hierarchy (zParametersBundlingDefault.txt:30-32)
    max_num_images: int = 1200                # keyframe capacity of the global problem
    submap_size: int = 10

    # solver budgets (zParametersBundlingDefault.txt:37-40)
    num_local_non_lin_iterations: int = 2
    num_local_lin_iterations: int = 100
    num_global_non_lin_iterations: int = 3
    num_global_lin_iterations: int = 150
    use_local_dense: bool = True
    use_global_dense_at_end: bool = True      # USE_GLOBAL_DENSE_AT_END compile flag
    # photometric weight of the global dense-at-end solve (the reference
    # enables denseColor=0.1 with gradient gating there, SBA.cpp:28-38)
    dense_color_at_end_weight: float = 0.1
    num_opt_per_residual_removal: int = 1
    # prune-and-resolve rounds per global solve. The reference removes one
    # max-residual pair per solve but solves every frame
    # (s_numOptPerResidualRemoval=1, SBA.cpp:169-204); this engine solves
    # once per submap, so several rounds match the reference cadence.
    max_prune_rounds: int = 3
    # NEW_GUIDED_REMOVE (CUDASolverBundling.cpp:298-427): multi-pair removal
    # of bad long-range loop closures (compile-gated off in the reference)
    use_guided_remove: bool = False

    # dense BA term (zParametersBundlingDefault.txt:22-28,44-52)
    opt_max_res_thresh: float = 0.08
    dense_dist_thresh: float = 0.15
    dense_normal_thresh: float = 0.97
    dense_color_thresh: float = 0.1
    dense_color_gradient_min: float = 0.005
    dense_depth_min: float = 0.5
    dense_depth_max: float = 4.0
    dense_overlap_check_subsample_factor: int = 4
    downsampled_width: int = 80               # dense-BA cache resolution
    downsampled_height: int = 60
    min_dense_corr_for_pair: int = 800        # WeightDenseCorrespondences zero-thresh
    dense_overlap_min_hits: int = 10          # FindImageImageCorr threshold

    # dense-cache preprocessing
    color_down_sigma: float = 2.5
    depth_down_sigma_d: float = 1.0
    depth_down_sigma_r: float = 0.05
    depth_sigma_d: float = 2.0
    depth_sigma_r: float = 0.05
    depth_filter: bool = True

    # verification / recovery (SURVEY.md §5 failure detection)
    use_local_verify: bool = True
    verify_opt_err_thresh: float = 0.05
    verify_opt_corr_thresh: float = 0.001
    use_comprehensive_frame_invalidation: bool = True

    # solver internals (SolverBundling.cu early-outs)
    pcg_early_out: float = 5e-7               # |scanAlpha| early exit
    gn_early_out_delta: float = 0.005         # max |delta| convergence
    max_corr_per_image_min: int = 1000
    max_corr_per_image_max: int = 4000

    # capacities of this design (fixed shapes)
    max_global_corr: int = 262144             # EntryJ store capacity (global)
    max_local_corr: int = 4096                # EntryJ store capacity (per submap)
    solver_max_pairs: int = 16384             # active (i, j) pair cap in the
    solver_max_working_corrs: int = 131072    # live corrs entering one global
                                              # solve (sort/gather working set;
                                              # the store capacity can be far
                                              # larger — reference sizes it at
                                              # 25*G*(G-1)/2, SIFTImageManager
                                              # .cpp:302 — overflow surfaces
                                              # in pairs_dropped)
                                              # pair-reduced global solver

    timings_enabled: bool = False


_BOOL = {"true": True, "false": False}


def _coerce(current, raw: str):
    raw = raw.strip().rstrip(";").strip()
    if isinstance(current, bool):
        return _BOOL.get(raw.lower(), bool(current))
    if isinstance(current, int):
        return int(float(raw.rstrip("f")))
    if isinstance(current, float):
        return float(raw.rstrip("f"))
    return raw.strip('"')


_REF_RENAMES = {
    # reference knob name (no s_ prefix) -> our field name, where they differ
    "hashNumSDFBlocks": "hash_num_sdf_blocks",
    "SDFVoxelSize": "sdf_voxel_size",
    "SDFTruncation": "sdf_truncation",
    "SDFTruncationScale": "sdf_truncation_scale",
    "SDFMaxIntegrationDistance": "sdf_max_integration_distance",
    "SDFIntegrationWeightSample": "sdf_integration_weight_sample",
    "SDFIntegrationWeightMax": "sdf_integration_weight_max",
    "SDFMarchingCubeThreshFactor": "sdf_marching_cube_thresh_factor",
    "SDFRayIncrementFactor": "sdf_ray_increment_factor",
    "SDFRayThresSampleDistFactor": "sdf_ray_thres_sample_dist_factor",
    "SDFRayThresDistFactor": "sdf_ray_thres_dist_factor",
    "widthSIFT": "width_sift",
    "heightSIFT": "height_sift",
}


def _snake(name: str) -> str:
    if name in _REF_RENAMES:
        return _REF_RENAMES[name]
    s = re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()
    return s.replace("__", "_")


def parse_parameter_file(path: str, cfg):
    """Parse a reference-format ``key = value;`` parameter file onto a config.

    Mirrors mLib ``ParameterFile`` semantics used by ``GlobalAppState::readMembers``
    (reference GlobalAppState.h:122-136): unknown keys warn-and-skip, missing keys
    keep defaults. Returns a new config instance (configs are frozen).
    """
    updates = {}
    known = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    with open(path, "r", errors="replace") as fh:
        for line in fh:
            line = line.split("//")[0].strip()
            if not line or "=" not in line:
                continue
            key, _, val = line.partition("=")
            key = key.strip()
            if key.startswith("s_"):
                key = key[2:]
            field_name = _snake(key)
            if field_name in known:
                try:
                    updates[field_name] = _coerce(known[field_name], val)
                except ValueError:
                    pass
    return dataclasses.replace(cfg, **updates)


def default_configs() -> Tuple[AppConfig, BundlingConfig]:
    return AppConfig(), BundlingConfig()

"""Online BundleFusion pipeline: the full per-frame loop.

Re-design of the reference's orchestration stack — ``FriedLiver.cpp`` main
loop + bundling thread, ``OnlineBundler`` (two-level hierarchy, submap
double-buffering, trajectory chaining), ``Bundler`` (detect / match+filter /
optimize per domain), ``DepthSensing.cpp`` frame loop (integrate, reintegrate,
raycast) — as one host-driven Python class over a handful of FUSED jitted
programs.

Hierarchy semantics mirrored from the reference:
- submaps of ``submap_size`` frames with ONE-FRAME OVERLAP: frame k*S is both
  the last frame of submap k-1 and frame 0 (anchor/keyframe) of submap k
  (``OnlineBundler::processInput`` copyFrame at ``isLastLocalFrame``,
  OnlineBundler.cpp:206-215).
- per-frame chaining to the nearest matched previous frame
  (``computeSiftTransformCU``, OnlineBundler.cu:6-71).
- local solve (2 GN x 100 PCG) per submap; keyframe fusion; global
  match+filter of the new keyframe vs all previous keyframes; global solve
  (3 GN x 150 PCG) with max-residual pruning (``SBA::removeMaxResidualCUDA``).
- complete trajectory composition complete[f] = global[k] @ local[k][r]
  (``updateTrajectoryCU``, OnlineBundler.cu:73-110).
- TrajectoryManager-driven de-integration / re-integration with a
  per-frame op budget (``DepthSensing.cpp: reintegrate():854-902``).

Latency design (the analog of the reference's dual-GPU thread split): the
reference hides per-stage latency with two threads and per-kernel syncs;
this engine instead fuses each phase into ONE jitted program over
device-resident state, so the host pays one dispatch per phase:

- ``frame_step``  — preprocess + SIFT detect + store + match/filter cascade
  + residual append + pose chaining + TSDF integrate, one dispatch per frame.
- ``submap_step`` — local GN/PCG solve + dense verification + keyframe
  fusion + global match/filter + global solve + max-residual pruning +
  submap rollover, one dispatch per submap.
- ``reintegrate_batch`` — the whole ≤10-op de/re-integration budget as one
  ``lax.scan``, one dispatch per frame (skipped when idle).

Host code only routes pytrees and keeps the scheduling state the reference
also keeps on CPU (TrajectoryManager, retry list).

Transfer design: every device->host transfer is a synchronization point,
so the hot loop performs ZERO device->host transfers:

- processed frames stay in device memory (``FrameStore``; the reference round-trips
  every frame through CPU RAM) and re-integration gathers them by index;
- everything the host scheduler needs (chained poses, validity, keyframe
  state, the composed optimized trajectory) is packed into ONE flat float32
  buffer by ``submap_step``, copied back asynchronously, and consumed
  lazily (``is_ready``) or at the next submap boundary — one transfer per
  ``submap_size`` frames, overlapped with a full submap of compute.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from bundlefusion_tpu.config import AppConfig, BundlingConfig
from bundlefusion_tpu.geometry.camera import CameraIntrinsics
from bundlefusion_tpu.geometry.lie import matrix_to_pose, pose_inverse, pose_to_matrix
from bundlefusion_tpu.ops.filters import DenseVerifyParams, dense_verify_pair
from bundlefusion_tpu.ops.image import erode_depth, resample_bilinear, resample_nearest, rgb_to_intensity
from bundlefusion_tpu.ops.sift import SiftConfig, detect_and_describe
from bundlefusion_tpu.pipeline.frames import (
    DenseCache,
    FrameStore,
    KeyframeStore,
    copy_cache_frame,
    create_dense_cache,
    create_frame_store,
    create_keyframe_store,
    decode_frame,
    encode_frame,
    store_cache_frame,
    store_keypoints,
)
from bundlefusion_tpu.pipeline.frontend import (
    FrontendParams,
    add_to_residuals,
    chained_sift_transform,
    fuse_keyframe,
    match_and_filter,
)
from bundlefusion_tpu.pipeline.trajectory import TrajectoryManager
from bundlefusion_tpu.solver.dense_term import DenseTermParams
from bundlefusion_tpu.solver.gn_pcg import (
    SolverParams,
    apply_pair_kill_sorted,
    apply_pair_kill_store,
    compute_residuals,
    corr_counts_per_frame_sorted,
    guided_kill_mask,
    invalidate_pair_sorted,
    max_residual,
    max_residual_sorted,
    presort_corrs,
    solve_bundle,
    solve_sparse,
    solve_sparse_presorted,
)
from bundlefusion_tpu.solver.residuals import (
    CorrStore,
    corr_counts_per_frame,
    create_corr_store,
    invalidate_image_pair,
)
from bundlefusion_tpu.tsdf.apply_ops import apply_tsdf_ops
from bundlefusion_tpu.tsdf.integrate import TsdfParams, candidate_keys
from bundlefusion_tpu.tsdf.table import EMPTY_KEY, allocate_packed
from bundlefusion_tpu.tsdf.raycast import RaycastParams, raycast
from bundlefusion_tpu.tsdf.splat import SplatParams, splat_render
from bundlefusion_tpu.tsdf.table import create_table, garbage_collect
from bundlefusion_tpu.utils.timing import TimingLog


class LocalState(NamedTuple):
    """Device-resident per-submap state (the reference's ``m_local`` Bundler:
    SIFTImageManager arrays + CUDACache + EntryJ store + relative poses)."""

    keys: KeyframeStore     # [S] keypoint store
    cache: DenseCache       # [S] dense cache
    corrs: CorrStore        # intra-submap EntryJ store
    rel: jax.Array          # [S, 4, 4] frame -> submap-anchor transforms
    valid: jax.Array        # [S] bool per-frame tracking validity


class GlobalState(NamedTuple):
    """Device-resident keyframe-graph state (the reference's ``m_global``
    Bundler + per-submap solved trajectories for composition)."""

    keys: KeyframeStore     # [G] fused keyframe keypoints
    cache: DenseCache       # [G] keyframe dense cache
    corrs: CorrStore        # global EntryJ store
    poses: jax.Array        # [G, 6] keyframe poses (Lie [omega, t])
    local_traj: jax.Array   # [G, S, 4, 4] solved submap trajectories
    local_valid: jax.Array  # [G, S] bool per-frame validity after local solve


@partial(jax.jit, static_argnames=("sift_hw", "int_hw"))
def preprocess_frame(depth, color, sift_hw, int_hw):
    """Input-res depth/color -> (intensity_sift, depth_sift, depth_int,
    color_int). Mirrors ``CUDAImageManager::process`` (erode x2, resample)
    + ``OnlineBundler::getCurrentFrame`` (resampleToIntensity)."""
    d = erode_depth(erode_depth(depth))
    sh, sw = sift_hw
    ih, iw = int_hw
    intensity = rgb_to_intensity(color)
    intensity_sift = resample_bilinear(intensity, sh, sw)
    depth_sift = resample_nearest(d, sh, sw)
    depth_int = resample_nearest(d, ih, iw)
    color_int = resample_bilinear(color, ih, iw)
    return intensity_sift, depth_sift, depth_int, color_int


def _verify_local_pairs(local_world, lv, cache: DenseCache, intr, vp):
    """Dense-verify all adjacent submap frame pairs (``VerifyTrajectoryCU``).
    Returns (n_checked, n_failed) scalars."""
    T_next_inv = jax.vmap(pose_inverse)(local_world[1:])
    T_rel = jnp.einsum("sij,sjk->sik", T_next_inv, local_world[:-1])
    keep, err, corr = jax.vmap(
        lambda T, d0, c0, n0, d1, c1, n1: dense_verify_pair(
            T, d0, c0, n0, d1, c1, n1, intr, vp
        )
    )(
        T_rel,
        cache.depth[:-1], cache.campos[:-1], cache.normal[:-1],
        cache.depth[1:], cache.campos[1:], cache.normal[1:],
    )
    checked = lv[:-1] & lv[1:]
    n_checked = jnp.sum(checked.astype(jnp.int32))
    n_failed = jnp.sum((checked & ~keep).astype(jnp.int32))
    return n_checked, n_failed


class BundleFusion:
    """The engine. Feed RGB-D frames; read back poses / renders / mesh."""

    def __init__(
        self,
        intr_input: CameraIntrinsics,
        app: AppConfig = AppConfig(),
        bundling: BundlingConfig = BundlingConfig(),
        sift_cfg: Optional[SiftConfig] = None,
        max_keyframes: Optional[int] = None,
        mesh=None,
    ):
        """``mesh``: optional ``jax.sharding.Mesh``; with >1 device the
        GLOBAL problem's COMPUTE shards across it: the boundary step splits
        into a single-device local phase (submap solve + keyframe fusion —
        the "reconstruction GPU") and a mesh program whose hot regions are
        explicit ``shard_map``s — keyframe-chunked global matching and the
        corr-chunked pair-reduced GN/PCG (``parallel/ba_sharded.py``).
        Global STATE is replicated over the mesh (it is small — the corr
        store is ~10 MB at reference capacity, the keyframe stores a few
        hundred MB); replication keeps the per-frame path entirely on one
        device and pins every program's sharding, which profiling showed is
        what actually scales (axis-sharded state caused GSPMD recompile
        thrash: 6 s/frame at n=2 vs 1.2 s at n=1 on the CPU harness).
        This is the reference's recon/bundling DualGPU split scaled out
        (SURVEY.md §2.8 north star)."""
        self.mesh = mesh
        self._use_mesh = mesh is not None and mesh.devices.size > 1
        if self._use_mesh:
            n_dev = int(mesh.devices.size)
            G_eff = max_keyframes or bundling.max_num_images
            assert G_eff % n_dev == 0, (
                f"keyframe capacity {G_eff} must divide the mesh size {n_dev}"
            )
            assert bundling.max_global_corr % n_dev == 0, (
                f"max_global_corr {bundling.max_global_corr} must divide the "
                f"mesh size {n_dev}"
            )
        self.app = app
        self.bundling = bundling
        self.intr_input = intr_input
        self.intr_sift = intr_input.scaled(bundling.width_sift, bundling.height_sift)
        self.intr_int = intr_input.scaled(app.integration_width, app.integration_height)
        self.intr_cache = intr_input.scaled(
            bundling.downsampled_width, bundling.downsampled_height
        )
        self.sift_cfg = sift_cfg or SiftConfig(
            target_keys=bundling.feature_count_threshold,
            min_scale=bundling.min_key_scale,
            depth_min=app.sensor_depth_min,
            depth_max=app.sensor_depth_max,
        )
        self.S = bundling.submap_size + 1  # +1: one-frame overlap
        self.G = max_keyframes or bundling.max_num_images

        self.tsdf_params = TsdfParams(
            voxel_size=app.sdf_voxel_size,
            truncation=app.sdf_truncation,
            truncation_scale=app.sdf_truncation_scale,
            max_integration_distance=app.sdf_max_integration_distance,
            integration_weight_sample=app.sdf_integration_weight_sample,
            integration_weight_max=app.sdf_integration_weight_max,
            depth_min=app.sensor_depth_min,
            depth_max=app.sensor_depth_max,
        )
        self.table = create_table(app.hash_key_capacity, app.hash_num_sdf_blocks)
        self.vis_cap = app.visible_blocks_cap

        dense = DenseVerifyParams(
            dist_thresh=bundling.proj_corr_dist_thres,
            normal_thresh=bundling.proj_corr_normal_thres,
            err_thresh=bundling.verify_sift_err_thresh,
            corr_thresh=bundling.verify_sift_corr_thresh,
            depth_min=app.sensor_depth_min,
            depth_max=app.sensor_depth_max,
        )
        self.frontend_local = FrontendParams(
            sift_match_thresh=bundling.sift_match_thresh,
            sift_match_ratio=bundling.sift_match_ratio_max_local,
            num_raw_matches=bundling.max_matches_per_image_pair_raw,
            max_filtered=bundling.max_matches_per_image_pair_filtered,
            min_num_matches=bundling.min_num_matches_local,
            max_kabsch_res2=bundling.max_kabsch_residual2,
            surf_area_thresh=bundling.surf_area_pca_thresh,
            dense=dense,
        )
        self.frontend_global = dataclasses.replace(
            self.frontend_local,
            sift_match_ratio=bundling.sift_match_ratio_max_global,
            min_num_matches=bundling.min_num_matches_global,
        )
        self.local_solver = SolverParams(
            num_gn=bundling.num_local_non_lin_iterations,
            num_pcg=bundling.num_local_lin_iterations,
            pcg_early_out=bundling.pcg_early_out,
            gn_early_out_delta=bundling.gn_early_out_delta,
            max_pairs=self.S * (self.S + 1) // 2 + 1,
        )
        self.global_solver = SolverParams(
            num_gn=bundling.num_global_non_lin_iterations,
            num_pcg=bundling.num_global_lin_iterations,
            pcg_early_out=bundling.pcg_early_out,
            gn_early_out_delta=bundling.gn_early_out_delta,
            max_pairs=min(bundling.solver_max_pairs, self.G * (self.G + 1) // 2 + 1),
            max_working_corrs=bundling.solver_max_working_corrs,
        )
        self.dense_term_params = DenseTermParams(
            dist_thresh=bundling.dense_dist_thresh,
            normal_thresh=bundling.dense_normal_thresh,
            color_thresh=bundling.dense_color_thresh,
            color_gradient_min=bundling.dense_color_gradient_min,
            depth_min=bundling.dense_depth_min,
            depth_max=bundling.dense_depth_max,
            overlap_subsample=bundling.dense_overlap_check_subsample_factor,
            overlap_min_hits=bundling.dense_overlap_min_hits,
            min_corr_per_pair=bundling.min_dense_corr_for_pair,
            max_pairs=64,
        )

        # ---- device-resident state ----
        self.local = self._fresh_local()
        self.glob = GlobalState(
            keys=create_keyframe_store(self.G, bundling.max_num_keys_per_image),
            cache=create_dense_cache(
                self.G, self.intr_cache.height, self.intr_cache.width
            ),
            corrs=create_corr_store(bundling.max_global_corr),
            poses=jnp.zeros((self.G, 6), jnp.float32),
            local_traj=jnp.zeros((self.G, self.S, 4, 4), jnp.float32),
            local_valid=jnp.zeros((self.G, self.S), bool),
        )
        if self._use_mesh:
            self.glob = self._shard_global(self.glob)
        self.keyframe_valid = np.zeros(self.G, bool)
        # device twin of keyframe_valid: feeds the next submap dispatch so
        # the boundary never blocks on the previous submap's host readback
        # (the host copy is only consumed by the retry/bookkeeping logic,
        # which tolerates a one-submap lag)
        self.kf_valid_dev = jnp.zeros((self.G,), bool)
        if self._use_mesh:
            self.kf_valid_dev = jax.device_put(self.kf_valid_dev, self._mesh_rep())
        self.num_keyframes = 0

        # device-resident frame archive for re-integration (no host copy)
        sub_len = self.S - 1
        self.frame_cap = min(app.max_frames, self.G * sub_len + self.S)
        self.store = create_frame_store(
            self.frame_cap, self.intr_int.height, self.intr_int.width
        )

        # packed per-submap readback layout (see _build_programs)
        NF = self.G * sub_len
        self._off_lv = self.S * 16
        self._off_kf = self.S * 17
        self._off_flags = self.S * 17 + self.G
        self._off_comp = self._off_flags + 3
        self._off_ok = self._off_comp + NF * 16

        self.frame_idx = 0
        self.frame_valid: List[bool] = []
        self.sift_world: List[np.ndarray] = []     # per-frame chained estimate
        self.complete_traj: List[np.ndarray] = []  # per-frame optimized 4x4 (nan invalid)
        self._recorded_upto = 0                    # host bookkeeping high-water mark
        # device-resident current-submap anchor pose (never round-trips)
        self.submap_base = jnp.eye(4, dtype=jnp.float32)
        # the device the per-frame state lives on (the default device)
        self._frame_device = next(iter(self.submap_base.devices()))
        self._pending_submaps: List[tuple] = []  # FIFO of (g, pack_dev)
        # frame index of the current window's anchor + the buffer slot it
        # lives in (0 after a rollover; sub_len past keyframe capacity,
        # where boundaries stop rolling the buffer over)
        self._window_base = 0
        self._anchor_slot = 0

        # host paging of cold TSDF blocks (the chunk-grid analog; OFF by
        # default like the reference's BundleFusion config — paging is
        # incompatible with de-integration, CUDASceneRepHashSDF.h:89-91).
        # When on: a host block store + the device-side sorted paged-key
        # array the alloc path consults (isSDFBlockStreamedOut analog).
        if app.streaming_enabled:
            from bundlefusion_tpu.tsdf.streaming import HostBlockStore

            self.host_blocks = HostBlockStore()
            self._blocked_dev = jnp.full(
                (app.streaming_blocked_cap,), EMPTY_KEY, jnp.int32
            )

        self.traj_manager = TrajectoryManager(app.top_n_active, app.min_pose_dist_sqrt)
        # relocalization retry list (reference SIFTImageManager retry list +
        # Bundler::tryRevalidation, Bundler.cpp:306-352)
        self.retry_list: List[int] = []
        # attempt counters are telemetry only — the reference's retry list
        # is persistent and uncapped (SIFTImageManager.h:263-271): a lost
        # keyframe stays in the queue, oldest-first, one attempt per submap,
        # until it revalidates
        self.retry_attempts: dict = {}
        self.timing = TimingLog()
        # device-time attribution (CUDATimer analog, SiftGPU/CUDATimer.h:
        # 1-121): every ``profile_every``-th frame is replayed serialized —
        # block_until_ready between stage dispatches — recording honest
        # per-program device times into ``device_timing``. The async
        # steady-state TimingLog above measures enqueue cost only.
        self.profile_every = 0
        self.device_timing = TimingLog()
        self.lost_count = 0
        # pair-cap overflow accounting (write-only in round 2 — now
        # surfaced per retire and reported by the bench)
        self.pairs_dropped_total = 0
        # re-integration accounting (TimingLogDepthSensing analog): frames
        # that dispatched the rows program + total de/re-integration ops
        self.reint_frames = 0
        self.reint_ops_total = 0
        self.pairs_dropped_max = 0
        # per-frame raycast cadence (reference: every frame); 0 disables
        self.render_every = 1 if app.reconstruction_enabled else 0
        self.last_render = None
        # device-resident constant cache: small per-frame scalars are
        # uploaded once and reused instead of one transfer per dispatch
        self._dev_i32 = {}
        self._dev_eye = jnp.eye(4, dtype=jnp.float32)
        self._dev_true = jnp.asarray(True)
        self._dev_false = jnp.asarray(False)

        self._build_programs()

    # ------------------------------------------------------------------
    def _i32(self, v: int):
        r = self._dev_i32.get(v)
        if r is None:
            r = self._dev_i32[v] = jnp.asarray(v, jnp.int32)
        return r

    # ------------------------------------------------------------------
    def _shard_global(self, glob: GlobalState) -> GlobalState:
        """Place the global state REPLICATED over the mesh. Compute (not
        state) is what shards: the boundary mesh program chunks the
        keyframe axis for matching and the corr axis for the solver system
        build inside explicit shard_maps (see ``_build_mesh_programs``).
        Replicated state keeps every program's input sharding pinned — no
        GSPMD layout churn — and costs little memory (corr store ~10 MB,
        keyframe stores a few hundred MB at reference capacity)."""
        rep = self._mesh_rep()
        return jax.tree.map(lambda x: jax.device_put(x, rep), glob)

    # ------------------------------------------------------------------
    def _mesh_rep(self):
        from jax.sharding import NamedSharding, PartitionSpec as P

        return NamedSharding(self.mesh, P())

    # ------------------------------------------------------------------
    def _fresh_local(self) -> LocalState:
        S = self.S
        return LocalState(
            keys=create_keyframe_store(S, self.sift_cfg.target_keys),
            cache=create_dense_cache(
                S, self.intr_cache.height, self.intr_cache.width
            ),
            corrs=create_corr_store(self.bundling.max_local_corr),
            rel=jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (S, 4, 4)),
            valid=jnp.zeros((S,), bool),
        )

    # ------------------------------------------------------------------
    def _build_programs(self):
        """Trace-time closure capture of all static config; builds the fused
        jitted phase programs."""
        app, bundling = self.app, self.bundling
        intr_sift, intr_int, intr_cache = self.intr_sift, self.intr_int, self.intr_cache
        sift_cfg = self.sift_cfg
        fp_local, fp_global = self.frontend_local, self.frontend_global
        tsdf_params, vis_cap = self.tsdf_params, self.vis_cap
        S, G = self.S, self.G
        sub_len = S - 1
        local_solver, global_solver = self.local_solver, self.global_solver
        dtp = self.dense_term_params
        verify_params = dataclasses.replace(
            fp_local.dense,
            err_thresh=bundling.verify_opt_err_thresh,
            corr_thresh=bundling.verify_opt_corr_thresh,
        )

        def _apply_ops(table, depths, colors, poses, signs, img_of_op):
            """Multi-op TSDF update over the frustum-active rows. Ops apply
            sequentially; sign 0 is an exact no-op."""
            return apply_tsdf_ops(
                table, depths, colors, poses, signs, img_of_op, intr_int,
                tsdf_params, vis_cap,
            )

        # ---------------- frame_step ----------------
        def frame_step(depth_u16, color_u8, local: LocalState, store: FrameStore,
                       submap_base, cur_slot, store_slot):
            """One frame: preprocess -> detect -> archive -> match/filter ->
            chain. Returns (local', store', T_world, valid). TSDF work
            happens in the separate fused ``tsdf_step`` dispatch (which
            also carries the frame's re-integration budget).
            Nothing bulk ever leaves the device.

            Inputs arrive compact (uint16 mm depth / uint8 color — the .sens
            wire formats) and are decoded on device: uploading float32
            would move 3.3x the bytes.
            """
            depth = jnp.where(
                depth_u16 > 0, depth_u16.astype(jnp.float32) * 1e-3, jnp.nan
            )
            color = color_u8.astype(jnp.float32) * (1.0 / 255.0)
            d = erode_depth(erode_depth(depth))
            intensity = rgb_to_intensity(color)
            intensity_sift = resample_bilinear(intensity, intr_sift.height, intr_sift.width)
            depth_sift = resample_nearest(d, intr_sift.height, intr_sift.width)
            depth_int = resample_nearest(d, intr_int.height, intr_int.width)
            color_int = resample_bilinear(color, intr_int.height, intr_int.width)
            # archive at integration res; integrate the DECODED values so a
            # later de-integration subtracts bitwise-identical contributions
            # (erode/nearest-resample preserve the mm quantization, so the
            # depth round-trip is exact)
            d_mm, c_u8 = encode_frame(depth_int, color_int)
            store = FrameStore(
                depth_mm=store.depth_mm.at[store_slot].set(d_mm),
                color=store.color.at[store_slot].set(c_u8),
            )
            depth_int, color_int = decode_frame(d_mm, c_u8)

            kp = detect_and_describe(intensity_sift, depth_sift, sift_cfg)
            local = local._replace(
                keys=store_keypoints(local.keys, cur_slot, kp),
                cache=store_cache_frame(local.cache, cur_slot, depth_int, color_int, intr_cache),
            )

            def with_match(loc: LocalState):
                mf = match_and_filter(
                    cur_slot, loc.keys, loc.cache, intr_sift, intr_cache, fp_local
                )
                corrs = add_to_residuals(
                    loc.corrs, mf, cur_slot.astype(jnp.int32),
                    jnp.arange(S, dtype=jnp.int32),
                )
                T_chain, found, _ = chained_sift_transform(mf, loc.rel)
                T_hold = loc.rel[jnp.maximum(cur_slot - 1, 0)]
                T_rel = jnp.where(found, T_chain, T_hold)
                return loc._replace(corrs=corrs), T_rel, found

            def without_match(loc: LocalState):
                return loc, jnp.eye(4, dtype=jnp.float32), jnp.asarray(True)

            local, T_rel, valid = jax.lax.cond(
                cur_slot > 0, with_match, without_match, local
            )
            local = local._replace(
                rel=local.rel.at[cur_slot].set(T_rel),
                valid=local.valid.at[cur_slot].set(valid),
            )
            T_world = submap_base @ T_rel
            return local, store, T_world, valid

        self._frame_step = jax.jit(frame_step, donate_argnums=(2, 3))

        # ---------------- tsdf_step (fused integrate + re-integration) ----
        R = 5  # max re-integration rows per frame (2 ops each, budget 10)

        def _decode_rows(store: FrameStore, fids):
            ds, cs = [], []
            for i in range(fids.shape[0]):
                d, c = decode_frame(store.depth_mm[fids[i]], store.color[fids[i]])
                ds.append(d)
                cs.append(c)
            return jnp.stack(ds), jnp.stack(cs)

        stream_on = app.streaming_enabled

        def tsdf_fast(table, store: FrameStore, fid, T_cur, valid, blocked=None):
            """Typical frame: just the current frame's fuse (no rows).
            ONE allocation + ONE kernel sweep. ``blocked`` (streaming only)
            carries the paged-out-block keys the alloc must skip."""
            d, c = decode_frame(store.depth_mm[fid], store.color[fid])
            packed = candidate_keys(d, intr_int, T_cur, tsdf_params)
            table = allocate_packed(
                table, jnp.where(valid, packed, jnp.int32(EMPTY_KEY)),
                blocked=blocked,
            )
            return _apply_ops(
                table,
                d[None],
                c[None],
                T_cur[None],
                valid.astype(jnp.float32)[None],
                jnp.zeros((1,), jnp.int32),
            )

        def tsdf_rows(table, store: FrameStore, packed, fid_cur, T_cur,
                      cur_valid, blocked=None):
            """Re-integration frame: up to R rows (de/re/int ops,
            ``DepthSensing.cpp: reintegrate():854-902``) + the current
            frame's fuse, in ONE batched allocation + ONE kernel sweep.
            ``packed`` [R, 34] = fid | op | T_old flat | T_new flat per row
            (op: 0=skip, 1=de-integrate, 2=de+re, 3=integrate) — one upload."""
            row_fids = packed[:, 0].astype(jnp.int32)
            row_ops = packed[:, 1].astype(jnp.int32)
            T_olds = packed[:, 2:18].reshape(R, 4, 4)
            T_news = packed[:, 18:34].reshape(R, 4, 4)
            fids = jnp.concatenate([row_fids, fid_cur[None]])
            depths, colors = _decode_rows(store, fids)     # [R+1, ...]
            de_en = (row_ops == 1) | (row_ops == 2)
            re_en = (row_ops == 2) | (row_ops == 3)

            # ops: [de_0, re_0, de_1, re_1, ..., current] — row order matches
            # the host scheduler's sequential semantics
            poses = jnp.concatenate(
                [
                    jnp.stack([T_olds, T_news], axis=1).reshape(R * 2, 4, 4),
                    T_cur[None],
                ]
            )
            signs = jnp.concatenate(
                [
                    jnp.stack(
                        [-de_en.astype(jnp.float32), re_en.astype(jnp.float32)],
                        axis=1,
                    ).reshape(R * 2),
                    cur_valid.astype(jnp.float32)[None],
                ]
            )
            img_of_op = jnp.concatenate(
                [
                    jnp.repeat(jnp.arange(R, dtype=jnp.int32), 2),
                    jnp.asarray([R], jnp.int32),
                ]
            )

            # batched allocation: re-integration targets + current frame
            alloc_en = jnp.concatenate([re_en, cur_valid[None]])
            alloc_T = jnp.concatenate([T_news, T_cur[None]])
            packed = jax.vmap(
                lambda d_, T_: candidate_keys(d_, intr_int, T_, tsdf_params)
            )(depths, alloc_T)
            packed = jnp.where(
                alloc_en[:, None], packed, jnp.int32(EMPTY_KEY)
            ).reshape(-1)
            # scale the dedup-compact capacity by the number of candidate
            # frames so each op keeps its full single-frame allocation
            # budget (one shared default budget starved later frames' new
            # blocks, losing them permanently after the de-integration)
            from bundlefusion_tpu.tsdf.table import ALLOC_COMPACT

            table = allocate_packed(
                table, packed, compact=ALLOC_COMPACT * (R + 1), blocked=blocked
            )
            return _apply_ops(table, depths, colors, poses, signs, img_of_op)

        if stream_on:
            self._tsdf_fast = jax.jit(tsdf_fast, donate_argnums=(0,))
            self._tsdf_rows = jax.jit(tsdf_rows, donate_argnums=(0,))
        else:
            # fix the no-streaming signature (no blocked arg; scripts/tests
            # call these directly)
            self._tsdf_fast = jax.jit(
                lambda table, store, fid, T, v: tsdf_fast(table, store, fid, T, v),
                donate_argnums=(0,),
            )
            self._tsdf_rows = jax.jit(
                lambda table, store, packed, fid, T, v: tsdf_rows(
                    table, store, packed, fid, T, v
                ),
                donate_argnums=(0,),
            )

        # ---------------- submap_step ----------------
        def submap_step(local: LocalState, glob: GlobalState, kf_valid, g,
                        submap_base, last_world):
            """Submap boundary: local solve -> verify -> fuse keyframe ->
            global match -> global solve (+ max-residual pruning) -> rollover.

            Returns (fresh_local, glob', kf_valid', overlap_world, pack)
            where ``pack`` is the flat float32 host-readback buffer
            [chained world S*16 | frame valid S | kf_valid G | submap_ok,
            matched, pairs_dropped | composed trajectory G*sub_len*16 |
            composed valid G*sub_len] — everything the host scheduler
            consumes, fetched in ONE transfer per submap."""
            init = matrix_to_pose(local.rel)
            lv = local.valid
            if bundling.use_local_dense:
                # sparse + dense depth term, dense weight ramp iter+1
                # (SBA.cpp:28-38)
                poses, _ = solve_bundle(
                    init, lv, local.corrs, local.cache, intr_cache,
                    local_solver, dtp,
                )
            else:
                poses, _ = solve_sparse(init, lv, local.corrs, local_solver)
            local_world = pose_to_matrix(poses)

            submap_ok = lv[0] & (jnp.sum(lv.astype(jnp.int32)) >= 2)
            if bundling.use_local_verify:
                # solved submap failing dense verification invalidates it
                # (VerifyTrajectoryCU path, Bundler.cpp:259-273)
                n_checked, n_failed = _verify_local_pairs(
                    local_world, lv, local.cache, intr_cache, verify_params
                )
                submap_ok = submap_ok & (
                    (n_checked == 0) | (n_failed <= n_checked // 3)
                )
            lv_out = lv & submap_ok

            glob = glob._replace(
                local_traj=glob.local_traj.at[g].set(local_world),
                local_valid=glob.local_valid.at[g].set(lv_out),
            )

            # fuse keyframe from the solved submap's feature tracks
            # (anchor frame 0; SIFTImageManager::fuseToGlobal)
            fused = fuse_keyframe(
                local.keys, local.corrs, local_world, 0, intr_sift,
                glob.keys.keys_per_frame,
            )
            gk = glob.keys
            gk = gk._replace(
                pos=gk.pos.at[g].set(fused["pos"]),
                scale=gk.scale.at[g].set(fused["scale"]),
                depth=gk.depth.at[g].set(fused["depth"]),
                response=gk.response.at[g].set(fused["response"]),
                valid=gk.valid.at[g].set(fused["valid"]),
                desc=gk.desc.at[g].set(fused["desc"].astype(jnp.bfloat16)),
                frame_valid=gk.frame_valid.at[g].set(submap_ok),
            )
            glob = glob._replace(
                keys=gk,
                cache=copy_cache_frame(glob.cache, g, local.cache, 0),
                poses=glob.poses.at[g].set(matrix_to_pose(submap_base)),
            )
            kf_valid = kf_valid.at[g].set(submap_ok)

            def global_branch(op):
                glob, kf_valid = op
                mf = match_and_filter(
                    g, glob.keys, glob.cache, intr_sift, intr_cache, fp_global
                )
                matched = jnp.any(mf["pair_valid"])
                corrs = jax.lax.cond(
                    matched,
                    lambda c: add_to_residuals(
                        c, mf, g.astype(jnp.int32), jnp.arange(G, dtype=jnp.int32)
                    ),
                    lambda c: c,
                    glob.corrs,
                )
                kf_valid = kf_valid.at[g].set(kf_valid[g] & matched)
                kv = kf_valid & (jnp.arange(G) <= g)
                prev_poses = glob.poses  # trajectory before this solve
                # ONE sort per boundary; the pruning rounds below only flip
                # validity bits in the presorted working set
                prob = presort_corrs(corrs, G, global_solver)
                sposes = solve_sparse_presorted(
                    glob.poses, kv, prob, global_solver
                )
                dropped = prob.sc.dropped

                # ---- residual pruning, multiple rounds per solve ----
                # (SBA::removeMaxResidualCUDA, SBA.cpp:169-204; the reference
                # prunes once per solve but solves every frame with
                # s_numOptPerResidualRemoval=1 — one solve per submap here,
                # so run up to max_prune_rounds rounds to match cadence)
                def prune_round(carry, _):
                    corrs, prob, sposes = carry
                    mr, fa, fb = max_residual_sorted(sposes, prob)
                    do = (mr > bundling.opt_max_res_thresh) & (fa >= 0) & (fb >= 0)

                    def prune(cp):
                        c, pr = cp
                        c = invalidate_image_pair(c, fa, fb)
                        pr = invalidate_pair_sorted(pr, fa, fb)
                        if bundling.use_guided_remove:
                            # NEW_GUIDED_REMOVE (CUDASolverBundling.cpp:298-427):
                            # when badly off, also remove long-range pairs of
                            # the newest keyframe whose residual is high now
                            # AND was >1.5x higher under the previous
                            # trajectory (a bad loop closure, not drift)
                            killed = guided_kill_mask(
                                sposes, prev_poses, pr, g, mr, G
                            )
                            c = apply_pair_kill_store(c, killed, G)
                            pr = apply_pair_kill_sorted(pr, killed, G)
                        p2 = solve_sparse_presorted(
                            prev_poses, kv, pr, global_solver
                        )
                        return c, pr, p2

                    corrs, prob, sposes = jax.lax.cond(
                        do, prune, lambda cp: (cp[0], cp[1], sposes),
                        (corrs, prob),
                    )
                    return (corrs, prob, sposes), do

                (corrs, prob, sposes), _ = jax.lax.scan(
                    prune_round, (corrs, prob, sposes), None,
                    length=bundling.max_prune_rounds,
                )

                # ---- comprehensive frame invalidation: valid keyframes left
                # without correspondences after pruning lose their pose
                # (CheckForInvalidFramesCU, SIFTImageManager.cu:725-764).
                # Counts come from the presorted working set (prune kills
                # are mirrored into it), NOT a full-capacity scatter ----
                if bundling.use_comprehensive_frame_invalidation:
                    counts = corr_counts_per_frame_sorted(prob, G)
                    ks = jnp.arange(G)
                    keep = (counts > 0) | (ks == 0) | (ks > g)
                    kf_valid = kf_valid & keep
                return (
                    glob._replace(corrs=corrs, poses=sposes), kf_valid, matched,
                    dropped,
                )

            def no_global(op):
                glob, kf_valid = op
                return glob, kf_valid, jnp.asarray(True), jnp.asarray(0, jnp.int32)

            glob, kf_valid, matched, pairs_dropped = jax.lax.cond(
                g > 0, global_branch, no_global, (glob, kf_valid)
            )

            # rollover: overlap frame becomes slot 0 of the fresh submap
            kf_world_g = pose_to_matrix(glob.poses[g])
            overlap_world = jnp.where(
                submap_ok, kf_world_g @ local_world[S - 1], last_world
            )
            fresh_keys = create_keyframe_store(S, sift_cfg.target_keys)
            fresh_cache = create_dense_cache(S, intr_cache.height, intr_cache.width)
            new_local = LocalState(
                keys=jax.tree.map(
                    lambda dst, src: dst.at[0].set(src[S - 1]), fresh_keys, local.keys
                ),
                cache=jax.tree.map(
                    lambda dst, src: dst.at[0].set(src[S - 1]), fresh_cache, local.cache
                ),
                corrs=create_corr_store(bundling.max_local_corr),
                rel=jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (S, 4, 4)),
                valid=jnp.zeros((S,), bool).at[0].set(local.valid[S - 1]),
            )

            # ---- packed host readback (one flat transfer per submap) ----
            world_chained = jnp.einsum("ij,sjk->sik", submap_base, local.rel)
            comp, comp_ok = compose(glob.poses, kf_valid, glob.local_traj, glob.local_valid)
            pack = jnp.concatenate([
                world_chained.reshape(-1),
                lv.astype(jnp.float32),
                kf_valid.astype(jnp.float32),
                jnp.stack([
                    submap_ok.astype(jnp.float32), matched.astype(jnp.float32),
                    pairs_dropped.astype(jnp.float32),
                ]),
                comp.reshape(-1),
                comp_ok.astype(jnp.float32),
            ])
            return new_local, glob, kf_valid, overlap_world, pack

        if not self._use_mesh:
            self._submap_step = jax.jit(submap_step, donate_argnums=(0, 1))

        # ---------------- trajectory composition ----------------
        def compose(gposes, kf_valid, local_traj, local_valid):
            """complete[k*sub_len + r] = kf_world[k] @ local[k][r]
            (``updateTrajectoryCU``: invalid -> nan)."""
            kf_world = pose_to_matrix(gposes)
            comp = jnp.einsum("kij,ksjl->ksil", kf_world, local_traj[:, :sub_len])
            ok = kf_valid[:, None] & local_valid[:, :sub_len]
            comp = jnp.where(ok[..., None, None], comp, jnp.nan)
            return comp.reshape(G * sub_len, 4, 4), ok.reshape(G * sub_len)

        self._compose = jax.jit(
            lambda *a: (lambda c, o: (c.reshape(-1), o))(*compose(*a))
        )

        # tail pack for the trailing partial submap at finish():
        # [chained world S*16 | frame valid S]
        def pack_tail(local: LocalState, submap_base):
            world = jnp.einsum("ij,sjk->sik", submap_base, local.rel)
            return jnp.concatenate(
                [world.reshape(-1), local.valid.astype(jnp.float32)]
            )

        self._pack_tail = jax.jit(pack_tail)

        # ---------------- mesh boundary programs ----------------
        # Multi-device split of submap_step (SURVEY §2.8 north star): a
        # single-device LOCAL phase (submap solve + verification + keyframe
        # fusion + rollover — the "reconstruction device" work) and a mesh
        # GLOBAL phase whose hot regions are explicit shard_maps:
        # keyframe-chunked global matching and the corr-chunked pair-reduced
        # GN/PCG. Global state is replicated (see _shard_global); the only
        # cross-phase traffic is the fused keyframe row (~1 MB) out and a
        # 4x4 overlap pose back.
        if self._use_mesh:
            from jax.sharding import PartitionSpec as PSpec
            from bundlefusion_tpu.parallel.ba_sharded import (
                make_replicated_chunk_solver,
            )

            mesh = self.mesh
            ax = mesh.axis_names[0]
            n_dev = int(mesh.devices.size)
            Gl = G // n_dev
            glob_K = bundling.max_num_keys_per_image

            sharded_solve = make_replicated_chunk_solver(
                mesh, G, bundling.max_global_corr, global_solver, ax
            )

            def submap_local(local: LocalState, submap_base, last_world):
                """Single-device boundary phase: local solve -> verify ->
                fuse keyframe -> rollover. Same math as submap_step's head."""
                init = matrix_to_pose(local.rel)
                lv = local.valid
                if bundling.use_local_dense:
                    poses, _ = solve_bundle(
                        init, lv, local.corrs, local.cache, intr_cache,
                        local_solver, dtp,
                    )
                else:
                    poses, _ = solve_sparse(init, lv, local.corrs, local_solver)
                local_world = pose_to_matrix(poses)
                submap_ok = lv[0] & (jnp.sum(lv.astype(jnp.int32)) >= 2)
                if bundling.use_local_verify:
                    n_checked, n_failed = _verify_local_pairs(
                        local_world, lv, local.cache, intr_cache, verify_params
                    )
                    submap_ok = submap_ok & (
                        (n_checked == 0) | (n_failed <= n_checked // 3)
                    )
                lv_out = lv & submap_ok
                fused = fuse_keyframe(
                    local.keys, local.corrs, local_world, 0, intr_sift, glob_K
                )
                cache_row = jax.tree.map(lambda a: a[0], local.cache)

                fresh_keys = create_keyframe_store(S, sift_cfg.target_keys)
                fresh_cache = create_dense_cache(
                    S, intr_cache.height, intr_cache.width
                )
                new_local = LocalState(
                    keys=jax.tree.map(
                        lambda dst, src: dst.at[0].set(src[S - 1]),
                        fresh_keys, local.keys,
                    ),
                    cache=jax.tree.map(
                        lambda dst, src: dst.at[0].set(src[S - 1]),
                        fresh_cache, local.cache,
                    ),
                    corrs=create_corr_store(bundling.max_local_corr),
                    rel=jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (S, 4, 4)),
                    valid=jnp.zeros((S,), bool).at[0].set(local.valid[S - 1]),
                )
                world_chained = jnp.einsum("ij,sjk->sik", submap_base, local.rel)
                pack_a = jnp.concatenate(
                    [world_chained.reshape(-1), lv.astype(jnp.float32)]
                )
                return (
                    new_local, local_world, lv_out, submap_ok, fused,
                    cache_row, pack_a,
                )

            self._submap_local = jax.jit(submap_local, donate_argnums=(0,))

            # keyframe-chunked global matching: each device matches the new
            # keyframe against its Gl-slot chunk of the (replicated) store,
            # runs the full filter cascade incl. 80x60 dense verify on its
            # chunk, and all_gathers the small per-pair outputs
            @partial(
                jax.shard_map,
                mesh=mesh,
                in_specs=(PSpec(), PSpec(), PSpec()),
                out_specs=PSpec(),
                check_vma=False,
            )
            def match_chunk(g_, keys, cache):
                k = jax.lax.axis_index(ax)
                slot_ids = (k * Gl + jnp.arange(Gl)).astype(jnp.int32)
                mf = match_and_filter(
                    g_, keys, cache, intr_sift, intr_cache, fp_global,
                    slots=slot_ids,
                )
                out = {
                    f: mf[f]
                    for f in (
                        "pair_valid", "inlier_mask", "idx_cur", "idx_prev",
                        "p_cur", "p_prev",
                    )
                }
                return jax.tree.map(
                    lambda a: jax.lax.all_gather(a, ax, tiled=True), out
                )

            def submap_global(glob: GlobalState, kf_valid, g, fused,
                              cache_row, local_world, lv_out, submap_ok,
                              base_pose, last_world):
                """Mesh boundary phase: insert keyframe -> sharded global
                match -> sharded global solve (+ pruning) -> compose.
                Mirrors submap_step's global branch."""
                gk = glob.keys
                gk = gk._replace(
                    pos=gk.pos.at[g].set(fused["pos"]),
                    scale=gk.scale.at[g].set(fused["scale"]),
                    depth=gk.depth.at[g].set(fused["depth"]),
                    response=gk.response.at[g].set(fused["response"]),
                    valid=gk.valid.at[g].set(fused["valid"]),
                    desc=gk.desc.at[g].set(fused["desc"].astype(jnp.bfloat16)),
                    frame_valid=gk.frame_valid.at[g].set(submap_ok),
                )
                glob = glob._replace(
                    keys=gk,
                    cache=jax.tree.map(
                        lambda dst, src: dst.at[g].set(src), glob.cache, cache_row
                    ),
                    poses=glob.poses.at[g].set(matrix_to_pose(base_pose)),
                    local_traj=glob.local_traj.at[g].set(local_world),
                    local_valid=glob.local_valid.at[g].set(lv_out),
                )
                kf_valid = kf_valid.at[g].set(submap_ok)

                def global_branch(op):
                    glob, kf_valid = op
                    mf = dict(match_chunk(g, glob.keys, glob.cache))
                    mf["cur_slot"] = g
                    mf["num_keys_per_frame"] = glob_K
                    matched = jnp.any(mf["pair_valid"])
                    corrs = jax.lax.cond(
                        matched,
                        lambda c: add_to_residuals(
                            c, mf, g.astype(jnp.int32),
                            jnp.arange(G, dtype=jnp.int32),
                        ),
                        lambda c: c,
                        glob.corrs,
                    )
                    kf_valid = kf_valid.at[g].set(kf_valid[g] & matched)
                    kv = kf_valid & (jnp.arange(G) <= g)
                    prev_poses = glob.poses
                    sposes, dropped = sharded_solve(glob.poses, kv, corrs)

                    def prune_round(carry, _):
                        corrs, sposes = carry
                        mr, ci = max_residual(sposes, corrs)
                        fa = corrs.img_i[ci]
                        fb = corrs.img_j[ci]
                        do = (
                            (mr > bundling.opt_max_res_thresh)
                            & (fa >= 0) & (fb >= 0)
                        )

                        def prune(c):
                            c = invalidate_image_pair(c, fa, fb)
                            if bundling.use_guided_remove:
                                r_now, v_ = compute_residuals(sposes, c)
                                m_now = jnp.max(jnp.abs(r_now), -1)
                                r_prev, _ = compute_residuals(prev_poses, c)
                                m_prev = jnp.max(jnp.abs(r_prev), -1)
                                hi_thresh = jnp.clip(0.2 * mr, 0.1, 0.4)
                                qual = (
                                    v_ & (mr > 0.2)
                                    & (m_now > hi_thresh)
                                    & (c.img_i == g)
                                    & (jnp.abs(c.img_i - c.img_j) > 10)
                                    & (m_prev > 1.5 * m_now)
                                )
                                pid = jnp.where(v_, c.img_i * G + c.img_j, G * G)
                                killed = jnp.zeros((G * G + 1,), bool).at[
                                    jnp.where(qual, pid, G * G)
                                ].set(True, mode="drop")
                                c = c._replace(
                                    img_i=jnp.where(killed[pid], -1, c.img_i)
                                )
                            p2, _ = sharded_solve(prev_poses, kv, c)
                            return c, p2

                        corrs, sposes = jax.lax.cond(
                            do, prune, lambda c: (c, sposes), corrs
                        )
                        return (corrs, sposes), do

                    (corrs, sposes), _ = jax.lax.scan(
                        prune_round, (corrs, sposes), None,
                        length=bundling.max_prune_rounds,
                    )

                    if bundling.use_comprehensive_frame_invalidation:
                        counts = corr_counts_per_frame(corrs, G)
                        ks = jnp.arange(G)
                        keep = (counts > 0) | (ks == 0) | (ks > g)
                        kf_valid = kf_valid & keep
                    return (
                        glob._replace(corrs=corrs, poses=sposes), kf_valid,
                        matched, dropped,
                    )

                def no_global(op):
                    glob, kf_valid = op
                    return (
                        glob, kf_valid, jnp.asarray(True),
                        jnp.asarray(0, jnp.int32),
                    )

                glob, kf_valid, matched, pairs_dropped = jax.lax.cond(
                    g > 0, global_branch, no_global, (glob, kf_valid)
                )

                kf_world_g = pose_to_matrix(glob.poses[g])
                overlap_world = jnp.where(
                    submap_ok, kf_world_g @ local_world[S - 1], last_world
                )
                comp, comp_ok = compose(
                    glob.poses, kf_valid, glob.local_traj, glob.local_valid
                )
                pack_b = jnp.concatenate([
                    kf_valid.astype(jnp.float32),
                    jnp.stack([
                        submap_ok.astype(jnp.float32),
                        matched.astype(jnp.float32),
                        pairs_dropped.astype(jnp.float32),
                    ]),
                    comp.reshape(-1),
                    comp_ok.astype(jnp.float32),
                ])
                return glob, kf_valid, overlap_world, pack_b

            self._submap_global = jax.jit(submap_global, donate_argnums=(0,))

        self._gc = jax.jit(garbage_collect, donate_argnums=(0,), static_argnums=(1,))
        from bundlefusion_tpu.solver.residuals import compact_corrs

        self._compact_corrs = jax.jit(compact_corrs, donate_argnums=(0,))

        # per-frame visualization (the reference raycasts every frame at
        # integration res and blits it, DepthSensing.cpp:1066-1068); the
        # render stays on device — callers fetch ``last_render`` lazily.
        # Uses the surface-splat renderer (splat.py) in place of the
        # per-pixel march (raycast.py), with the same output contract.
        # the splat's packed z-buffer carries a 19-bit sample index (block *
        # 64 runs), capping it at 8192 rasterized blocks per frame (the
        # SplatParams default) — ample for a 320x240 preview (524K
        # candidate samples for 77K pixels)
        sp = SplatParams(
            depth_min=app.render_depth_min,
            depth_max=app.render_depth_max,
        )
        self._render = jax.jit(
            lambda table, cam: splat_render(table, intr_int, cam, tsdf_params, sp)
        )

    # ------------------------------------------------------------------
    def warmup(self) -> float:
        """Compile + execute every engine program before the first frame.

        The driver benchmark runs in a fresh process; any program first
        reached inside the timed window would dominate the measurement.
        This executes all of them — frame step,
        both TSDF variants, garbage collection, submap step (both
        global-branch sides via lax.cond), revalidation matching,
        finish-path solves, composition, rendering.

        Runs against the ENGINE'S OWN (still-empty) state via donation —
        a dummy zero frame writes into slot 0 / keyframe row 1, all of
        which the real stream fully overwrites, and contributes no TSDF
        blocks, no correspondences, and no keyframe validity. Duplicating
        the state instead would double peak device memory at the reference
        default capacity (12000-frame archive + 200K-block
        volume ~ 7 GB of state). Returns elapsed seconds.
        """
        import time as _time

        assert self.frame_idx == 0, "warmup() must run before the first frame"
        t0 = _time.perf_counter()
        bundling = self.bundling
        d = jnp.zeros((self.intr_input.height, self.intr_input.width), jnp.uint16)
        c = jnp.zeros((self.intr_input.height, self.intr_input.width, 3), jnp.uint8)
        self.local, self.store, T_dev, valid_dev = self._frame_step(
            d, c, self.local, self.store, self._dev_eye, self._i32(0), self._i32(0)
        )
        # zero depth -> no candidate blocks: the TSDF/gc warmups are no-ops
        stream_args = (self._blocked_dev,) if self.app.streaming_enabled else ()
        self.table = self._tsdf_fast(
            self.table, self.store, self._i32(0), T_dev, valid_dev, *stream_args
        )
        packed = jnp.zeros((5, 34), jnp.float32)
        self.table = self._tsdf_rows(
            self.table, self.store, packed, self._i32(0), T_dev, valid_dev,
            *stream_args,
        )
        self.table = self._gc(self.table)
        render = self._render(self.table, self._dev_eye)
        if not self._use_mesh:
            self.local, self.glob, self.kf_valid_dev, _, pack = self._submap_step(
                self.local, self.glob, self.kf_valid_dev, self._i32(1),
                self._dev_eye, self._dev_eye,
            )
        else:
            (
                self.local, local_world, lv_out, submap_ok, fused, cache_row,
                pack,
            ) = self._submap_local(self.local, self._dev_eye, self._dev_eye)
            rep = self._mesh_rep()

            def put(t):
                return jax.tree.map(lambda a: jax.device_put(a, rep), t)

            self.glob, self.kf_valid_dev, _, pack_b = self._submap_global(
                self.glob, self.kf_valid_dev, jax.device_put(np.int32(1), rep),
                put(fused), put(cache_row), put(local_world), put(lv_out),
                put(submap_ok), put(self._dev_eye), put(self._dev_eye),
            )
            pack = (pack, pack_b)
        glob = self.glob
        # revalidation path programs (match + conditional residual append +
        # the eager frame_valid toggles, Bundler::tryRevalidation analog);
        # nothing appends (no pair survives against an all-invalid store)
        gk = glob.keys
        glob = glob._replace(keys=gk._replace(frame_valid=gk.frame_valid.at[0].set(True)))
        mf = match_and_filter(
            jnp.asarray(0), glob.keys, glob.cache,
            self.intr_sift, self.intr_cache, self.frontend_global,
        )
        corrs2 = add_to_residuals(
            glob.corrs, mf, jnp.asarray(0, jnp.int32),
            jnp.arange(self.G, dtype=jnp.int32),
        )
        gk = glob.keys
        self.glob = glob._replace(
            keys=gk._replace(frame_valid=gk.frame_valid.at[0].set(False))
        )
        # finish() path programs: standalone global solves + composition
        # (results discarded; the engine's poses are not donated)
        kfv = self.kf_valid_dev
        gposes, _ = solve_sparse(self.glob.poses, kfv, corrs2, self.global_solver)
        if bundling.use_global_dense_at_end:
            gposes, _ = solve_bundle(
                self.glob.poses, kfv, corrs2, self.glob.cache, self.intr_cache,
                self.global_solver, self.dense_term_params,
                dense_weights=jnp.full(
                    (self.global_solver.num_gn,), 15.0, jnp.float32
                ),
                w_color=bundling.dense_color_at_end_weight,
            )
        comp = self._compose(gposes, kfv, self.glob.local_traj, self.glob.local_valid)
        tail = self._pack_tail(self.local, self._dev_eye)
        jax.block_until_ready((self.table, render, pack, comp, tail, self.glob))
        del render, pack, comp, tail, corrs2, gposes, mf
        return _time.perf_counter() - t0

    # ------------------------------------------------------------------
    @staticmethod
    def _to_wire(depth, color):
        """Host-side compaction to the upload wire format (uint16 mm depth /
        uint8 color), mirroring the .sens on-disk representation."""
        depth = np.asarray(depth)
        color = np.asarray(color)
        if depth.dtype != np.uint16:
            d = np.where(np.isfinite(depth), depth, 0.0)
            depth = np.clip(d * 1000.0 + 0.5, 0, 65535).astype(np.uint16)
        if color.dtype != np.uint8:
            color = np.clip(color * 255.0 + 0.5, 0, 255).astype(np.uint8)
        return depth, color

    # ------------------------------------------------------------------
    def upload_frame(self, depth, color):
        """Start the async host->device upload of one input frame.

        Uploading frame i+1 while frame i computes hides the transfer — the
        analog of the reference's sensor thread overlapping the GPU
        (``CUDAImageManager::process`` upload vs render thread). Returns a
        handle to pass to :meth:`process_frame` as ``depth`` (with
        ``color=None``).
        """
        depth_u16, color_u8 = self._to_wire(depth, color)
        return (jax.device_put(depth_u16), jax.device_put(color_u8))

    # ------------------------------------------------------------------
    def process_frame(self, depth, color=None):
        """Process one input-resolution RGB-D frame.

        Args:
          depth: [H, W] float32 meters (or uint16 mm) at input resolution —
            or the handle returned by :meth:`upload_frame` (then ``color``
            must be None).
          color: [H, W, 3] float32 in [0, 1] (or uint8).

        Returns dict: ``pose`` (4x4, cam-to-world estimate), ``valid``.
        The values are device arrays fetched lazily — coerce with
        ``np.asarray`` / ``bool`` when needed; this keeps the hot loop free
        of per-frame device round-trips (the engine retires results with a
        one-frame lag, the analog of the reference's recon/bundling thread
        handshake).
        """
        f = self.frame_idx
        ft = self.timing.new_frame(f)
        S = self.S
        # serialized device-time replay frame (CUDATimer analog): drain all
        # in-flight work first so each stage's block_until_ready below times
        # exactly that stage's device execution
        prof = self.profile_every > 0 and f > 0 and f % self.profile_every == 0
        if prof:
            jax.block_until_ready((self.local, self.glob, self.table))

        # submap slot (with one-frame overlap): frame k*(S-1) is slot S-1 of
        # submap k-1 AND slot 0 of submap k
        sub_len = S - 1
        slot = f % sub_len
        is_boundary = f > 0 and slot == 0
        cur_slot = sub_len if is_boundary else slot  # position in current buffer

        # retire any submaps whose async readback already landed; the
        # boundary dispatch itself never blocks on them — its keyframe
        # validity comes from the device-resident ``kf_valid_dev`` twin
        with self.timing.stage("time_solve", ft):
            self._retire_submap(force=False)
            if is_boundary and self.num_keyframes >= self.G:
                # past keyframe capacity: no rollover will happen, and this
                # frame's frame_step will overwrite the anchor slot — record
                # the finishing window's chained poses first
                self._retire_submap(force=True)
                self._record_window_tail(f)

        with self.timing.stage("time_frame_step", ft):
            if color is None:
                depth_dev, color_dev = depth  # pre-uploaded handle
            else:
                depth_u16, color_u8_in = self._to_wire(depth, color)
                depth_dev = jnp.asarray(depth_u16)
                color_dev = jnp.asarray(color_u8_in)
            store_slot = self._store_slot(f)
            if prof:
                with self.device_timing.stage("dev_frame_step"):
                    self.local, self.store, T_world_dev, valid_dev = self._frame_step(
                        depth_dev, color_dev, self.local, self.store,
                        self.submap_base, self._i32(cur_slot),
                        self._i32(store_slot),
                    )
                    jax.block_until_ready((self.local, T_world_dev))
            else:
                self.local, self.store, T_world_dev, valid_dev = self._frame_step(
                    depth_dev,
                    color_dev,
                    self.local,
                    self.store,
                    self.submap_base,
                    self._i32(cur_slot),
                    self._i32(store_slot),
                )

        # ---- fused TSDF dispatch: re-integration budget + current frame
        # fuse in ONE kernel sweep (reference order: reintegrate() then
        # integrate(), DepthSensing.cpp:854-902 + :1047) ----
        with self.timing.stage("time_re_integrate", ft):
            if self.app.integration_enabled:
                if prof:
                    # split the replay sample by path: a rows (re-
                    # integration) dispatch carries up to 11 ops against
                    # the plain path's one, so averaging them under one
                    # name would overstate the per-frame device time
                    import time as _time

                    rows_before = self.reint_frames
                    _t0 = _time.perf_counter()
                    self._tsdf_dispatch(store_slot, T_world_dev, valid_dev)
                    jax.block_until_ready(self.table)
                    _dt = _time.perf_counter() - _t0
                    self.device_timing.add(
                        "dev_tsdf_rows"
                        if self.reint_frames > rows_before
                        else "dev_tsdf",
                        _dt,
                    )
                else:
                    self._tsdf_dispatch(store_slot, T_world_dev, valid_dev)

        # ---- per-frame visualization: raycast the TSDF at the current pose
        # (the reference renders every frame, DepthSensing.cpp:1066-1068);
        # the result stays on device, fetched lazily via ``last_render`` ----
        if self.render_every and f % self.render_every == 0:
            with self.timing.stage("time_visualize", ft):
                if prof:
                    with self.device_timing.stage("dev_render"):
                        self.last_render = self._render(self.table, T_world_dev)
                        jax.block_until_ready(self.last_render)
                else:
                    self.last_render = self._render(self.table, T_world_dev)

        # ---- streaming sweep (opt-in): page far blocks to the host, pull
        # returning ones back, refresh the paged-key array the alloc skips
        # (full sweep every streaming_every frames vs the reference's
        # 1/80th-per-frame round robin — same steady-state contract) ----
        if (
            self.app.streaming_enabled
            and f > 0
            and f % self.app.streaming_every == 0
        ):
            self._stream_update()

        # ---- submap boundary: dispatch the solve (device-side dependency
        # only; results retired on a later frame) ----
        if is_boundary:
            with self.timing.stage("time_submap_step", ft):
                if prof:
                    with self.device_timing.stage("dev_submap"):
                        dispatched = self._dispatch_submap(T_world_dev)
                        if self._pending_submaps:
                            jax.block_until_ready(self._pending_submaps[-1][1])
                else:
                    dispatched = self._dispatch_submap(T_world_dev)
            self._window_base = f
            self._anchor_slot = 0 if dispatched else sub_len

        self.frame_idx += 1
        return {"pose": T_world_dev, "valid": valid_dev}

    # ------------------------------------------------------------------
    def _stream_update(self):
        """One host paging sweep around the latest known camera position:
        stream returning blocks in, far blocks out, and refresh the
        device-side paged-key array (``isSDFBlockStreamedOut`` analog,
        consulted by the alloc path)."""
        from bundlefusion_tpu.tsdf.streaming import stream_in, stream_out

        if not self.sift_world:
            return  # no retired pose yet to center the radius on
        campos = np.asarray(self.sift_world[-1])[:3, 3]
        vs = self.app.sdf_voxel_size
        r = self.app.streaming_radius
        self.table = stream_in(self.table, self.host_blocks, campos, r, vs)
        self.table = stream_out(self.table, self.host_blocks, campos, r, vs)
        self._refresh_blocked_dev()

    # ------------------------------------------------------------------
    def _stream_in_for_rows(self, rows):
        """Page in every host block that a pending re-integration row's old
        or new pose frustum could touch (conservative 8-corner test), then
        refresh the device-side paged-key array the alloc path consults."""
        from bundlefusion_tpu.tsdf.streaming import (
            paged_keys_in_frustum,
            stream_in_keys,
        )

        poses = []
        for _f, mode, To, Tn in rows:
            if mode in (1, 2):
                poses.append(To)
            if mode in (2, 3):
                poses.append(Tn)
        keys = paged_keys_in_frustum(
            self.host_blocks,
            poses,
            self.intr_int,
            self.tsdf_params,
            self.app.integration_height,
            self.app.integration_width,
        )
        if len(keys):
            self.table = stream_in_keys(self.table, self.host_blocks, keys)
            self._refresh_blocked_dev()

    # ------------------------------------------------------------------
    def _refresh_blocked_dev(self):
        """Rebuild the sorted device-side paged-key array from the host
        store. Grows (power-of-two doubling -> one recompile of the alloc
        program per growth) rather than truncating: a dropped key would let
        the alloc path re-allocate that block empty, forking it from the
        host copy, and a later stream_in would overwrite the fork with the
        stale host payload."""
        cap = self._blocked_dev.shape[0]
        n = len(self.host_blocks.blocks)
        while n > cap:
            cap *= 2
        arr = np.full((cap,), int(EMPTY_KEY), np.int32)
        if n:
            ks = np.sort(
                np.fromiter(self.host_blocks.blocks.keys(), np.int64).astype(
                    np.int32
                )
            )
            arr[: len(ks)] = ks
        self._blocked_dev = jnp.asarray(arr)

    # ------------------------------------------------------------------
    def _store_slot(self, f: int) -> int:
        """Frame archive slot: frames beyond capacity land in the scratch
        slot (they become non-re-integrable, like streamed-out blocks)."""
        return f if f < self.frame_cap else self.frame_cap

    # ------------------------------------------------------------------
    def _record_frame(self, f: int, T_world: np.ndarray, valid: bool):
        """Host bookkeeping for one frame (from a submap readback pack)."""
        assert f == len(self.frame_valid)
        T_world = np.asarray(T_world, np.float32)
        self.frame_valid.append(valid)
        self.sift_world.append(T_world.copy())
        self.complete_traj.append(
            T_world.copy() if valid else np.full((4, 4), np.nan, np.float32)
        )
        if valid and self.app.integration_enabled:
            self.traj_manager.add_frame(f, T_world)
        else:
            self.traj_manager.add_frame(f, None)

    # ------------------------------------------------------------------
    def _flush_pending(self):
        """Retire everything in flight (end of stream / before evaluation)."""
        self._retire_submap(force=True)
        if self._recorded_upto < self.frame_idx:
            # trailing frames of the current (partial) window
            self._record_window_tail(self.frame_idx)

    # ------------------------------------------------------------------
    def _record_window_tail(self, end_frame: int):
        """Record frames [recorded_upto, end_frame) from the live local
        buffer (one small transfer). Handles both the normal trailing
        partial submap and the past-capacity windows where boundaries stop
        rolling the buffer over (the anchor then sits at slot ``sub_len``,
        not slot 0)."""
        if self._recorded_upto >= end_frame:
            return
        S = self.S
        sub_len = S - 1
        tail = np.asarray(self._pack_tail(self.local, self.submap_base))
        world = tail[: S * 16].reshape(S, 4, 4)
        lv = tail[S * 16:] > 0.5
        base = self._window_base
        for f in range(self._recorded_upto, end_frame):
            s = self._anchor_slot if f == base else f - base
            assert 0 <= s <= sub_len, (f, base, self._anchor_slot)
            self._record_frame(f, world[s], bool(lv[s]))
        self._recorded_upto = end_frame

    # ------------------------------------------------------------------
    def _dispatch_submap(self, last_world_dev) -> bool:
        """Dispatch local solve -> keyframe fusion -> global match -> global
        solve -> rollover (``OnlineBundler::process``); results retired on a
        later frame. Returns False once keyframe capacity is reached."""
        g = self.num_keyframes  # submap index == keyframe index
        if g >= self.G:
            return False  # capacity reached (reference caps s_maxNumImages)

        # relocalization attempt BEFORE the solve so revalidated corrs join
        # this submap's global solve (tryRevalidation, Bundler.cpp:306-352)
        self._try_revalidation()

        # periodic corr-store compaction: residual pruning / frame
        # invalidation only MARK corrs dead (reference semantics), so long
        # runs leak append capacity; reclaiming every 64 submaps keeps the
        # cursor bounded by the LIVE count (the reference's append-only
        # store cannot do this)
        if g > 0 and g % 64 == 0 and not self._use_mesh:
            self.glob = self.glob._replace(
                corrs=self._compact_corrs(self.glob.corrs)
            )

        if not self._use_mesh:
            (
                self.local,
                self.glob,
                self.kf_valid_dev,
                overlap_world_dev,
                pack_dev,
            ) = self._submap_step(
                self.local,
                self.glob,
                self.kf_valid_dev,
                self._i32(g),
                self.submap_base,
                last_world_dev,
            )
            pack_dev.copy_to_host_async()
            # the next submap's frames chain off the solved overlap pose —
            # stays on device, no round-trip
            self.submap_base = overlap_world_dev
            self.num_keyframes += 1
            self._pending_submaps.append((g, pack_dev))
            return True

        # ---- mesh path: single-device local phase, then the sharded
        # global phase on the mesh; traffic between them is the fused
        # keyframe row + cache row (~1 MB) and a 4x4 pose back ----
        (
            self.local,
            local_world,
            lv_out,
            submap_ok,
            fused,
            cache_row,
            pack_a,
        ) = self._submap_local(self.local, self.submap_base, last_world_dev)
        rep = self._mesh_rep()

        def put(t):
            return jax.tree.map(lambda a: jax.device_put(a, rep), t)

        (
            self.glob,
            self.kf_valid_dev,
            overlap_mesh,
            pack_b,
        ) = self._submap_global(
            self.glob,
            self.kf_valid_dev,
            jax.device_put(np.int32(g), rep),
            put(fused),
            put(cache_row),
            put(local_world),
            put(lv_out),
            put(submap_ok),
            put(self.submap_base),
            put(last_world_dev),
        )
        pack_a.copy_to_host_async()
        pack_b.copy_to_host_async()
        # overlap pose returns to the per-frame device
        self.submap_base = jax.device_put(overlap_mesh, self._frame_device)
        self.num_keyframes += 1
        self._pending_submaps.append((g, (pack_a, pack_b)))
        return True

    # ------------------------------------------------------------------
    def _retire_submap(self, force: bool = True):
        """Consume the packed readbacks of dispatched submaps (in order):
        per-frame host bookkeeping, keyframe validity, lost-keyframe retry
        queue, and the optimized complete trajectory — one flat transfer
        each. Without ``force``, stops at the first pack still in flight."""
        while self._pending_submaps:
            pack = self._pending_submaps[0][1]
            parts = pack if isinstance(pack, tuple) else (pack,)
            if not force and not all(p.is_ready() for p in parts):
                return
            g, pack = self._pending_submaps.pop(0)
            if isinstance(pack, tuple):
                pack = np.concatenate([np.asarray(p) for p in pack])
            self._retire_one(g, pack)

    # ------------------------------------------------------------------
    def _retire_one(self, g: int, pack_dev):
        pack = np.asarray(pack_dev)
        S = self.S
        sub_len = S - 1

        world = pack[: self._off_lv].reshape(S, 4, 4)
        lv = pack[self._off_lv : self._off_kf] > 0.5
        prev_kf_valid = self.keyframe_valid
        self.keyframe_valid = pack[self._off_kf : self._off_flags] > 0.5
        matched = pack[self._off_flags + 1] > 0.5
        # silent-cap accounting: pairs beyond solver_max_pairs were dropped
        # from this global solve (the reference silently truncates too,
        # SolverBundling.cu:1242-1245 — here it is surfaced)
        dropped = int(pack[self._off_flags + 2])
        if dropped > 0:
            self.pairs_dropped_total += dropped
            self.pairs_dropped_max = max(self.pairs_dropped_max, dropped)
        # keyframes that LOST validity during this solve (residual pruning +
        # comprehensive frame invalidation) queue for relocalization retries,
        # exactly like freshly-lost keyframes (SIFTImageManager retry list)
        for k in np.where(prev_kf_valid[: g + 1] & ~self.keyframe_valid[: g + 1])[0]:
            k = int(k)
            if k not in self.retry_list:
                self.retry_list.append(k)
        comp = pack[self._off_comp : self._off_ok].reshape(-1, 4, 4)
        comp_ok = pack[self._off_ok :] > 0.5

        # per-frame bookkeeping for the frames this submap covers
        base = g * sub_len
        last = min(base + sub_len, self.frame_idx - 1)
        for f in range(self._recorded_upto, last + 1):
            s = f - base
            self._record_frame(f, world[s], bool(lv[s]))
        self._recorded_upto = max(self._recorded_upto, last + 1)

        if g > 0 and not matched:
            # keyframe not matched: tracking lost for this submap -> queue
            # for relocalization retries
            self.lost_count += 1
            self.retry_list.append(g)

        # optimized trajectory for all solved submaps (invalid -> nan)
        m = min(len(self.complete_traj), (g + 1) * sub_len, comp.shape[0])
        nanT = np.full((4, 4), np.nan, np.float32)
        for i in range(m):
            self.complete_traj[i] = (
                comp[i].astype(np.float32) if comp_ok[i] else nanT
            )
        self._push_optimized_to_manager()

    # ------------------------------------------------------------------
    def _try_revalidation(self):
        """One relocalization attempt per submap: re-match the oldest lost
        keyframe against all valid keyframes (``tryRevalidation``,
        Bundler.cpp:306-352). Success restores the keyframe and appends its
        correspondences; failure re-queues (persistent, uncapped — the
        reference retries until revalidation succeeds)."""
        if not self.retry_list:
            return
        k = self.retry_list.pop(0)
        self.retry_attempts[k] = self.retry_attempts.get(k, 0) + 1
        # temporarily mark the keyframe's stored features active for matching
        gk = self.glob.keys
        self.glob = self.glob._replace(
            keys=gk._replace(frame_valid=gk.frame_valid.at[k].set(True))
        )
        mf = match_and_filter(
            jnp.asarray(k),
            self.glob.keys,
            self.glob.cache,
            self.intr_sift,
            self.intr_cache,
            self.frontend_global,
        )
        pair_valid = np.asarray(mf["pair_valid"])
        # only pairs against currently-valid keyframes count
        pair_valid = pair_valid & self.keyframe_valid[: self.G]
        if pair_valid.any():
            self.glob = self.glob._replace(
                corrs=add_to_residuals(
                    self.glob.corrs,
                    mf,
                    jnp.asarray(k, jnp.int32),
                    jnp.arange(self.G, dtype=jnp.int32),
                )
            )
            self.keyframe_valid[k] = True
            self.kf_valid_dev = self.kf_valid_dev.at[k].set(True)
        else:
            gk = self.glob.keys
            self.glob = self.glob._replace(
                keys=gk._replace(frame_valid=gk.frame_valid.at[k].set(False))
            )
            self.retry_list.append(k)

    # ------------------------------------------------------------------
    def _push_optimized_to_manager(self):
        """Feed the current complete trajectory to the re-integration
        scheduler (``TrajectoryManager::updateOptimizedTransform``)."""
        n = len(self.complete_traj)
        poses = np.stack(self.complete_traj) if n else np.zeros((0, 4, 4))
        valid = np.isfinite(poses).all(axis=(1, 2)) if n else np.zeros((0,), bool)
        self.traj_manager.update_optimized_transforms(poses, valid)

    # ------------------------------------------------------------------
    def _update_complete_trajectory(self, n_solved: Optional[int] = None):
        """complete[f] = keyframe_world[k] @ local[k][r]
        (``updateTrajectoryCU``: invalid frames -> -inf/nan). Synchronous
        (one transfer) — used at finish() after extra solves; the hot loop
        gets this from the submap readback pack instead.

        Args:
          n_solved: number of solved submaps; only their frames are
            overwritten (later frames keep the chained estimate).
        """
        if n_solved is None:
            n_solved = self.num_keyframes
        comp_flat, ok = self._compose(
            self.glob.poses,
            jnp.asarray(self.keyframe_valid),
            self.glob.local_traj,
            self.glob.local_valid,
        )
        comp = np.asarray(comp_flat).reshape(-1, 4, 4)
        ok = np.asarray(ok)
        n = len(self.complete_traj)
        m = min(n, n_solved * (self.S - 1), comp.shape[0])
        nanT = np.full((4, 4), np.nan, np.float32)
        for f in range(m):
            self.complete_traj[f] = comp[f] if ok[f] else nanT
        self._push_optimized_to_manager()

    # ------------------------------------------------------------------
    def _tsdf_dispatch(self, store_slot=None, T_world_dev=None, valid_dev=None):
        """Dispatch the frame's fused TSDF program: the ≤``max_frame_fixes``
        re-integration budget (``DepthSensing.cpp: reintegrate():854-902``)
        plus the current frame's fuse, as ONE kernel sweep. With no current
        frame (drain mode at finish()) only rows run."""
        rows = self._build_reintegrate_rows() if self.app.integration_enabled else []
        has_cur = store_slot is not None
        if not rows and not has_cur:
            return
        if rows and self.app.streaming_enabled and len(self.host_blocks):
            # stream-in-before-reintegrate: a de/re-integration over a paged
            # region would silently under-subtract (the alloc-path blocked
            # check drops those blocks). Pull every paged block any row's
            # old or new frustum could touch back in first — the reference's
            # chunk grid does the same before integrating
            # (CUDASceneRepChunkGrid.h:142-210).
            self._stream_in_for_rows(rows)
        R = 5
        stream_args = (self._blocked_dev,) if self.app.streaming_enabled else ()
        if not rows and has_cur:
            self.table = self._tsdf_fast(
                self.table,
                self.store,
                self._i32(store_slot),
                T_world_dev,
                valid_dev,
                *stream_args,
            )
            return

        rows = rows[:R]
        self.reint_frames += 1
        self.reint_ops_total += sum(
            2 if mode == 2 else 1 for _f, mode, _To, _Tn in rows
        )
        eye = np.eye(4, dtype=np.float32)
        # single packed upload per frame (one host->device transfer):
        # [fid, op, T_old flat 16, T_new flat 16]
        packed = np.zeros((R, 34), np.float32)
        packed[:, 2:18] = eye.reshape(-1)
        packed[:, 18:34] = eye.reshape(-1)
        for i, (f, mode, To, Tn) in enumerate(rows):
            packed[i, 0] = f
            packed[i, 1] = mode
            packed[i, 2:18] = To.reshape(-1)
            packed[i, 18:34] = Tn.reshape(-1)
        if has_cur:
            fid_cur = self._i32(store_slot)
            T_cur, cur_valid = T_world_dev, valid_dev
        else:
            fid_cur = self._i32(0)
            T_cur = self._dev_eye
            cur_valid = self._dev_false
        self.table = self._tsdf_rows(
            self.table,
            self.store,
            jnp.asarray(packed),
            fid_cur,
            T_cur,
            cur_valid,
            *stream_args,
        )
        for f, mode, To, Tn in rows:
            if mode == 1:
                self.traj_manager.mark_deintegrated(f)
            elif mode == 2:
                self.traj_manager.mark_deintegrated(f)
                self.traj_manager.mark_integrated(f, Tn)
            elif mode == 3:
                self.traj_manager.mark_integrated(f, Tn)
        if self.app.garbage_collection_enabled and any(
            mode in (1, 2) for _, mode, _, _ in rows
        ):
            # de-integration may empty blocks; reclaim them (the fast path
            # never frees, so gc only runs on row frames)
            self.table = self._gc(self.table)

    # ------------------------------------------------------------------
    def _build_reintegrate_rows(self):
        """Schedule at most ``max_frame_fixes`` de/re-integration ops
        (``TrajectoryManager::generateUpdateLists`` consumption)."""
        deint, reint, integ = self.traj_manager.generate_update_lists()
        if not (deint or reint or integ):
            return []
        budget = self.app.max_frame_fixes
        eye = np.eye(4, dtype=np.float32)
        # frames evicted from the device archive cannot be re-integrated;
        # mark them handled so the scheduler stops re-ranking them
        for lst in (deint, reint, integ):
            for f in [x for x in lst if x >= self.frame_cap]:
                rec = self.traj_manager.records[f]
                if rec.optimized_transform is not None:
                    self.traj_manager.mark_integrated(f, rec.optimized_transform)
        deint = [f for f in deint if f < self.frame_cap]
        reint = [f for f in reint if f < self.frame_cap]
        integ = [f for f in integ if f < self.frame_cap]
        rows: List[tuple] = []  # (frame, mode, T_old, T_new)
        ops = 0
        hit_budget = False
        for f in deint:
            if ops >= budget:
                hit_budget = True
                break
            rec = self.traj_manager.records[f]
            if rec.integrated_transform is None:
                continue
            rows.append((f, 1, rec.integrated_transform, eye))
            ops += 1
        if not hit_budget:
            for f in reint:
                if ops + 2 > budget and ops > 0:
                    break
                rec = self.traj_manager.records[f]
                new_T = rec.optimized_transform
                has_old = rec.integrated_transform is not None
                ok_new = new_T is not None and np.isfinite(new_T).all()
                if has_old and ok_new:
                    rows.append((f, 2, rec.integrated_transform, new_T))
                elif has_old:
                    rows.append((f, 1, rec.integrated_transform, eye))
                elif ok_new:
                    rows.append((f, 3, eye, new_T))
                ops += 2
            for f in integ:
                if ops >= budget:
                    break
                rec = self.traj_manager.records[f]
                new_T = rec.optimized_transform
                if new_T is None or not np.isfinite(new_T).all():
                    continue
                rows.append((f, 3, eye, new_T))
                ops += 1
        return rows

    # ------------------------------------------------------------------
    def finish(self, extra_solves: Optional[int] = None):
        """End-of-sequence: solve the trailing partial submap, run extra
        global solves + drain re-integration (``numSolveFramesBeforeExit``)."""
        self._flush_pending()
        sub_len = self.S - 1
        if self.frame_idx % sub_len != 1 and self.frame_idx > 0:
            # trailing partial submap: pad state is already sized; solve it
            self._dispatch_submap(jnp.asarray(self.sift_world[-1]))
            self._retire_submap()
        n_extra = (
            extra_solves
            if extra_solves is not None
            else max(self.app.num_solve_frames_before_exit // 10, 1)
        )
        for it in range(n_extra):
            if self.num_keyframes > 1:
                kv = self.keyframe_valid.copy()
                kv[self.num_keyframes :] = False
                if self.bundling.use_global_dense_at_end and it == n_extra - 1:
                    # final pass with dense depth weight 15 and photometric
                    # weight 0.1 (USE_GLOBAL_DENSE_AT_END,
                    # OnlineBundler.cpp:177-189; denseColor SBA.cpp:28-38)
                    gposes, _ = solve_bundle(
                        self.glob.poses,
                        jnp.asarray(kv),
                        self.glob.corrs,
                        self.glob.cache,
                        self.intr_cache,
                        self.global_solver,
                        self.dense_term_params,
                        dense_weights=jnp.full(
                            (self.global_solver.num_gn,), 15.0, jnp.float32
                        ),
                        w_color=self.bundling.dense_color_at_end_weight,
                    )
                else:
                    gposes, _ = solve_sparse(
                        self.glob.poses,
                        jnp.asarray(kv),
                        self.glob.corrs,
                        self.global_solver,
                    )
                self.glob = self.glob._replace(poses=gposes)
            self._update_complete_trajectory()
            for _ in range(10):
                before = self.traj_manager.generate_update_lists()
                if not any(before):
                    break
                self._tsdf_dispatch()

    # ------------------------------------------------------------------
    def render(self, cam_to_world, raycast_params: Optional[RaycastParams] = None):
        rp = raycast_params or RaycastParams(
            ray_increment_factor=self.app.sdf_ray_increment_factor,
            depth_min=self.app.render_depth_min,
            depth_max=self.app.render_depth_max,
        )
        return raycast(
            self.table, self.intr_int, jnp.asarray(cam_to_world), self.tsdf_params, rp
        )

    def extract_mesh(self):
        from bundlefusion_tpu.tsdf.marching_cubes import extract_mesh

        return extract_mesh(self.table, self.tsdf_params.voxel_size)

    def trajectory(self) -> np.ndarray:
        """Per-frame optimized camera-to-world matrices (nan = invalid)."""
        if not self.complete_traj:
            return np.zeros((0, 4, 4), np.float32)
        return np.stack(self.complete_traj)

    # ------------------------------------------------------------------
    def save(self, path: str):
        """Checkpoint the complete engine state (voxel table, keyframe and
        correspondence stores, frame archive, trajectories, scheduler) —
        the unified analog of the reference's piecemeal TSDF-hash /
        SIFTImageManager / CUDACache save paths. Resume with
        :meth:`BundleFusion.load`."""
        from bundlefusion_tpu.io.checkpoint import save_engine

        save_engine(self, path)

    @staticmethod
    def load(path: str, mesh=None) -> "BundleFusion":
        from bundlefusion_tpu.io.checkpoint import load_engine

        return load_engine(path, mesh=mesh)

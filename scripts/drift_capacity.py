"""Capacity-scale drift-correction / relocalization run on one GPU.

Runs >= 600 keyframes (reference capacity regime, submap 10) over a
multi-loop-closure trajectory with depth noise and TWO tracking
blackouts, and prints one JSON line with:

  - chained (odometry-only) vs optimized ATE RMSE + improvement factor,
  - re-integration op counts (the on-the-fly surface re-integration
    machinery actually exercising at scale),
  - relocalization outcomes (lost keyframes, recovery after blackouts),
  - voxel-table invariants at the end (debugHash analog).

Input is rendered in-process in 400-frame shards at 320x240 to bound host
memory; SIFT/integration run at the same resolution (resolution is a
correctness-neutral knob here — the filter cascade + solver +
re-integration machinery is what is being stressed). Needs a GPU; there
is no CPU configuration.

Usage: python scripts/drift_capacity.py [n_frames]
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

SHARD = 400


def render_shards(n_frames, intr, noise, blackouts):
    """Yield (depth, color, poses) wire shards of the multi-loop sequence;
    blackout ranges are global frame indices, clipped to each shard."""
    from bundlefusion_tpu.io.synthetic import make_sequence_wire, multiloop_trajectory

    poses_full = multiloop_trajectory(n_frames)
    for s0 in range(0, n_frames, SHARD):
        n = min(SHARD, n_frames - s0)
        bl = None
        for b0, b1 in blackouts:
            a, b = max(b0 - s0, 0), min(b1 - s0, n)
            if a < b:
                bl = (a, b)
                break  # one blackout per shard; shards are 400 frames
        seq = make_sequence_wire(
            n, intr=intr, poses=poses_full[s0:s0 + n], noise_depth=noise,
            blackout=bl, seed=s0,
        )
        yield seq["depth"], seq["color"], seq["poses"]


def main():
    import jax

    n_frames = int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1].isdigit() else 6400

    from bundlefusion_tpu import AppConfig, BundlingConfig
    from bundlefusion_tpu.io.synthetic import default_intrinsics
    from bundlefusion_tpu.ops.sift import SiftConfig
    from bundlefusion_tpu.pipeline.online import BundleFusion
    from bundlefusion_tpu.tsdf.table import check_invariants
    from bundlefusion_tpu.utils.device import device_summary, require_gpu
    from bundlefusion_tpu.utils.metrics import evaluate_ate_rmse

    device = device_summary(require_gpu())
    w, h = 320, 240
    sub = 10
    G = n_frames // sub  # 640 keyframes at the default 6400
    noise = 0.005
    b0 = (int(n_frames * 0.35) // sub) * sub + 2
    b1 = (int(n_frames * 0.7) // sub) * sub + 2
    blackouts = [(b0, b0 + sub), (b1, b1 + sub)]

    intr = default_intrinsics(w, h)
    app = AppConfig(
        integration_width=w, integration_height=h,
        hash_num_sdf_blocks=131072, hash_key_capacity=131072,
        visible_blocks_cap=8192,
    )
    # Reference worst-case sizing: 25 * G*(G-1)/2 = 5.1M corrs at G=640
    # (SIFTImageManager.cpp:302). Loop-dense trajectories really do grow
    # corrs quadratically (every keyframe overlaps the anchor region):
    # a 131072 store filled at kf ~112, a 1M store at kf ~370 — and
    # comprehensive invalidation then killed every later keyframe.
    # Pair budget >= the loop-dense pair count so the solve drops
    # ~nothing; the dense-LU reduced solve + presort reuse keep the
    # boundary bounded at this scale.
    bundling = BundlingConfig(
        width_sift=w, height_sift=h,
        max_global_corr=1 << 23,
        solver_max_pairs=262144,
        solver_max_working_corrs=1 << 22,
    )
    sift_cfg = SiftConfig(
        target_keys=150, min_scale=1.5,
        depth_min=app.sensor_depth_min, depth_max=app.sensor_depth_max,
    )
    eng = BundleFusion(intr, app, bundling, sift_cfg=sift_cfg, max_keyframes=G)

    # Pre-stage ALL input frames on the device (the RGBDFrameCacheRead
    # prefetch analog). Wire format is ~0.4 MB/frame at 320x240 -> 2.4 GB
    # at 6400.
    gt_poses = []
    handles = []
    shard_sizes = []
    t_up = time.perf_counter()
    for depths, colors, poses in render_shards(n_frames, intr, noise, blackouts):
        gt_poses.append(poses)
        shard_sizes.append(len(poses))
        for i in range(len(poses)):
            handles.append(eng.upload_frame(depths[i], colors[i]))
    jax.block_until_ready(handles)
    print(f"render_and_prestage_s={time.perf_counter() - t_up:.1f}", flush=True)

    t_compile = eng.warmup()
    print(f"compile_s={t_compile:.1f}", flush=True)

    t0 = time.perf_counter()
    done = 0
    for n in shard_sizes:
        for i in range(n):
            eng.process_frame(handles[done])
            done += 1
        jax.block_until_ready(eng.table)
        el = time.perf_counter() - t0
        print(f"{done}/{n_frames} frames  {done/el:.1f} fps  "
              f"kf={eng.num_keyframes} lost={eng.lost_count} "
              f"reint_ops={eng.reint_ops_total}", flush=True)
    jax.block_until_ready((eng.local, eng.glob, eng.table))
    fps = done / (time.perf_counter() - t0)
    eng.finish(extra_solves=3)

    gt = np.concatenate(gt_poses)
    chained = np.stack(eng.sift_world)
    optimized = eng.trajectory()
    valid = np.isfinite(optimized).all((1, 2))

    ate_chained, _ = evaluate_ate_rmse(
        np.where(valid[:, None, None], chained[: len(valid)], np.nan), gt
    )
    ate_opt, n_o = evaluate_ate_rmse(optimized, gt)

    after = np.arange(len(valid)) >= blackouts[-1][1] + sub
    recovered = int((valid & after).sum())
    after_total = int(after.sum())
    inv = {k: int(v) for k, v in check_invariants(eng.table).items()}

    corr_count = int(eng.glob.corrs.count)
    corr_capacity = int(eng.glob.corrs.capacity)
    kv = np.asarray(eng.keyframe_valid[: eng.num_keyframes])
    lv = np.asarray(eng.glob.local_valid[: eng.num_keyframes])
    inval_runs = np.where(~valid)[0]
    out = {
        "corr_count": corr_count,
        "corr_capacity": corr_capacity,
        "corr_store_full": corr_count >= corr_capacity,
        "kf_valid": int(kv.sum()),
        "kf_invalid_idx_head": [int(x) for x in np.where(~kv)[0][:20]],
        "local_valid_frac": round(float(lv.mean()), 3),
        "first_invalid_frame": int(inval_runs[0]) if len(inval_runs) else -1,
        "device": device,
        "frames": n_frames,
        "keyframes": eng.num_keyframes,
        "keyframe_capacity": G,
        "fps": round(fps, 2),
        "blackouts": [list(b) for b in blackouts],
        "ate_chained_cm": round(float(ate_chained) * 100, 3),
        "ate_optimized_cm": round(float(ate_opt) * 100, 3),
        "improvement_x": round(float(ate_chained / max(ate_opt, 1e-9)), 2),
        "valid_frames": int(valid.sum()),
        "invalid_frames": int((~valid).sum()),
        "lost_keyframes": eng.lost_count,
        "recovered_frames_after_blackouts": [recovered, after_total],
        "reint_frames": eng.reint_frames,
        "reint_ops": eng.reint_ops_total,
        "pairs_dropped": eng.pairs_dropped_total,
        "invariants": inv,
        "compile_s": round(t_compile, 1),
    }
    print(json.dumps(out))
    assert all(v == 0 for v in inv.values()), inv
    assert out["improvement_x"] >= 5.0 or out["ate_optimized_cm"] <= 1.0, out


if __name__ == "__main__":
    main()

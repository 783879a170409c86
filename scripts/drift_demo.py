"""Drift correction + relocalization on a hard sequence, on one GPU.

Builds a synthetic sequence that actually stresses the optimizer:
  - a LONG excursion that returns to the start (real loop closure),
  - multiplicative depth noise (odometry drifts),
  - a forced tracking break (blackout frames) mid-sequence.

Prints one JSON line with:
  - ATE RMSE of the CHAINED (frame-to-frame SIFT odometry) trajectory —
    "optimization off",
  - ATE RMSE of the OPTIMIZED trajectory (global BA + re-integration) —
    "optimization on",
  - tracking-loss accounting: lost keyframes, invalid frames during the
    blackout, and recovery after it (frames valid again = relocalized).

The reference's analogous machinery: ATE eval ``PoseHelper.h:35-79``,
retry/revalidation ``Bundler.cpp:306-352``, red-overlay lost state
``DepthSensing.cpp:806-808``.

Needs a GPU; there is no CPU configuration.

Usage: python scripts/drift_demo.py [n_frames]
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402


def ate_of(traj, gt):
    from bundlefusion_tpu.utils.metrics import evaluate_ate_rmse

    rmse, n = evaluate_ate_rmse(traj, gt[: len(traj)])
    return rmse, n


def main():
    import jax

    n_frames = int(sys.argv[1]) if len(sys.argv) > 1 else 241

    from bundlefusion_tpu import AppConfig, BundlingConfig
    from bundlefusion_tpu.io.synthetic import (
        default_intrinsics,
        loop_trajectory,
        make_sequence_wire,
    )
    from bundlefusion_tpu.ops.sift import SiftConfig
    from bundlefusion_tpu.pipeline.online import BundleFusion

    from bundlefusion_tpu.utils.device import device_summary, require_gpu

    device = device_summary(require_gpu())
    intr = default_intrinsics(640, 480)
    app = AppConfig(
        hash_num_sdf_blocks=131072, hash_key_capacity=131072,
        visible_blocks_cap=8192,
    )
    bundling = BundlingConfig(max_global_corr=32768)
    sift_cfg = SiftConfig(
        target_keys=150, min_scale=bundling.min_key_scale,
        depth_min=app.sensor_depth_min, depth_max=app.sensor_depth_max,
    )
    G = 64

    # blackout roughly 60% through, one submap long
    sub_len = bundling.submap_size
    b0 = (int(n_frames * 0.6) // sub_len) * sub_len + 2
    blackout = (b0, b0 + sub_len)
    poses = loop_trajectory(n_frames)
    print(f"rendering {n_frames} frames (blackout {blackout}) ...", flush=True)
    seq = make_sequence_wire(
        n_frames, intr=intr, poses=poses, noise_depth=0.005, blackout=blackout
    )

    eng = BundleFusion(intr, app, bundling, sift_cfg=sift_cfg, max_keyframes=G)
    t_compile = eng.warmup()
    print(f"compile_s={t_compile:.1f}", flush=True)
    t0 = time.perf_counter()
    for i in range(n_frames):
        eng.process_frame(seq["depth"][i], seq["color"][i])
    jax.block_until_ready((eng.local, eng.glob, eng.table))
    fps = n_frames / (time.perf_counter() - t0)
    eng.finish(extra_solves=3)

    gt = seq["poses"]
    chained = np.stack(eng.sift_world)           # odometry only
    optimized = eng.trajectory()                 # global BA + composition
    valid = np.isfinite(optimized).all((1, 2))

    # chained ATE over frames the engine tracked (exclude blackout: both
    # trajectories are undefined there)
    ate_chained, n_c = ate_of(
        np.where(valid[:, None, None], chained[: len(valid)], np.nan), gt
    )
    ate_opt, n_o = ate_of(optimized, gt)

    # relocalization accounting
    after = np.arange(len(valid)) >= blackout[1] + sub_len
    recovered = int((valid & after).sum())
    after_total = int(after.sum())
    out = {
        "device": device,
        "frames": n_frames,
        "keyframes": eng.num_keyframes,
        "fps": round(fps, 2),
        "blackout": list(blackout),
        "ate_chained_cm": round(float(ate_chained) * 100, 3),
        "ate_optimized_cm": round(float(ate_opt) * 100, 3),
        "improvement_x": round(float(ate_chained / max(ate_opt, 1e-9)), 2),
        "valid_frames": int(valid.sum()),
        "invalid_frames": int((~valid).sum()),
        "lost_keyframes": eng.lost_count,
        "recovered_frames_after_blackout": [recovered, after_total],
        "compile_s": round(t_compile, 1),
    }
    print(json.dumps(out))
    # the demo's contract: optimization must beat raw odometry, and the
    # engine must recover tracking after the blackout
    assert out["lost_keyframes"] >= 1 or out["invalid_frames"] >= sub_len
    assert recovered > after_total * 0.7, (recovered, after_total)


if __name__ == "__main__":
    main()

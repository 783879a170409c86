"""Reference-capacity long run on one GPU.

Runs the engine at the REFERENCE default capacity — G=1200 keyframes,
submap 10, 12000-frame archive, 262144-corr store, 16384-pair solver cap
(``zParametersBundlingDefault.txt:30-31``, ``GlobalDefines.h``) — over a
>=1000-frame synthetic loop sequence, and prints one JSON line
{device, frames, keyframes, fps, ate_rmse_cm, pairs_dropped, ...}.

It proves the default-capacity state allocates, compiles, and runs, and
that the solver's silent pair cap is not hit (pairs_dropped == 0). Needs a
GPU; there is no CPU configuration.

Usage:  python scripts/scale_run.py [n_frames]
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402


def main():
    import jax

    n_frames = int(sys.argv[1]) if len(sys.argv) > 1 else 1010

    from bundlefusion_tpu import AppConfig, BundlingConfig
    from bundlefusion_tpu.io.synthetic import (
        default_intrinsics,
        loop_trajectory,
        make_sequence_wire,
    )
    from bundlefusion_tpu.ops.sift import SiftConfig
    from bundlefusion_tpu.pipeline.online import BundleFusion
    from bundlefusion_tpu.utils.device import device_summary, require_gpu
    from bundlefusion_tpu.utils.metrics import evaluate_ate_rmse

    device = device_summary(require_gpu())
    intr = default_intrinsics(640, 480)
    # REFERENCE DEFAULTS: G=1200 keyframes, 12000-frame archive, 200K blocks
    app = AppConfig()
    bundling = BundlingConfig()
    sift_cfg = SiftConfig(
        target_keys=150, min_scale=bundling.min_key_scale,
        depth_min=app.sensor_depth_min, depth_max=app.sensor_depth_max,
    )

    print(f"rendering {n_frames}-frame loop sequence ...", flush=True)
    seq = make_sequence_wire(
        n_frames, intr=intr, poses=loop_trajectory(n_frames, odom_noise=0.0),
        noise_depth=0.002,
    )

    print("allocating default-capacity engine (G=1200, 12000-frame store) ...",
          flush=True)
    eng = BundleFusion(intr, app, bundling, sift_cfg=sift_cfg)
    assert eng.G == 1200, eng.G
    assert eng.frame_cap >= 12000, eng.frame_cap
    # prestage ALL inputs on the device (SensorDataReader prefetch analog)
    print("prestaging inputs ...", flush=True)
    handles = [
        eng.upload_frame(seq["depth"][i], seq["color"][i])
        for i in range(n_frames)
    ]
    jax.block_until_ready(handles)
    t_compile = eng.warmup()
    print(f"compile_s={t_compile:.1f}", flush=True)

    warmup_frames = 12
    for i in range(warmup_frames):
        eng.process_frame(handles[i])
    jax.block_until_ready((eng.local, eng.glob, eng.table))

    t0 = time.perf_counter()
    for i in range(warmup_frames, n_frames):
        eng.process_frame(handles[i])
        if i % 100 == 0:
            print(f"  frame {i}/{n_frames} kf={eng.num_keyframes}", flush=True)
    jax.block_until_ready((eng.local, eng.glob, eng.table))
    elapsed = time.perf_counter() - t0
    timed = n_frames - warmup_frames
    fps = timed / elapsed

    eng.finish(extra_solves=2)
    traj = eng.trajectory()
    rmse, n_valid = evaluate_ate_rmse(traj, seq["poses"][: len(traj)])

    out = {
        "device": device,
        "frames": n_frames,
        "keyframes": eng.num_keyframes,
        "keyframe_capacity": eng.G,
        "frame_archive_capacity": eng.frame_cap,
        "fps": round(fps, 3),
        "ms_per_frame": round(1000.0 * elapsed / timed, 2),
        "ate_rmse_cm": round(rmse * 100, 3),
        "valid_frames": int(n_valid),
        "pairs_dropped": eng.pairs_dropped_total,
        "lost_count": eng.lost_count,
        "compile_s": round(t_compile, 1),
        "reint_frames": eng.reint_frames,
        "reint_ops": eng.reint_ops_total,
        "corr_count": int(eng.glob.corrs.count),
        "corr_capacity": int(eng.glob.corrs.capacity),
        "stage_ms": {
            k: round(1000.0 * v, 2)
            for k, v in eng.timing.averages().items()
            if k.startswith("time_")
        },
    }
    print(json.dumps(out))
    assert out["pairs_dropped"] == 0, "silent pair-cap overflow at capacity!"


if __name__ == "__main__":
    main()

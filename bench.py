"""Benchmark: end-to-end frames/s on one GPU + ATE RMSE on a synthetic sequence.

    python bench.py

Needs a GPU (there is no CPU configuration). Prints the device and the
card's name and power limit, then ONE JSON line:
  {"metric": ..., "value": fps, "unit": "frames/s", "vs_baseline": fps/30, ...}

Baseline: the reference BundleFusion targets 30 Hz real-time on two desktop
GPUs (BASELINE.md); vs_baseline is measured fps / 30.

The workload mirrors the reference's default operating point (BASELINE.md):
640x480 input & SIFT, 320x240 integration + per-frame raycast (the reference
renders every frame, DepthSensing.cpp:1066-1068), submap size 10, ~150
features per frame, 1 cm voxels — on a synthetic scene rendered with
ground-truth poses so ATE RMSE is measured in the same run.

Timing protocol: ``engine.warmup()`` compiles + executes EVERY program
against dummy state before any timed frame; compile time is reported
separately as ``compile_s``, per-stage means under ``stage_ms``.
"""

import json
import time


def main():
    import jax

    from bundlefusion_tpu.utils.device import device_summary, nvidia_smi_name_power, require_gpu

    device = device_summary(require_gpu())
    print(f"device: {json.dumps(device)}", flush=True)
    print(nvidia_smi_name_power(), flush=True)

    from bundlefusion_tpu import AppConfig, BundlingConfig
    from bundlefusion_tpu.io.synthetic import default_intrinsics, make_sequence
    from bundlefusion_tpu.ops.sift import SiftConfig
    from bundlefusion_tpu.pipeline.online import BundleFusion
    from bundlefusion_tpu.utils.metrics import evaluate_ate_rmse

    # reference operating point
    n_frames = 72
    stream_frames = 20
    profile_frames = 16
    intr = default_intrinsics(640, 480)
    app = AppConfig(
        hash_num_sdf_blocks=131072,
        hash_key_capacity=131072,
        # in-frustum blocks at 1 cm voxels / 4 m range stay well under this
        visible_blocks_cap=8192,
    )
    # right-size the corr-store capacity for the 64-keyframe run: the
    # solver's per-iteration work scales with capacity, not live count
    bundling = BundlingConfig(max_global_corr=16384)
    sift_cfg = SiftConfig(
        target_keys=150, min_scale=bundling.min_key_scale,
        depth_min=app.sensor_depth_min, depth_max=app.sensor_depth_max,
    )
    max_keyframes = 64
    warmup_frames = 12

    total_frames = n_frames + stream_frames + profile_frames
    seq = make_sequence(total_frames, intr=intr)
    eng = BundleFusion(intr, app, bundling, sift_cfg=sift_cfg, max_keyframes=max_keyframes)

    # Pre-stage all input frames on device (the SensorDataReader
    # RGBDFrameCacheRead prefetch analog, SensorDataReader.cpp:38-124).
    handles = [
        eng.upload_frame(seq["depth"][i], seq["color"][i])
        for i in range(total_frames)
    ]
    jax.block_until_ready(handles)

    # compile + execute every program on throwaway state, OUTSIDE the timed
    # window; then run a few real frames so steady-state caches settle.
    compile_s = eng.warmup()
    for i in range(warmup_frames):
        eng.process_frame(handles[i])
    jax.block_until_ready((eng.local, eng.glob, eng.table))

    reint_before = (eng.reint_frames, eng.reint_ops_total)
    t0 = time.perf_counter()
    for i in range(warmup_frames, n_frames):
        eng.process_frame(handles[i])
    jax.block_until_ready((eng.local, eng.glob, eng.table))  # drain in-flight work
    elapsed = time.perf_counter() - t0
    timed = n_frames - warmup_frames
    fps = timed / elapsed
    reint_timed = (
        eng.reint_frames - reint_before[0],
        eng.reint_ops_total - reint_before[1],
    )

    # device-time attribution (CUDATimer analog): replay the next frames
    # SERIALIZED — block_until_ready between stage dispatches — so each
    # stage's device execution time is measured. Runs AFTER the timed
    # window so it cannot perturb the fps number.
    eng.profile_every = 1
    # first half: re-integration DEFERRED so the replay is guaranteed to
    # sample the PLAIN tsdf path (on a drifting tail every frame otherwise
    # spends its reint budget and the plain path gets zero samples);
    # second half: normal, sampling the rows path
    half = n_frames + profile_frames // 2
    orig_rows = eng._build_reintegrate_rows
    eng._build_reintegrate_rows = lambda: []
    for i in range(n_frames, half):
        eng.process_frame(handles[i])  # prestaged: no transfer in-stage
    eng._build_reintegrate_rows = orig_rows
    for i in range(half, n_frames + profile_frames):
        eng.process_frame(handles[i])
    eng.profile_every = 0

    # ---- steady-state streaming-input window: frame i+1's 1.5 MB wire
    # upload runs CONCURRENTLY with frame i's compute — the sensor-rate
    # ingest the pre-staged window does not exercise. Same engine, same
    # sequence continuation.
    s0, s1 = n_frames + profile_frames, total_frames
    t0 = time.perf_counter()
    nxt = eng.upload_frame(seq["depth"][s0], seq["color"][s0])
    for i in range(s0, s1):
        cur = nxt
        if i + 1 < s1:
            nxt = eng.upload_frame(seq["depth"][i + 1], seq["color"][i + 1])
        eng.process_frame(cur)
    jax.block_until_ready((eng.local, eng.glob, eng.table))
    fps_streaming = stream_frames / (time.perf_counter() - t0)

    eng.finish(extra_solves=2)
    traj = eng.trajectory()
    rmse, n_valid = evaluate_ate_rmse(traj, seq["poses"][: len(traj)])

    stage_ms = {
        k: round(1000.0 * v, 2)
        for k, v in eng.timing.averages().items()
        if k.startswith("time_")
    }
    # per-stage DEVICE times from the serialized replay frames (each
    # stage syncs exactly once). The TSDF samples are split by path — dev_tsdf is the PLAIN fast path,
    # dev_tsdf_rows the re-integration rows path — so the per-frame
    # estimate below is a plain frame plus the measured reint share, not
    # an average polluted by the larger rows dispatches
    dev_avg = dict(eng.device_timing.averages())
    sub_len = eng.S - 1
    stage_dev_ms = {k: round(1000.0 * v, 2) for k, v in dev_avg.items()}
    dev_plain_ms = sum(
        v * (1.0 / sub_len if k == "dev_submap" else 1.0)
        for k, v in dev_avg.items()
        if k != "dev_tsdf_rows"
    ) * 1000.0
    reint_share = reint_timed[0] / max(timed, 1)
    dev_frame_ms = dev_plain_ms + reint_share * 1000.0 * max(
        dev_avg.get("dev_tsdf_rows", 0.0) - dev_avg.get("dev_tsdf", 0.0), 0.0
    )
    out = {
        "metric": "frames_per_second_per_chip",
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / 30.0, 4),
        "ate_rmse_cm": round(rmse * 100, 3),
        "valid_frames": int(n_valid),
        "total_frames": total_frames,
        "platform": device["platform"],
        "device": device,
        "ms_per_frame": round(1000.0 * elapsed / timed, 2),
        "compile_s": round(compile_s, 1),
        "stage_ms": stage_ms,
        "stage_dev_ms": stage_dev_ms,
        "dev_frame_plain_ms": round(dev_plain_ms, 2),
        "dev_frame_ms": round(dev_frame_ms, 2),
        "ms_per_frame_streaming": round(1000.0 / fps_streaming, 2),
        "fps_streaming": round(fps_streaming, 2),
        # silent-cap accounting: must stay 0 for an exact global solve
        "pairs_dropped": eng.pairs_dropped_total,
        "tsdf_row_overflows": int(eng.table.row_overflows),
        "reint_frames": eng.reint_frames,
        "reint_ops": eng.reint_ops_total,
        # rows frames WITHIN the timed fps window
        "reint_frames_timed": reint_timed[0],
        "reint_ops_timed": reint_timed[1],
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()

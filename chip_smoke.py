"""Chip smoke test: the engine's main path once on one GPU, at full width.

    python chip_smoke.py          # one GPU: device, engine, TSDF, chip tests
    python chip_smoke.py --four   # four GPUs: sharded paths vs one device

Phases (one process; any failure exits non-zero without the "ok" line):

- device: JAX must find a GPU (no CPU fallback); prints the device and the
  card's name and power limit from ``nvidia-smi``.
- engine: the CLI (``bundlefusion_tpu.__main__.run``) on a synthetic orbit
  at the reference operating point (640x480 input and SIFT, 320x240
  integration, 1 cm voxels, 200 000 blocks, submap 10); checks validity,
  ATE, dropped pairs, table invariants, re-integration, a render against
  ground truth, the mesh and the output files.
- tsdf: the frustum-compacted TSDF update against the full-sweep plain
  reference on the engine's own table, for a plain frame (1 op) and a
  re-integration frame (11 ops, with de-integration and sign-0 ops), at
  the engine's row capacity and at a capacity that forces several passes.
- chip tests: the tests marked ``gpu``, run by ``pytest.main`` in-process.

The last line of standard output is one JSON object with the device.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import shutil
import time

import numpy as np

N_FRAMES = 36               # 3 submap boundaries at submap_size 10
ATE_MAX_M = 0.02            # noiseless orbit
RENDER_MAX_VOXELS = 3.0     # median |render - GT| at hit pixels
MESH_MIN_TRIANGLES = 10_000
TSDF_ATOL = 1e-6            # sdf/color vs the full sweep; weights bitwise
MULTI_PASS_CAP = 512        # rows per pass below the active count: several passes
ROOT = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, flush=True)


def engine_phase(out_dir):
    """Run the CLI at full width; check the engine it returns."""
    import jax
    import jax.numpy as jnp

    from bundlefusion_tpu.__main__ import run
    from bundlefusion_tpu.io.synthetic import default_scene, orbit_trajectory, render_frame
    from bundlefusion_tpu.tsdf.table import check_invariants

    t0 = time.perf_counter()
    rc, eng = run(["--synthetic", str(N_FRAMES), "--out", out_dir])
    wall_s = time.perf_counter() - t0
    with open(os.path.join(out_dir, "processed.txt")) as fh:
        verdict = json.load(fh)
    traj = eng.trajectory()
    valid = np.isfinite(traj).all((1, 2))
    errs = check_invariants(eng.table)

    # render from the engine's own poses (its world frame is anchored at
    # frame 0) against ground-truth depth at integration resolution
    gt_poses = orbit_trajectory(N_FRAMES)
    scene = default_scene()
    render_err = []
    for k in (0, N_FRAMES // 2, N_FRAMES - 1):
        r = eng.render(traj[k])
        d = np.asarray(r["depth"])
        gt, _ = render_frame(scene, eng.intr_int, jnp.asarray(gt_poses[k]))
        gt = np.asarray(gt)
        hit = np.isfinite(d) & np.isfinite(gt)
        render_err.append(float(np.median(np.abs(d[hit] - gt[hit]))) if hit.any() else float("inf"))
    verts, _ = eng.extract_mesh()
    n_tri = int(verts.shape[0])
    voxel = eng.tsdf_params.voxel_size
    res = {
        "rc": rc,
        "frames": N_FRAMES,
        "valid_frames": int(valid.sum()),
        "ate_rmse_m": verdict.get("ate_rmse_m"),
        "pairs_dropped": eng.pairs_dropped_total,
        "invariant_errors": int(sum(errs.values())),
        "num_alloc_failures": int(eng.table.num_alloc_failures),
        "row_overflows": int(eng.table.row_overflows),
        "reint_frames": eng.reint_frames,
        "reint_ops": eng.reint_ops_total,
        "render_median_err_m": render_err,
        "mesh_triangles": n_tri,
        "files": sorted(os.listdir(out_dir)),
        "fps_cli": verdict["fps"],
        "compile_s": verdict["compile_s"],
        "wall_s": wall_s,
        "peak_bytes_in_use": (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use"),
    }
    log("engine:", json.dumps(res))
    checks = {
        "cli exit code 0": rc == 0,
        "every frame valid": res["valid_frames"] == N_FRAMES,
        f"ATE < {ATE_MAX_M} m": res["ate_rmse_m"] is not None and res["ate_rmse_m"] < ATE_MAX_M,
        "pairs_dropped == 0": res["pairs_dropped"] == 0,
        "table invariants clean": res["invariant_errors"] == 0,
        "num_alloc_failures == 0": res["num_alloc_failures"] == 0,
        "reint_ops > 0": res["reint_ops"] > 0,
        f"render median < {RENDER_MAX_VOXELS} voxels": max(render_err) < RENDER_MAX_VOXELS * voxel,
        f"mesh > {MESH_MIN_TRIANGLES} triangles": n_tri > MESH_MIN_TRIANGLES,
        "processed.txt and .ply written": {"processed.txt", "synthetic.ply"} <= set(res["files"]),
    }
    for name, ok in checks.items():
        log(f"  [{'ok' if ok else 'FAIL'}] {name}")
    program_memory(eng)
    return eng, all(checks.values())


def program_memory(eng):
    """``compiled.memory_analysis()`` of each engine program (set-up fact)."""
    i32 = eng._i32
    T, v = eng._dev_eye, eng._dev_true
    d = np.zeros((eng.intr_input.height, eng.intr_input.width), np.uint16)
    c = np.zeros(d.shape + (3,), np.uint8)
    programs = {
        "frame_step": (eng._frame_step, (d, c, eng.local, eng.store, T, i32(0), i32(0))),
        "tsdf_fast": (eng._tsdf_fast, (eng.table, eng.store, i32(0), T, v)),
        "tsdf_rows": (eng._tsdf_rows, (eng.table, eng.store, np.zeros((5, 34), np.float32), i32(0), T, v)),
        "gc": (eng._gc, (eng.table,)),
        "render": (eng._render, (eng.table, T)),
        "submap_step": (eng._submap_step, (eng.local, eng.glob, eng.kf_valid_dev, i32(1), T, T)),
    }
    for name, (fn, args) in programs.items():
        m = fn.lower(*args).compile().memory_analysis()
        log(f"  memory {name}: args={m.argument_size_in_bytes} out={m.output_size_in_bytes} "
            f"temp={m.temp_size_in_bytes} alias={m.alias_size_in_bytes} code={m.generated_code_size_in_bytes}")


def reintegration_ops(eng, n_ops):
    """An op batch over the engine's archived frames at its own poses: one
    fuse (``n_ops`` = 1), or 5 re-integration rows (de-integrate at the
    integrated pose, integrate 2 mm away; one row sign 0) plus the newest
    frame's fuse (``n_ops`` = 11)."""
    import jax.numpy as jnp

    from bundlefusion_tpu.pipeline.frames import decode_frame

    traj = eng.trajectory()
    last = len(traj) - 1
    if n_ops == 1:
        frames, poses, signs = [last], [traj[last]], [1.0]
    else:
        rows = np.linspace(0, last - 1, 5).astype(int)
        frames, poses, signs = [], [], []
        for r, f in enumerate(rows):
            moved = traj[f].copy()
            moved[:3, 3] += 0.002
            frames += [f, f]
            poses += [traj[f], moved]
            signs += [0.0, 0.0] if r == 2 else [-1.0, 1.0]
        frames.append(last)
        poses.append(traj[last])
        signs.append(1.0)
    uniq = sorted(set(frames))
    dc = [decode_frame(eng.store.depth_mm[f], eng.store.color[f]) for f in uniq]
    depths = jnp.stack([d for d, _ in dc])
    colors = jnp.stack([c for _, c in dc])
    img = jnp.asarray([uniq.index(f) for f in frames], jnp.int32)
    return depths, colors, jnp.asarray(np.stack(poses)), jnp.asarray(signs, jnp.float32), img


def tsdf_phase(eng):
    """Compacted TSDF update vs the full sweep on the engine's table, in
    passes of the engine's row capacity and in passes of MULTI_PASS_CAP
    rows (several passes per batch)."""
    from bundlefusion_tpu.tsdf.apply_ops import compare_with_reference

    ok = True
    for n_ops in (1, 11):
        ops = reintegration_ops(eng, n_ops)
        for cap in (eng.vis_cap, MULTI_PASS_CAP):
            r = compare_with_reference(eng.table, *ops, eng.intr_int, eng.tsdf_params, cap)
            passed = (
                r["weight_mismatch"] == 0 and r["sdf_max_abs"] <= TSDF_ATOL
                and r["color_max_abs"] <= TSDF_ATOL and r["outside_changed"] == 0
                and r["rows_updated"] > 0
                and (cap == eng.vis_cap or r["row_overflows"] == 1)
            )
            log(f"tsdf OPS={n_ops} cap={cap}: {json.dumps(r)} [{'ok' if passed else 'FAIL'}]")
            ok = ok and passed
    return ok


class _Outcomes:
    """pytest plugin: counts the outcome of every test call."""

    def __init__(self):
        self.counts = {}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] = self.counts.get(report.outcome, 0) + 1


def chip_tests_phase():
    """The ``gpu``-marked tests, in this process: all must run and pass.

    Only the files that hold such tests are collected: the others import
    ``tests.*`` helpers, which an installed package named ``tests`` can
    shadow when pytest runs inside another program."""
    from pathlib import Path

    import pytest

    files = [str(f) for f in sorted(Path(ROOT, "tests").glob("test_*.py"))
             if "mark.gpu" in f.read_text()]
    seen = _Outcomes()
    rc = pytest.main([*files, "-q", "-m", "gpu", "-p", "no:cacheprovider"],
                     plugins=[seen])
    log(f"chip tests: pytest exit code {int(rc)}, outcomes {seen.counts}")
    return int(rc) == 0 and seen.counts.get("passed", 0) > 0 and set(seen.counts) == {"passed"}


def four_phase(devices):
    import __graft_entry__
    from bundlefusion_tpu import AppConfig, BundlingConfig
    from bundlefusion_tpu.io.synthetic import default_intrinsics

    n_dev = len(devices)
    engine = dict(
        intr=default_intrinsics(640, 480), app=AppConfig(),
        bundling=BundlingConfig(), sift_cfg=None,
        max_keyframes=2 * n_dev, n_frames=N_FRAMES,
        tol_traj_m=1e-3, tol_ate_m=ATE_MAX_M,
    )
    __graft_entry__.multichip_check(devices, 256, 1 << 20, engine, log=log)
    return True


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded phase")
    args = ap.parse_args(argv)

    from bundlefusion_tpu.utils.device import device_summary, nvidia_smi_name_power, require_gpu

    devices = require_gpu()
    dev = device_summary(devices)
    log(f"device: platform={dev['platform']} kind={dev['kind']} count={dev['count']}")
    log(nvidia_smi_name_power())

    if args.four:
        if len(devices) < 4:
            raise RuntimeError(f"--four needs 4 GPUs, JAX found {len(devices)}")
        devices = devices[:4]
        ok = four_phase(devices)
        dev = device_summary(devices)
    else:
        out_dir = os.path.join(ROOT, "build", "chip_smoke")
        shutil.rmtree(out_dir, ignore_errors=True)
        eng, ok = engine_phase(out_dir)
        ok = tsdf_phase(eng) and ok
        del eng
        gc.collect()
        ok = chip_tests_phase() and ok
    if not ok:
        log("chip smoke FAILED")
        return 1
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Tests that need a GPU (marker ``gpu``; they skip elsewhere).

Run on the card by ``python chip_smoke.py``, or alone with
``python -m pytest tests/test_gpu.py -m gpu``. The TSDF update is checked
against the full-sweep plain reference at the reference operating point:
1 cm voxels, 320x240 integration, a 200 000-block table.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from bundlefusion_tpu.config import AppConfig
from bundlefusion_tpu.io.synthetic import default_intrinsics, make_sequence
from bundlefusion_tpu.tsdf.apply_ops import apply_tsdf_ops, compare_with_reference
from bundlefusion_tpu.tsdf.integrate import TsdfParams, candidate_keys
from bundlefusion_tpu.tsdf.table import allocate_packed, create_table
from bundlefusion_tpu.utils.device import require_gpu

N_FRAMES = 6


@pytest.fixture(scope="module")
def full_width_table():
    app = AppConfig()
    intr = default_intrinsics(app.integration_width, app.integration_height)
    params = TsdfParams(
        voxel_size=app.sdf_voxel_size, truncation=app.sdf_truncation,
        truncation_scale=app.sdf_truncation_scale,
        max_integration_distance=app.sdf_max_integration_distance,
        depth_min=app.sensor_depth_min, depth_max=app.sensor_depth_max,
    )
    seq = make_sequence(N_FRAMES, intr=intr)
    depths = jnp.asarray(seq["depth"])
    colors = jnp.asarray(seq["color"])
    poses = jnp.asarray(seq["poses"])
    table = create_table(app.hash_key_capacity, app.hash_num_sdf_blocks)
    for i in range(N_FRAMES):
        table = allocate_packed(table, candidate_keys(depths[i], intr, poses[i], params))
        table = apply_tsdf_ops(
            table, depths[i:i + 1], colors[i:i + 1], poses[i:i + 1],
            jnp.ones(1), jnp.zeros(1, jnp.int32), intr, params,
            app.visible_blocks_cap,
        )
    return table, depths, colors, poses, intr, params


@pytest.mark.gpu
def test_require_gpu_finds_the_card(gpu):
    assert require_gpu() == gpu


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [AppConfig().visible_blocks_cap, 512])
@pytest.mark.parametrize("n_ops", [1, 11])
def test_full_width_tsdf_matches_reference(gpu, full_width_table, n_ops, cap):
    """At the configured row capacity, and at 512 rows per pass (below the
    active count, so the batch runs in several passes)."""
    table, depths, colors, poses, intr, params = full_width_table
    if n_ops == 1:
        signs, img = jnp.ones(1), jnp.asarray([N_FRAMES - 1], jnp.int32)
        op_poses = poses[-1:]
    else:
        # five rows: de-integrate, re-integrate 2 mm away (row 2 sign 0),
        # then the newest frame's fuse
        rows = np.arange(5)
        moved = np.asarray(poses[:5]).copy()
        moved[:, :3, 3] += 0.002
        op_poses = jnp.asarray(np.concatenate(
            [np.stack([np.asarray(poses[:5]), moved], 1).reshape(10, 4, 4),
             np.asarray(poses[-1:])]))
        s = np.tile([-1.0, 1.0], 5)
        s[4:6] = 0.0
        signs = jnp.asarray(np.append(s, 1.0), jnp.float32)
        img = jnp.asarray(np.append(np.repeat(rows, 2), N_FRAMES - 1), jnp.int32)
    r = compare_with_reference(table, depths, colors, op_poses, signs, img,
                               intr, params, cap)
    assert r["rows_updated"] > 0, r
    assert r["row_overflows"] == int(r["rows_active"] > cap), r
    assert r["weight_mismatch"] == 0, r
    assert r["sdf_max_abs"] <= 1e-6 and r["color_max_abs"] <= 1e-6, r
    assert r["outside_changed"] == 0, r

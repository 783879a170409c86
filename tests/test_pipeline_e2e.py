"""End-to-end pipeline test on a tiny synthetic sequence.

The analog of the reference's built-in evaluation (run a sequence,
check ATE RMSE + mesh exists — SURVEY.md §4). Tiny shapes keep the CPU
run tractable; ``chip_smoke.py`` runs full resolution on the GPU.
"""

import numpy as np
import pytest

from bundlefusion_tpu.config import AppConfig, BundlingConfig
from bundlefusion_tpu.io.synthetic import default_intrinsics, make_sequence
from bundlefusion_tpu.ops.sift import SiftConfig
from bundlefusion_tpu.pipeline.online import BundleFusion
from bundlefusion_tpu.utils.metrics import evaluate_ate_rmse

N_FRAMES = 9


@pytest.fixture(scope="module")
def engine_run():
    intr = default_intrinsics(160, 120)
    seq = make_sequence(N_FRAMES, intr=intr)
    app = AppConfig(
        integration_width=80,
        integration_height=60,
        sdf_voxel_size=0.03,
        sdf_truncation=0.09,
        hash_num_sdf_blocks=8192,
        hash_key_capacity=16384,
        visible_blocks_cap=8192,
        alloc_max_new_blocks_per_frame=8192,
    )
    bundling = BundlingConfig(
        width_sift=160,
        height_sift=120,
        submap_size=4,
        downsampled_width=40,
        downsampled_height=30,
        max_local_corr=2048,
        max_global_corr=8192,
        min_num_matches_local=4,
        min_num_matches_global=4,
    )
    sift_cfg = SiftConfig(
        num_octaves=3,
        target_keys=96,
        max_candidates_per_octave=256,
        min_scale=1.0,
        dog_thresh=0.004,
    )
    eng = BundleFusion(intr, app, bundling, sift_cfg=sift_cfg, max_keyframes=8)
    results = []
    for i in range(N_FRAMES):
        out = eng.process_frame(seq["depth"][i], seq["color"][i])
        results.append(out)
    eng.finish(extra_solves=1)
    return eng, seq, results


def test_tracking_stays_valid(engine_run):
    eng, seq, results = engine_run
    valids = [r["valid"] for r in results]
    assert all(valids), valids


def test_ate_rmse(engine_run):
    eng, seq, results = engine_run
    traj = eng.trajectory()
    rmse, n = evaluate_ate_rmse(traj, seq["poses"][: len(traj)])
    assert n >= N_FRAMES - 2
    # tiny-res synthetic: expect a few cm accuracy
    assert rmse < 0.06, rmse


def test_map_nonempty_and_renders(engine_run):
    import jax.numpy as jnp

    from bundlefusion_tpu.tsdf.table import num_occupied

    eng, seq, results = engine_run
    assert int(num_occupied(eng.table)) > 50
    out = eng.render(eng.trajectory()[0])  # engine world frame anchor
    d = np.asarray(out["depth"])
    gt = seq["depth"][0][::2, ::2]  # render is at integration res
    both = np.isfinite(d) & np.isfinite(gt)
    assert both.mean() > 0.3
    err = np.abs(d[both] - gt[both])
    assert np.median(err) < 0.05


def test_mesh_extraction(engine_run):
    eng, seq, results = engine_run
    verts, cols = eng.extract_mesh()
    assert verts.shape[0] > 100
    assert np.isfinite(verts).all()

"""End-to-end verify drive (the .claude/skills/verify recipe, CPU shapes)."""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.2")

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from bundlefusion_tpu import AppConfig, BundlingConfig
from bundlefusion_tpu.io.synthetic import default_intrinsics, make_sequence
from bundlefusion_tpu.ops.sift import SiftConfig
from bundlefusion_tpu.pipeline.online import BundleFusion
from bundlefusion_tpu.tsdf.table import check_invariants
from bundlefusion_tpu.utils.metrics import evaluate_ate_rmse

intr = default_intrinsics(160, 120)
seq = make_sequence(9, intr=intr)
app = AppConfig(integration_width=80, integration_height=60, sdf_voxel_size=0.03,
                sdf_truncation=0.09, hash_num_sdf_blocks=8192, hash_key_capacity=16384,
                visible_blocks_cap=8192)
bund = BundlingConfig(width_sift=160, height_sift=120, submap_size=4,
                      downsampled_width=40, downsampled_height=30,
                      max_local_corr=2048, max_global_corr=8192,
                      min_num_matches_local=4, min_num_matches_global=4)
sift = SiftConfig(num_octaves=3, target_keys=96, max_candidates_per_octave=256,
                  min_scale=1.0, dog_thresh=0.004)
eng = BundleFusion(intr, app, bund, sift_cfg=sift, max_keyframes=8)
for i in range(9):
    out = eng.process_frame(seq["depth"][i], seq["color"][i])
eng.finish(extra_solves=1)
traj = eng.trajectory()
rmse, n = evaluate_ate_rmse(traj, seq["poses"][:len(traj)])
print(f"ATE RMSE: {rmse*100:.3f} cm, valid {n}/9")
assert n == 9, f"not all frames valid: {n}"
assert rmse < 0.06, f"rmse too high: {rmse}"

inv = check_invariants(eng.table)
print("invariants:", inv)
assert all(v == 0 for v in inv.values()), inv
assert int(eng.table.num_alloc_failures) == 0

render = eng.render(traj[0])
d = np.asarray(render["depth"])
gt = np.asarray(seq["depth"][0])
# compare at integration res
from bundlefusion_tpu.ops.image import resample_nearest
import jax.numpy as jnp
gt_i = np.asarray(resample_nearest(jnp.asarray(gt), app.integration_height, app.integration_width))
hit = np.isfinite(d) & np.isfinite(gt_i)
err = np.abs(d[hit] - gt_i[hit])
print(f"render: {hit.sum()} hit px, median |d-gt| = {np.median(err)*100:.2f} cm")
assert hit.sum() > 1000
assert np.median(err) < 3 * app.sdf_voxel_size

verts, cols = eng.extract_mesh()
print(f"mesh: {len(verts)} verts")
assert len(verts) > 10000
print("VERIFY OK")

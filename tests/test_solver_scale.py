"""Capacity-scale solver test: the pair-reduced GN/PCG at reference-class
keyframe counts (zParametersBundlingDefault.txt:30-32 caps the global
problem at 1200 keyframes with up to ~10^6 corrs). The former [C, N]
one-hot incidence design was O(C*N) per PCG step; the pair-reduced design
is O(P*N) with P = active pairs, so a 512-pose / 49K-corr problem stays
CPU-tractable here and small in device memory."""

import numpy as np
import jax.numpy as jnp

from bundlefusion_tpu.geometry import pose_to_matrix
from bundlefusion_tpu.solver.gn_pcg import SolverParams, solve_sparse, cost
from bundlefusion_tpu.solver.residuals import CorrStore


def big_ring_graph(rng, n_frames, corrs_per_pair=16, reach=3):
    """Chain + short loop closures over n_frames poses, vectorized build."""
    gt_poses = np.zeros((n_frames, 6), np.float32)
    t = np.arange(n_frames, dtype=np.float32)
    gt_poses[:, 1] = 0.002 * t                     # slow yaw
    gt_poses[:, 3] = 0.05 * np.sin(0.05 * t)
    gt_poses[:, 4] = 0.02 * t / n_frames
    gt_poses[:, 5] = 0.05 * np.cos(0.05 * t)
    mats = np.asarray(pose_to_matrix(jnp.asarray(gt_poses)))

    pairs = []
    for d in range(1, reach + 1):
        i = np.arange(d, n_frames)
        pairs.append(np.stack([i, i - d], -1))
    pairs = np.concatenate(pairs)                  # [P, 2] (i > j)
    P = len(pairs)
    world = rng.uniform(-1, 1, size=(P, corrs_per_pair, 3)).astype(np.float32)
    world[..., 2] += 2.0
    Ti = mats[pairs[:, 0]]
    Tj = mats[pairs[:, 1]]
    inv = np.linalg.inv
    p_i = np.einsum("pab,pcb->pca", inv(Ti)[:, :3, :3], world) + inv(Ti)[:, None, :3, 3]
    p_j = np.einsum("pab,pcb->pca", inv(Tj)[:, :3, :3], world) + inv(Tj)[:, None, :3, 3]
    C = P * corrs_per_pair
    store = CorrStore(
        img_i=jnp.asarray(np.repeat(pairs[:, 0], corrs_per_pair).astype(np.int32)),
        img_j=jnp.asarray(np.repeat(pairs[:, 1], corrs_per_pair).astype(np.int32)),
        p_i=jnp.asarray(p_i.reshape(C, 3)),
        p_j=jnp.asarray(p_j.reshape(C, 3)),
        key_i=jnp.zeros((C,), jnp.int32),
        key_j=jnp.zeros((C,), jnp.int32),
        count=jnp.asarray(C, jnp.int32),
    )
    return gt_poses, store


def test_solve_512_keyframes_converges():
    rng = np.random.default_rng(0)
    N = 512
    gt, store = big_ring_graph(rng, N)
    # perturb
    init = gt + rng.normal(size=gt.shape).astype(np.float32) * 0.01
    init[0] = gt[0]
    params = SolverParams(num_gn=3, num_pcg=60, max_pairs=2048)
    poses, stats = solve_sparse(
        jnp.asarray(init), jnp.ones((N,), bool), store, params
    )
    assert int(stats.num_pairs_dropped) == 0
    c0 = float(cost(jnp.asarray(init), store))
    c1 = float(stats.final_cost)
    assert c1 < 1e-3 * c0, (c0, c1)
    # poses return to GT up to the gauge (frame 0 fixed in both)
    err = np.abs(np.asarray(poses) - gt)
    assert err.max() < 5e-3


def test_pair_overflow_accounted():
    rng = np.random.default_rng(1)
    N = 64
    gt, store = big_ring_graph(rng, N)
    params = SolverParams(num_gn=1, num_pcg=10, max_pairs=32)
    _, stats = solve_sparse(jnp.asarray(gt), jnp.ones((N,), bool), store, params)
    assert int(stats.num_pairs_dropped) > 0

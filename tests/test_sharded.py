"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bundlefusion_tpu.geometry import matrix_to_pose, pose_to_matrix
from bundlefusion_tpu.parallel.ba_sharded import (
    make_mesh,
    match_descriptors_sharded,
    shard_corrs,
    solve_sparse_sharded,
)
from bundlefusion_tpu.solver.gn_pcg import SolverParams, solve_sparse
from bundlefusion_tpu.solver.residuals import append_corrs, create_corr_store

from tests.test_solver import build_pose_graph


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_sharded_matches_single_device(rng):
    gt, store = build_pose_graph(rng)
    n = len(gt)
    gt_poses = np.stack([np.asarray(matrix_to_pose(jnp.asarray(g))) for g in gt])
    init = gt_poses.copy()
    init[1:] += rng.normal(size=(n - 1, 6)).astype(np.float32) * 0.04

    params = SolverParams(num_gn=3, num_pcg=40)
    ref, _ = solve_sparse(jnp.asarray(init), jnp.ones(n, bool), store, params)

    mesh = make_mesh()
    store_sharded = shard_corrs(store, mesh)
    out, cost = solve_sparse_sharded(
        jnp.asarray(init), jnp.ones(n, bool), store_sharded, mesh, params
    )
    assert float(cost) < 1e-5
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=2e-3)


def test_sharded_matching(rng):
    mesh = make_mesh()
    G, K = 16, 32
    desc = rng.normal(size=(G, K, 128)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh, P("shard"))
    m = match_descriptors_sharded(
        jnp.asarray(desc[3]),
        jnp.ones(K, bool),
        jax.device_put(jnp.asarray(desc), sh),
        jax.device_put(jnp.ones((G, K), bool), sh),
        jax.device_put(jnp.ones(G, bool), sh),
        mesh,
        num_matches=16,
    )
    v = np.asarray(m.valid)
    # slot 3 matches itself exactly
    assert v[3].sum() == 16
    ii = np.asarray(m.idx_i[3])[v[3]]
    jj = np.asarray(m.idx_j[3])[v[3]]
    np.testing.assert_array_equal(ii, jj)


def test_graft_dryrun_multichip():
    import __graft_entry__

    __graft_entry__.dryrun_multichip(8)


def test_sharded_matches_single_device_realistic_scale(rng):
    """Validate the sharded solver at a realistic
    problem size — a keyframe graph (>= 160 keyframes,
    >= 1e5 live corrs) solved on the 8-device virtual mesh must agree with
    the single-device solve, with zero dropped pairs."""
    G = 160
    per_pair = 30
    # loop-dense pose graph: local chain + periodic loop closures into the
    # anchor region (the capacity-regime pair structure)
    t = np.arange(G) * 0.05
    gt = np.zeros((G, 6), np.float32)
    gt[:, 1] = 0.02 * t
    gt[:, 3] = np.cos(0.2 * t)
    gt[:, 4] = np.sin(0.2 * t)
    Tm = np.asarray(pose_to_matrix(jnp.asarray(gt)))

    pairs = []
    for i in range(1, G):
        for j in range(max(0, i - 4), i):
            pairs.append((i, j))
        if i > 28:
            for j in rng.choice(i - 20, size=min(24, i - 20), replace=False):
                pairs.append((i, int(j)))
    pairs = sorted(set(pairs))
    n_corrs = len(pairs) * per_pair
    assert n_corrs >= 1e5  # realistic-scale bar

    cap = 1 << 17  # 131072 — divisible by the 8-device mesh
    store = create_corr_store(cap)
    ii, jj, pi, pj = [], [], [], []
    for (a, b) in pairs:
        world = rng.uniform(-1, 1, size=(per_pair, 3)).astype(np.float32)
        world[:, 2] += 2.0
        Ta, Tb = np.linalg.inv(Tm[a]), np.linalg.inv(Tm[b])
        ii.append(np.full(per_pair, a, np.int32))
        jj.append(np.full(per_pair, b, np.int32))
        pi.append(world @ Ta[:3, :3].T + Ta[:3, 3])
        pj.append(world @ Tb[:3, :3].T + Tb[:3, 3])
    store = append_corrs(
        store,
        jnp.asarray(np.concatenate(ii)),
        jnp.asarray(np.concatenate(jj)),
        jnp.asarray(np.concatenate(pi).astype(np.float32)),
        jnp.asarray(np.concatenate(pj).astype(np.float32)),
        jnp.ones(len(pairs) * per_pair, bool),
    )
    assert int(store.count) == n_corrs

    init = gt.copy()
    init[1:] += rng.normal(size=(G - 1, 6)).astype(np.float32) * 0.01
    init = jnp.asarray(init)
    kv = jnp.ones((G,), bool)
    params = SolverParams(num_gn=3, num_pcg=60, max_pairs=1 << 14)

    ref, stats = solve_sparse(init, kv, store, params)
    assert int(stats.num_pairs_dropped) == 0

    mesh = make_mesh()
    store_sharded = shard_corrs(store, mesh)
    out, cost = solve_sparse_sharded(init, kv, store_sharded, mesh, params)
    # both recover ground truth; agreement to solver tolerance
    err_ref = np.abs(np.asarray(ref) - gt).max()
    err_sh = np.abs(np.asarray(out) - gt).max()
    assert err_ref < 2e-3, err_ref
    assert err_sh < 2e-3, err_sh
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=3e-3)

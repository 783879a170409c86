"""Multi-chip sharded bundle adjustment + matching.

The reference's only "multi-device" story is two GPUs in one process with
cudaMemcpy (``DualGPU.h``). This design scales the *global* problem over a
device mesh (keyframe chunks and correspondences partitioned over devices,
per-device reduced-system partials combined with XLA collectives):

- **Correspondence sharding (BA)**: the EntryJ store is sharded along the
  corr axis; poses are replicated. Each device sorts ITS corr shard by pair
  id and segment-sums it into per-pair 12x12 JtJ blocks / 12-vector Jtr —
  the O(C) work, embarrassingly parallel. The tiny per-pair blocks
  (~156 floats per pair) are ``all_gather``-ed ONCE per GN iteration; the
  PCG inner loop then runs fully REPLICATED on the gathered reduced system
  with ZERO collectives per iteration. Because the reference's 3D-3D
  sparse energy has NO landmark variables
  (``SolverBundlingEquationsLie.h:42-57``), the "distributed Schur
  complement" reduces to concatenating per-device pair-block partials —
  one small all-gather per GN iteration (a pair split across a
  shard boundary simply contributes two additive blocks).
- **Keyframe sharding (matching)**: previous keyframes' descriptors are
  sharded across devices; the current keyframe is replicated; each device
  runs the matmul matcher against its shard (embarrassingly parallel).

Single-chip ``solver.gn_pcg.solve_sparse`` and this module share the same
math (``build_sparse_pair_system`` / ``make_pair_seg`` segment reductions /
the PCG body); this module wraps the stages in ``shard_map`` over a 1-D
mesh.

All O(C) work happens before the one gather per GN iteration, so the PCG
iterations need no collective (a psum-ed scatter-add J/JT rebuild per PCG
iteration would add O(C) work and a collective to every linear step).
Scaling on GPUs is not measured.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bundlefusion_tpu.solver.gn_pcg import (
    SolverParams,
    _gather_poses,
    _jac_batch,
    _pair_matvec_f32,
    _pair_precond,
    _pair_rhs,
    _res_batch,
    build_sparse_pair_system,
    make_pair_seg,
    sort_corrs_by_pair,
)
from bundlefusion_tpu.solver.residuals import CorrStore


def make_mesh(devices=None, axis: str = "shard") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def shard_corrs(corrs: CorrStore, mesh: Mesh, axis: str = "shard") -> CorrStore:
    """Place the corr store sharded along the corr axis (capacity must be
    divisible by the mesh size)."""
    sh = NamedSharding(mesh, P(axis))
    return CorrStore(
        img_i=jax.device_put(corrs.img_i, sh),
        img_j=jax.device_put(corrs.img_j, sh),
        p_i=jax.device_put(corrs.p_i, sh),
        p_j=jax.device_put(corrs.p_j, sh),
        key_i=jax.device_put(corrs.key_i, sh),
        key_j=jax.device_put(corrs.key_j, sh),
        count=jax.device_put(corrs.count, NamedSharding(mesh, P())),
    )


def _pair_gather_gn(poses, free_f, sc, axis: str, params: SolverParams, w_sqrt):
    """The shared per-device GN/PCG body: per-shard pair-system build
    (``build_sparse_pair_system`` over the device's SortedCorrs) ->
    all_gather of the per-pair blocks -> replicated PCG. Called inside a
    shard_map region; returns (poses, dropped_local)."""
    N = poses.shape[0]

    # static pair->pose structure, gathered once per solve (a pair whose
    # corrs straddle a shard boundary appears twice; its two partial
    # blocks are additive through the segment reductions). The gathered
    # list is only per-shard sorted, so the i-side needs its own perm.
    pair_i_g = jax.lax.all_gather(sc.pair_i, axis, tiled=True)
    pair_j_g = jax.lax.all_gather(sc.pair_j, axis, tiled=True)
    pair_v_g = jax.lax.all_gather(sc.pair_valid, axis, tiled=True)
    ps = make_pair_seg(pair_i_g, pair_j_g, pair_v_g, N, assume_sorted_i=False)

    def gn_iter(it, carry):
        poses, done = carry
        # O(C/n_dev) per-shard: residuals + exact Jacobians + sorted
        # segment-sum into per-pair blocks
        H, b = build_sparse_pair_system(poses, sc, w_sqrt)
        # THE one collective per GN iteration: [P_local, 156] blocks
        Hg = jax.lax.all_gather(H, axis, tiled=True)      # [P_tot,12,12]
        bg = jax.lax.all_gather(b, axis, tiled=True)      # [P_tot,12]

        rhs = -_pair_rhs(bg, ps, N) * free_f
        Pm = _pair_precond(Hg, ps, N) + jnp.eye(6) * 1e-6
        P_inv = jnp.linalg.inv(Pm)

        def apply_P(x):
            return jnp.einsum("nij,nj->ni", P_inv, x) * free_f

        def A(x):
            return _pair_matvec_f32(Hg, ps, x * free_f) * free_f

        # PCG, fully replicated on the reduced system: no collectives
        x0 = jnp.zeros_like(poses)
        r0 = rhs
        z0 = apply_P(r0)
        rz0 = jnp.sum(r0 * z0)

        def pcg_body(state):
            k, x, rr, z, p, rz = state
            Ap = A(p)
            pAp = jnp.sum(p * Ap)
            alpha = jnp.where(jnp.abs(pAp) > 1e-20, rz / pAp, 0.0)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z = apply_P(rr)
            rz_new = jnp.sum(rr * z)
            beta = jnp.where(jnp.abs(rz) > 1e-20, rz_new / rz, 0.0)
            return k + 1, x, rr, z, z + beta * p, rz_new

        def pcg_cond(state):
            k, x, rr, z, p, rz = state
            return (k < params.num_pcg) & (jnp.abs(rz) > params.pcg_early_out)

        _, delta, *_ = jax.lax.while_loop(
            pcg_cond, pcg_body, (jnp.asarray(0), x0, r0, z0, z0, rz0)
        )
        max_delta = jnp.max(jnp.abs(delta))
        poses = jnp.where(done, poses, poses + delta * free_f)
        done = done | (max_delta < params.gn_early_out_delta)
        return poses, done

    poses, _ = jax.lax.fori_loop(
        0, params.num_gn, gn_iter, (poses, jnp.asarray(False))
    )
    return poses, sc.dropped


def make_replicated_chunk_solver(
    mesh: Mesh,
    num_frames: int,
    capacity: int,
    params: SolverParams = SolverParams(),
    axis: str = "shard",
):
    """Sharded-COMPUTE solver over a REPLICATED corr store, callable inside
    an outer jit (the engine's mesh boundary program).

    The global EntryJ store is small (~10 MB at reference capacity), so the
    multi-chip engine keeps it replicated; each device slices its static
    1/n chunk of the corr axis by ``axis_index``, builds the per-pair
    blocks for its chunk, and the reduced system is all_gather-combined as
    in :func:`solve_sparse_sharded`. Returns
    ``solve(poses, pose_valid, corrs) -> (poses, dropped)``.
    """
    n_dev = int(mesh.shape[axis])
    assert capacity % n_dev == 0, (capacity, n_dev)
    Cl = capacity // n_dev
    # per-shard pair capacity: a contiguous corr chunk can hold MORE distinct
    # pairs than a 1/n share of the global budget (skewed corr counts); the
    # true bound is the chunk's corr count, so min(max_pairs, Cl) guarantees
    # no shard drops a pair the single-device solve (cap = max_pairs total)
    # would keep
    P_local = min(params.max_pairs, Cl)
    w_sqrt = jnp.sqrt(jnp.asarray(params.sparse_weight, jnp.float32))
    N = num_frames

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def run(poses, free_f, img_i, img_j, p_i, p_j):
        k = jax.lax.axis_index(axis)
        start = k * Cl

        def sl(a):
            return jax.lax.dynamic_slice_in_dim(a, start, Cl, 0)

        local = CorrStore(
            img_i=sl(img_i), img_j=sl(img_j), p_i=sl(p_i), p_j=sl(p_j),
            key_i=jnp.zeros((Cl,), jnp.int32), key_j=jnp.zeros((Cl,), jnp.int32),
            count=jnp.asarray(0, jnp.int32),
        )
        sc = sort_corrs_by_pair(local, N, P_local)
        poses_out, dropped_local = _pair_gather_gn(
            poses, free_f, sc, axis, params, w_sqrt
        )
        return poses_out, jax.lax.psum(dropped_local, axis)

    def solve(poses, pose_valid, corrs: CorrStore):
        free = pose_valid & (jnp.arange(N) != 0)
        free_f = free.astype(jnp.float32)[:, None]
        return run(poses, free_f, corrs.img_i, corrs.img_j, corrs.p_i, corrs.p_j)

    return solve


def solve_sparse_sharded(
    poses,
    pose_valid,
    corrs: CorrStore,
    mesh: Mesh,
    params: SolverParams = SolverParams(),
    axis: str = "shard",
):
    """GN/PCG with corr-sharded pair-system build and a replicated PCG.

    Same semantics as ``solve_sparse`` (minus per-corr max-residual stats);
    returns (poses, final_cost). ``params.max_pairs`` is the TOTAL pair
    budget across the mesh (rounded up to a multiple of the mesh size).
    """
    N = poses.shape[0]
    n_dev = int(np.prod([mesh.shape[a] for a in (axis,)]))
    # per-shard pair capacity: bounded by the shard's corr count, not a 1/n
    # share of the pair budget (a skewed chunk could exceed its share and
    # silently drop pairs the single-device solve would keep)
    P_local = min(params.max_pairs, corrs.capacity // n_dev)
    w_sqrt = jnp.sqrt(jnp.asarray(params.sparse_weight, jnp.float32))

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(), P()),
        # outputs are replicated by construction (PCG runs on the gathered
        # reduced system, identical on every device); the varying-axis
        # checker can't infer that through the loops
        check_vma=False,
    )
    def run(poses, free_f, img_i, img_j, p_i, p_j):
        # per-shard segment structure (fixed per solve): sort the local corr
        # shard by pair id, ready for the per-GN segment-sum reduction
        local = CorrStore(
            img_i=img_i, img_j=img_j, p_i=p_i, p_j=p_j,
            key_i=jnp.zeros_like(img_i), key_j=jnp.zeros_like(img_j),
            count=jnp.asarray(0, jnp.int32),
        )
        sc = sort_corrs_by_pair(local, N, P_local)
        poses, _ = _pair_gather_gn(poses, free_f, sc, axis, params, w_sqrt)
        # final cost (global)
        v = img_i >= 0
        vf = v.astype(jnp.float32)[:, None]
        pi = _gather_poses(poses, img_i)
        pj = _gather_poses(poses, img_j)
        r = _res_batch(pi, pj, p_i, p_j) * vf
        cost = jax.lax.psum(jnp.sum(r * r), axis)
        return poses, cost

    free = pose_valid & (jnp.arange(N) != 0)
    free_f = free.astype(jnp.float32)[:, None]
    return run(poses, free_f, corrs.img_i, corrs.img_j, corrs.p_i, corrs.p_j)


def match_descriptors_sharded(
    desc_cur,
    valid_cur,
    desc_prev,
    valid_prev,
    active_prev,
    mesh: Mesh,
    axis: str = "shard",
    dist_max: float = 0.7,
    ratio_max: float = 0.8,
    num_matches: int = 128,
):
    """Current keyframe vs previous-keyframe stack, sharded over keyframes.

    desc_prev [G, K, 128] is sharded along G; the current descriptors are
    replicated. Results come back fully replicated (all_gather along G) —
    tiny ([G, M] index arrays).
    """
    from bundlefusion_tpu.ops.matching import match_descriptors_pair

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis), P(axis)),
        out_specs=P(axis),
    )
    def run(dc, vc, dp, vp, act):
        def one(slot):
            m = match_descriptors_pair(
                dc, vc, dp[slot], vp[slot], dist_max, ratio_max, num_matches
            )
            return m._replace(valid=m.valid & act[slot])

        return jax.vmap(one)(jnp.arange(dp.shape[0]))

    return run(desc_cur, valid_cur, desc_prev, valid_prev, active_prev)

"""Weighted Kabsch rigid alignment (batched, jittable).

Replaces the reference's hand-rolled device SVD + greedy Kabsch machinery
(``SiftGPU/cuda_kabsch.h:422-506``, ``cuda_svd3.h``) with a single masked
SVD-based solve on 3x3 covariances via ``jnp.linalg``; callers ``vmap`` over
image pairs. Also used for trajectory alignment in ATE RMSE
(``PoseHelper.h:35-79`` uses mLib ``EigenWrapperf::kabsch``).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from bundlefusion_tpu.geometry.lie import _rt_to_mat


def kabsch(src, dst, weights=None):
    """Best rigid transform T with T @ src ~= dst (least squares).

    Args:
      src: [N, 3] source points.
      dst: [N, 3] target points.
      weights: optional [N] nonnegative weights (zeros mask points out).

    Returns:
      (T, residual2): 4x4 transform and mean squared residual over the
      weighted points.
    """
    src = jnp.asarray(src, jnp.float32)
    dst = jnp.asarray(dst, jnp.float32)
    n = src.shape[0]
    if weights is None:
        weights = jnp.ones((n,), jnp.float32)
    # zero-weight or non-finite points must not poison the sums (0 * nan = nan)
    finite = jnp.isfinite(src).all(-1) & jnp.isfinite(dst).all(-1)
    weights = jnp.where(finite, weights, 0.0)
    src = jnp.where(weights[:, None] > 0, src, 0.0)
    dst = jnp.where(weights[:, None] > 0, dst, 0.0)
    w = weights / (jnp.sum(weights) + 1e-12)
    mu_s = jnp.sum(src * w[:, None], axis=0)
    mu_d = jnp.sum(dst * w[:, None], axis=0)
    sc = src - mu_s
    dc = dst - mu_d
    # 3x3 cross-covariance
    H = (sc * w[:, None]).T @ dc
    U, S, Vt = jnp.linalg.svd(H)
    d = jnp.sign(jnp.linalg.det(Vt.T @ U.T))
    D = jnp.diag(jnp.array([1.0, 1.0, 0.0], jnp.float32)) + jnp.diag(
        jnp.array([0.0, 0.0, 1.0], jnp.float32)
    ) * d
    R = Vt.T @ D @ U.T
    t = mu_d - R @ mu_s
    T = _rt_to_mat(R, t)
    res = dst - (src @ R.T + t)
    residual2 = jnp.sum(jnp.sum(res * res, axis=-1) * w)
    return T, residual2


def sym3_eigenvalues(A):
    """Analytic eigenvalues of symmetric 3x3 matrices [..., 3, 3], ascending.

    Trigonometric (Cardano) closed form — branch-free and batched, unlike
    LAPACK-style iterative ``eigvalsh`` which is slow for huge batches of
    tiny matrices. Used by the greedy Kabsch filter's
    condition-number checks (reference ``covarianceSVD`` eigenvalue ratios).
    """
    a00 = A[..., 0, 0]
    a11 = A[..., 1, 1]
    a22 = A[..., 2, 2]
    a01 = A[..., 0, 1]
    a02 = A[..., 0, 2]
    a12 = A[..., 1, 2]
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22) / 6.0 + (
        a01 * a01 + a02 * a02 + a12 * a12
    ) / 3.0
    p = jnp.sqrt(jnp.maximum(p2, 1e-30))
    # det(B)/2 where B = (A - qI)
    detB = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    )
    r = jnp.clip(detB / (2.0 * p * p * p), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    e2 = q + 2.0 * p * jnp.cos(phi)                       # largest
    e0 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)  # smallest
    e1 = 3.0 * q - e0 - e2
    return jnp.stack([e0, e1, e2], -1)


def kabsch_fast(src, dst, weights, num_iters: int = 16):
    """Rigid alignment via Horn's quaternion method with power iteration.

    Batched, branch-free replacement for SVD-based Kabsch inside hot loops (the
    greedy filter runs one fit per candidate per pair — thousands of tiny
    fits per frame): builds the 4x4 symmetric N-matrix from the weighted
    cross-covariance and extracts its top eigenvector (the optimal unit
    quaternion) with ``num_iters`` power iterations. Always returns a
    proper rotation (no reflection case, unlike raw SVD Kabsch).

    Returns (T 4x4, residual2 weighted mean squared error).
    """
    finite = jnp.isfinite(src).all(-1) & jnp.isfinite(dst).all(-1)
    weights = jnp.where(finite, weights, 0.0)
    src = jnp.where(weights[:, None] > 0, src, 0.0)
    dst = jnp.where(weights[:, None] > 0, dst, 0.0)
    w = weights / (jnp.sum(weights) + 1e-12)
    mu_s = jnp.sum(src * w[:, None], axis=0)
    mu_d = jnp.sum(dst * w[:, None], axis=0)
    sc = src - mu_s
    dc = dst - mu_d
    H = (sc * w[:, None]).T @ dc  # 3x3 cross-covariance
    Sxx, Sxy, Sxz = H[0, 0], H[0, 1], H[0, 2]
    Syx, Syy, Syz = H[1, 0], H[1, 1], H[1, 2]
    Szx, Szy, Szz = H[2, 0], H[2, 1], H[2, 2]
    N = jnp.array(
        [
            [Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
            [Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
            [Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy],
            [Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz],
        ]
    )
    # shift so all eigenvalues are positive and the top stays the top, then
    # square the matrix k times: M^(2^k) -> lambda_max^(2^k) v v^T, i.e.
    # 2^k power iterations for k tiny matmuls. Far faster convergence than
    # plain power iteration, whose rate the shift would destroy.
    shift = jnp.sqrt(jnp.sum(N * N)) + 1e-12
    M = N + shift * jnp.eye(4)
    M = M / jnp.sqrt(jnp.sum(M * M))

    def body(i, M):
        M = M @ M
        return M / jnp.maximum(jnp.sqrt(jnp.sum(M * M)), 1e-30)

    k_sq = max(3, int(math.ceil(math.log2(max(num_iters, 8)))) + 3)
    M = jax.lax.fori_loop(0, k_sq, body, M)
    # every column of the limit is proportional to the top eigenvector
    col_norms = jnp.sum(M * M, axis=0)
    q = M[:, jnp.argmax(col_norms)]
    q = q / jnp.maximum(jnp.linalg.norm(q), 1e-20)
    qw, qx, qy, qz = q[0], q[1], q[2], q[3]
    R = jnp.array(
        [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
            [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
            [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
        ]
    )
    t = mu_d - R @ mu_s
    T = _rt_to_mat(R, t)
    res = dst - (src @ R.T + t)
    residual2 = jnp.sum(jnp.sum(res * res, axis=-1) * w)
    return T, residual2


def kabsch_condition(src, weights=None, thresh: float = 100.0):
    """Degeneracy check of the source point set, as in the reference's
    eigenvalue-ratio condition test (``cuda_kabsch.h:381-410``,
    KABSCH_CONDITION_THRESH): ratio of largest to smallest covariance
    eigenvalue must stay below ``thresh``.

    Returns (condition_ratio, ok_bool).
    """
    src = jnp.asarray(src, jnp.float32)
    n = src.shape[0]
    if weights is None:
        weights = jnp.ones((n,), jnp.float32)
    w = weights / (jnp.sum(weights) + 1e-12)
    mu = jnp.sum(src * w[:, None], axis=0)
    c = src - mu
    cov = (c * w[:, None]).T @ c
    ev = jnp.linalg.eigvalsh(cov)
    ratio = ev[2] / jnp.maximum(ev[0], 1e-12)
    return ratio, ratio < thresh

"""so(3)/se(3) Lie-group math in pure JAX (float32 throughout).

The reference optimizes poses in Lie space (``USE_LIE_SPACE`` in
``GlobalDefines.h:12``) with hand-derived Rodrigues exp/log and analytic
derivatives (``Solver/LieDerivUtil.h:19-133``). Here the same group ops are
expressed as small jittable functions; Jacobians come from ``jax.jacfwd`` or
the closed forms in ``solver/``.

Conventions:
- a *pose* is a 6-vector ``[omega(3), t(3)]`` — axis-angle rotation + translation
  of the **matrix** ``T = [R | t]`` (i.e. t is the matrix translation, not the
  se(3) twist translation). This matches the reference's ``PoseHelper``
  convention where conversion is R = exp(omega), t stored directly
  (``LieDerivUtil.h: poseToMatrix``). We additionally provide true se(3)
  exp/log (twist) for integration/interpolation.
- matrices are 4x4 row-major float32.

All functions broadcast over leading batch dimensions via ``jax.vmap`` use.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-7


def _hat(w):
    """3-vector -> skew-symmetric 3x3."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], -1),
            jnp.stack([wz, z, -wx], -1),
            jnp.stack([-wy, wx, z], -1),
        ],
        -2,
    )


def so3_exp(w):
    """Rodrigues: axis-angle 3-vector -> 3x3 rotation. Small-angle-safe."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    # sin(t)/t and (1-cos t)/t^2 with Taylor fallbacks near 0
    small = theta2 < 1e-8
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / (theta2 + _EPS * _EPS))
    W = _hat(w)
    I = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return I + a[..., None, None] * W + b[..., None, None] * (W @ W)


def so3_log(R):
    """3x3 rotation -> axis-angle 3-vector. Handles angle near 0 and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_theta)
    # vee of the antisymmetric part
    v = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        -1,
    )
    sin_theta = jnp.sin(theta)
    # generic case: w = theta/(2 sin theta) * vee
    scale = jnp.where(
        jnp.abs(sin_theta) < 1e-5,
        0.5 + theta * theta / 12.0,  # Taylor of theta/(2 sin theta)
        theta / (2.0 * sin_theta + _EPS),
    )
    w_generic = scale[..., None] * v
    # near pi: vee ~ 0, extract axis from diagonal of (R + I)/2
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], -1)
    axis2 = jnp.clip((diag - cos_theta[..., None]) / (1.0 - cos_theta[..., None] + _EPS), 0.0, None)
    axis = jnp.sqrt(axis2 + _EPS * _EPS)
    # fix signs using off-diagonal sums (R + R^T terms)
    sx = jnp.where(R[..., 2, 1] - R[..., 1, 2] < 0, -1.0, 1.0)
    sy = jnp.where(R[..., 0, 2] - R[..., 2, 0] < 0, -1.0, 1.0)
    sz = jnp.where(R[..., 1, 0] - R[..., 0, 1] < 0, -1.0, 1.0)
    # near pi signs are ambiguous from vee; use products with largest axis comp
    m01 = R[..., 0, 1] + R[..., 1, 0]
    m02 = R[..., 0, 2] + R[..., 2, 0]
    m12 = R[..., 1, 2] + R[..., 2, 1]
    ax, ay, az = axis[..., 0], axis[..., 1], axis[..., 2]
    # choose signs consistent with the largest component positive
    sy_pi = jnp.where(m01 < 0, -1.0, 1.0)
    sz_pi = jnp.where(m02 < 0, -1.0, 1.0)
    w_pi = theta[..., None] * jnp.stack([ax, sy_pi * ay, sz_pi * az], -1)
    near_pi = jnp.abs(jnp.pi - theta) < 1e-3
    del sx, sy, sz, m12
    return jnp.where(near_pi[..., None], w_pi, w_generic)


def _so3_left_jacobian(w):
    """Left Jacobian J of SO(3): exp((J w)^) integrates the twist translation."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / (theta2 + _EPS * _EPS))
    c = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (theta2 * theta + _EPS))
    W = _hat(w)
    I = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return I + b[..., None, None] * W + c[..., None, None] * (W @ W)


def se3_exp(xi):
    """Twist 6-vector [omega, v] -> 4x4 transform (true se(3) exponential)."""
    w, v = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    t = (_so3_left_jacobian(w) @ v[..., None])[..., 0]
    return _rt_to_mat(R, t)


def se3_log(T):
    """4x4 transform -> twist 6-vector [omega, v]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    Jinv = jnp.linalg.inv(_so3_left_jacobian(w))
    v = (Jinv @ t[..., None])[..., 0]
    return jnp.concatenate([w, v], -1)


def _rt_to_mat(R, t):
    B = R.shape[:-2]
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), B + (1, 4)
    )
    top = jnp.concatenate([R, t[..., None]], -1)
    return jnp.concatenate([top, bottom], -2)


def pose_to_matrix(pose):
    """[omega, t] 6-vector -> 4x4; R = exp(omega^), translation stored directly.

    Matches the solver's pose parameterization (``LieDerivUtil.h`` poseToMatrix):
    rotation in axis-angle, translation in world units.
    """
    return _rt_to_mat(so3_exp(pose[..., :3]), pose[..., 3:])


def matrix_to_pose(T):
    """4x4 -> [omega, t] 6-vector."""
    return jnp.concatenate([so3_log(T[..., :3, :3]), T[..., :3, 3]], -1)


def pose_compose(Ta, Tb):
    """Compose two 4x4 transforms (Ta then applied after Tb): returns Ta @ Tb."""
    return Ta @ Tb


def pose_inverse(T):
    """Rigid-transform inverse without a general 4x4 solve."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    ti = -(Rt @ t[..., None])[..., 0]
    return _rt_to_mat(Rt, ti)


def transform_points(T, pts):
    """Apply 4x4 transform(s) to points [..., 3]."""
    return pts @ jnp.swapaxes(T[..., :3, :3], -1, -2) + T[..., :3, 3]


def rotate_vectors(T, vecs):
    """Apply only the rotation part of 4x4 transform(s) to vectors [..., 3]."""
    return vecs @ jnp.swapaxes(T[..., :3, :3], -1, -2)


def pose_delta(Ta, Tb, rot_scale: float = 2.0):
    """Scalar pose-change metric between two 4x4 transforms.

    Mirrors ``TrajectoryManager::generateUpdateLists`` (TrajectoryManager.cpp:66-75):
    translation distance plus rotation angle rescaled by ``rot_scale``.
    """
    dt = jnp.linalg.norm(Ta[..., :3, 3] - Tb[..., :3, 3], axis=-1)
    dR = jnp.swapaxes(Ta[..., :3, :3], -1, -2) @ Tb[..., :3, :3]
    trace = dR[..., 0, 0] + dR[..., 1, 1] + dR[..., 2, 2]
    ang = jnp.arccos(jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0))
    return dt + rot_scale * ang

"""Synthetic RGB-D sequence generation from analytic SDF scenes.

The reference is driven by recorded ``.sens`` sequences; for hermetic tests
and benches (no datasets, zero egress) we render ground-truth depth/color by
sphere-tracing an analytic signed-distance scene from known camera poses.
This provides: (a) oracle depth for TSDF integrate/raycast round-trip tests,
(b) full sequences with ground-truth trajectories for end-to-end ATE
evaluation, mirroring how the reference validates against ``.sens`` GT poses
(``SensorDataReader.cpp:168-188``).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from bundlefusion_tpu.geometry.camera import CameraIntrinsics
from bundlefusion_tpu.geometry.lie import pose_to_matrix


class Scene(NamedTuple):
    """Analytic scene: spheres + axis-aligned boxes (+ floor plane)."""

    sphere_centers: jax.Array  # [S, 3]
    sphere_radii: jax.Array    # [S]
    box_centers: jax.Array     # [B, 3]
    box_halfsizes: jax.Array   # [B, 3]
    floor_y: float             # y of floor plane (y-up negative camera convention)


def default_scene() -> Scene:
    """A room-like scene: floor + furniture-ish boxes + spheres, in front of
    the origin (cameras look along +z)."""
    return Scene(
        sphere_centers=jnp.array(
            [[0.35, 0.0, 1.9], [-0.5, 0.25, 2.3], [0.1, -0.35, 1.5]], jnp.float32
        ),
        sphere_radii=jnp.array([0.3, 0.22, 0.15], jnp.float32),
        box_centers=jnp.array(
            [[-0.45, -0.3, 1.8], [0.7, 0.35, 2.6], [0.0, 0.65, 2.2]], jnp.float32
        ),
        box_halfsizes=jnp.array(
            [[0.25, 0.25, 0.25], [0.3, 0.2, 0.3], [0.9, 0.05, 0.8]], jnp.float32
        ),
        floor_y=0.85,  # +y is down in camera frame
    )


def scene_sdf(scene: Scene, p):
    """Signed distance at world points [..., 3]."""
    d_sph = (
        jnp.linalg.norm(p[..., None, :] - scene.sphere_centers, axis=-1)
        - scene.sphere_radii
    )  # [..., S]
    q = jnp.abs(p[..., None, :] - scene.box_centers) - scene.box_halfsizes
    d_box = jnp.linalg.norm(jnp.maximum(q, 0.0), axis=-1) + jnp.minimum(
        jnp.max(q, axis=-1), 0.0
    )  # [..., B]
    d_floor = (scene.floor_y - p[..., 1])[..., None]
    return jnp.min(jnp.concatenate([d_sph, d_box, d_floor], -1), -1)


def scene_color(scene: Scene, p):
    """Cheap procedural albedo: per-object hue + position-based texture that
    gives the SIFT frontend gradients to latch on to."""
    d_sph = (
        jnp.linalg.norm(p[..., None, :] - scene.sphere_centers, axis=-1)
        - scene.sphere_radii
    )
    q = jnp.abs(p[..., None, :] - scene.box_centers) - scene.box_halfsizes
    d_box = jnp.linalg.norm(jnp.maximum(q, 0.0), axis=-1) + jnp.minimum(
        jnp.max(q, axis=-1), 0.0
    )
    d_floor = (scene.floor_y - p[..., 1])[..., None]
    dists = jnp.concatenate([d_sph, d_box, d_floor], -1)
    obj = jnp.argmin(dists, -1)
    n_obj = dists.shape[-1]
    hues = jnp.linspace(0.05, 0.95, n_obj)
    # one flat take over the flattened object ids
    hue = jnp.take(hues, obj.reshape(-1), mode="clip").reshape(obj.shape)
    base = jnp.stack([hue, 0.5 + 0.5 * jnp.cos(6.28 * hue), 1.0 - hue], -1)
    # high-frequency checker/wave texture for feature points
    tex = (
        0.5
        + 0.22 * jnp.sin(37.0 * p[..., 0]) * jnp.sin(41.0 * p[..., 1])
        + 0.18 * jnp.sin(29.0 * p[..., 2] + 3.0 * p[..., 0])
        + 0.1 * jnp.sin(113.0 * (p[..., 0] + p[..., 1] + p[..., 2]))
    )
    return jnp.clip(base * tex[..., None] + 0.15, 0.0, 1.0)


@partial(jax.jit, static_argnames=("intr", "n_steps"))
def render_frame(scene: Scene, intr: CameraIntrinsics, cam_to_world, n_steps: int = 64):
    """Sphere-trace GT (depth [H, W], color [H, W, 3]) from a camera pose."""
    H, W = intr.height, intr.width
    v = jnp.broadcast_to(jnp.arange(H, dtype=jnp.float32)[:, None], (H, W))
    u = jnp.broadcast_to(jnp.arange(W, dtype=jnp.float32)[None, :], (H, W))
    dirs_cam = jnp.stack(
        [(u - intr.cx) / intr.fx, (v - intr.cy) / intr.fy, jnp.ones_like(u)], -1
    )
    norm = jnp.linalg.norm(dirs_cam, axis=-1, keepdims=True)
    dn = dirs_cam / norm
    origin = cam_to_world[:3, 3]
    dirs_world = dn @ cam_to_world[:3, :3].T

    def body(i, carry):
        t, done = carry
        p = origin + t[..., None] * dirs_world
        d = scene_sdf(scene, p)
        hit = d < 1e-4
        done = done | hit
        t = jnp.where(done, t, t + jnp.maximum(d, 1e-4))
        return t, done

    t0 = jnp.full((H, W), 0.05, jnp.float32)
    t, done = jax.lax.fori_loop(0, n_steps, body, (t0, jnp.zeros((H, W), bool)))
    hit = done & (t < 12.0)
    p = origin + t[..., None] * dirs_world
    color = scene_color(scene, p)
    # simple lambertian-ish shading from SDF normal for realism of intensity
    eps = 1e-3
    nx = scene_sdf(scene, p + jnp.array([eps, 0, 0])) - scene_sdf(scene, p - jnp.array([eps, 0, 0]))
    ny = scene_sdf(scene, p + jnp.array([0, eps, 0])) - scene_sdf(scene, p - jnp.array([0, eps, 0]))
    nz = scene_sdf(scene, p + jnp.array([0, 0, eps])) - scene_sdf(scene, p - jnp.array([0, 0, eps]))
    n = jnp.stack([nx, ny, nz], -1)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
    light = jnp.array([0.3, -0.8, -0.52])
    shade = 0.6 + 0.4 * jnp.clip(jnp.sum(n * light, -1), 0, 1)
    color = color * shade[..., None]
    depth = jnp.where(hit, t * dn[..., 2], jnp.nan)  # z-depth
    color = jnp.where(hit[..., None], color, 0.0)
    return depth, color


def orbit_trajectory(n_frames: int, radius: float = 0.4, noise: float = 0.0, seed: int = 0):
    """Smooth camera trajectory: slight orbit + bob, looking at the scene.

    Returns [N, 4, 4] cam-to-world matrices (float32 numpy).
    """
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n_frames):
        a = 2.0 * np.pi * i / max(n_frames, 1) * 0.25  # quarter orbit
        eye = np.array(
            [radius * np.sin(a), 0.1 * np.sin(2.5 * a), -0.2 + 0.15 * np.cos(a) - 0.15],
            np.float64,
        )
        target = np.array([0.0, 0.0, 2.0])
        fwd = target - eye
        fwd /= np.linalg.norm(fwd)
        up = np.array([0.0, -1.0, 0.0])  # y-down camera
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        R = np.stack([right, up2, fwd], 1)
        if noise > 0:
            eye = eye + rng.normal(scale=noise, size=3)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = eye
        poses.append(T)
    return np.stack(poses)


def loop_trajectory(
    n_frames: int,
    radius: float = 0.55,
    seed: int = 0,
    odom_noise: float = 0.0,
):
    """Long-excursion trajectory with a REAL loop closure: the camera sweeps
    a full orbit segment away from its start and returns to (nearly) the
    starting pose in the final frames, the classic drift-then-close setup
    the reference's global BA exists for (BundleFusion paper §1; ATE
    evaluation vs GT ``PoseHelper.h:35-79``).

    Returns [N, 4, 4] cam-to-world (float32). ``odom_noise`` adds small
    per-frame pose jitter (meters) to make frame-to-frame tracking drift.
    """
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        # out-and-back angle: 0 -> pi/2 -> 0 (returns to start)
        a = np.pi / 2.0 * np.sin(np.pi * s) ** 2
        eye = np.array(
            [
                radius * np.sin(a),
                0.12 * np.sin(4.0 * np.pi * s),
                -0.35 + 0.2 * (1.0 - np.cos(a)),
            ],
            np.float64,
        )
        if odom_noise > 0:
            eye = eye + rng.normal(scale=odom_noise, size=3)
        target = np.array([0.0, 0.0, 2.0])
        fwd = target - eye
        fwd /= np.linalg.norm(fwd)
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        R = np.stack([right, up2, fwd], 1)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = eye
        poses.append(T)
    return np.stack(poses)


def make_sequence_wire(
    n_frames: int,
    intr: CameraIntrinsics | None = None,
    scene: Scene | None = None,
    poses: np.ndarray | None = None,
    noise_depth: float = 0.0,
    blackout: tuple | None = None,
    seed: int = 0,
):
    """Render a sequence directly to the engine's wire format (uint16 mm
    depth / uint8 color) to keep host memory bounded for LONG sequences
    (a 640x480 frame is 1.3 MB wire vs 4.9 MB float32).

    ``blackout``: optional (start, end) frame range rendered black/empty to
    force a tracking loss (relocalization exercise — the reference's
    retry-list machinery, SIFTImageManager.h:263-271).

    Returns dict: depth_mm [N,H,W] u16, color [N,H,W,3] u8, poses, intr.
    """
    intr = intr or default_intrinsics()
    scene = scene or default_scene()
    if poses is None:
        poses = orbit_trajectory(n_frames)
    rng = np.random.default_rng(seed)
    depths = np.zeros((n_frames, intr.height, intr.width), np.uint16)
    colors = np.zeros((n_frames, intr.height, intr.width, 3), np.uint8)
    for i in range(n_frames):
        if blackout is not None and blackout[0] <= i < blackout[1]:
            continue  # leave zeros: no depth, black image
        d, c = render_frame(scene, intr, jnp.asarray(poses[i]))
        d = np.asarray(d)
        if noise_depth > 0:
            d = d + rng.normal(scale=noise_depth, size=d.shape).astype(
                np.float32
            ) * d
        d = np.where(np.isfinite(d), d, 0.0)
        depths[i] = np.clip(d * 1000.0 + 0.5, 0, 65535).astype(np.uint16)
        colors[i] = np.clip(np.asarray(c) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return {
        "depth": depths,
        "color": colors,
        "poses": poses,
        "intrinsics": intr,
    }


def default_intrinsics(width: int = 320, height: int = 240) -> CameraIntrinsics:
    f = 0.89 * width  # ~58 deg hfov like Kinect
    return CameraIntrinsics(
        fx=f, fy=f, cx=(width - 1) / 2.0, cy=(height - 1) / 2.0, width=width, height=height
    )


def make_sequence(
    n_frames: int,
    intr: CameraIntrinsics | None = None,
    scene: Scene | None = None,
    noise_depth: float = 0.0,
    seed: int = 0,
):
    """Render a full synthetic RGB-D sequence with GT poses.

    Returns dict of numpy arrays: depth [N, H, W], color [N, H, W, 3],
    poses [N, 4, 4], intr.
    """
    intr = intr or default_intrinsics()
    scene = scene or default_scene()
    poses = orbit_trajectory(n_frames)
    rng = np.random.default_rng(seed)
    depths, colors = [], []
    for i in range(n_frames):
        d, c = render_frame(scene, intr, jnp.asarray(poses[i]))
        d = np.asarray(d)
        if noise_depth > 0:
            d = d + rng.normal(scale=noise_depth, size=d.shape).astype(np.float32) * d
        depths.append(d)
        colors.append(np.asarray(c))
    return {
        "depth": np.stack(depths),
        "color": np.stack(colors),
        "poses": poses,
        "intrinsics": intr,
    }


def multiloop_trajectory(
    n_frames: int,
    n_loops: int = 3,
    radius: float = 0.55,
    seed: int = 0,
    odom_noise: float = 0.0,
):
    """Several out-and-back excursions, each returning to (nearly) the
    start — MULTIPLE real loop closures over a long sequence (the paper's
    apt-scale scans revisit previously mapped regions repeatedly).

    Each loop sweeps a different azimuth sector so excursions map
    different parts of the scene but share the common start view (the
    loop-closure anchor). Returns [N, 4, 4] cam-to-world float32.
    """
    rng = np.random.default_rng(seed)
    poses = []
    per = n_frames / float(n_loops)
    for i in range(n_frames):
        loop = min(int(i / per), n_loops - 1)
        s = (i - loop * per) / max(per - 1.0, 1.0)
        s = min(max(s, 0.0), 1.0)
        a = np.pi / 2.0 * np.sin(np.pi * s) ** 2
        # alternate direction per loop + a small per-loop tilt
        sign = 1.0 if loop % 2 == 0 else -1.0
        a = sign * a
        lift = 0.1 * loop
        eye = np.array(
            [
                radius * np.sin(a),
                0.12 * np.sin(4.0 * np.pi * s) + lift * np.sin(np.pi * s) ** 2,
                -0.35 + 0.2 * (1.0 - np.cos(a)),
            ],
            np.float64,
        )
        if odom_noise > 0:
            eye = eye + rng.normal(scale=odom_noise, size=3)
        target = np.array([0.0, 0.0, 2.0])
        fwd = target - eye
        fwd /= np.linalg.norm(fwd)
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        R = np.stack([right, up2, fwd], 1)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = eye
        poses.append(T)
    return np.stack(poses)

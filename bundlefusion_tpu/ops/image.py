"""Depth/color image preprocessing ops.

Equivalents of the reference's ``CUDAImageUtil`` kernel set
(``CUDAImageUtil.h:10-42``): resampling, depth erosion, bilateral depth
filtering, camera-space conversion, normal estimation, intensity conversion
and derivatives. All are jittable pure functions on [H, W(, C)] float32
arrays; invalid depth is nan (the reference uses MINF).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from bundlefusion_tpu.geometry.camera import CameraIntrinsics, unproject


def resample_nearest(img, new_h: int, new_w: int):
    """Nearest-neighbor resample (reference ``resampleFloat``/``resampleUCHAR4``
    use nearest for depth to avoid mixing surfaces)."""
    H, W = img.shape[:2]
    vs = (jnp.arange(new_h) + 0.5) * (H / new_h) - 0.5
    us = (jnp.arange(new_w) + 0.5) * (W / new_w) - 0.5
    vi = jnp.clip(jnp.round(vs).astype(jnp.int32), 0, H - 1)
    ui = jnp.clip(jnp.round(us).astype(jnp.int32), 0, W - 1)
    # two axis-wise takes (row then column gathers) instead of one general
    # outer-product gather
    return jnp.take(jnp.take(img, vi, axis=0), ui, axis=1)


def resample_bilinear(img, new_h: int, new_w: int):
    """Bilinear resample for color/intensity images."""
    H, W = img.shape[:2]
    vs = (jnp.arange(new_h, dtype=jnp.float32) + 0.5) * (H / new_h) - 0.5
    us = (jnp.arange(new_w, dtype=jnp.float32) + 0.5) * (W / new_w) - 0.5
    v0 = jnp.clip(jnp.floor(vs).astype(jnp.int32), 0, H - 1)
    u0 = jnp.clip(jnp.floor(us).astype(jnp.int32), 0, W - 1)
    v1 = jnp.clip(v0 + 1, 0, H - 1)
    u1 = jnp.clip(u0 + 1, 0, W - 1)
    fv = jnp.clip(vs - v0, 0.0, 1.0)[:, None]
    fu = jnp.clip(us - u0, 0.0, 1.0)[None, :]
    if img.ndim == 3:
        fv = fv[..., None]
        fu = fu[..., None]
    # axis-wise takes (see resample_nearest)
    rows0 = jnp.take(img, v0, axis=0)
    rows1 = jnp.take(img, v1, axis=0)
    a = jnp.take(rows0, u0, axis=1)
    b = jnp.take(rows0, u1, axis=1)
    c = jnp.take(rows1, u0, axis=1)
    d = jnp.take(rows1, u1, axis=1)
    return (
        a * (1 - fv) * (1 - fu)
        + b * (1 - fv) * fu
        + c * fv * (1 - fu)
        + d * fv * fu
    )


def rgb_to_intensity(color):
    """[H, W, 3] -> [H, W] luminance (reference ``resampleToIntensity`` uses
    0.299/0.587/0.114)."""
    w = jnp.array([0.299, 0.587, 0.114], color.dtype)
    return color @ w


def erode_depth(depth, radius: int = 2, dist_thresh: float = 0.1, frac_req: float = 0.4):
    """Invalidate depth pixels whose neighborhood disagrees.

    Mirrors ``erodeDepthMap`` (CUDAImageUtil.cu): a pixel survives only if a
    sufficient fraction of its (2r+1)^2 neighborhood is valid and within
    ``dist_thresh`` (scaled by depth) of the center. Applied twice by the
    image manager (``CUDAImageManager.cpp:93-106``).
    """
    valid = jnp.isfinite(depth)
    d0 = jnp.where(valid, depth, 0.0)
    thr = dist_thresh * jnp.maximum(depth, 1.0)
    cnt_ok = jnp.zeros_like(depth)
    cnt_all = (2 * radius + 1) ** 2
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            dn = jnp.roll(jnp.roll(d0, dy, 0), dx, 1)
            vn = jnp.roll(jnp.roll(valid, dy, 0), dx, 1)
            ok = vn & (jnp.abs(dn - d0) < thr)
            cnt_ok = cnt_ok + ok.astype(depth.dtype)
    keep = valid & (cnt_ok >= frac_req * cnt_all)
    return jnp.where(keep, depth, jnp.nan)


def bilateral_filter_depth(depth, sigma_d: float = 2.0, sigma_r: float = 0.1, radius: int | None = None):
    """Edge-preserving depth smoothing (reference ``gaussFilterDepthMap``).

    Spatial gaussian x range gaussian; invalid neighbors excluded; output
    invalid where the center is invalid.
    """
    if radius is None:
        radius = int(2 * sigma_d)
    valid = jnp.isfinite(depth)
    d0 = jnp.where(valid, depth, 0.0)
    acc = jnp.zeros_like(d0)
    wacc = jnp.zeros_like(d0)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            w_s = jnp.exp(-(dx * dx + dy * dy) / (2.0 * sigma_d * sigma_d))
            dn = jnp.roll(jnp.roll(d0, dy, 0), dx, 1)
            vn = jnp.roll(jnp.roll(valid, dy, 0), dx, 1)
            w_r = jnp.exp(-((dn - d0) ** 2) / (2.0 * sigma_r * sigma_r))
            w = w_s * w_r * vn.astype(d0.dtype)
            acc = acc + w * dn
            wacc = wacc + w
    out = acc / jnp.maximum(wacc, 1e-12)
    return jnp.where(valid & (wacc > 1e-12), out, jnp.nan)


def gauss_filter(img, sigma: float = 2.5, radius: int | None = None):
    """Separable gaussian blur for intensity/color (reference
    ``gaussFilterIntensity``)."""
    if radius is None:
        radius = int(2 * sigma)
    x = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    k = jnp.exp(-(x * x) / (2.0 * sigma * sigma))
    k = k / jnp.sum(k)

    def conv1d(a, axis):
        out = jnp.zeros_like(a)
        for i, off in enumerate(range(-radius, radius + 1)):
            out = out + k[i] * jnp.roll(a, off, axis)
        return out

    return conv1d(conv1d(img, 0), 1)


def compute_normals(cam_points):
    """Central-difference normals from camera-space points [H, W, 3]
    (reference ``computeNormals``). nan where neighbors invalid."""
    dx = jnp.roll(cam_points, -1, 1) - jnp.roll(cam_points, 1, 1)
    dy = jnp.roll(cam_points, -1, 0) - jnp.roll(cam_points, 1, 0)
    n = jnp.cross(dy, dx)
    nn = jnp.linalg.norm(n, axis=-1, keepdims=True)
    ok = jnp.isfinite(nn) & (nn > 1e-8)
    n = jnp.where(ok, n / jnp.maximum(nn, 1e-12), jnp.nan)
    return n


def intensity_derivatives(intensity):
    """Sobel-style dI/du, dI/dv [H, W, 2] (reference
    ``computeIntensityDerivatives``)."""
    i = intensity
    gx = (
        (jnp.roll(i, -1, 1) - jnp.roll(i, 1, 1)) * 2.0
        + (jnp.roll(jnp.roll(i, -1, 1), 1, 0) - jnp.roll(jnp.roll(i, 1, 1), 1, 0))
        + (jnp.roll(jnp.roll(i, -1, 1), -1, 0) - jnp.roll(jnp.roll(i, 1, 1), -1, 0))
    ) * 0.125
    gy = (
        (jnp.roll(i, -1, 0) - jnp.roll(i, 1, 0)) * 2.0
        + (jnp.roll(jnp.roll(i, -1, 0), 1, 1) - jnp.roll(jnp.roll(i, 1, 0), 1, 1))
        + (jnp.roll(jnp.roll(i, -1, 0), -1, 1) - jnp.roll(jnp.roll(i, 1, 0), -1, 1))
    ) * 0.125
    return jnp.stack([gx, gy], -1)


def depth_to_cam_points(depth, intr: CameraIntrinsics):
    """Alias of geometry.camera.unproject for parity with
    ``convertDepthFloatToCameraSpaceFloat4``."""
    return unproject(depth, intr)


def reproject_depth_to_color(
    depth,
    intr_depth: CameraIntrinsics,
    intr_color: CameraIntrinsics,
    depth_to_color,
    fill_passes: int = 1,
):
    """Re-render a depth map into the color camera's frame
    (``CUDAImageCalibrator`` analog — the reference rasterizes the depth
    point cloud through DX11 when ``s_bUseCameraCalibration`` is on).

    Design: unproject depth-camera pixels, transform by the
    depth-to-color extrinsics, z-buffer into the color image with one
    packed scatter-min (depth-quantized key | source index), then fill
    sub-pixel holes with 3x3 valid-neighbor passes.

    Args:
      depth: [Hd, Wd] float32 meters (nan invalid).
      depth_to_color: [4, 4] transform from depth-camera to color-camera
        coordinates (extrinsic_color^-1 @ extrinsic_depth).

    Returns [Hc, Wc] float32 depth in the color camera (nan = no sample).
    """
    Hc, Wc = intr_color.height, intr_color.width
    pts = unproject(depth, intr_depth)                      # [Hd, Wd, 3]
    fin = jnp.isfinite(pts).all(-1)
    p = jnp.where(fin[..., None], pts, 0.0).reshape(-1, 3)
    q = p @ depth_to_color[:3, :3].T + depth_to_color[:3, 3]
    z = q[:, 2]
    ok = fin.reshape(-1) & (z > 1e-3)
    zs = jnp.maximum(z, 1e-6)
    u = jnp.round(q[:, 0] / zs * intr_color.fx + intr_color.cx).astype(jnp.int32)
    v = jnp.round(q[:, 1] / zs * intr_color.fy + intr_color.cy).astype(jnp.int32)
    ok = ok & (u >= 0) & (u < Wc) & (v >= 0) & (v < Hc)
    pix = jnp.where(ok, v * Wc + u, Hc * Wc)
    M = p.shape[0]
    # 19 index bits must cover every depth pixel (else winners alias)
    assert M <= 1 << 19, f"depth map too large for packed z-buffer: {M}"
    # quantize z into 12 bits scaled to the live depth range so ordering
    # holds for any scene depth (a fixed 1 mm step saturated at 4.095 m,
    # randomizing far-sample occlusion); cap at 4094 so the packed word
    # never collides with the 2^31-1 miss sentinel
    zmax = jnp.maximum(jnp.max(jnp.where(ok, z, 0.0)), 1e-3)
    zq = jnp.clip((z / zmax * 4094.0).astype(jnp.int32), 0, 4094)
    idx = jnp.arange(M, dtype=jnp.int32)
    packed = jnp.where(ok, (zq << 19) | idx, jnp.int32(2**31 - 1))
    zbuf = jnp.full((Hc * Wc + 1,), 2**31 - 1, jnp.int32)
    zbuf = zbuf.at[pix].min(packed, mode="drop")[: Hc * Wc]
    hit = zbuf != 2**31 - 1
    winner = jnp.clip(zbuf & ((1 << 19) - 1), 0, M - 1)
    out = jnp.where(hit, z[winner], jnp.nan).reshape(Hc, Wc)

    for _ in range(fill_passes):
        best = jnp.full((Hc, Wc), jnp.inf, jnp.float32)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                dn = jnp.roll(jnp.roll(out, dy, 0), dx, 1)
                best = jnp.where(jnp.isfinite(dn) & (dn < best), dn, best)
        out = jnp.where(~jnp.isfinite(out) & jnp.isfinite(best), best, out)
    return out

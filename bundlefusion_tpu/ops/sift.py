"""SIFT-style keypoint detection + 128-d descriptors in JAX.

Behavioral equivalent of the reference's SiftGPU subsystem
(``SiftPyramid.cpp:148-230``: BuildPyramid -> DetectKeypoints ->
LimitFeatureCount -> GetFeatureOrientations -> GetFeatureDescriptors;
kernels in ``ProgramCU.cu``: gaussian filtering, DoG (:550), keypoint
detection with depth-range rejection (:616), orientation histogram (:905),
4x4x8 descriptor (:1178, normalize :1339), per-key depth attach
(``CreateGlobalKeyPointList:2049``)).

Design: everything is fixed-shape. The pyramid is dense conv work
(XLA-friendly); per-keypoint stages (orientation, descriptor) gather fixed
16x16 sample grids scaled by keypoint scale and rotated by orientation —
scale-adaptive windows with static shapes — and are ``vmap``ed over a fixed
keypoint capacity with validity masks. Feature-count limiting takes the
top-N by DoG response (the reference adapts its threshold toward ~150
features/frame; top-N achieves the same contract deterministically).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class SiftConfig:
    num_octaves: int = 4
    scales_per_octave: int = 3
    sigma0: float = 1.6
    dog_thresh: float = 0.0066        # ~= SiftGPU default 0.02/3 on [0,1] intensity
    edge_thresh: float = 10.0
    max_candidates_per_octave: int = 512
    max_keys: int = 1024              # s_maxNumKeysPerImage
    target_keys: int = 150            # featureCountThreshold (Bundler.cpp:61)
    min_scale: float = 3.0            # s_minKeyScale
    depth_min: float = 0.1
    depth_max: float = 4.0


class SiftKeypoints(NamedTuple):
    """Fixed-capacity keypoint set for one image (pos in full-res pixels)."""

    pos: jax.Array          # [K, 2] (x, y)
    scale: jax.Array        # [K]
    orientation: jax.Array  # [K] radians
    response: jax.Array     # [K]
    depth: jax.Array        # [K]
    valid: jax.Array        # [K] bool
    desc: jax.Array         # [K, 128] unit-normalized float32


def _gauss_kernel1d(sigma: float):
    radius = max(1, int(np.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()  # numpy: taps become compile-time scalars


def _sep_conv(img, k):
    """Separable 2D blur as shift-and-add with edge-clamp padding.

    2*(2r+1) shifted-scaled adds that XLA fuses into one elementwise pass,
    in place of a 1-channel ``conv_general_dilated`` for these small
    kernels.
    """
    r = (k.shape[0] - 1) // 2
    kw = [float(k[i]) for i in range(k.shape[0])]
    H, W = img.shape
    xp = jnp.pad(img, ((0, 0), (r, r)), mode="edge")
    acc = kw[0] * xp[:, 0:W]
    for i in range(1, len(kw)):
        acc = acc + kw[i] * xp[:, i : i + W]
    xp = jnp.pad(acc, ((r, r), (0, 0)), mode="edge")
    acc = kw[0] * xp[0:H, :]
    for i in range(1, len(kw)):
        acc = acc + kw[i] * xp[i : i + H, :]
    return acc


def _bilinear(img, x, y):
    """Bilinear sample of [H, W] at float coords (x, y); clamps at borders."""
    H, W = img.shape
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = jnp.clip(x0.astype(jnp.int32), 0, W - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, H - 1)
    x1i = jnp.clip(x0i + 1, 0, W - 1)
    y1i = jnp.clip(y0i + 1, 0, H - 1)
    # flat takes, NOT 2-D advanced indexing: the multi-index-array gather
    # lowering degrades the runtime's h2d transfer path ~50x process-wide
    # after one execution (see _bilinear_flat)
    fimg = img.reshape(-1)
    a = jnp.take(fimg, y0i * W + x0i, mode="clip")
    b = jnp.take(fimg, y0i * W + x1i, mode="clip")
    c = jnp.take(fimg, y1i * W + x0i, mode="clip")
    d = jnp.take(fimg, y1i * W + x1i, mode="clip")
    return a * (1 - fx) * (1 - fy) + b * fx * (1 - fy) + c * (1 - fx) * fy + d * fx * fy


def build_pyramid(intensity, cfg: SiftConfig):
    """Gaussian + DoG pyramid.

    Returns per-octave lists: gauss [S+3, h, w], dog [S+2, h, w],
    grad magnitude/orientation at level 1 (detection-adjacent) per octave.
    """
    S = cfg.scales_per_octave
    octaves = []
    base = intensity
    for o in range(cfg.num_octaves):
        levels = []
        img = base
        sigma_prev = 0.5 if o == 0 else cfg.sigma0
        # level sigmas within octave: sigma0 * 2^(s/S)
        for s in range(S + 3):
            sigma_target = cfg.sigma0 * (2.0 ** (s / S))
            add = float(np.sqrt(max(sigma_target**2 - sigma_prev**2, 0.01)))
            img = _sep_conv(img, _gauss_kernel1d(add))
            sigma_prev = sigma_target
            levels.append(img)
        gauss = jnp.stack(levels)
        dog = gauss[1:] - gauss[:-1]
        octaves.append({"gauss": gauss, "dog": dog})
        # next octave: downsample level S (sigma = 2*sigma0)
        base = levels[S][::2, ::2]
    return octaves


def _detect_octave(dog, cfg: SiftConfig, octave: int):
    """Find local 3D extrema of the DoG stack for one octave.

    Returns fixed-cap candidates: (xy [C, 2] octave pixels, scale_idx [C],
    response [C], valid [C]).
    """
    S = cfg.scales_per_octave
    Hh, Ww = dog.shape[1:]
    cands_val, cands_resp, cands_x, cands_y, cands_s = [], [], [], [], []
    resp_all = []
    for s in range(1, S + 1):
        center = dog[s]
        is_max = jnp.ones_like(center, bool)
        is_min = jnp.ones_like(center, bool)
        for ds in (-1, 0, 1):
            nb = dog[s + ds]
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if ds == 0 and dy == 0 and dx == 0:
                        continue
                    sh = jnp.roll(jnp.roll(nb, dy, 0), dx, 1)
                    is_max = is_max & (center > sh)
                    is_min = is_min & (center < sh)
        extremum = (is_max | is_min) & (jnp.abs(center) > cfg.dog_thresh)
        # edge rejection via 2x2 spatial Hessian
        dxx = jnp.roll(center, -1, 1) + jnp.roll(center, 1, 1) - 2 * center
        dyy = jnp.roll(center, -1, 0) + jnp.roll(center, 1, 0) - 2 * center
        dxy = 0.25 * (
            jnp.roll(jnp.roll(center, -1, 0), -1, 1)
            + jnp.roll(jnp.roll(center, 1, 0), 1, 1)
            - jnp.roll(jnp.roll(center, -1, 0), 1, 1)
            - jnp.roll(jnp.roll(center, 1, 0), -1, 1)
        )
        tr = dxx + dyy
        det = dxx * dyy - dxy * dxy
        r = cfg.edge_thresh
        edge_ok = (det > 0) & (tr * tr * r < (r + 1) * (r + 1) * det)
        # border exclusion
        bx = jnp.zeros_like(extremum)
        bx = bx.at[2:-2, 2:-2].set(True)
        ok = extremum & edge_ok & bx
        resp_all.append(jnp.where(ok, jnp.abs(center), 0.0))
    resp = jnp.stack(resp_all)  # [S, H, W]
    flat = resp.reshape(-1)
    C = cfg.max_candidates_per_octave
    top_resp, top_idx = jax.lax.top_k(flat, C)
    s_idx = top_idx // (Hh * Ww) + 1
    rem = top_idx % (Hh * Ww)
    yy = rem // Ww
    xx = rem % Ww
    valid = top_resp > 0
    return xx.astype(jnp.float32), yy.astype(jnp.float32), s_idx, top_resp, valid


# 16x16 sample grid offsets for orientation/descriptor windows
_GRID = np.stack(
    np.meshgrid(np.arange(16) - 7.5, np.arange(16) - 7.5, indexing="xy"), -1
).reshape(-1, 2).astype(np.float32)  # [256, 2] in units of "descriptor cells/4"
_GRID_J = jnp.asarray(_GRID)


def _bilinear_flat(flat, base, W, H, x, y):
    """Bilinear sample from a flattened image bank.

    Args:
      flat: [total] concatenation of all (octave, level) images.
      base: per-sample flat offset of the image start ([...] int32).
      W, H: per-sample image dims ([...] int32).
      x, y: per-sample float coords.

    One pass over keys of all octaves/levels — replaces the reference's
    per-level kernel launches (and this module's former 12x masked passes).
    """
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = jnp.clip(x0.astype(jnp.int32), 0, W - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, H - 1)
    x1i = jnp.minimum(x0i + 1, W - 1)
    y1i = jnp.minimum(y0i + 1, H - 1)
    # flat 1-D takes with clipped indices: one element gather per corner
    a = jnp.take(flat, base + y0i * W + x0i, mode="clip")
    b = jnp.take(flat, base + y0i * W + x1i, mode="clip")
    c = jnp.take(flat, base + y1i * W + x0i, mode="clip")
    d = jnp.take(flat, base + y1i * W + x1i, mode="clip")
    return a * (1 - fx) * (1 - fy) + b * fx * (1 - fy) + c * (1 - fx) * fy + d * fx * fy


def _orientations(gm_flat, go_flat, base, W, H, x, y, sigma_local):
    """Dominant gradient orientations for all keys at once
    (reference ``ComputeOrientation_Kernel``). All args [K]-shaped except
    the flat banks; returns [K] angles.
    """
    scale = (1.5 * sigma_local / 4.0 * 2.0)[:, None]      # [K, 1]
    offx = _GRID_J[None, :, 0] * scale                     # [K, 256]
    offy = _GRID_J[None, :, 1] * scale
    sx = x[:, None] + offx
    sy = y[:, None] + offy
    m = _bilinear_flat(gm_flat, base[:, None], W[:, None], H[:, None], sx, sy)
    o = _bilinear_flat(go_flat, base[:, None], W[:, None], H[:, None], sx, sy)
    r2 = offx * offx + offy * offy
    sig_w = (1.5 * sigma_local)[:, None]
    w = m * jnp.exp(-r2 / (2 * sig_w * sig_w * 4.0))
    bins = jnp.floor(o / (2 * jnp.pi) * 36.0).astype(jnp.int32) % 36
    # scatter-free histogram: one-hot contraction (a matmul)
    hist = jnp.einsum(
        "ks,ksb->kb", w, jax.nn.one_hot(bins, 36, dtype=jnp.float32)
    )                                                      # [K, 36]
    for _ in range(2):  # smooth (2 passes of [1,1,1]/3)
        hist = (jnp.roll(hist, 1, 1) + hist + jnp.roll(hist, -1, 1)) / 3.0
    b = jnp.argmax(hist, axis=1)                           # [K]
    k_idx = jnp.arange(hist.shape[0])
    hflat = hist.reshape(-1)  # flat takes (not 2-D advanced indexing)
    h0 = jnp.take(hflat, k_idx * 36 + (b - 1) % 36, mode="clip")
    h1 = jnp.take(hflat, k_idx * 36 + b, mode="clip")
    h2 = jnp.take(hflat, k_idx * 36 + (b + 1) % 36, mode="clip")
    denom = h0 - 2 * h1 + h2
    delta = jnp.where(jnp.abs(denom) > 1e-12, 0.5 * (h0 - h2) / denom, 0.0)
    return (b.astype(jnp.float32) + 0.5 + delta) * (2 * jnp.pi / 36.0)


def _descriptors(gm_flat, go_flat, base, W, H, x, y, sigma_local, ang):
    """4x4x8 SIFT descriptors for all keys at once (reference
    ``ComputeDescriptor_Kernel`` + ``NormalizeDescriptor``). Returns [K, 128].
    """
    cell = (3.0 * sigma_local / 4.0)[:, None]              # [K, 1]
    ca = jnp.cos(ang)[:, None]
    sa = jnp.sin(ang)[:, None]
    gx = _GRID_J[None, :, 0] * cell
    gy = _GRID_J[None, :, 1] * cell
    sx = x[:, None] + ca * gx - sa * gy
    sy = y[:, None] + sa * gx + ca * gy
    m = _bilinear_flat(gm_flat, base[:, None], W[:, None], H[:, None], sx, sy)
    o = _bilinear_flat(go_flat, base[:, None], W[:, None], H[:, None], sx, sy) - ang[:, None]
    w = m * jnp.exp(
        -(_GRID_J[None, :, 0] ** 2 + _GRID_J[None, :, 1] ** 2) / (2 * 8.0 * 8.0)
    )                                                      # [K, 256]
    bx = (_GRID_J[None, :, 0] + 7.5) / 4.0
    by = (_GRID_J[None, :, 1] + 7.5) / 4.0
    bo = (o / (2 * jnp.pi)) % 1.0 * 8.0
    bx0 = jnp.floor(bx - 0.5)
    by0 = jnp.floor(by - 0.5)
    bo0 = jnp.floor(bo)
    fx = bx - 0.5 - bx0
    fy = by - 0.5 - by0
    fo = bo - bo0
    desc = jnp.zeros((w.shape[0], 128), jnp.float32)
    for dx_ in (0, 1):
        for dy_ in (0, 1):
            for do_ in (0, 1):
                wx = fx if dx_ else 1 - fx
                wy = fy if dy_ else 1 - fy
                wo = fo if do_ else 1 - fo
                ix = (bx0 + dx_).astype(jnp.int32)
                iy = (by0 + dy_).astype(jnp.int32)
                io = (bo0 + do_).astype(jnp.int32) % 8
                inb = (ix >= 0) & (ix < 4) & (iy >= 0) & (iy < 4)
                contrib = jnp.where(inb, w * wx * wy * wo, 0.0)   # [K, 256]
                lin = (jnp.clip(iy, 0, 3) * 4 + jnp.clip(ix, 0, 3)) * 8 + io
                # scatter-free trilinear binning: one-hot contraction
                desc = desc + jnp.einsum(
                    "ks,ksb->kb", contrib, jax.nn.one_hot(lin, 128, dtype=jnp.float32)
                )
    d = desc / jnp.maximum(jnp.linalg.norm(desc, axis=1, keepdims=True), 1e-12)
    d = jnp.minimum(d, 0.2)
    return d / jnp.maximum(jnp.linalg.norm(d, axis=1, keepdims=True), 1e-12)


@partial(jax.jit, static_argnames=("cfg",))
def detect_and_describe(intensity, depth, cfg: SiftConfig = SiftConfig()) -> SiftKeypoints:
    """Full detection pipeline on one frame.

    Args:
      intensity: [H, W] float32 in [0, 1] (at SIFT resolution, e.g. 640x480).
      depth: [H, W] float32 aligned depth for per-key depth attach and
        range rejection (reference ``ComputeKEY`` depth rejection +
        ``CreateGlobalKeyPointList``).
    """
    octaves = build_pyramid(intensity, cfg)
    S = cfg.scales_per_octave

    all_x, all_y, all_scale, all_resp, all_valid = [], [], [], [], []
    all_oct, all_sidx = [], []
    for o, pyr in enumerate(octaves):
        xx, yy, sidx, resp, valid = _detect_octave(pyr["dog"], cfg, o)
        mul = float(2**o)
        all_x.append(xx * mul)
        all_y.append(yy * mul)
        scale = cfg.sigma0 * (2.0 ** (sidx.astype(jnp.float32) / S)) * mul
        all_scale.append(scale)
        all_resp.append(resp)
        all_valid.append(valid)
        all_oct.append(jnp.full_like(sidx, o))
        all_sidx.append(sidx)
    x = jnp.concatenate(all_x)
    y = jnp.concatenate(all_y)
    scale = jnp.concatenate(all_scale)
    resp = jnp.concatenate(all_resp)
    valid = jnp.concatenate(all_valid)
    oct_idx = jnp.concatenate(all_oct)
    s_idx = jnp.concatenate(all_sidx)

    # depth attach + rejection at full-res coords
    H, W = depth.shape
    xi = jnp.clip(jnp.round(x).astype(jnp.int32), 0, W - 1)
    yi = jnp.clip(jnp.round(y).astype(jnp.int32), 0, H - 1)
    d = jnp.take(depth.reshape(-1), yi * W + xi, mode="clip")
    depth_ok = jnp.isfinite(d) & (d >= cfg.depth_min) & (d <= cfg.depth_max)
    scale_ok = scale >= cfg.min_scale
    valid = valid & depth_ok & scale_ok

    # keep top target_keys by response
    K = cfg.target_keys
    score = jnp.where(valid, resp, -1.0)
    top_score, top_i = jax.lax.top_k(score, K)
    kx = x[top_i]
    ky = y[top_i]
    kscale = scale[top_i]
    kresp = resp[top_i]
    kd = d[top_i]
    kvalid = top_score > 0
    koct = oct_idx[top_i]
    ksidx = s_idx[top_i]

    # Gradient bank: magnitude/orientation of every (octave, level) image,
    # flattened and concatenated so each key gathers from its own level in
    # ONE pass (the former per-(octave, level) masked passes did the full
    # per-key work num_octaves*S times).
    gm_parts, go_parts = [], []
    base_np = np.zeros((len(octaves), S + 1), np.int32)
    W_np = np.zeros((len(octaves),), np.int32)
    H_np = np.zeros((len(octaves),), np.int32)
    off = 0
    for o, pyr in enumerate(octaves):
        Ho, Wo = pyr["gauss"].shape[1:]
        H_np[o], W_np[o] = Ho, Wo
        for s in range(1, S + 1):
            g = pyr["gauss"][s]
            dgx = 0.5 * (jnp.roll(g, -1, 1) - jnp.roll(g, 1, 1))
            dgy = 0.5 * (jnp.roll(g, -1, 0) - jnp.roll(g, 1, 0))
            gm_parts.append(jnp.sqrt(dgx * dgx + dgy * dgy).reshape(-1))
            go_parts.append((jnp.arctan2(dgy, dgx) % (2 * jnp.pi)).reshape(-1))
            base_np[o, s] = off
            off += Ho * Wo
    gm_flat = jnp.concatenate(gm_parts)
    go_flat = jnp.concatenate(go_parts)

    base = jnp.take(
        jnp.asarray(base_np).reshape(-1), koct * (S + 1) + ksidx, mode="clip"
    )                                                      # [K]
    Wk = jnp.asarray(W_np)[koct]
    Hk = jnp.asarray(H_np)[koct]
    mulk = jnp.exp2(koct.astype(jnp.float32))
    lx = kx / mulk
    ly = ky / mulk
    sig_local = cfg.sigma0 * jnp.exp2(ksidx.astype(jnp.float32) / S)

    ang = _orientations(gm_flat, go_flat, base, Wk, Hk, lx, ly, sig_local)
    desc = _descriptors(gm_flat, go_flat, base, Wk, Hk, lx, ly, sig_local, ang)
    desc = jnp.where(kvalid[:, None], desc, 0.0)

    return SiftKeypoints(
        pos=jnp.stack([kx, ky], -1),
        scale=kscale,
        orientation=ang,
        response=kresp,
        depth=kd,
        valid=kvalid,
        desc=desc,
    )

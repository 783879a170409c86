"""Per-frame dense cache + keypoint stores (fixed-capacity device state).

Equivalents of the reference's ``CUDACache`` (80x60 downsampled depth,
camera-space positions, normals, intensity per frame — ``CUDACacheUtil.h:
10-53``, ``CUDACache::storeFrame`` CUDACache.cpp:45-86) and the
``SIFTImageManager`` per-image keypoint/descriptor store. Both are pytrees
of fixed-capacity arrays indexed by frame slot, updated functionally.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from bundlefusion_tpu.geometry.camera import CameraIntrinsics, unproject
from bundlefusion_tpu.ops.image import (
    bilateral_filter_depth,
    compute_normals,
    resample_bilinear,
    resample_nearest,
    rgb_to_intensity,
)
from bundlefusion_tpu.ops.sift import SiftKeypoints


class DenseCache(NamedTuple):
    """Downsampled per-frame geometry for dense verify / dense BA."""

    depth: jax.Array       # [F, h, w]
    campos: jax.Array      # [F, h, w, 3]
    normal: jax.Array      # [F, h, w, 3]
    intensity: jax.Array   # [F, h, w]

    @property
    def capacity(self) -> int:
        return self.depth.shape[0]


def create_dense_cache(capacity: int, h: int, w: int) -> DenseCache:
    nan = jnp.nan
    return DenseCache(
        depth=jnp.full((capacity, h, w), nan, jnp.float32),
        campos=jnp.full((capacity, h, w, 3), nan, jnp.float32),
        normal=jnp.full((capacity, h, w, 3), nan, jnp.float32),
        intensity=jnp.zeros((capacity, h, w), jnp.float32),
    )


def make_cache_frame(
    depth,
    color,
    intr_small: CameraIntrinsics,
    sigma_d: float = 1.0,
    sigma_r: float = 0.05,
):
    """Compute one cache entry from (integration-res) depth + color.

    Mirrors ``CUDACache::storeFrame``: bilateral-filter depth -> downsample
    -> camera-space positions -> normals -> intensity.
    """
    h, w = intr_small.height, intr_small.width
    d = bilateral_filter_depth(depth, sigma_d, sigma_r)
    d_small = resample_nearest(d, h, w)
    campos = unproject(d_small, intr_small)
    normal = compute_normals(campos)
    inten = resample_bilinear(rgb_to_intensity(color), h, w)
    return d_small, campos, normal, inten


def store_cache_frame(cache: DenseCache, slot, depth, color, intr_small) -> DenseCache:
    d, cp, n, i = make_cache_frame(depth, color, intr_small)
    return DenseCache(
        depth=cache.depth.at[slot].set(d),
        campos=cache.campos.at[slot].set(cp),
        normal=cache.normal.at[slot].set(n),
        intensity=cache.intensity.at[slot].set(i),
    )


def copy_cache_frame(dst: DenseCache, dst_slot, src: DenseCache, src_slot) -> DenseCache:
    """``CUDACache::copyCacheFrameFrom`` (submap frame 0 -> keyframe cache)."""
    return DenseCache(
        depth=dst.depth.at[dst_slot].set(src.depth[src_slot]),
        campos=dst.campos.at[dst_slot].set(src.campos[src_slot]),
        normal=dst.normal.at[dst_slot].set(src.normal[src_slot]),
        intensity=dst.intensity.at[dst_slot].set(src.intensity[src_slot]),
    )


class FrameStore(NamedTuple):
    """Device-resident integration-resolution frame archive.

    The reference keeps every processed frame on the CPU for later
    re-integration (``ManagedRGBDInputFrame``, CUDAImageManager.h:13-138)
    and re-uploads on demand. Here frames stay in device memory in their
    compact wire encoding (uint16 mm depth + uint8 color, the .sens on-disk
    representation: 375 KB/frame at 320x240) and re-integration gathers them
    by index without any transfer. The last slot is a scratch slot for
    frames beyond capacity (they simply become non-re-integrable, like
    streamed-out frames in the reference's chunk grid).
    """

    depth_mm: jax.Array  # [F+1, h, w] uint16 (0 = invalid)
    color: jax.Array     # [F+1, h, w, 3] uint8

    @property
    def capacity(self) -> int:
        """Number of addressable (re-integrable) frames."""
        return self.depth_mm.shape[0] - 1


def create_frame_store(capacity: int, h: int, w: int) -> FrameStore:
    return FrameStore(
        depth_mm=jnp.zeros((capacity + 1, h, w), jnp.uint16),
        color=jnp.zeros((capacity + 1, h, w, 3), jnp.uint8),
    )


def encode_frame(depth, color):
    """float32 (meters, [0,1] rgb) -> wire encoding (uint16 mm, uint8)."""
    d_mm = jnp.where(
        jnp.isfinite(depth), jnp.clip(depth * 1000.0 + 0.5, 0, 65535), 0.0
    ).astype(jnp.uint16)
    c_u8 = jnp.clip(color * 255.0 + 0.5, 0, 255).astype(jnp.uint8)
    return d_mm, c_u8


def decode_frame(d_mm, c_u8):
    """Exact inverse of :func:`encode_frame` for mm-quantized depth — the
    TSDF de-integration path must subtract bitwise-identical values."""
    depth = jnp.where(d_mm > 0, d_mm.astype(jnp.float32) * 1e-3, jnp.nan)
    color = c_u8.astype(jnp.float32) * (1.0 / 255.0)
    return depth, color


def store_frame(store: FrameStore, slot, depth, color) -> FrameStore:
    d_mm, c_u8 = encode_frame(depth, color)
    return FrameStore(
        depth_mm=store.depth_mm.at[slot].set(d_mm),
        color=store.color.at[slot].set(c_u8),
    )


class KeyframeStore(NamedTuple):
    """Fixed-capacity keypoint/descriptor store over frames
    (SIFTImageManager's per-image arrays, structure-of-arrays form)."""

    pos: jax.Array       # [F, K, 2]
    scale: jax.Array     # [F, K]
    depth: jax.Array     # [F, K]
    response: jax.Array  # [F, K]
    valid: jax.Array     # [F, K] bool
    desc: jax.Array      # [F, K, 128] (bfloat16 to halve the memory footprint)
    frame_valid: jax.Array  # [F] bool — frame participates in matching

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    @property
    def keys_per_frame(self) -> int:
        return self.pos.shape[1]


def create_keyframe_store(capacity: int, keys_per_frame: int) -> KeyframeStore:
    return KeyframeStore(
        pos=jnp.zeros((capacity, keys_per_frame, 2), jnp.float32),
        scale=jnp.zeros((capacity, keys_per_frame), jnp.float32),
        depth=jnp.zeros((capacity, keys_per_frame), jnp.float32),
        response=jnp.zeros((capacity, keys_per_frame), jnp.float32),
        valid=jnp.zeros((capacity, keys_per_frame), bool),
        desc=jnp.zeros((capacity, keys_per_frame, 128), jnp.bfloat16),
        frame_valid=jnp.zeros((capacity,), bool),
    )


def store_keypoints(store: KeyframeStore, slot, kp: SiftKeypoints) -> KeyframeStore:
    """Insert a detection result (possibly smaller K than store width)."""
    K = store.keys_per_frame
    k = kp.pos.shape[0]

    def fit(x, fill=0.0):
        if k == K:
            return x
        pad = [(0, K - k)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, pad, constant_values=fill)

    return store._replace(
        pos=store.pos.at[slot].set(fit(kp.pos)),
        scale=store.scale.at[slot].set(fit(kp.scale)),
        depth=store.depth.at[slot].set(fit(kp.depth)),
        response=store.response.at[slot].set(fit(kp.response)),
        valid=store.valid.at[slot].set(fit(kp.valid, False)),
        desc=store.desc.at[slot].set(fit(kp.desc).astype(jnp.bfloat16)),
        frame_valid=store.frame_valid.at[slot].set(jnp.any(kp.valid)),
    )


def backproject_keys(pos, depth, intr: CameraIntrinsics):
    """Keypoint pixel+depth -> camera-space 3D (reference back-projects via
    colorIntrinsicsInv in ``getKeySourceAndTargetPoints``)."""
    x = (pos[..., 0] - intr.cx) / intr.fx * depth
    y = (pos[..., 1] - intr.cy) / intr.fy * depth
    return jnp.stack([x, y, depth], -1)

"""GPU<->host streaming of cold TSDF blocks (chunk-grid analog).

The reference pages voxel blocks outside an active radius to CPU RAM in 1 m^3
chunks with a round-robin sweep (``CUDASceneRepChunkGrid.{h,cpp,cu}``,
disabled by default for BundleFusion because paging conflicts with
de-integration). This design keeps the same contract — bound device
memory by the active working set — but with the sorted-key table it is a
bulk set operation, not per-bucket linked-list surgery:

- ``stream_out``: select blocks beyond ``radius`` of the camera, gather
  their payloads to host (one device->host copy), free them from the table.
- ``stream_in``: re-insert previously paged blocks that re-enter the
  radius, restoring their payloads (host->device copy + scatter).

Host storage is a plain dict keyed by packed block coord. Re-integration of
a streamed-out frame region must ``stream_in`` first (same constraint as
the reference's ``isSDFBlockStreamedOut`` check in the alloc kernel).
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax.numpy as jnp
import numpy as np

from bundlefusion_tpu.tsdf.table import (
    BLOCK_SIZE,
    EMPTY_KEY,
    FREE_COMPACT,
    VoxelBlockTable,
    allocate,
    block_to_world,
    free_blocks,
    lookup_packed,
    unpack_key,
)


class HostBlockStore:
    """Host-side paged block storage (the ChunkDesc vectors analog)."""

    def __init__(self):
        self.blocks: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}

    def __len__(self) -> int:
        return len(self.blocks)

    def insert(self, keys: np.ndarray, sdf: np.ndarray, weight: np.ndarray, color: np.ndarray):
        for i, k in enumerate(keys):
            self.blocks[int(k)] = (sdf[i].copy(), weight[i].copy(), color[i].copy())

    def take(self, keys):
        out = [self.blocks.pop(int(k)) for k in keys]
        if not out:
            return (
                np.zeros((0, BLOCK_SIZE**3), np.float32),
                np.zeros((0, BLOCK_SIZE**3), np.float32),
                np.zeros((0, 3, BLOCK_SIZE**3), np.float32),
            )
        return (
            np.stack([o[0] for o in out]),
            np.stack([o[1] for o in out]),
            np.stack([o[2] for o in out]),
        )


def stream_out(
    table: VoxelBlockTable,
    store: HostBlockStore,
    camera_pos: np.ndarray,
    radius: float,
    voxel_size: float,
    max_blocks: int = 100000,
) -> VoxelBlockTable:
    """Page out blocks whose center is farther than ``radius`` from the
    camera. Returns the updated table; payloads land in ``store``."""
    keys = np.asarray(table.keys)
    occ = keys != int(EMPTY_KEY)
    coords = np.asarray(unpack_key(table.keys))
    centers = (coords + 0.5) * (BLOCK_SIZE * voxel_size)
    dist = np.linalg.norm(centers - np.asarray(camera_pos), axis=-1)
    out_mask = occ & (dist > radius)
    idx = np.nonzero(out_mask)[0][:max_blocks]
    if len(idx) == 0:
        return table
    slots = np.asarray(table.slots)[idx]
    sel_keys = keys[idx]
    store.insert(
        sel_keys,
        np.asarray(table.sdf)[slots],
        np.asarray(table.weight)[slots],
        np.asarray(table.color)[slots],
    )
    # free in <= FREE_COMPACT batches: free_blocks only zeroes that many
    # freed payload rows per call, and the free list is LIFO — a bigger
    # batch would push stale non-zero payloads onto the list for allocate
    # (which assumes zeroed slots) to pop first. Key positions re-sort on
    # every free, so each batch re-derives its mask from key VALUES.
    for start in range(0, len(sel_keys), FREE_COMPACT):
        chunk = sel_keys[start : start + FREE_COMPACT]
        cur_keys = np.asarray(table.keys)
        mask = np.isin(cur_keys, chunk)
        table = free_blocks(table, jnp.asarray(mask))
    return table


def stream_in(
    table: VoxelBlockTable,
    store: HostBlockStore,
    camera_pos: np.ndarray,
    radius: float,
    voxel_size: float,
    max_blocks: int = 100000,
) -> VoxelBlockTable:
    """Page in stored blocks that re-entered the radius."""
    if not store.blocks:
        return table
    keys = np.fromiter(store.blocks.keys(), np.int64)
    coords = np.asarray(unpack_key(jnp.asarray(keys.astype(np.int32))))
    centers = (coords + 0.5) * (BLOCK_SIZE * voxel_size)
    dist = np.linalg.norm(centers - np.asarray(camera_pos), axis=-1)
    sel = keys[dist <= radius][:max_blocks]
    return stream_in_keys(table, store, sel)


def stream_in_keys(
    table: VoxelBlockTable, store: HostBlockStore, keys
) -> VoxelBlockTable:
    """Page in an explicit set of stored block keys (e.g. blocks a pending
    re-integration op's frustum touches). Blocks that fail to allocate
    (free-list exhaustion) stay in the host store rather than being lost."""
    sel = np.asarray(keys, np.int64)
    if len(sel) == 0:
        return table
    sdf, weight, color = store.take(sel)
    coords_sel = np.asarray(unpack_key(jnp.asarray(sel.astype(np.int32))))
    table = allocate(
        table, jnp.asarray(coords_sel.astype(np.int32)), jnp.ones(len(sel), bool)
    )
    slots = np.asarray(lookup_packed(table, jnp.asarray(sel.astype(np.int32))))
    ok = slots >= 0  # may fail on free-list exhaustion
    if not ok.all():
        store.insert(sel[~ok], sdf[~ok], weight[~ok], color[~ok])
    if not ok.any():
        return table
    return table._replace(
        sdf=table.sdf.at[jnp.asarray(slots[ok])].set(jnp.asarray(sdf[ok])),
        weight=table.weight.at[jnp.asarray(slots[ok])].set(jnp.asarray(weight[ok])),
        color=table.color.at[jnp.asarray(slots[ok])].set(jnp.asarray(color[ok])),
    )


def paged_keys_in_frustum(
    store: HostBlockStore,
    poses,          # iterable of cam-to-world 4x4 (numpy)
    intr,
    params,
    H: int,
    W: int,
) -> np.ndarray:
    """Conservative host-side frustum test: paged block keys whose AABB
    could be touched by ANY of the given camera poses' integration updates
    (the 8-corner convex-hull test of ``active_tile_indices``, on host).

    Mirrors the reference's stream-in-before-integrate contract
    (``CUDASceneRepChunkGrid.h:142-210`` + ``isSDFBlockStreamedOut``,
    ``CUDASceneRepHashSDF.cu:153-163``)."""
    if not store.blocks:
        return np.zeros((0,), np.int64)
    keys = np.fromiter(store.blocks.keys(), np.int64)
    coords = np.asarray(unpack_key(jnp.asarray(keys.astype(np.int32))))
    bs = BLOCK_SIZE * params.voxel_size
    corner = coords.astype(np.float32) * bs
    offs = np.asarray(
        [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)], np.float32
    ) * bs
    pts = corner[:, None, :] + offs[None]                       # [N, 8, 3]
    dmax = min(params.depth_max, params.max_integration_distance)
    zmax = dmax + params.truncation + params.truncation_scale * dmax
    hit = np.zeros(len(keys), bool)
    for T in poses:
        w2c = np.linalg.inv(np.asarray(T, np.float64)).astype(np.float32)
        R, t = w2c[:3, :3], w2c[:3, 3]
        pc = pts @ R.T + t
        z = pc[..., 2]
        all_front = (z > 1e-3).all(axis=1)
        zs = np.maximum(z, 1e-3)
        u = pc[..., 0] / zs * intr.fx + intr.cx
        v = pc[..., 1] / zs * intr.fy + intr.cy
        inside = (
            (u.max(1) >= 0.0) & (u.min(1) <= W - 1)
            & (v.max(1) >= 0.0) & (v.min(1) <= H - 1)
            & (z.min(1) <= zmax)
        )
        straddle = (z > 0.0).any(axis=1) & ~all_front           # conservative
        hit |= np.where(all_front, inside, straddle)
    return keys[hit]

"""Isosurface extraction from the block-sparse TSDF.

The reference extracts a triangle mesh per compactified voxel block with
classic marching-cubes tables and atomic triangle appends
(``CUDAMarchingCubesHashSDF.*``, ``MarchingCubesSDFUtil.h:26-90``,
``Tables.h``). This design uses **marching tetrahedra** (each cube split
into 6 tetrahedra): the per-tet case logic is branch-free arithmetic instead
of a 256-entry lookup table, which maps cleanly onto vectorized masked
compute, and produces a topologically consistent zero-isosurface of the same
SDF. Triangle output uses fixed-capacity buffers with cumsum compaction
(the analog of the reference's atomic append + capacity cap
``marchingCubesMaxNumTriangles``).

Extraction runs in chunks of blocks to bound memory; the host loops over
chunks and concatenates (mesh export is offline, matching the reference where
extraction happens at scan end / on keypress).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from bundlefusion_tpu.geometry.camera import CameraIntrinsics  # noqa: F401  (doc parity)
from bundlefusion_tpu.tsdf.table import (
    BLOCK_SIZE,
    EMPTY_KEY,
    VoxelBlockTable,
    color_at,
    lookup_blocks,
    unpack_key,
)

# 6-tetrahedra decomposition of a cube sharing the 0-6 diagonal.
# cube corner order: (x, y, z) bits -> corner index c = x + 2y + 4z
_TETS = np.array(
    [
        [0, 5, 1, 6],
        [0, 1, 3, 6],
        [0, 3, 2, 6],
        [0, 2, 4, 6],
        [0, 4, 5, 6],
        [5, 4, 7, 6],
    ],
    np.int32,
)
# tet edge list: 6 edges between the 4 verts
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int32)
# For each of the 16 sign cases (bit i = vert i inside), the edges carrying
# triangle vertices. Cases with 1 or 3 inside verts -> 1 triangle; 2 inside
# -> 2 triangles (quad). -1 pads. Winding chosen so normals point outward
# (toward positive sdf) and fixed up by orientation check at emit time.
_TET_TRIS = np.full((16, 2, 3), -1, np.int32)


def _init_tet_tris():
    # enumerate cases programmatically for robustness
    for case in range(16):
        inside = [i for i in range(4) if case & (1 << i)]
        outside = [i for i in range(4) if not (case & (1 << i))]
        if len(inside) == 0 or len(inside) == 4:
            continue

        def edge_id(a, b):
            for ei, (u, v) in enumerate(_TET_EDGES):
                if {a, b} == {u, v}:
                    return ei
            raise AssertionError

        if len(inside) == 1:
            a = inside[0]
            es = [edge_id(a, b) for b in outside]
            _TET_TRIS[case, 0] = es
        elif len(inside) == 3:
            a = outside[0]
            es = [edge_id(a, b) for b in inside]
            _TET_TRIS[case, 0] = es[::-1]
        else:  # 2 inside, 2 outside -> quad = 2 triangles
            a, b = inside
            c, d = outside
            e_ac, e_ad = edge_id(a, c), edge_id(a, d)
            e_bc, e_bd = edge_id(b, c), edge_id(b, d)
            _TET_TRIS[case, 0] = [e_ac, e_ad, e_bd]
            _TET_TRIS[case, 1] = [e_ac, e_bd, e_bc]


_init_tet_tris()
_TETS_J = jnp.asarray(_TETS)
_TET_EDGES_J = jnp.asarray(_TET_EDGES)
_TET_TRIS_J = jnp.asarray(_TET_TRIS)

# cube corner offsets, corner index c = x + 2y + 4z
_CORNERS_J = jnp.asarray(
    np.array([[c & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], np.int32)
)


def _corner_samples(table: VoxelBlockTable, block_pos_chunk, voxel_size):
    """Sample sdf/weight/color at the 8 cube corners of every voxel in the
    chunk's blocks. Cubes span voxel centers, so corner c of cube at voxel v
    is voxel v + offset(c); cross-block neighbors resolved via table lookup.

    Returns (sdf [K, V, 8], wmin-> validity [K, V, 8], color [K, V, 8, 3],
    cube corner world positions [K, V, 3] of corner 0).
    """
    K = block_pos_chunk.shape[0]
    safe = jnp.clip(block_pos_chunk, 0, table.capacity - 1)
    valid_block = block_pos_chunk >= 0
    bcoords = unpack_key(table.keys[safe])  # [K, 3]

    r = jnp.arange(BLOCK_SIZE, dtype=jnp.int32)
    zz, yy, xx = jnp.meshgrid(r, r, r, indexing="ij")
    local = jnp.stack([xx, yy, zz], -1).reshape(-1, 3)  # [V, 3]
    vox = bcoords[:, None, :] * BLOCK_SIZE + local[None]  # [K, V, 3] global voxel coords

    sdfs, ws, cols = [], [], []
    for c in range(8):
        corner_vox = vox + _CORNERS_J[c][None, None]
        cb = jnp.floor_divide(corner_vox, BLOCK_SIZE)
        cl = corner_vox - cb * BLOCK_SIZE
        lin = (cl[..., 2] * BLOCK_SIZE + cl[..., 1]) * BLOCK_SIZE + cl[..., 0]
        slot = lookup_blocks(table, cb)
        ok = slot >= 0
        ss = jnp.clip(slot, 0, table.num_blocks - 1)
        s = jnp.where(ok, table.sdf[ss, lin], 0.0)
        w = jnp.where(ok, table.weight[ss, lin], 0.0)
        col = jnp.where(
            ok[..., None], color_at(table, ss, lin) / jnp.maximum(w, 1e-12)[..., None], 0.0
        )
        sdfs.append(s)
        ws.append(w)
        cols.append(col)
    sdf = jnp.stack(sdfs, -1)
    w = jnp.stack(ws, -1)
    col = jnp.stack(cols, -2)
    corner0_world = (vox.astype(jnp.float32) + 0.5) * voxel_size
    w = jnp.where(valid_block[:, None, None], w, 0.0)
    return sdf, w, col, corner0_world


@partial(jax.jit, static_argnames=("voxel_size", "max_tris", "chunk"))
def _extract_chunk(table: VoxelBlockTable, block_pos_chunk, voxel_size: float, max_tris: int, chunk: int):
    """Extract triangles for a chunk of blocks.

    Returns (verts [max_tris, 3, 3], colors [max_tris, 3, 3], count).
    """
    sdf, w, col, corner0 = _corner_samples(table, block_pos_chunk, voxel_size)
    K, V = sdf.shape[:2]
    corner_pos = (
        corner0[:, :, None, :] + _CORNERS_J[None, None].astype(jnp.float32) * voxel_size
    )  # [K, V, 8, 3]
    cube_valid = jnp.all(w > 0, axis=-1)  # all 8 corners observed

    # gather per-tet corner values: [K, V, 6 tets, 4]
    tet_sdf = sdf[:, :, _TETS_J]
    tet_pos = corner_pos[:, :, _TETS_J]
    tet_col = col[:, :, _TETS_J]
    inside = tet_sdf < 0
    case = (
        inside[..., 0].astype(jnp.int32)
        + 2 * inside[..., 1].astype(jnp.int32)
        + 4 * inside[..., 2].astype(jnp.int32)
        + 8 * inside[..., 3].astype(jnp.int32)
    )  # [K, V, 6]

    # interpolated vertex on each tet edge: [K, V, 6, 6edges, 3]
    ea = tet_sdf[..., _TET_EDGES_J[:, 0]]
    eb = tet_sdf[..., _TET_EDGES_J[:, 1]]
    denom = ea - eb
    alpha = jnp.where(jnp.abs(denom) > 1e-12, ea / denom, 0.5)
    alpha = jnp.clip(alpha, 0.0, 1.0)[..., None]
    pa = tet_pos[..., _TET_EDGES_J[:, 0], :]
    pb = tet_pos[..., _TET_EDGES_J[:, 1], :]
    edge_v = pa + alpha * (pb - pa)
    ca = tet_col[..., _TET_EDGES_J[:, 0], :]
    cb = tet_col[..., _TET_EDGES_J[:, 1], :]
    edge_c = ca + alpha * (cb - ca)

    # triangles: [K, V, 6, 2, 3 edge ids]
    tri_edges = _TET_TRIS_J[case]
    tri_valid = (tri_edges[..., 0] >= 0) & cube_valid[:, :, None, None]
    te = jnp.clip(tri_edges, 0, 5)
    # gather triangle vertices from edge vertices by one-hot contraction
    # (6 edges is tiny; avoids awkward take_along_axis reshapes)
    onehot = jax.nn.one_hot(te, 6, dtype=edge_v.dtype)  # [K,V,6,2,3,6]
    tri_v = jnp.einsum("kvtabe,kvten->kvtabn", onehot, edge_v)
    tri_c = jnp.einsum("kvtabe,kvten->kvtabn", onehot, edge_c)

    tri_v = tri_v.reshape(-1, 3, 3)
    tri_c = tri_c.reshape(-1, 3, 3)
    tv = tri_valid.reshape(-1)
    pos = jnp.cumsum(tv.astype(jnp.int32)) - 1
    count = jnp.minimum(jnp.sum(tv.astype(jnp.int32)), max_tris)
    out_v = jnp.zeros((max_tris, 3, 3), jnp.float32)
    out_c = jnp.zeros((max_tris, 3, 3), jnp.float32)
    dst = jnp.where(tv & (pos < max_tris), pos, max_tris)
    out_v = out_v.at[dst].set(tri_v, mode="drop")
    out_c = out_c.at[dst].set(tri_c, mode="drop")
    return out_v, out_c, count


def extract_mesh(
    table: VoxelBlockTable,
    voxel_size: float,
    chunk_blocks: int = 256,
    max_tris_per_chunk: int = 200000,
):
    """Extract the full zero-isosurface mesh (host-driven, chunked).

    Returns (vertices [T, 3, 3] float32 np, colors [T, 3, 3] np) triangle soup.
    """
    occ = np.asarray(table.keys) != int(EMPTY_KEY)
    positions = np.nonzero(occ)[0].astype(np.int32)
    all_v, all_c = [], []
    for i in range(0, len(positions), chunk_blocks):
        chunk = positions[i : i + chunk_blocks]
        if len(chunk) < chunk_blocks:
            chunk = np.pad(chunk, (0, chunk_blocks - len(chunk)), constant_values=-1)
        v, c, n = _extract_chunk(
            table, jnp.asarray(chunk), voxel_size, max_tris_per_chunk, chunk_blocks
        )
        n = int(n)
        if n > 0:
            all_v.append(np.asarray(v[:n]))
            all_c.append(np.asarray(c[:n]))
    if not all_v:
        return np.zeros((0, 3, 3), np.float32), np.zeros((0, 3, 3), np.float32)
    return np.concatenate(all_v), np.concatenate(all_c)

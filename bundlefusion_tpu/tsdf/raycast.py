"""TSDF raycasting (rendered depth / normals / color from the voxel map).

Reference: ``CUDARayCastSDF.cu`` — per-pixel ray march at
``rayIncrementFactor * truncation`` steps between per-pixel min/max bounds
produced by rasterizing block AABBs through DX11 ("ray interval splatting",
``rayIntervalSplatKernel``), zero-crossing detection, bisection refine,
trilinear SDF/color interpolation (``RayCastSDFUtil.h:97-303``).

Design: rasterization-based splatting is replaced by a **dense local
block-index grid**: a [D^3] int32 volume centered on the camera that maps
block coords -> voxel slot, built in one scatter pass over the key table.
Ray marching then needs only direct grid indexing (no hash probe, no
searchsorted) per step — the entire march is a ``lax.fori_loop`` over a
static step count with per-pixel done-masking, and trilinear refinement uses
the same grid. The grid (64^3 int32 = 1 MB) is the analog of the splatting
min/max buffers as an XLA-friendly acceleration structure.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from bundlefusion_tpu.geometry.camera import CameraIntrinsics
from bundlefusion_tpu.geometry.lie import transform_points
from bundlefusion_tpu.tsdf.table import (
    BLOCK_SIZE,
    EMPTY_KEY,
    VoxelBlockTable,
    unpack_key,
)
from bundlefusion_tpu.tsdf.integrate import TsdfParams


@dataclass(frozen=True)
class RaycastParams:
    ray_increment_factor: float = 0.8     # step = factor * truncation
    depth_min: float = 0.1
    depth_max: float = 4.0
    grid_dim: int = 0                     # local grid blocks per axis;
                                          # 0 = auto-size to the frustum
    refine_iters: int = 6                 # bisection refinement steps
    use_color: bool = True


def build_local_grid(table: VoxelBlockTable, center_world, voxel_size: float, grid_dim: int):
    """Dense [grid_dim^3] int32 block->slot grid centered near the camera.

    Blocks outside the local grid are invisible to the raycaster; at the
    default 96 blocks x 8 vox x 1 cm the grid spans 7.7 m — larger than the
    4 m sensor range in any direction that matters.

    Returns (grid [D, D, D] int32 slots with -1 empty, origin_block [3] int32).
    """
    block_extent = BLOCK_SIZE * voxel_size
    center_block = jnp.floor(center_world / block_extent).astype(jnp.int32)
    origin = center_block - grid_dim // 2
    coords = unpack_key(table.keys) - origin  # [C, 3]
    occ = table.keys != EMPTY_KEY
    inb = occ & jnp.all((coords >= 0) & (coords < grid_dim), axis=-1)
    lin = (coords[:, 2] * grid_dim + coords[:, 1]) * grid_dim + coords[:, 0]
    lin = jnp.where(inb, lin, grid_dim**3)
    grid = jnp.full((grid_dim**3 + 1,), -1, jnp.int32)
    grid = grid.at[lin].set(jnp.where(inb, table.slots, -1), mode="drop")
    return grid[:-1].reshape(grid_dim, grid_dim, grid_dim), origin


def _sample_nearest(grid, origin, table, pts_world, voxel_size, grid_dim):
    """Nearest-voxel (sdf, weight) at world points [..., 3]."""
    vox = jnp.floor(pts_world / voxel_size).astype(jnp.int32)
    block = jnp.floor_divide(vox, BLOCK_SIZE) - origin
    local = vox - (block + origin) * BLOCK_SIZE
    inb = jnp.all((block >= 0) & (block < grid_dim), axis=-1)
    bc = jnp.clip(block, 0, grid_dim - 1)
    slot = grid[bc[..., 2], bc[..., 1], bc[..., 0]]
    slot = jnp.where(inb, slot, -1)
    lin = (local[..., 2] * BLOCK_SIZE + local[..., 1]) * BLOCK_SIZE + local[..., 0]
    ok = slot >= 0
    ss = jnp.clip(slot, 0, table.num_blocks - 1)
    sdf = table.sdf[ss, lin]
    w = table.weight[ss, lin]
    return jnp.where(ok, sdf, 0.0), jnp.where(ok, w, 0.0)


def _sample_trilinear(grid, origin, table, pts_world, voxel_size, grid_dim, with_color):
    """Trilinear (sdf, weight_min, color) at world points [..., 3].

    Weight_min is the minimum corner weight — used as validity (all corners
    must be observed), matching ``trilinearInterpolationSimpleFastFast``
    which fails if any corner has zero weight.
    """
    g = pts_world / voxel_size - 0.5  # voxel-center grid
    base = jnp.floor(g).astype(jnp.int32)
    frac = g - base
    sdf_acc = jnp.zeros(pts_world.shape[:-1], jnp.float32)
    wmin = jnp.full(pts_world.shape[:-1], jnp.inf, jnp.float32)
    col_acc = (
        jnp.zeros(pts_world.shape[:-1] + (3,), jnp.float32) if with_color else None
    )
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                corner = base + jnp.array([dx, dy, dz], jnp.int32)
                wgt = (
                    (frac[..., 0] if dx else 1 - frac[..., 0])
                    * (frac[..., 1] if dy else 1 - frac[..., 1])
                    * (frac[..., 2] if dz else 1 - frac[..., 2])
                )
                block = jnp.floor_divide(corner, BLOCK_SIZE) - origin
                local = corner - (block + origin) * BLOCK_SIZE
                inb = jnp.all((block >= 0) & (block < grid_dim), axis=-1)
                bc = jnp.clip(block, 0, grid_dim - 1)
                slot = grid[bc[..., 2], bc[..., 1], bc[..., 0]]
                slot = jnp.where(inb, slot, -1)
                ok = slot >= 0
                ss = jnp.clip(slot, 0, table.num_blocks - 1)
                lin = (local[..., 2] * BLOCK_SIZE + local[..., 1]) * BLOCK_SIZE + local[..., 0]
                s = jnp.where(ok, table.sdf[ss, lin], 0.0)
                w = jnp.where(ok, table.weight[ss, lin], 0.0)
                sdf_acc = sdf_acc + wgt * s
                wmin = jnp.minimum(wmin, w)
                if with_color:
                    from bundlefusion_tpu.tsdf.table import color_at

                    c = jnp.where(
                        ok[..., None],
                        color_at(table, ss, lin) / jnp.maximum(w, 1e-12)[..., None],
                        0.0,
                    )
                    col_acc = col_acc + wgt[..., None] * c
    return sdf_acc, wmin, col_acc


@partial(jax.jit, static_argnames=("intr", "tsdf_params", "params"))
def raycast(
    table: VoxelBlockTable,
    intr: CameraIntrinsics,
    cam_to_world,
    tsdf_params: TsdfParams,
    params: RaycastParams = RaycastParams(),
):
    """Render the TSDF from a camera pose.

    Returns dict with ``depth`` [H, W] (nan where no surface), ``points``
    [H, W, 3] camera-space, ``normals`` [H, W, 3] camera-space (nan invalid),
    ``color`` [H, W, 3].
    """
    import math

    H, W = intr.height, intr.width
    voxel_size = tsdf_params.voxel_size
    cam_pos = cam_to_world[:3, 3]
    # The grid is centered at the view-frustum MIDPOINT (not the camera) and
    # auto-sized so the whole frustum + truncation margin fits: the old
    # camera-centered fixed grid silently dropped geometry farther than
    # half its span, so offline renders of large scenes were incomplete.
    # (The reference raycasts any allocated region via interval splatting,
    # CUDARayCastSDF.cu:101-190 — no such bound.) All inputs are static, so
    # the size is resolved at trace time.
    grid_dim = params.grid_dim
    if grid_dim == 0:
        xm = max(intr.cx, intr.width - intr.cx) / intr.fx * params.depth_max
        ym = max(intr.cy, intr.height - intr.cy) / intr.fy * params.depth_max
        zh = 0.5 * (params.depth_max - params.depth_min)
        r = math.sqrt(xm * xm + ym * ym + zh * zh) + tsdf_params.truncation
        be = BLOCK_SIZE * voxel_size
        grid_dim = 2 * (int(math.ceil(r / be)) + 1)
    center = cam_pos + cam_to_world[:3, 2] * (
        0.5 * (params.depth_min + params.depth_max)
    )
    grid, origin = build_local_grid(table, center, voxel_size, grid_dim)

    v = jnp.broadcast_to(jnp.arange(H, dtype=jnp.float32)[:, None], (H, W))
    u = jnp.broadcast_to(jnp.arange(W, dtype=jnp.float32)[None, :], (H, W))
    dirs_cam = jnp.stack(
        [(u - intr.cx) / intr.fx, (v - intr.cy) / intr.fy, jnp.ones_like(u)], -1
    )
    ray_norm = jnp.linalg.norm(dirs_cam, axis=-1)
    dirs_world = dirs_cam @ cam_to_world[:3, :3].T

    step = params.ray_increment_factor * tsdf_params.truncation
    n_steps = int(math.ceil((params.depth_max - params.depth_min) / step)) + 1

    def body(i, carry):
        t_hit, prev_sdf, prev_t, prev_ok, done = carry
        t = params.depth_min + i * step
        pts = cam_pos + t * dirs_world
        sdf, w = _sample_nearest(grid, origin, table, pts, voxel_size, grid_dim)
        ok = w > 0
        crossing = prev_ok & ok & (prev_sdf > 0) & (sdf <= 0) & ~done
        # linear interpolation of the zero crossing
        denom = prev_sdf - sdf
        alpha = jnp.where(jnp.abs(denom) > 1e-12, prev_sdf / denom, 0.5)
        t_surf = prev_t + alpha * (t - prev_t)
        t_hit = jnp.where(crossing, t_surf, t_hit)
        done = done | crossing
        return t_hit, sdf, t * jnp.ones_like(prev_t), ok, done

    t_hit0 = jnp.full((H, W), jnp.nan, jnp.float32)
    init = (
        t_hit0,
        jnp.zeros((H, W), jnp.float32),
        jnp.zeros((H, W), jnp.float32),
        jnp.zeros((H, W), bool),
        jnp.zeros((H, W), bool),
    )
    t_hit, _, _, _, done = jax.lax.fori_loop(0, n_steps, body, init)

    # bisection refinement with trilinear sdf
    lo = jnp.where(done, t_hit - step, 0.0)
    hi = jnp.where(done, t_hit + step * 0.0 + step, 0.0)
    lo = jnp.maximum(lo, params.depth_min)

    def refine(i, carry):
        lo, hi = carry
        mid = 0.5 * (lo + hi)
        pts = cam_pos + mid[..., None] * dirs_world
        sdf, wmin, _ = _sample_trilinear(
            grid, origin, table, pts, voxel_size, grid_dim, False
        )
        valid = wmin > 0
        go_lo = valid & (sdf <= 0)
        hi = jnp.where(go_lo, mid, hi)
        lo = jnp.where(go_lo, lo, mid)
        return lo, hi

    lo, hi = jax.lax.fori_loop(0, params.refine_iters, refine, (lo, hi))
    t_final = jnp.where(done, 0.5 * (lo + hi), jnp.nan)

    pts_world = cam_pos + t_final[..., None] * dirs_world
    _, wmin, color = _sample_trilinear(
        grid, origin, table, pts_world, voxel_size, grid_dim, params.use_color
    )
    depth = t_final  # t parameterizes z because dirs_cam has z=1
    ok = done & jnp.isfinite(depth)
    depth = jnp.where(ok, depth, jnp.nan)

    # camera-space points + normals from cross products of neighbors
    pts_cam = dirs_cam * depth[..., None]
    dzdx = 0.5 * (jnp.roll(pts_cam, -1, 1) - jnp.roll(pts_cam, 1, 1))
    dzdy = 0.5 * (jnp.roll(pts_cam, -1, 0) - jnp.roll(pts_cam, 1, 0))
    n = jnp.cross(dzdy, dzdx)
    nn = jnp.linalg.norm(n, axis=-1, keepdims=True)
    normals = jnp.where(nn > 1e-8, n / jnp.maximum(nn, 1e-12), jnp.nan)
    if params.use_color:
        color = jnp.where(ok[..., None], jnp.clip(color, 0.0, 1.0), jnp.nan)
    else:
        color = jnp.full((H, W, 3), jnp.nan, jnp.float32)
    return {
        "depth": depth,
        "points": jnp.where(ok[..., None], pts_cam, jnp.nan),
        "normals": normals,
        "color": color,
    }

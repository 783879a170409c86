"""Multi-op TSDF integrate/de-integrate over the frustum-active payload rows.

One call applies ALL of a frame's TSDF ops: a re-integration row is two
ops on the same image (sign -1 at the old pose, +1 at the new) and the
current frame's fuse is one op. Ops apply sequentially per voxel, exactly
like the reference's sequential ``integrateDepthMapKernel`` launches
(``CUDASceneRepHashSDF.cu:420-521``, ``DepthSensing.cpp:854-902``).
sign=0 is an exact bitwise no-op (it gates invalid frames without copies).

The update touches only the live rows whose block some op's frustum can
reach (:func:`active_rows`, a bounding-sphere test per block): those rows
are gathered into passes of ``cap`` rows (``AppConfig.visible_blocks_cap``),
updated by :func:`apply_tsdf_ops_rows`, and scattered back into the donated
table. When more rows are active than one pass holds, further passes run
until every active row is done — the result stays exact — and the table's
``row_overflows`` counter records the batch.

:func:`apply_tsdf_ops_xla` applies the same rows update to every payload
row; it is the plain reference the compacted path is checked against.

Voxel update (truncation band, weighted running average with sign,
premultiplied channel-major color) matches ``integrate.integrate_frame``.
Depth is sampled as a bf16 hi/lo pair and color as bf16, so a frame's
contribution is identical whichever path applies it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from bundlefusion_tpu.geometry.camera import CameraIntrinsics
from bundlefusion_tpu.geometry.lie import pose_inverse
from bundlefusion_tpu.tsdf.integrate import TsdfParams
from bundlefusion_tpu.tsdf.table import (
    BLOCK_SIZE,
    BLOCK_VOLUME,
    EMPTY_KEY,
    GRID_BITS,
    GRID_DIM,
    GRID_HALF,
    VoxelBlockTable,
)


def active_rows(table, w2c, signs, intr, params, H, W, op_dmax=None):
    """Mask [num_blocks] of live payload rows that ANY op could touch.

    A voxel update requires z > 0, a projection that rounds into the image
    (it lies in [-0.5, W - 0.5] x [-0.5, H - 0.5]) and a camera depth below
    depth_max + truncation (``upd = inb & depth_ok & (sd > -trunc)``).
    Each block is tested by its bounding sphere, which holds every voxel
    centre of the block, against the four side half-spaces of that window
    (planes through the camera centre), the camera plane and the far bound:
    a sphere that misses one of them holds no voxel the op could update.
    ``op_dmax`` [OPS] optionally tightens each op's far bound to its
    image's largest valid depth.
    """
    N = table.num_blocks
    bs = BLOCK_SIZE * params.voxel_size
    geo = table.slot_geo[:N, :4]
    live = (geo[:, 3] > 0.5) & (jnp.arange(N) < table.high_water)
    c = geo[:, :3] * bs + 0.5 * bs                          # block centres
    r = 0.5 * bs * 3.0**0.5                                 # bounding radius
    # side planes a * (x or y) + b * z >= 0 at the half-pixel window
    planes = (
        (0, intr.fx, intr.cx + 0.5), (0, -intr.fx, W - 0.5 - intr.cx),
        (1, intr.fy, intr.cy + 0.5), (1, -intr.fy, H - 0.5 - intr.cy),
    )
    dmax = min(params.depth_max, params.max_integration_distance)

    any_op = jnp.zeros((N,), bool)
    for o in range(w2c.shape[0]):
        dm = dmax if op_dmax is None else jnp.minimum(op_dmax[o], dmax)
        zmax = dm + params.truncation + params.truncation_scale * dm
        R, t = w2c[o, :3, :3], w2c[o, :3, 3]
        x, y, z = (
            c[:, 0] * R[i, 0] + c[:, 1] * R[i, 1] + c[:, 2] * R[i, 2] + t[i]
            for i in range(3)
        )
        ok = (z > -r) & (z - r <= zmax) & (signs[o] != 0.0)
        for axis, a, b in planes:
            ok = ok & (a * (x if axis == 0 else y) + b * z >= -r * (a * a + b * b) ** 0.5)
        any_op = any_op | ok
    return live & any_op


def selected_rows(table, depths, poses, signs, img_of_op, intr, params):
    """Mask [num_blocks] of the rows :func:`apply_tsdf_ops` updates: the
    :func:`active_rows` of the op batch, with each op's far bound set by
    its image's largest valid depth."""
    H, W = depths.shape[1:]
    w2c = jax.vmap(pose_inverse)(poses)
    d_fin = jnp.where(jnp.isfinite(depths) & (jnp.abs(depths) < 1e30), depths, 0.0)
    op_dmax = jnp.max(d_fin, axis=(1, 2))[img_of_op]
    return active_rows(table, w2c, signs, intr, params, H, W, op_dmax=op_dmax)


def quantized_images(depths, colors):
    """The sampled values every path uses: depth as a bf16 hi/lo pair
    summed back to f32, color rounded to bf16. Non-finite pixels are 0."""

    def _fin(x):
        return jnp.where(jnp.isfinite(x) & (jnp.abs(x) < 1e30), x, 0.0)

    d_f = _fin(depths)
    d_hi = d_f.astype(jnp.bfloat16)
    d_lo = (d_f - d_hi.astype(jnp.float32)).astype(jnp.bfloat16)
    d_q = d_hi.astype(jnp.float32) + d_lo.astype(jnp.float32)
    c_q = _fin(colors).astype(jnp.bfloat16).astype(jnp.float32)
    return d_q, c_q


def apply_tsdf_ops_rows(
    key,               # int32 [R] packed block coords per payload row
    sdf_rows,          # f32 [R, V]
    weight_rows,       # f32 [R, V]
    color_rows,        # f32 [R, 3V]
    depths,            # [IMGS, H, W] f32 (non-finite = invalid)
    colors,            # [IMGS, H, W, 3] f32 in [0, 1]
    poses,             # [OPS, 4, 4] cam-to-world per op
    signs,             # [OPS] f32: +1 integrate, -1 de-integrate, 0 no-op
    img_of_op,         # [OPS] int32 index into depths/colors
    intr: CameraIntrinsics,
    params: TsdfParams,
):
    """Apply the op batch to an arbitrary set of payload rows (each row is
    independent given its packed block key; EMPTY rows pass through).
    Returns (sdf, weight, color) rows."""
    live = key != EMPTY_KEY
    kx = ((key & (GRID_DIM - 1)) - GRID_HALF).astype(jnp.float32)
    ky = (((key >> GRID_BITS) & (GRID_DIM - 1)) - GRID_HALF).astype(jnp.float32)
    kz = (((key >> (2 * GRID_BITS)) & (GRID_DIM - 1)) - GRID_HALF).astype(jnp.float32)
    lin = jnp.arange(BLOCK_VOLUME, dtype=jnp.int32)
    lx = (lin % BLOCK_SIZE).astype(jnp.float32)
    ly = ((lin // BLOCK_SIZE) % BLOCK_SIZE).astype(jnp.float32)
    lz = (lin // (BLOCK_SIZE * BLOCK_SIZE)).astype(jnp.float32)
    bs = BLOCK_SIZE * params.voxel_size
    wx = kx[:, None] * bs + (lx[None] + 0.5) * params.voxel_size
    wy = ky[:, None] * bs + (ly[None] + 0.5) * params.voxel_size
    wz = kz[:, None] * bs + (lz[None] + 0.5) * params.voxel_size

    H, W = depths.shape[1:]
    dmax = min(params.depth_max, params.max_integration_distance)
    d_q, c_q = quantized_images(depths, colors)

    def op(state, pose, sign, img):
        sdf, w, col = state
        w2c = pose_inverse(pose)
        R, tr = w2c[:3, :3], w2c[:3, 3]
        px = R[0, 0] * wx + R[0, 1] * wy + R[0, 2] * wz + tr[0]
        py = R[1, 0] * wx + R[1, 1] * wy + R[1, 2] * wz + tr[1]
        z = R[2, 0] * wx + R[2, 1] * wy + R[2, 2] * wz + tr[2]
        u = jnp.round(px / jnp.maximum(z, 1e-6) * intr.fx + intr.cx).astype(jnp.int32)
        v = jnp.round(py / jnp.maximum(z, 1e-6) * intr.fy + intr.cy).astype(jnp.int32)
        inb = (u >= 0) & (u < W) & (v >= 0) & (v < H) & (z > 0)
        lin = jnp.clip(v, 0, H - 1) * W + jnp.clip(u, 0, W - 1)
        d = jnp.take(d_q[img].reshape(-1), lin, mode="clip")
        rgb_r = jnp.take(c_q[img, :, :, 0].reshape(-1), lin, mode="clip")
        rgb_g = jnp.take(c_q[img, :, :, 1].reshape(-1), lin, mode="clip")
        rgb_b = jnp.take(c_q[img, :, :, 2].reshape(-1), lin, mode="clip")
        depth_ok = (d >= params.depth_min) & (d <= dmax)
        sd = d - z
        trunc = params.truncation + params.truncation_scale * d
        upd = inb & depth_ok & (sd > -trunc) & live[:, None]
        sd_cl = jnp.minimum(sd, trunc)
        w_new = (upd.astype(jnp.float32) * params.integration_weight_sample) * sign
        new_w = jnp.clip(w + w_new, 0.0, params.integration_weight_max)
        applied = new_w - w
        sum_sdf = sdf * w + jnp.where(upd, sd_cl, 0.0) * applied
        new_sdf = jnp.where(
            applied != 0,
            jnp.where(new_w > 0, sum_sdf / jnp.maximum(new_w, 1e-12), 0.0),
            sdf,
        )
        appc = jnp.where(upd, applied, 0.0)
        rgb_cm = jnp.concatenate([rgb_r, rgb_g, rgb_b], axis=1)
        new_col = jnp.maximum(col + rgb_cm * jnp.tile(appc, (1, 3)), 0.0)
        return new_sdf, new_w, new_col

    # unrolled (OPS is static): XLA fuses the whole op chain into one pass
    # over the rows instead of re-reading the rows' state for every op
    state = (sdf_rows, weight_rows, color_rows)
    for o in range(poses.shape[0]):
        state = op(state, poses[o], signs[o], img_of_op[o])
    return state


def apply_tsdf_ops(
    table: VoxelBlockTable,
    depths,
    colors,
    poses,
    signs,
    img_of_op,
    intr: CameraIntrinsics,
    params: TsdfParams,
    cap: int,
) -> VoxelBlockTable:
    """Apply a batch of (de)integration ops to the frustum-active rows.

    Ops execute sequentially per voxel in array order — callers list
    de-integrations before the re-integrations/integrations that follow
    them, mirroring the reference's dispatch order
    (``DepthSensing.cpp: reintegrate()`` then ``integrate()``). ``cap`` is
    the static row capacity of one pass; a batch with more active rows
    runs extra passes and counts one ``row_overflows``.
    """
    N = table.num_blocks
    cap = min(cap, N)
    mask = selected_rows(table, depths, poses, signs, img_of_op, intr, params)
    n_active = jnp.sum(mask.astype(jnp.int32))
    n_batches = (n_active + cap - 1) // cap
    # active row ids in slot order, padded with the dummy row N to a whole
    # number of passes (a pass never re-reads a row another pass wrote)
    n_pad = -(-N // cap) * cap
    order = jnp.nonzero(mask, size=n_pad, fill_value=N)[0].astype(jnp.int32)

    def batch(b, payload):
        sdf, w, col = payload
        idx = jax.lax.dynamic_slice_in_dim(order, b * cap, cap)
        new = apply_tsdf_ops_rows(
            table.slot_keys[idx], sdf[idx], w[idx], col[idx],
            depths, colors, poses, signs, img_of_op, intr, params,
        )
        dst = jnp.where(idx < N, idx, N + 1)      # padding -> dropped
        return tuple(
            a.at[dst].set(r, mode="drop") for a, r in zip(payload, new)
        )

    sdf, w, col = jax.lax.fori_loop(
        0, n_batches, batch, (table.sdf, table.weight, table.color)
    )
    return table._replace(
        sdf=sdf, weight=w, color=col,
        row_overflows=table.row_overflows + (n_batches > 1).astype(jnp.int32),
    )


def apply_tsdf_ops_xla(
    table: VoxelBlockTable,
    depths,
    colors,
    poses,
    signs,
    img_of_op,
    intr: CameraIntrinsics,
    params: TsdfParams,
) -> VoxelBlockTable:
    """Plain reference: the rows update over every payload row.

    Rows no op can touch come back bitwise unchanged, so this equals
    :func:`apply_tsdf_ops` on any table.
    """
    N = table.num_blocks
    sdf, w, col = apply_tsdf_ops_rows(
        table.slot_keys[:N], table.sdf[:N], table.weight[:N],
        table.color[:N], depths, colors, poses, signs, img_of_op,
        intr, params,
    )
    return table._replace(
        sdf=table.sdf.at[:N].set(sdf),
        weight=table.weight.at[:N].set(w),
        color=table.color.at[:N].set(col),
    )


def compare_with_reference(
    table: VoxelBlockTable,
    depths,
    colors,
    poses,
    signs,
    img_of_op,
    intr: CameraIntrinsics,
    params: TsdfParams,
    cap: int,
) -> dict:
    """Apply one op batch to ``table`` both ways and report the differences
    between :func:`apply_tsdf_ops` (passes of ``cap`` rows) and the full
    sweep: weight mismatches, largest sdf / color differences, and voxels
    changed outside the rows :func:`selected_rows` picks. ``table`` itself
    is not modified."""
    N = table.num_blocks
    fast = jax.jit(apply_tsdf_ops, static_argnames=("intr", "params", "cap"))(
        table, depths, colors, poses, signs, img_of_op,
        intr=intr, params=params, cap=cap,
    )
    ref = jax.jit(apply_tsdf_ops_xla, static_argnames=("intr", "params"))(
        table, depths, colors, poses, signs, img_of_op, intr=intr, params=params,
    )
    outside = ~selected_rows(
        table, depths, poses, signs, img_of_op, intr, params)[:, None]

    def changed(a, b):
        return jnp.sum(outside & (a[:N] != b[:N]))

    return {
        "rows_active": int(jnp.sum(~outside)),
        "rows_updated": int(jnp.sum(jnp.any(fast.weight[:N] != table.weight[:N], axis=1))),
        "row_overflows": int(fast.row_overflows - table.row_overflows),
        "weight_mismatch": int(jnp.sum(fast.weight != ref.weight)),
        "sdf_max_abs": float(jnp.max(jnp.abs(fast.sdf - ref.sdf))),
        "color_max_abs": float(jnp.max(jnp.abs(fast.color - ref.color))),
        "outside_changed": int(
            changed(fast.sdf, table.sdf) + changed(fast.weight, table.weight)
            + changed(fast.color, table.color)
        ),
    }

"""Dense depth (point-to-plane) + photometric BA term.

Re-design of the reference's ``BuildDenseSystem`` path
(``Solver/SolverBundling.cu:308-471`` + ``SolverBundlingDenseUtil.h``):

1. ``FindImageImageCorr_Kernel`` (:30-79): candidate frame pairs whose
   cameras look in similar directions (angle < ~52 deg in the code's
   0.52 rad threshold region) and whose subsampled projective overlap has
   >= 10 hits.
2. ``FindDenseCorrespondences_Kernel`` (:92-160): per-pair dense corr count
   at full cache res; ``WeightDenseCorrespondences`` (:162-180): pair weight
   1/sqrt-ish falloff — zero below 800 corrs.
3. ``BuildDenseSystem_Kernel`` (:183-306): per-pair per-pixel point-to-plane
   depth residual (+ photometric intensity residual with gradient gating),
   accumulating 6x6 JtJ blocks and Jtr into the global camera system.

Design: pairs are a fixed-capacity masked list; per-pair per-pixel
residuals and exact Jacobians (``jax.jacfwd`` of the pixel residual in the
12 pose parameters) are reduced on-device into per-pair [12, 12] / [12]
blocks; the PCG matvec applies them with gathers + segment-sums — no global
6N x 6N matrix, no atomics.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from bundlefusion_tpu.geometry.camera import CameraIntrinsics
from bundlefusion_tpu.geometry.lie import pose_inverse, so3_exp
from bundlefusion_tpu.pipeline.frames import DenseCache


@dataclass(frozen=True)
class DenseTermParams:
    dist_thresh: float = 0.15          # s_denseDistThresh
    normal_thresh: float = 0.97        # s_denseNormalThresh
    color_thresh: float = 0.1          # s_denseColorThresh
    color_gradient_min: float = 0.005  # s_denseColorGradientMin
    depth_min: float = 0.5             # s_denseDepthMin
    depth_max: float = 4.0             # s_denseDepthMax
    overlap_subsample: int = 4         # s_denseOverlapCheckSubsampleFactor
    overlap_min_hits: int = 10         # FindImageImageCorr threshold
    min_corr_per_pair: int = 800       # WeightDenseCorrespondences zero-thresh
    angle_thresh: float = 0.52         # rad, view-angle gate
    max_pairs: int = 128               # fixed pair capacity


def _pose_mat(pose):
    R = so3_exp(pose[:3])
    T = jnp.eye(4, dtype=pose.dtype)
    T = T.at[:3, :3].set(R)
    return T.at[:3, 3].set(pose[3:])


def find_overlapping_pairs(
    poses,
    frame_valid,
    cache: DenseCache,
    intr: CameraIntrinsics,
    p: DenseTermParams,
):
    """Candidate pair list [max_pairs, 2] + mask, from view-angle + coarse
    projective-overlap tests over all frame pairs in the domain."""
    N = poses.shape[0]
    mats = jax.vmap(_pose_mat)(poses)
    z_axes = mats[:, :3, 2]
    centers = mats[:, :3, 3]

    ii, jj = jnp.meshgrid(jnp.arange(N), jnp.arange(N), indexing="ij")
    upper = ii < jj
    both_valid = frame_valid[ii] & frame_valid[jj]
    ang = jnp.arccos(jnp.clip(jnp.sum(z_axes[ii] * z_axes[jj], -1), -1.0, 1.0))
    cand = upper & both_valid & (ang < 2 * p.angle_thresh)

    # coarse overlap: project subsampled valid points of i into j
    sub = p.overlap_subsample
    pts = cache.campos[:, ::sub, ::sub]  # [N, h', w', 3]

    def overlap_count(i, j):
        T_ij = pose_inverse(mats[j]) @ mats[i]
        q = pts[i] @ T_ij[:3, :3].T + T_ij[:3, 3]
        z = q[..., 2]
        u = q[..., 0] / jnp.maximum(z, 1e-6) * intr.fx + intr.cx
        v = q[..., 1] / jnp.maximum(z, 1e-6) * intr.fy + intr.cy
        ok = (
            jnp.isfinite(q).all(-1)
            & (z > p.depth_min)
            & (z < p.depth_max)
            & (u >= 0) & (u <= intr.width - 1)
            & (v >= 0) & (v <= intr.height - 1)
        )
        return jnp.sum(ok.astype(jnp.int32))

    flat_i = ii.reshape(-1)
    flat_j = jj.reshape(-1)
    # chunked evaluation: a flat vmap over all N^2 pairs materializes
    # [N^2, h', w', 3] — 35 GB at the reference capacity N=1200. lax.map
    # serializes fixed-size chunks, bounding the intermediate to
    # [CH, h', w', 3] (~30 MB) while keeping each chunk wide enough to
    # fill the device.
    P_all = N * N
    CH = min(16384, P_all)
    n_chunks = -(-P_all // CH)
    pad = n_chunks * CH - P_all
    fi_pad = jnp.concatenate([flat_i, jnp.zeros((pad,), flat_i.dtype)])
    fj_pad = jnp.concatenate([flat_j, jnp.zeros((pad,), flat_j.dtype)])

    def chunk_counts(c):
        fi = jax.lax.dynamic_slice_in_dim(fi_pad, c * CH, CH)
        fj = jax.lax.dynamic_slice_in_dim(fj_pad, c * CH, CH)
        return jax.vmap(overlap_count)(fi, fj)

    counts = jax.lax.map(chunk_counts, jnp.arange(n_chunks)).reshape(-1)
    counts = counts[:P_all].reshape(N, N)
    cand = cand & (counts >= p.overlap_min_hits)

    flat = cand.reshape(-1)
    pos = jnp.cumsum(flat.astype(jnp.int32)) - 1
    dst = jnp.where(flat & (pos < p.max_pairs), pos, p.max_pairs)
    pairs = jnp.zeros((p.max_pairs + 1, 2), jnp.int32)
    pairs = pairs.at[dst].set(jnp.stack([flat_i, flat_j], -1), mode="drop")
    mask = jnp.arange(p.max_pairs) < jnp.minimum(jnp.sum(flat.astype(jnp.int32)), p.max_pairs)
    return pairs[: p.max_pairs], mask


def _pair_residuals(pose_i, pose_j, campos_i, normal_i, inten_i,
                    campos_j, normal_j, inten_j, grad_j,
                    intr: CameraIntrinsics, p: DenseTermParams):
    """Masked per-pixel (depth_res, color_res, weight) for one pair.

    Projective association of frame i's points into frame j
    (``findDenseCorr``): r_depth = n_j . (T p_i - p_j_assoc), gated on
    distance + normal agreement; r_color = I_i - I_j(proj), gated on
    gradient magnitude.
    """
    # sanitize BEFORE any arithmetic: nan inputs poison jacfwd tangents even
    # through jnp.where (the where-gradient trap)
    fin_i = jnp.isfinite(campos_i).all(-1) & jnp.isfinite(normal_i).all(-1)
    campos_i = jnp.where(fin_i[..., None], campos_i, 0.0)
    normal_i = jnp.where(fin_i[..., None], normal_i, 0.0)
    fin_j_img = jnp.isfinite(campos_j).all(-1) & jnp.isfinite(normal_j).all(-1)
    campos_j = jnp.where(fin_j_img[..., None], campos_j, 0.0)
    normal_j = jnp.where(fin_j_img[..., None], normal_j, 0.0)

    Ti = _pose_mat(pose_i)
    Tj = _pose_mat(pose_j)
    T = pose_inverse(Tj) @ Ti
    q = campos_i @ T[:3, :3].T + T[:3, 3]
    nq = normal_i @ T[:3, :3].T
    z = q[..., 2]
    u = q[..., 0] / jnp.maximum(z, 1e-6) * intr.fx + intr.cx
    v = q[..., 1] / jnp.maximum(z, 1e-6) * intr.fy + intr.cy
    ui = jnp.clip(jnp.round(u).astype(jnp.int32), 0, intr.width - 1)
    vi = jnp.clip(jnp.round(v).astype(jnp.int32), 0, intr.height - 1)
    inb = (u >= 0) & (u <= intr.width - 1) & (v >= 0) & (v <= intr.height - 1) & (z > 0)
    # projective association via one-hot resample (ops/resample.py);
    # samples are constants wrt the
    # poses within a GN iteration, exactly like the reference's Jacobian
    from bundlefusion_tpu.ops.resample import onehot_gather2d

    stack_j = jnp.concatenate(
        [
            jnp.moveaxis(campos_j, -1, 0),
            jnp.moveaxis(normal_j, -1, 0),
            inten_j[None],
            jnp.moveaxis(grad_j, -1, 0),
            fin_j_img[None].astype(jnp.float32),
        ],
        axis=0,
    )  # [10, H, W]
    smp = onehot_gather2d(stack_j, vi, ui, inb)
    pt = smp[..., 0:3]
    nt = smp[..., 3:6]
    it_ = smp[..., 6]
    gt_ = smp[..., 7:9]
    fin_j = smp[..., 9] > 0.5
    d = jnp.sqrt(jnp.sum((q - pt) ** 2, -1) + 1e-18)
    dn = jnp.sum(nq * nt, -1)
    valid = (
        inb
        & fin_i
        & fin_j
        & (z > p.depth_min) & (z < p.depth_max)
        & (d <= p.dist_thresh)
        & (dn >= p.normal_thresh)
    )
    r_depth = jnp.where(valid, jnp.sum(nt * (q - pt), -1), 0.0)
    gmag = jnp.linalg.norm(gt_, axis=-1)
    cvalid = valid & (gmag >= p.color_gradient_min)
    r_color = jnp.where(cvalid, inten_i - it_, 0.0)
    # distance+depth falloff weight (reference weighted ICP style)
    w = jnp.where(
        valid,
        jnp.maximum(
            0.0,
            0.5 * ((1.0 - d / p.dist_thresh)
                   + (1.0 - jnp.clip((z - p.depth_min) / (p.depth_max - p.depth_min), 0, 1))),
        ),
        0.0,
    )
    return r_depth, r_color, w, valid, cvalid


class DensePairSystem(NamedTuple):
    pairs: jax.Array      # [P, 2] int32
    mask: jax.Array       # [P] bool (pair active + enough corrs)
    H: jax.Array          # [P, 12, 12] JtJ blocks (ordered [pose_i, pose_j])
    b: jax.Array          # [P, 12] Jtr
    num_corr: jax.Array   # [P] int32


@partial(jax.jit, static_argnames=("intr", "p", "w_depth", "w_color"))
def build_dense_system(
    poses,
    pairs,
    pair_mask,
    cache: DenseCache,
    intr: CameraIntrinsics,
    p: DenseTermParams = DenseTermParams(),
    w_depth: float = 1.0,
    w_color: float = 0.0,
) -> DensePairSystem:
    """Per-pair reduced systems with exact jacfwd Jacobians."""
    grad = jnp.stack(
        [
            0.5 * (jnp.roll(cache.intensity, -1, 2) - jnp.roll(cache.intensity, 1, 2)),
            0.5 * (jnp.roll(cache.intensity, -1, 1) - jnp.roll(cache.intensity, 1, 1)),
        ],
        -1,
    )

    def one_pair(pair, active):
        i, j = pair[0], pair[1]

        def res_fn(pose_ij):
            rd, rc, w, valid, cvalid = _pair_residuals(
                pose_ij[:6], pose_ij[6:],
                cache.campos[i], cache.normal[i], cache.intensity[i],
                cache.campos[j], cache.normal[j], cache.intensity[j], grad[j],
                intr, p,
            )
            # weights are IRLS-style constants within a GN iteration (the
            # reference bakes them into the accumulators, not the Jacobian);
            # stop_gradient also avoids the sqrt(0) infinite-derivative trap
            sw = jax.lax.stop_gradient(jnp.sqrt(jnp.maximum(w, 0.0)))
            r = jnp.concatenate(
                [
                    (rd * sw).reshape(-1) * jnp.sqrt(w_depth),
                    (rc * sw).reshape(-1) * jnp.sqrt(w_color) if w_color > 0 else jnp.zeros((0,)),
                ]
            )
            return r, (valid, w)

        pose_ij = jnp.concatenate([poses[i], poses[j]])
        # exact Jacobian [R, 12] by forward mode; R = num cache pixels
        # (4800 x 12 floats = 230 KB per pair lane)
        r, (valid, w) = res_fn(pose_ij)
        J = jax.jacfwd(lambda y: res_fn(y)[0])(pose_ij)
        n_corr = jnp.sum(valid.astype(jnp.int32))
        ok = active & (n_corr >= p.min_corr_per_pair)
        H = J.T @ J
        b = J.T @ r
        scale = jnp.where(ok, 1.0, 0.0)
        return H * scale, b * scale, n_corr, ok

    H, b, n_corr, ok = jax.vmap(one_pair)(pairs, pair_mask)
    return DensePairSystem(pairs=pairs, mask=ok, H=H, b=b, num_corr=n_corr)


def dense_matvec(sys: DensePairSystem, x, num_frames: int):
    """[N, 6] -> [N, 6]: apply the summed pair JtJ blocks."""
    i = sys.pairs[:, 0]
    j = sys.pairs[:, 1]
    xi = x[jnp.clip(i, 0, num_frames - 1)]
    xj = x[jnp.clip(j, 0, num_frames - 1)]
    xij = jnp.concatenate([xi, xj], -1)  # [P, 12]
    y = jnp.einsum("pab,pb->pa", sys.H, xij)
    y = jnp.where(sys.mask[:, None], y, 0.0)
    out = jnp.zeros((num_frames + 1, 6), x.dtype)
    ii = jnp.where(sys.mask, i, num_frames)
    jj = jnp.where(sys.mask, j, num_frames)
    out = out.at[ii].add(y[:, :6], mode="drop")
    out = out.at[jj].add(y[:, 6:], mode="drop")
    return out[:num_frames]


def dense_rhs(sys: DensePairSystem, num_frames: int):
    """-Jtr contribution [N, 6]."""
    i = sys.pairs[:, 0]
    j = sys.pairs[:, 1]
    bb = jnp.where(sys.mask[:, None], sys.b, 0.0)
    out = jnp.zeros((num_frames + 1, 6), sys.b.dtype)
    out = out.at[jnp.where(sys.mask, i, num_frames)].add(bb[:, :6], mode="drop")
    out = out.at[jnp.where(sys.mask, j, num_frames)].add(bb[:, 6:], mode="drop")
    return -out[:num_frames]


def dense_precond_blocks(sys: DensePairSystem, num_frames: int):
    """Per-frame 6x6 diagonal blocks of the dense JtJ (for block-Jacobi)."""
    i = sys.pairs[:, 0]
    j = sys.pairs[:, 1]
    Hii = jnp.where(sys.mask[:, None, None], sys.H[:, :6, :6], 0.0)
    Hjj = jnp.where(sys.mask[:, None, None], sys.H[:, 6:, 6:], 0.0)
    out = jnp.zeros((num_frames + 1, 6, 6), sys.H.dtype)
    out = out.at[jnp.where(sys.mask, i, num_frames)].add(Hii, mode="drop")
    out = out.at[jnp.where(sys.mask, j, num_frames)].add(Hjj, mode="drop")
    return out[:num_frames]


def dense_block_matrix(sys: DensePairSystem, num_frames: int):
    """Assemble the dense-term contribution as a full [N, N, 6, 6] block
    grid (for the direct reduced solve; P is small — 64 pairs at the local
    solve — so the scatter is trivial)."""
    import jax.numpy as jnp

    N = num_frames
    i = jnp.where(sys.mask, sys.pairs[:, 0], N)
    j = jnp.where(sys.mask, sys.pairs[:, 1], N)
    Hm = jnp.where(sys.mask[:, None, None], sys.H, 0.0)
    A = jnp.zeros((N + 1, N + 1, 6, 6), sys.H.dtype)
    A = A.at[i, i].add(Hm[:, :6, :6], mode="drop")
    A = A.at[i, j].add(Hm[:, :6, 6:], mode="drop")
    A = A.at[j, i].add(Hm[:, 6:, :6], mode="drop")
    A = A.at[j, j].add(Hm[:, 6:, 6:], mode="drop")
    return A[:N, :N]

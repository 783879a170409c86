"""Match-filter cascade: greedy Kabsch -> surface area -> dense verify.

Fixed-shape re-design of the reference's three-stage correspondence filter
(``SIFTImageManager.cu``: ``FilterKeyPointMatchesCU:186-263`` via
``cuda_kabsch.h:422-506``, ``FilterMatchesBySurfaceAreaCU:318-391`` via
``cuda_surfaceArea.h``, ``FilterMatchesByDenseVerifyCU:491-606``). Each
stage is a jittable fixed-shape function vmapped over image pairs.

Notes on fidelity:
- The greedy Kabsch filter mirrors the reference's distance-ordered greedy
  consensus build (pixel-dedup at 5 px, 3x3 SVD fit, max-residual^2 bound,
  condition-number degeneracy checks at 100). The reference's inner
  "strip-worst-until-ok" loop is replaced by accept/reject of each candidate
  against the current consensus — same contract (<= 25 inliers + rigid
  transform or rejection), fully maskable; validated against the NumPy
  oracle port of the reference CPU filter (``tests/oracles/match_filter.py``,
  mirroring ``SIFTMatchFilter::filterKeyPointMatches``) plus behavioral
  recover/reject tests in ``tests/test_filters.py``.
- Surface-area: 3D PCA of matched points, project to dominant plane, 2D PCA
  oriented-bounding-box area; pair rejected iff BOTH images' areas fall
  below the threshold (0.032).
- Dense verify: symmetric projective depth/normal agreement over the 80x60
  cache with the reference's exact residual/weight/corr accounting,
  including the "known-bad free-space violation" term.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from bundlefusion_tpu.geometry.kabsch import kabsch_fast, sym3_eigenvalues
from bundlefusion_tpu.geometry.camera import CameraIntrinsics

PIXEL_DIST_THRESH = 5.0        # MATCH_FILTER_PIXEL_DIST_THRESH (cuda_kabsch.h:278)
CONDITION_THRESH = 100.0       # KABSCH_CONDITION_THRESH (cuda_kabsch.h:279)


# ---------------------------------------------------------------------------
# Stage 1: greedy Kabsch filter
# ---------------------------------------------------------------------------


def _cov_cond(pts, w):
    """largest/second eigenvalue ratio of the weighted covariance (coplanar ok).

    Uses the analytic symmetric-3x3 eigenvalue solver — this runs once per
    greedy step per pair, so LAPACK-style eigvalsh would dominate runtime.
    """
    w = jnp.where(jnp.isfinite(pts).all(-1), w, 0.0)
    pts = jnp.where(w[:, None] > 0, pts, 0.0)
    wsum = jnp.maximum(jnp.sum(w), 1e-12)
    mu = jnp.sum(pts * w[:, None], 0) / wsum
    c = (pts - mu) * w[:, None]
    cov = c.T @ (pts - mu) / wsum
    ev = sym3_eigenvalues(cov)  # ascending
    return jnp.abs(ev[2] / jnp.where(jnp.abs(ev[1]) > 1e-12, ev[1], 1e-12))


def _cross_cov_cond(src, tgt, w):
    """sigma1/sigma2 of the weighted Kabsch cross-covariance (the
    reference's ``c1`` condition, cuda_kabschReference.h:418)."""
    fin = jnp.isfinite(src).all(-1) & jnp.isfinite(tgt).all(-1)
    w = jnp.where(fin, w, 0.0)
    src = jnp.where(w[:, None] > 0, src, 0.0)
    tgt = jnp.where(w[:, None] > 0, tgt, 0.0)
    wn = w / (jnp.sum(w) + 1e-12)
    mu_s = jnp.sum(src * wn[:, None], 0)
    mu_t = jnp.sum(tgt * wn[:, None], 0)
    H = ((src - mu_s) * wn[:, None]).T @ (tgt - mu_t)
    ev = sym3_eigenvalues(H.T @ H)  # ascending; singular values^2
    s2 = jnp.sqrt(jnp.maximum(ev, 0.0))
    return jnp.abs(s2[2] / jnp.where(s2[1] > 1e-12, s2[1], 1e-12))


def kabsch_filter_pair(
    src_pts,
    tgt_pts,
    pix_src,
    pix_tgt,
    valid,
    max_filtered: int = 25,
    min_num_matches: int = 4,
    max_res2: float = 4e-4,
):
    """Greedy geometric-consistency filter for one image pair.

    Args:
      src_pts/tgt_pts: [R, 3] back-projected keypoint positions of the raw
        matches, sorted ascending by descriptor distance.
      pix_src/pix_tgt: [R, 2] pixel positions (for the 5 px dedup).
      valid: [R] raw-match validity. MUST be prefix-contiguous (all True
        entries before the first False): the early-exit scan stops at the
        first invalid entry, exactly like the reference's candidate loop.
        ``matching.py`` guarantees this (top-k sorts invalid entries to the
        tail); any other caller must too.

    Returns dict with ``inlier_mask`` [R], ``count``, ``transform`` (4x4
    src->tgt), ``valid_pair``.
    """
    R = src_pts.shape[0]

    def _geo(mask):
        """Fit + stats of the masked consensus: (T, residuals[R], maxres,
        cond_ok). Residuals are squared, under the new fit."""
        w = mask.astype(jnp.float32)
        T_new, _ = kabsch_fast(src_pts, tgt_pts, w)
        res = jnp.sum(
            (src_pts @ T_new[:3, :3].T + T_new[:3, 3] - tgt_pts) ** 2, -1
        )
        maxres = jnp.max(jnp.where(mask, res, -jnp.inf))
        c1 = _cross_cov_cond(src_pts, tgt_pts, w)
        c_src = _cov_cond(src_pts, w)
        c_tgt = _cov_cond(tgt_pts, w)
        cond_ok = (
            (c1 < CONDITION_THRESH)
            & (c_src < CONDITION_THRESH)
            & (c_tgt < CONDITION_THRESH)
        )
        return T_new, res, maxres, cond_ok

    def body(state):
        i, inlier, count, T, maxres, validT = state
        cand_ok = valid[i] & (count < max_filtered)
        # pixel-distance dedup vs current inliers (either image)
        d_s = jnp.linalg.norm(pix_src - pix_src[i], axis=-1)
        d_t = jnp.linalg.norm(pix_tgt - pix_tgt[i], axis=-1)
        dup = jnp.any(inlier & ((d_s <= PIXEL_DIST_THRESH) | (d_t <= PIXEL_DIST_THRESH)))
        cand_ok = cand_ok & ~dup

        def add_and_strip(args):
            """Reference semantics (cuda_kabschReference.h:458-496): always
            add the candidate, refit; while the max residual exceeds the
            bound, strip the worst inlier and refit — reverting the last
            removal if stripping down to 3 made things worse."""
            inlier, count, T, maxres, validT = args
            tentative = inlier.at[i].set(True)
            n_new = count + 1

            def lt3(a):
                # fewer than 3: accept without geometric checking
                return tentative, n_new, T, maxres, validT

            def ge3(a):
                T1, res1, m1, ok1 = _geo(tentative)
                # snapshot of the post-add fit: restored if stripping fails
                b, prev_T = ok1, T1

                def rm_cond(s):
                    mask, n, T, mres, okT, stop = s
                    return (mres > max_res2) & (n > 3) & ~stop

                def rm_body(s):
                    mask, n, T, mres, okT, stop = s
                    # worst inlier under the current fit
                    res = jnp.sum(
                        (src_pts @ T[:3, :3].T + T[:3, 3] - tgt_pts) ** 2, -1
                    )
                    worst = jnp.argmax(jnp.where(mask, res, -jnp.inf))
                    mask2 = mask.at[worst].set(False)
                    n2 = n - 1
                    T2, _, m2, ok2 = _geo(mask2)
                    # reference revert rule: stripping to 3 and it's still
                    # bad (or killed a previously-valid fit) -> restore the
                    # post-add state and stop
                    revert = (n2 == 3) & ((m2 > max_res2) | (b & ~ok2))
                    mask_o = jnp.where(revert, mask, mask2)
                    n_o = jnp.where(revert, n, n2)
                    T_o = jnp.where(revert, prev_T, T2)
                    m_o = jnp.where(revert, mres, m2)
                    ok_o = jnp.where(revert, b, ok2)
                    stop_o = revert | (m2 < max_res2)
                    return mask_o, n_o, T_o, m_o, ok_o, stop_o

                mask_f, n_f, T_f, m_f, ok_f, _ = jax.lax.while_loop(
                    rm_cond, rm_body,
                    (tentative, n_new, T1, m1, ok1, jnp.asarray(False)),
                )
                return mask_f, n_f, T_f, m_f, ok_f

            return jax.lax.cond(n_new < 3, lt3, ge3, 0)

        inlier, count, T, maxres, validT = jax.lax.cond(
            cand_ok,
            add_and_strip,
            lambda a: a,
            (inlier, count, T, maxres, validT),
        )
        return i + 1, inlier, count, T, maxres, validT

    def cont(state):
        # early exit like the reference's candidate loop (cuda_kabsch.h:430:
        # while curFiltered < maxFiltered && more matches): matches arrive
        # sorted with invalid entries at the tail, so the first invalid one
        # ends the scan (see the prefix-contiguity requirement above). Under
        # vmap this runs until the LAST pair finishes — typically ~30 steps
        # instead of R=128.
        i, _, count, *_ = state
        return (i < R) & (count < max_filtered) & valid[jnp.minimum(i, R - 1)]

    init = (
        jnp.asarray(0, jnp.int32),
        jnp.zeros((R,), bool),
        jnp.asarray(0, jnp.int32),
        jnp.eye(4, dtype=jnp.float32),
        jnp.asarray(100.0, jnp.float32),
        jnp.asarray(False),
    )
    _, inlier, count, T, maxres, validT = jax.lax.while_loop(cont, body, init)
    valid_pair = (count >= min_num_matches) & (maxres < max_res2) & validT
    inlier = inlier & valid_pair
    return {
        "inlier_mask": inlier,
        "count": jnp.where(valid_pair, count, 0),
        "transform": T,
        "valid_pair": valid_pair,
    }


kabsch_filter = jax.vmap(
    kabsch_filter_pair, in_axes=(0, 0, 0, 0, 0, None, None, None)
)


# ---------------------------------------------------------------------------
# Stage 2: surface-area filter
# ---------------------------------------------------------------------------


def _obb_area_2d(p2, w):
    """Oriented-bounding-box area of weighted 2D points (reference
    ``computeAreaOrientedBoundingBox2``)."""
    wsum = jnp.maximum(jnp.sum(w), 1e-12)
    mu = jnp.sum(p2 * w[:, None], 0) / wsum
    c = (p2 - mu) * w[:, None]
    cov = c.T @ (p2 - mu) / wsum
    _, evec = jnp.linalg.eigh(cov)
    proj = (p2 - 0.0) @ evec  # rotate into OBB space (translation irrelevant)
    big = 1e18
    pmax = jnp.max(jnp.where(w[:, None] > 0, proj, -big), 0)
    pmin = jnp.min(jnp.where(w[:, None] > 0, proj, big), 0)
    ext = pmax - pmin
    ok = jnp.all(ext > 1e-5)
    return jnp.where(ok, ext[0] * ext[1], 0.0)


def _surface_area_one(pts, w):
    """PCA-plane projected OBB area of one image's matched keypoints."""
    w = jnp.where(jnp.isfinite(pts).all(-1), w, 0.0)
    pts = jnp.where(w[:, None] > 0, pts, 0.0)
    wsum = jnp.maximum(jnp.sum(w), 1e-12)
    mu = jnp.sum(pts * w[:, None], 0) / wsum
    c = (pts - mu) * w[:, None]
    cov = c.T @ (pts - mu) / wsum
    _, evec = jnp.linalg.eigh(cov)  # ascending: evec[:, 2] = dominant
    ev0 = evec[:, 2]
    ev1 = evec[:, 1]
    ev2 = evec[:, 0]  # plane normal (smallest)
    rel = pts - mu
    s = rel - jnp.sum(rel * ev2, -1, keepdims=True) * ev2
    p2 = jnp.stack([s @ ev0, s @ ev1], -1)
    return _obb_area_2d(p2, w)


def surface_area_filter_pair(src_pts, tgt_pts, inlier_mask, area_thresh: float = 0.032):
    """Reject the pair if the matched keys are near-degenerate (tiny spanned
    area) in BOTH images. Returns (keep_bool, area_src, area_tgt)."""
    w = inlier_mask.astype(jnp.float32)
    a0 = _surface_area_one(src_pts, w)
    a1 = _surface_area_one(tgt_pts, w)
    keep = ~((a0 < area_thresh) & (a1 < area_thresh))
    keep = keep & (jnp.sum(w) > 0)
    return keep, a0, a1


surface_area_filter = jax.vmap(surface_area_filter_pair, in_axes=(0, 0, 0, None))


# ---------------------------------------------------------------------------
# Stage 3: dense verify
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DenseVerifyParams:
    dist_thresh: float = 0.15      # s_projCorrDistThres
    normal_thresh: float = 0.97    # s_projCorrNormalThres
    err_thresh: float = 0.075      # s_verifySiftErrThresh
    corr_thresh: float = 0.02      # s_verifySiftCorrThresh
    depth_min: float = 0.1
    depth_max: float = 4.0


def _proj_error_one_way(
    T,                      # input -> model transform [4,4]
    in_depth, in_campos, in_normal,
    md_depth, md_campos, md_normal,
    intr: CameraIntrinsics,
    p: DenseVerifyParams,
):
    """One direction of the symmetric projective check
    (reference ``computeProjError``, SIFTImageManager.cu:424-487).

    Returns (sum_residual, sum_weight, num_corr) scalars.
    """
    pin = in_campos                      # [H, W, 3]
    nin = in_normal
    din = in_depth
    ok_in = (
        jnp.isfinite(pin).all(-1)
        & jnp.isfinite(nin).all(-1)
        & jnp.isfinite(din)
        & (din >= p.depth_min)
        & (din <= p.depth_max)
    )
    pt = pin @ T[:3, :3].T + T[:3, 3]
    nt = nin @ T[:3, :3].T
    z = pt[..., 2]
    u = jnp.round(pt[..., 0] / jnp.maximum(z, 1e-6) * intr.fx + intr.cx).astype(jnp.int32)
    v = jnp.round(pt[..., 1] / jnp.maximum(z, 1e-6) * intr.fy + intr.cy).astype(jnp.int32)
    inb = (u >= 0) & (u < intr.width) & (v >= 0) & (v < intr.height) & (z > 0)
    uc = jnp.clip(u, 0, intr.width - 1)
    vc = jnp.clip(v, 0, intr.height - 1)
    # one-hot matmul resample of the depth/normal/color planes; sanitize
    # before stacking
    from bundlefusion_tpu.ops.resample import onehot_gather2d

    ok_md = (
        jnp.isfinite(md_campos).all(-1)
        & jnp.isfinite(md_normal).all(-1)
        & jnp.isfinite(md_depth)
    )
    stack_md = jnp.concatenate(
        [
            jnp.moveaxis(jnp.where(ok_md[..., None], md_campos, 0.0), -1, 0),
            jnp.moveaxis(jnp.where(ok_md[..., None], md_normal, 0.0), -1, 0),
            jnp.where(ok_md, md_depth, 0.0)[None],
            ok_md[None].astype(jnp.float32),
        ],
        axis=0,
    )  # [8, H, W]
    smp = onehot_gather2d(stack_md, vc, uc, inb)
    ptgt = smp[..., 0:3]
    ntgt = smp[..., 3:6]
    dtgt = smp[..., 6]
    ok_tgt = (
        (smp[..., 7] > 0.5)
        & (dtgt >= p.depth_min)
        & (dtgt <= p.depth_max)
    )
    d = jnp.linalg.norm(pt - ptgt, axis=-1)
    dn = jnp.sum(nt * ntgt, -1)
    proj_in_depth = z
    # free-space violation counts as a (bad) correspondence too
    known_bad = (proj_in_depth < dtgt) & (d > p.dist_thresh)
    good = (dn >= p.normal_thresh) & (d <= p.dist_thresh)
    counted = ok_in & inb & ok_tgt & (good | known_bad)
    z_norm = (z - p.depth_min) / (p.depth_max - p.depth_min)
    weight = jnp.maximum(0.0, 0.5 * ((1.0 - d / p.dist_thresh) + (1.0 - z_norm)))
    sum_res = jnp.sum(jnp.where(counted, d, 0.0))
    sum_w = jnp.sum(jnp.where(counted, weight, 0.0))
    n_corr = jnp.sum(counted.astype(jnp.float32))
    return sum_res, sum_w, n_corr


def dense_verify_pair(
    T_ij,
    depth_i, campos_i, normal_i,
    depth_j, campos_j, normal_j,
    intr: CameraIntrinsics,
    p: DenseVerifyParams = DenseVerifyParams(),
):
    """Symmetric dense verification of a relative transform between cached
    frames i (input) and j (model). Returns (keep_bool, err, corr_frac)."""
    from bundlefusion_tpu.geometry.lie import pose_inverse

    r1 = _proj_error_one_way(
        T_ij, depth_i, campos_i, normal_i, depth_j, campos_j, normal_j, intr, p
    )
    r2 = _proj_error_one_way(
        pose_inverse(T_ij), depth_j, campos_j, normal_j, depth_i, campos_i, normal_i, intr, p
    )
    sum_res = r1[0] + r2[0]
    sum_w = r1[1] + r2[1]
    n_corr = r1[2] + r2[2]
    err = sum_res / jnp.maximum(sum_w, 1e-12)
    corr = 0.5 * n_corr / float(intr.width * intr.height)
    keep = (corr >= p.corr_thresh) & (err <= p.err_thresh) & (sum_w > 0)
    return keep, err, corr


def dense_verify(
    T_ij,
    depth_i, campos_i, normal_i,
    depth_j, campos_j, normal_j,
    intr: CameraIntrinsics,
    p: DenseVerifyParams = DenseVerifyParams(),
):
    """Batched dense verification: pair inputs [P, ...] vs one model frame j.

    (intr and p are static config — closed over, not vmapped.)
    """
    fn = lambda T, d, cp, n: dense_verify_pair(
        T, d, cp, n, depth_j, campos_j, normal_j, intr, p
    )
    return jax.vmap(fn)(T_ij, depth_i, campos_i, normal_i)

"""Per-frame sparse-frontend orchestration: match + filter + residuals.

The jitted core of ``Bundler::matchAndFilter`` (Bundler.cpp:103-249): match
the current image against every previous image in its domain, run the
filter cascade, mark frame validity, emit EntryJ residuals, and produce the
chained per-frame pose estimate (``OnlineBundler::computeCurrentSiftTransform``
-> ``computeSiftTransformCU``, OnlineBundler.cu:6-71). Also keyframe fusion
(``SIFTImageManager::fuseToGlobal``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from bundlefusion_tpu.geometry.camera import CameraIntrinsics
from bundlefusion_tpu.geometry.lie import pose_inverse
from bundlefusion_tpu.ops.filters import (
    DenseVerifyParams,
    dense_verify_pair,
    kabsch_filter_pair,
    surface_area_filter_pair,
)
from bundlefusion_tpu.ops.matching import match_descriptors_pair
from bundlefusion_tpu.pipeline.frames import DenseCache, KeyframeStore, backproject_keys
from bundlefusion_tpu.solver.residuals import CorrStore, append_corrs


@dataclass(frozen=True)
class FrontendParams:
    sift_match_thresh: float = 0.7
    sift_match_ratio: float = 0.8
    num_raw_matches: int = 128
    max_filtered: int = 25
    min_num_matches: int = 4
    max_kabsch_res2: float = 4e-4
    surf_area_thresh: float = 0.032
    use_dense_verify: bool = True
    dense: DenseVerifyParams = DenseVerifyParams()


@partial(jax.jit, static_argnames=("intr_sift", "intr_cache", "params"))
def match_and_filter(
    cur_slot,
    keys: KeyframeStore,
    cache: DenseCache,
    intr_sift: CameraIntrinsics,
    intr_cache: CameraIntrinsics,
    params: FrontendParams = FrontendParams(),
    slots=None,
):
    """Match frame ``cur_slot`` against all previous slots in the store.

    Args:
      slots: optional [P'] int32 subset of store slots to match against
        (default: every slot). The multi-chip boundary step passes each
        device's chunk of the keyframe axis here, sharding the O(G)
        match + filter cascade over the mesh.

    Returns per-pair dict over P = len(slots) (= store capacity default):
      ``pair_valid`` [P], ``transforms`` [P, 4, 4] (cur -> prev),
      ``inlier_mask`` [P, R], ``idx_cur``/``idx_prev`` [P, R],
      ``p_cur``/``p_prev`` [P, R, 3] back-projected matched keypoints.
    """
    explicit_slots = slots is not None
    slots = jnp.arange(keys.capacity) if slots is None else slots
    cur_desc = keys.desc[cur_slot].astype(jnp.float32)
    cur_valid = keys.valid[cur_slot]
    cur_pos = keys.pos[cur_slot]
    cur_depth = keys.depth[cur_slot]

    cur_d = cache.depth[cur_slot] if params.use_dense_verify else None
    cur_cp = cache.campos[cur_slot] if params.use_dense_verify else None
    cur_n = cache.normal[cur_slot] if params.use_dense_verify else None

    def run_slots(slot_ids, raw_ids):
        """Full cascade over one set of slots (raw_ids: pre-clip ids for
        the active test)."""
        active = (
            (raw_ids < cur_slot)
            & (raw_ids < keys.capacity)
            & keys.frame_valid[slot_ids]
        )

        def match_one(slot):
            m = match_descriptors_pair(
                cur_desc,
                cur_valid,
                keys.desc[slot].astype(jnp.float32),
                keys.valid[slot],
                params.sift_match_thresh,
                params.sift_match_ratio,
                params.num_raw_matches,
            )
            # back-project matched keys
            pc = backproject_keys(
                cur_pos[m.idx_i], cur_depth[m.idx_i], intr_sift
            )
            pp = backproject_keys(
                keys.pos[slot][m.idx_j], keys.depth[slot][m.idx_j], intr_sift
            )
            pix_c = cur_pos[m.idx_i]
            pix_p = keys.pos[slot][m.idx_j]
            return m, pc, pp, pix_c, pix_p

        matches, p_cur, p_prev, pix_cur, pix_prev = jax.vmap(match_one)(slot_ids)
        match_valid = matches.valid & active[:, None]

        kf = jax.vmap(
            lambda pc, pp, xc, xp, v: kabsch_filter_pair(
                pc, pp, xc, xp, v,
                params.max_filtered, params.min_num_matches, params.max_kabsch_res2,
            )
        )(p_cur, p_prev, pix_cur, pix_prev, match_valid)

        sa_keep, _, _ = jax.vmap(
            lambda pc, pp, m: surface_area_filter_pair(pc, pp, m, params.surf_area_thresh)
        )(p_cur, p_prev, kf["inlier_mask"])

        pair_valid = kf["valid_pair"] & sa_keep

        if params.use_dense_verify:
            def dv_one(slot, T):
                # T maps cur -> prev; verify with input=cur, model=prev
                return dense_verify_pair(
                    T,
                    cur_d, cur_cp, cur_n,
                    cache.depth[slot], cache.campos[slot], cache.normal[slot],
                    intr_cache,
                    params.dense,
                )

            dv_keep, _dv_err, _dv_corr = jax.vmap(dv_one)(slot_ids, kf["transform"])
            pair_valid = pair_valid & dv_keep

        inlier = kf["inlier_mask"] & pair_valid[:, None]
        return {
            "pair_valid": pair_valid,
            "transforms": kf["transform"],
            "num_inliers": jnp.sum(inlier.astype(jnp.int32), -1),
            "inlier_mask": inlier,
            "idx_cur": matches.idx_i,
            "idx_prev": matches.idx_j,
            "p_cur": p_cur,
            "p_prev": p_prev,
        }

    if explicit_slots or keys.capacity <= 128:
        out = run_slots(slots, slots)
    else:
        # Chunked sweep with an early-exit cond per chunk: the store fills
        # sequentially (slot g is the g-th keyframe), so chunks entirely
        # above ``cur_slot`` can contribute nothing — skipping them makes
        # the O(G) match + filter cascade cost O(live keyframes) instead of
        # O(capacity) at the reference G=1200 capacity with ~100 live
        # keyframes. The reference's loop over
        # previous frames has the same live-count cost (Bundler.cpp:112).
        CB = 128
        P = keys.capacity
        NB = -(-P // CB)

        R = params.num_raw_matches
        out = {
            "pair_valid": jnp.zeros((NB * CB,), bool),
            "transforms": jnp.broadcast_to(
                jnp.eye(4, dtype=jnp.float32), (NB * CB, 4, 4)
            ),
            "num_inliers": jnp.zeros((NB * CB,), jnp.int32),
            "inlier_mask": jnp.zeros((NB * CB, R), bool),
            "idx_cur": jnp.zeros((NB * CB, R), jnp.int32),
            "idx_prev": jnp.zeros((NB * CB, R), jnp.int32),
            "p_cur": jnp.zeros((NB * CB, R, 3), jnp.float32),
            "p_prev": jnp.zeros((NB * CB, R, 3), jnp.float32),
        }

        def chunk_body(cidx, acc):
            start = cidx * CB
            raw = start + jnp.arange(CB, dtype=jnp.int32)
            ids = jnp.clip(raw, 0, P - 1)

            def do(acc):
                res = run_slots(ids, raw)
                return {
                    k: jax.lax.dynamic_update_slice(
                        acc[k],
                        res[k].astype(acc[k].dtype),
                        (start,) + (0,) * (acc[k].ndim - 1),
                    )
                    for k in acc
                }

            return jax.lax.cond(start < cur_slot, do, lambda a: a, acc)

        out = jax.lax.fori_loop(0, NB, chunk_body, out)
        out = {k: v[:P] for k, v in out.items()}

    out["cur_slot"] = cur_slot
    out["num_keys_per_frame"] = keys.keys_per_frame
    return out


@jax.jit
def add_to_residuals(
    store: CorrStore,
    mf,                    # output of match_and_filter
    cur_frame_global,      # int32 global image index of the current frame
    prev_frame_global,     # int32 [P] global image indices of the slots
) -> CorrStore:
    """Append surviving matches as EntryJ residuals
    (``AddCurrToResidualsCU``, SIFTImageManager.cu:610-687). Also records
    flat key ids (slot * K + key index) per endpoint — the reference's
    ``d_globMatchesKeyPointIndices`` — consumed by track fusion."""
    P, R = mf["inlier_mask"].shape
    K = mf["num_keys_per_frame"]
    v = mf["inlier_mask"].reshape(-1)
    img_i = jnp.broadcast_to(cur_frame_global, (P, R)).reshape(-1)
    img_j = jnp.broadcast_to(prev_frame_global[:, None], (P, R)).reshape(-1)
    cur_slot = mf["cur_slot"]
    key_i = (cur_slot * K + mf["idx_cur"]).reshape(-1)
    key_j = (jnp.arange(P, dtype=jnp.int32)[:, None] * K + mf["idx_prev"]).reshape(-1)
    return append_corrs(
        store,
        img_i.astype(jnp.int32),
        img_j.astype(jnp.int32),
        mf["p_cur"].reshape(-1, 3),
        mf["p_prev"].reshape(-1, 3),
        v,
        key_i.astype(jnp.int32),
        key_j.astype(jnp.int32),
    )


@jax.jit
def chained_sift_transform(mf, prev_world_transforms):
    """Pose of the current frame by chaining the best (nearest previous)
    filtered match (``computeSiftTransformCU``): T_world_cur =
    T_world_prev @ T_prev<-cur. mf["transforms"][p] maps cur -> prev.

    Args:
      prev_world_transforms: [P, 4, 4] world poses of the previous slots.

    Returns (T_world_cur [4,4], found bool, best_prev_slot int32).
    """
    P = mf["pair_valid"].shape[0]
    score = jnp.where(mf["pair_valid"], jnp.arange(P), -1)
    best = jnp.argmax(score)
    found = score[best] >= 0
    T = prev_world_transforms[best] @ mf["transforms"][best]
    return jnp.where(found, T, jnp.eye(4)), found, best


# maximum world-space corr error for a match to contribute to a track's
# averaged position (MAX_TRACK_CORR_ERROR, SIFTImageManager.cpp:380)
MAX_TRACK_CORR_ERROR = 0.03


@partial(jax.jit, static_argnames=("intr_sift", "max_out_keys"))
def fuse_keyframe(
    keys: KeyframeStore,
    corrs: CorrStore,
    local_world,           # [S, 4, 4] solved submap trajectory (frame->frame0)
    frame0_slot,
    intr_sift: CameraIntrinsics,
    max_out_keys: int = 1024,
):
    """Fuse a solved submap's keypoints into one keyframe in frame-0 coords
    by feature *tracks*, mirroring ``SIFTImageManager::fuseToGlobal`` +
    ``computeTracks`` (SIFTImageManager.cpp:380-476):

    - tracks = connected components of keypoints linked by the submap's
      filtered correspondences (label propagation over the corr edges —
      the XLA-friendly replacement for the reference's recursive
      ``findTrack``);
    - a track's position is the average of its members' solved-trajectory
      world positions, counting only corrs with error < 0.03 m (high-error
      corrs still join the component but contribute no position);
    - the representative descriptor/scale come from the track's seed key
      (lowest key id — the reference's ``track.front()``);
    - the averaged position projects into frame 0; up to ``max_out_keys``
      keys survive, nearest-depth first (the reference sorts by depth when
      exceeding the 1024 cap).

    Returns a dict of fused key arrays (pos/depth/response/valid/desc).
    """
    S, K = keys.valid.shape
    NK = S * K
    T0_inv = pose_inverse(local_world[frame0_slot])
    rel = jax.vmap(lambda T: T0_inv @ T)(local_world)               # [S, 4, 4]

    key_ok = (keys.valid & keys.frame_valid[:, None]).reshape(NK)

    # ---- edges ----
    v = corrs.valid_mask()
    ki = jnp.clip(corrs.key_i, 0, NK - 1)
    kj = jnp.clip(corrs.key_j, 0, NK - 1)
    v = v & key_ok[ki] & key_ok[kj]
    Ti = rel[jnp.clip(corrs.img_i, 0, S - 1)]
    Tj = rel[jnp.clip(corrs.img_j, 0, S - 1)]
    wi = jnp.einsum("cab,cb->ca", Ti[:, :3, :3], corrs.p_i) + Ti[:, :3, 3]
    wj = jnp.einsum("cab,cb->ca", Tj[:, :3, :3], corrs.p_j) + Tj[:, :3, 3]
    err = jnp.linalg.norm(wi - wj, axis=-1)
    low = v & (err < MAX_TRACK_CORR_ERROR)

    # ---- connected components by min-label propagation ----
    labels = jnp.where(key_ok, jnp.arange(NK, dtype=jnp.int32), NK)

    def prop(_, labels):
        li = labels[ki]
        lj = labels[kj]
        m = jnp.minimum(li, lj)
        labels = labels.at[jnp.where(v, ki, NK)].min(m, mode="drop")
        labels = labels.at[jnp.where(v, kj, NK)].min(m, mode="drop")
        return labels

    labels = jax.lax.fori_loop(0, S + 2, prop, labels)

    # ---- per-track position average over low-error members ----
    lab_e = jnp.where(low, labels[ki], NK)                          # == labels[kj]
    sum_pos = jnp.zeros((NK + 1, 3), jnp.float32)
    sum_pos = sum_pos.at[lab_e].add(wi + wj, mode="drop")
    cnt = jnp.zeros((NK + 1,), jnp.float32).at[lab_e].add(
        jnp.where(low, 2.0, 0.0), mode="drop"
    )
    avg = sum_pos[:NK] / jnp.maximum(cnt[:NK, None], 1.0)

    # ---- roots -> fused keys ----
    own = jnp.arange(NK, dtype=jnp.int32)
    root = key_ok & (labels == own) & (cnt[:NK] > 0)
    z = avg[:, 2]
    u = avg[:, 0] / jnp.maximum(z, 1e-6) * intr_sift.fx + intr_sift.cx
    vv = avg[:, 1] / jnp.maximum(z, 1e-6) * intr_sift.fy + intr_sift.cy
    out_ok = (
        root & (z > 0.05)
        & (u >= 0) & (u <= intr_sift.width - 1)
        & (vv >= 0) & (vv <= intr_sift.height - 1)
    )

    # nearest-depth-first cap (reference depth sort at the 1024 cap)
    score = jnp.where(out_ok, -z, -jnp.inf)
    k_eff = min(max_out_keys, NK)
    top_score, sel = jax.lax.top_k(score, k_eff)
    if k_eff < max_out_keys:
        pad = max_out_keys - k_eff
        top_score = jnp.concatenate([top_score, jnp.full((pad,), -jnp.inf)])
        sel = jnp.concatenate([sel, jnp.zeros((pad,), sel.dtype)])
    valid_out = jnp.isfinite(top_score)
    resp = keys.response.reshape(NK)
    return {
        "pos": jnp.stack([u[sel], vv[sel]], -1),
        "depth": z[sel],
        "response": jnp.where(valid_out, resp[sel], 0.0),
        "scale": keys.scale.reshape(NK)[sel],
        "valid": valid_out,
        "desc": keys.desc.reshape(NK, 128)[sel],
    }

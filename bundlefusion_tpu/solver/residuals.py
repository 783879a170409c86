"""Sparse 3D-3D correspondence store (the EntryJ equivalent).

The reference keeps a growing global array of ``EntryJ{imgIdx_i, imgIdx_j,
pos_i, pos_j}`` residuals built from filtered SIFT matches
(``SIFTImageManager.h:45-60``, ``AddCurrToResidualsCU:610-687``) and a
variables->correspondences table for the solver
(``CUDASolverBundling.cpp:286``). Here the store is a fixed-capacity
structure-of-arrays with -1 image indices marking invalid entries; the
corr table is unnecessary because J^T is applied with segment-sums.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class CorrStore(NamedTuple):
    img_i: jax.Array   # int32 [C], -1 = invalid
    img_j: jax.Array   # int32 [C]
    p_i: jax.Array     # float32 [C, 3] camera-space point in frame i
    p_j: jax.Array     # float32 [C, 3] camera-space point in frame j
    key_i: jax.Array   # int32 [C] flat keypoint id (slot * K + key index) —
                       # the d_globMatchesKeyPointIndices analog, used by
                       # track-based keyframe fusion
    key_j: jax.Array   # int32 [C]
    count: jax.Array   # int32 [] append cursor (entries may be invalidated)

    @property
    def capacity(self) -> int:
        return self.img_i.shape[0]

    def valid_mask(self):
        return self.img_i >= 0


def create_corr_store(capacity: int) -> CorrStore:
    return CorrStore(
        img_i=jnp.full((capacity,), -1, jnp.int32),
        img_j=jnp.full((capacity,), -1, jnp.int32),
        p_i=jnp.zeros((capacity, 3), jnp.float32),
        p_j=jnp.zeros((capacity, 3), jnp.float32),
        key_i=jnp.zeros((capacity,), jnp.int32),
        key_j=jnp.zeros((capacity,), jnp.int32),
        count=jnp.asarray(0, jnp.int32),
    )


def append_corrs(
    store: CorrStore, img_i, img_j, p_i, p_j, valid, key_i=None, key_j=None
) -> CorrStore:
    """Append a batch of correspondences at the cursor (mirrors
    ``AddCurrToResidualsCU`` which atomically appends surviving matches).

    Invalid entries are compacted out before appending; overflow drops
    (fixed capacity, like the reference's cap).
    """
    v = valid
    rank = jnp.cumsum(v.astype(jnp.int32)) - 1
    dst = jnp.where(v, store.count + rank, store.capacity)
    dst = jnp.where(dst < store.capacity, dst, store.capacity)
    n_added = jnp.minimum(
        jnp.sum(v.astype(jnp.int32)), store.capacity - store.count
    )
    if key_i is None:
        key_i = jnp.zeros_like(img_i)
    if key_j is None:
        key_j = jnp.zeros_like(img_j)
    return store._replace(
        img_i=store.img_i.at[dst].set(jnp.where(v, img_i, -1), mode="drop"),
        img_j=store.img_j.at[dst].set(jnp.where(v, img_j, -1), mode="drop"),
        p_i=store.p_i.at[dst].set(p_i, mode="drop"),
        p_j=store.p_j.at[dst].set(p_j, mode="drop"),
        key_i=store.key_i.at[dst].set(key_i, mode="drop"),
        key_j=store.key_j.at[dst].set(key_j, mode="drop"),
        count=store.count + n_added,
    )


def invalidate_image_pair(store: CorrStore, frame_a, frame_b) -> CorrStore:
    """Invalidate all corrs between a specific image pair (reference
    ``InvalidateImageToImageCU``)."""
    kill = ((store.img_i == frame_a) & (store.img_j == frame_b)) | (
        (store.img_i == frame_b) & (store.img_j == frame_a)
    )
    return store._replace(img_i=jnp.where(kill, -1, store.img_i))


def invalidate_frame(store: CorrStore, frame) -> CorrStore:
    """Invalidate all corrs touching a frame (used when a frame is marked
    invalid by verification / residual pruning)."""
    kill = (store.img_i == frame) | (store.img_j == frame)
    return store._replace(img_i=jnp.where(kill, -1, store.img_i))


def corr_counts_per_frame(store: CorrStore, num_frames: int):
    """Number of valid corrs per frame (reference ``CheckForInvalidFrames``
    uses this to invalidate frames left without correspondences)."""
    v = store.valid_mask()
    seg_i = jnp.where(v, store.img_i, num_frames)
    seg_j = jnp.where(v, store.img_j, num_frames)
    ones = jnp.ones_like(seg_i)
    c = jnp.zeros((num_frames + 1,), jnp.int32)
    c = c.at[seg_i].add(ones, mode="drop")
    c = c.at[seg_j].add(ones, mode="drop")
    return c[:num_frames]


def compact_corrs(store: CorrStore) -> CorrStore:
    """Reclaim invalidated slots: compact live corrs to a prefix and reset
    the append cursor.

    The reference's residual store is append-only (``AddCurrToResidualsCU``
    bump-allocates; invalidation only marks ``imgIdx_i = -1``), so a long
    run with heavy pruning leaks capacity. The sorted/masked design
    makes reclamation one fixed-shape pass: stable-compact the live rows,
    zero the tail, drop the cursor to the live count. Callers run this
    when ``count`` approaches capacity."""
    C = store.capacity
    v = store.valid_mask()
    idx = jnp.nonzero(v, size=C, fill_value=C)[0]
    ok = idx < C
    ci = jnp.clip(idx, 0, C - 1)
    n_live = jnp.sum(v.astype(jnp.int32))
    return CorrStore(
        img_i=jnp.where(ok, store.img_i[ci], -1),
        img_j=jnp.where(ok, store.img_j[ci], -1),
        p_i=jnp.where(ok[:, None], store.p_i[ci], 0.0),
        p_j=jnp.where(ok[:, None], store.p_j[ci], 0.0),
        key_i=jnp.where(ok, store.key_i[ci], -1),
        key_j=jnp.where(ok, store.key_j[ci], -1),
        count=n_live,
    )

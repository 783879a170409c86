"""Batched SIFT descriptor matching as matrix products.

Replaces the reference's descriptor-matching kernels
(``ProgramCU.cu``: ``MultiplyDescriptor_Kernel:1634`` (all-pairs dot
products), ``RowMatch_Kernel:1772`` / ``ColMatch_Kernel:1852`` (mutual best
with distance + ratio tests), driven by ``SiftMatchGPU::GetSiftMatch``
(``SiftMatch.cpp``) with distmax = s_siftMatchThresh (0.7), ratiomax = 0.8,
capped at MAX_MATCHES_PER_IMAGE_PAIR_RAW = 128 sorted matches) and the
per-pair sort kernel ``SortKeyPointMatchesCU`` (SIFTImageManager.cu:59-143).

Design: descriptors are unit vectors; the [K, 128] x [128, K] similarity
matrix is one matmul per pair (batched over pairs in a single
[P*K, 128] x [128, K] or [P, K, 128] einsum, in bf16 with float32
accumulation — a tensor-core shape). Distance = sqrt(2 - 2 dot). Mutual-best + distance + ratio tests
are row/col argmax reductions; top-128 sort via ``lax.top_k``.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

MAX_RAW_MATCHES = 128  # MAX_MATCHES_PER_IMAGE_PAIR_RAW (GlobalDefines.h:8)


class PairMatches(NamedTuple):
    """Raw matches for (a batch of) image pairs, sorted by distance."""

    idx_i: jax.Array     # [..., M] keypoint index in image i (current)
    idx_j: jax.Array     # [..., M] keypoint index in image j (previous)
    dist: jax.Array      # [..., M] descriptor distance
    valid: jax.Array     # [..., M] bool


def match_descriptors_pair(
    desc_i,
    valid_i,
    desc_j,
    valid_j,
    dist_max: float = 0.7,
    ratio_max: float = 0.8,
    num_matches: int = MAX_RAW_MATCHES,
) -> PairMatches:
    """Mutual-best matching between two keypoint sets.

    Args:
      desc_i: [K, 128] unit descriptors of the current image.
      desc_j: [K, 128] unit descriptors of a previous image.
      valid_i/valid_j: [K] masks.

    A match (a, b) survives iff: b = argmin_b d(a, b), a = argmin_a d(a, b),
    d < dist_max, and d / d_second < ratio_max (second-best in the row).
    Output is the top ``num_matches`` by ascending distance.
    """
    big = jnp.float32(1e9)
    # bf16 is plenty for descriptor dot products and runs on the tensor cores
    sim = jnp.dot(
        desc_i.astype(jnp.bfloat16),
        desc_j.astype(jnp.bfloat16).T,
        preferred_element_type=jnp.float32,
    )
    d2 = jnp.maximum(2.0 - 2.0 * sim, 0.0)
    dist = jnp.sqrt(d2)
    mask = valid_i[:, None] & valid_j[None, :]
    dist = jnp.where(mask, dist, big)

    best_j = jnp.argmin(dist, axis=1)                       # [K]
    row_best = jnp.min(dist, axis=1)
    # second best in row for the ratio test
    row_wo_best = jnp.where(
        jax.nn.one_hot(best_j, dist.shape[1], dtype=bool), big, dist
    )
    row_second = jnp.min(row_wo_best, axis=1)
    best_i = jnp.argmin(dist, axis=0)                       # [K]
    mutual = best_i[best_j] == jnp.arange(dist.shape[0])
    ok = (
        mutual
        & (row_best < dist_max)
        & (row_best < ratio_max * row_second)
        & valid_i
    )
    score = jnp.where(ok, row_best, big)
    k = min(num_matches, score.shape[0])
    top_d, top_i = jax.lax.top_k(-score, k)
    top_d = -top_d
    if k < num_matches:  # pad to the fixed match cap
        pad = num_matches - k
        top_d = jnp.concatenate([top_d, jnp.full((pad,), big)])
        top_i = jnp.concatenate([top_i, jnp.zeros((pad,), top_i.dtype)])
    return PairMatches(
        idx_i=top_i.astype(jnp.int32),
        idx_j=best_j[jnp.clip(top_i, 0, score.shape[0] - 1)].astype(jnp.int32),
        dist=top_d,
        valid=top_d < dist_max,
    )


match_descriptors = jax.vmap(
    match_descriptors_pair, in_axes=(None, None, 0, 0, None, None, None)
)


@partial(jax.jit, static_argnames=("dist_max", "ratio_max", "num_matches"))
def match_current_against_previous(
    desc_cur,
    valid_cur,
    desc_prev,
    valid_prev,
    active_prev,
    dist_max: float = 0.7,
    ratio_max: float = 0.8,
    num_matches: int = MAX_RAW_MATCHES,
) -> PairMatches:
    """Match the current image against a stack of previous images.

    Args:
      desc_cur: [K, 128]; valid_cur: [K].
      desc_prev: [P, K, 128]; valid_prev: [P, K].
      active_prev: [P] which previous images participate (invalid frames
        are skipped, as in ``Bundler::matchAndFilter`` which only matches
        valid previous frames).

    Returns PairMatches with leading dim P; inactive pairs fully invalid.
    """
    m = match_descriptors(
        desc_cur, valid_cur, desc_prev, valid_prev, dist_max, ratio_max, num_matches
    )
    act = active_prev[:, None]
    return PairMatches(
        idx_i=m.idx_i, idx_j=m.idx_j, dist=m.dist, valid=m.valid & act
    )

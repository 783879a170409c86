"""Sparse bundle-adjustment: Gauss-Newton with a matrix-free PCG inner loop.

Re-design of the reference GPU solver (``Solver/SolverBundling.cu``,
``CUDASolverBundling.{h,cpp}``, energy in ``SolverBundlingEquationsLie.h``):

- variables: per-frame poses as 6-vectors [omega, t] in Lie space
  (``USE_LIE_SPACE``), first pose fixed (x == 0 skipped everywhere,
  ``SolverBundling.cu:762``).
- sparse energy: r_c = T_i p_i - T_j p_j over the EntryJ correspondence
  store (``evalFDevice``, SolverBundlingEquationsLie.h:42-57).
- GN outer loop x PCG inner loop with Jacobi preconditioning, PCG early-out
  |alpha_num| < 5e-7 (``SolverBundling.cu:1088-1093``) and GN early-out
  max|delta| < 0.005 (``EvalGNConvergence:694-749``).

Design — **pair-reduced systems** (the scalable replacement for both
the reference's per-PCG-iteration J/J^T kernels over a variables->corrs
table, CUDASolverBundling.cpp:286, and this module's former [C, N] one-hot
incidence matmuls, which cost O(C*N) memory/FLOPs per PCG step):

1. once per solve: sort correspondences by pair id (img_i * N + img_j);
2. once per GN iteration: per-corr residuals + exact ``jax.jacfwd``
   Jacobian blocks, then a segment reduction over the sorted runs (one
   cumulative sum + two row-gathers at segment boundaries) into per-pair 12x12 JtJ blocks and 12-vector Jtr, exactly like the
   dense term's ``DensePairSystem``;
3. per PCG iteration: O(P) matvecs — two [P, 6] pose gathers, one
   [P, 12, 12] block contraction, and two SORTED segment reductions back
   into per-pose rows (``PairSeg``). No [P, N] incidence materializes:
   at the capacity regime (P = 131072 pairs, N = 640+ keyframes) a
   one-hot form would read ~670 MB per PCG iteration.

Block-Jacobi preconditioning (6x6 per pose, a strict upgrade over the
reference's diagonal), fixed shapes throughout, invalid corrs carry zero
weight. A boundary's residual-pruning rounds reuse one sort
(``presort_corrs`` + ``solve_sparse_presorted``); pruning only flips
validity bits.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from bundlefusion_tpu.geometry.lie import so3_exp
from bundlefusion_tpu.solver.residuals import CorrStore

_BIG = jnp.int32(2**31 - 1)


def _chunk_size(C: int) -> int | None:
    """Chunk length for capacity-C passes, or None for a single pass.

    Large chunks matter: fixed 16384-corr chunks would mean 512
    sequential loop iterations of tiny work per reduction at the 2^23
    capacity store — loop overhead, not bandwidth. A chunk of
    262144 keeps transient buffers (per-corr Jacobians etc.) tens of MB
    while cutting the sequential depth 16x."""
    for kb in (262144, 65536, 16384):
        if C > kb and C % kb == 0:
            return kb
    return None


@dataclass(frozen=True)
class SolverParams:
    num_gn: int = 3                  # nonlinear iterations
    num_pcg: int = 150               # linear iterations
    pcg_early_out: float = 5e-7
    gn_early_out_delta: float = 0.005
    sparse_weight: float = 1.0
    max_pairs: int = 4096            # active (i, j) pair capacity
    max_working_corrs: int = 131072  # live corrs entering one solve; the
                                     # store capacity can be far larger
                                     # (262144 at reference defaults) and
                                     # the per-solve sort/gather work
                                     # scales with THIS, not capacity;
                                     # overflow surfaces in dropped
    linear: str = "auto"             # linear step: "dense" (direct LU on
                                     # the reduced [6N, 6N] system),
                                     # "pcg" (matrix-free), or
                                     # "auto" = dense for N <= 2048


class SolveStats(NamedTuple):
    initial_cost: jax.Array
    final_cost: jax.Array
    num_gn_done: jax.Array
    max_residual: jax.Array        # max per-axis component (SBA.cpp semantics)
    max_residual_corr: jax.Array   # corr index of the max residual
    num_pairs_dropped: jax.Array   # pairs beyond max_pairs (0 = exact solve)


def _residual_one(pose_i, pose_j, p_i, p_j):
    """r = T_i p_i - T_j p_j for one correspondence (3-vector)."""
    Ri = so3_exp(pose_i[:3])
    Rj = so3_exp(pose_j[:3])
    return (Ri @ p_i + pose_i[3:]) - (Rj @ p_j + pose_j[3:])


_res_batch = jax.vmap(_residual_one)
# exact per-corr Jacobian blocks d r / d pose_i, d r / d pose_j: [3, 6] each
_jac_batch = jax.vmap(jax.jacfwd(_residual_one, argnums=(0, 1)))


def _gather_poses(poses, idx):
    return poses[jnp.clip(idx, 0, poses.shape[0] - 1)]


def compute_residuals(poses, corrs: CorrStore):
    """[C, 3] residuals and [C] validity (invalid corrs -> 0 residual)."""
    v = corrs.valid_mask()
    pi = _gather_poses(poses, corrs.img_i)
    pj = _gather_poses(poses, corrs.img_j)
    r = _res_batch(pi, pj, corrs.p_i, corrs.p_j)
    return jnp.where(v[:, None], r, 0.0), v


def _chunked_residual_reduce(poses, corrs: CorrStore, reduce_fn, init):
    """Run ``reduce_fn(acc, r_chunk, v_chunk, start)`` over chunks of the
    corr store up to the APPEND CURSOR (``corrs.count``); the capacity tail
    beyond the cursor is skipped by a cond. The guard must be the cursor,
    not the live count: invalidation (``invalidate_image_pair/_frame``)
    punches holes without moving the cursor, so live corrs legally sit at
    any index < count until compaction re-establishes the prefix
    (``compact_corrs`` resets count to the live count). Falls back to one
    pass for small/ragged stores."""
    C = corrs.capacity
    KB = _chunk_size(C)
    if KB is None:
        r, v = compute_residuals(poses, corrs)
        return reduce_fn(init, r, v, 0)
    cursor = corrs.count

    def body(cidx, acc):
        start = cidx * KB

        def do(acc):
            sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start, KB, 0)
            v = sl(corrs.img_i) >= 0  # valid_mask semantics
            pi = _gather_poses(poses, sl(corrs.img_i))
            pj = _gather_poses(poses, sl(corrs.img_j))
            r = _res_batch(pi, pj, sl(corrs.p_i), sl(corrs.p_j))
            r = jnp.where(v[:, None], r, 0.0)
            return reduce_fn(acc, r, v, start)

        return jax.lax.cond(start < cursor, do, lambda a: a, acc)

    return jax.lax.fori_loop(0, C // KB, body, init)


def max_residual(poses, corrs: CorrStore):
    """Max |per-axis component| over valid corrs + its corr index
    (reference ``computeMaxResidual``; s_optMaxResThresh is per-axis)."""

    def red(acc, r, v, start):
        best, best_idx = acc
        m = jnp.where(v, jnp.max(jnp.abs(r), axis=-1), -1.0)
        i = jnp.argmax(m)
        better = m[i] > best
        return (
            jnp.where(better, m[i], best),
            jnp.where(better, start + i, best_idx),
        )

    return _chunked_residual_reduce(
        poses, corrs, red, (jnp.asarray(-1.0), jnp.asarray(0))
    )


def count_high_residuals(poses, corrs: CorrStore, thresh: float = 0.02):
    """Fraction-based verification (reference ``useVerification``,
    CUDASolverBundling.cpp:454-476): returns (num_high, num_valid)."""

    def red(acc, r, v, start):
        m = jnp.max(jnp.abs(r), axis=-1)
        high = v & (m > thresh)
        return (
            acc[0] + jnp.sum(high.astype(jnp.int32)),
            acc[1] + jnp.sum(v.astype(jnp.int32)),
        )

    return _chunked_residual_reduce(
        poses, corrs, red, (jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32))
    )


def cost(poses, corrs: CorrStore):
    def red(acc, r, v, start):
        return acc + jnp.sum(r * r)

    return _chunked_residual_reduce(poses, corrs, red, jnp.asarray(0.0))


# ---------------------------------------------------------------------------
# pair-reduced sparse system
# ---------------------------------------------------------------------------


class SortedCorrs(NamedTuple):
    """Correspondences sorted by pair id + the segment structure (fixed per
    solve — the analog of ``buildVariablesToCorrespondencesTableCUDA``)."""

    img_i: jax.Array     # [C] sorted
    img_j: jax.Array     # [C]
    p_i: jax.Array       # [C, 3]
    p_j: jax.Array       # [C, 3]
    valid: jax.Array     # [C] bool
    seg_id: jax.Array    # [C] pair/segment index of each sorted corr
                         #     (== max_pairs for invalid or dropped corrs)
    starts: jax.Array    # [P] segment start index into the sorted arrays
    ends: jax.Array      # [P] segment end index (inclusive)
    pair_i: jax.Array    # [P] pose index i of the pair
    pair_j: jax.Array    # [P]
    pair_valid: jax.Array  # [P] bool
    dropped: jax.Array   # [] int32: segments beyond the P cap


def _pair_chunk(P: int) -> int | None:
    """Chunk length for per-PCG-iteration pair passes, or None for one
    pass. Live pairs are a prefix of the pair arrays, so dynamic-bound
    while loops touch only ceil(n_pairs / PB) chunks — the padded pair
    capacity (H is ~151 MB at P = 262144) stops costing memory bandwidth
    per PCG iteration."""
    for pb in (32768, 8192):
        if P > pb and P % pb == 0:
            return pb
    return None


def _ranked_working_indices(corrs: CorrStore, num_frames: int, working: int):
    """Pair-budgeted working-set selection for the overflow regime.

    When live corrs exceed the working capacity, the old policy (keep the
    lowest-indexed = OLDEST prefix) preferentially dropped fresh loop
    closures — the most valuable residuals in the store. This ranks every
    live corr by (round-robin rank within its pair, pair recency): rank 0
    is each pair's newest corr, so every pair keeps ~working/P corrs before
    any pair gets a second helping, and within a rank newer pairs (recent
    loop closures) win. The reference bounds the same work per-image
    instead (``m_maxCorrPerImage`` = clamp(maxRes/maxIm, 1000, 4000),
    CUDASolverBundling.cpp:39); a per-pair budget is the equivalent bound
    for a pair-segment solver. Returns a [C] keep-mask (so the caller's
    stable compaction preserves append = pid order)."""
    C = corrs.capacity
    idx = jnp.arange(C)
    v = corrs.valid_mask()
    pid = jnp.where(v, corrs.img_i * num_frames + corrs.img_j, _BIG)
    # group by pair, newest-first within pair: stable argsort of the
    # reversed pid array (reversal makes "newest" the stable winner)
    o_pair = jnp.argsort(pid[::-1], stable=True)
    orig_g = C - 1 - o_pair           # original index of each grouped entry
    pid_g = pid[::-1][o_pair]
    vg = pid_g != _BIG
    is_start = vg & jnp.concatenate(
        [jnp.ones((1,), bool), pid_g[1:] != pid_g[:-1]]
    )
    seg_start = jax.lax.cummax(jnp.where(is_start, idx, 0))
    rank_g = jnp.where(vg, idx - seg_start, _BIG)
    # pair recency = original index of the pair's newest corr (appends are
    # chronological); smaller key2 = newer pair
    rec_g = orig_g[seg_start]
    key2_g = jnp.where(vg, C - 1 - rec_g, _BIG)
    # lexicographic (rank, newest-pair-first): stable sort by key2 then rank
    o_b = jnp.argsort(key2_g, stable=True)
    o_c = jnp.argsort(rank_g[o_b], stable=True)
    sel = o_b[o_c[:working]]
    keep_pos = jnp.where(rank_g[sel] != _BIG, orig_g[sel], C)
    return jnp.zeros((C,), bool).at[keep_pos].set(True, mode="drop")


def sort_corrs_by_pair(
    corrs: CorrStore, num_frames: int, max_pairs: int,
    working: int | None = None,
) -> SortedCorrs:
    """Sort the corr store by (img_i, img_j) and find segment boundaries.

    ``working``: optional live-corr working capacity. When smaller than the
    store, live corrs are COMPACTED (one cumsum pass) into a [working]
    array before sorting, so the argsort + order-gathers scale with the
    working set instead of store capacity (262144 at reference defaults).
    On overflow (live
    > working) the selection switches to a pair-budgeted ranking that keeps
    every pair's newest corrs (see ``_ranked_working_indices``); the
    excess is surfaced in ``dropped``.

    Sort-free fast path: the engine's stores are pid-sorted BY CONSTRUCTION
    (``add_to_residuals`` appends the current frame's pairs with ascending
    previous index, boundaries have ascending current index, and
    compactions are stable), so a one-pass monotonicity check usually
    replaces the argsort of a multi-million-entry working set. Revalidation appends (old
    keyframes re-matching) break monotonicity and fall back to the real
    sort.

    The working window is a STATIC SLICE of the store's first ``working``
    rows (the append cursor rarely passes it between the engine's periodic
    compactions), not a live-compaction: it avoids a full-capacity
    ``jnp.nonzero`` compaction of the 2^23 capacity store per boundary.
    Invalidation holes inside the window are tolerated: segment
    construction FILLS each hole with the enclosing pair id (cummax), so a
    pair id still maps to exactly one segment (the unique-index contract
    of the dense-assembly inverse maps) and hole entries ride along with
    zero contribution through the validity masks."""
    C = corrs.capacity
    extra_dropped = jnp.asarray(0, jnp.int32)
    if working is not None and working < C:
        vfull = corrs.valid_mask()
        n_live_full = jnp.sum(vfull.astype(jnp.int32))

        def cheap(_):
            # static contiguous slice — order-preserving, no gathers
            return (
                corrs.img_i[:working], corrs.img_j[:working],
                corrs.p_i[:working], corrs.p_j[:working],
                corrs.key_i[:working], corrs.key_j[:working],
            )

        def ranked(_):
            keep = _ranked_working_indices(corrs, num_frames, working)
            idx = jnp.nonzero(keep, size=working, fill_value=C)[0]
            ci = jnp.clip(idx, 0, C - 1)
            ok = idx < C
            return (
                jnp.where(ok, corrs.img_i[ci], -1),
                jnp.where(ok, corrs.img_j[ci], -1),
                jnp.where(ok[:, None], corrs.p_i[ci], 0.0),
                jnp.where(ok[:, None], corrs.p_j[ci], 0.0),
                jnp.where(ok, corrs.key_i[ci], -1),
                jnp.where(ok, corrs.key_j[ci], -1),
            )

        # the expensive ranked selection only runs when the CURSOR passes
        # the window (the engine compacts the store long before that in
        # the common regime)
        img_i, img_j, p_i, p_j, key_i, key_j = jax.lax.cond(
            corrs.count > working, ranked, cheap, operand=None
        )
        corrs = corrs._replace(
            img_i=img_i, img_j=img_j, p_i=p_i, p_j=p_j,
            key_i=key_i, key_j=key_j,
        )
        C = working
        n_live_window = jnp.sum((img_i >= 0).astype(jnp.int32))
        extra_dropped = jnp.maximum(n_live_full - n_live_window, 0)
    v = corrs.valid_mask()
    pid = jnp.where(v, corrs.img_i * num_frames + corrs.img_j, _BIG)
    if C > 65536:
        # monotone-over-valid check (holes allowed): pid[k] >= max of all
        # earlier valid pids -> the identity order IS a valid sort for the
        # hole-filling segment construction below
        pm = jax.lax.cummax(jnp.where(v, pid, jnp.int32(-1)))
        pm_prev = jnp.concatenate([jnp.full((1,), -1, jnp.int32), pm[:-1]])
        vals_ok = jnp.all(~v | (pid >= pm_prev))
        order = jax.lax.cond(
            vals_ok,
            lambda: jnp.arange(C),
            lambda: jnp.argsort(pid),
        )
    else:
        order = jnp.argsort(pid)
    img_i_s = corrs.img_i[order]
    img_j_s = corrs.img_j[order]
    v_s = img_i_s >= 0
    pid_s = jnp.where(v_s, img_i_s * num_frames + img_j_s, _BIG)
    # hole-filled pair ids: invalid entries inherit the previous valid pid,
    # so holes merge into the enclosing segment instead of splitting it
    pid_fill = jax.lax.cummax(jnp.where(v_s, pid_s, jnp.int32(-1)))
    prev_fill = jnp.concatenate([jnp.full((1,), -1, jnp.int32), pid_fill[:-1]])
    is_start = v_s & (pid_s != prev_fill)
    n_seg = jnp.sum(is_start.astype(jnp.int32))
    pair_valid = jnp.arange(max_pairs) < n_seg
    # per-corr segment id: holes ride with the enclosing segment (their
    # contributions are zeroed by the validity masks everywhere); entries
    # before the first valid corr map to segment 0 the same way; beyond
    # the pair cap -> the dropped bucket. Monotone by construction.
    cum_starts = jnp.cumsum(is_start.astype(jnp.int32))
    seg_raw = cum_starts - 1
    seg_id = jnp.minimum(jnp.maximum(seg_raw, 0), max_pairs)
    # segment boundaries without a full-length nonzero: cum_starts is
    # monotone and steps exactly at each segment's first VALID entry, so
    # starts[s] = first position with cum_starts == s + 1 (leading holes
    # carry seg_id 0 but cum_starts 0, so they are correctly skipped);
    # ends[s] includes any trailing holes riding the segment (unused
    # downstream beyond bounds)
    sq = jnp.arange(max_pairs)
    starts = jnp.clip(jnp.searchsorted(cum_starts, sq + 1, side="left"), 0, C - 1)
    ends = jnp.clip(jnp.searchsorted(cum_starts, sq + 1, side="right") - 1, 0, C - 1)
    return SortedCorrs(
        img_i=img_i_s,
        img_j=img_j_s,
        p_i=corrs.p_i[order],
        p_j=corrs.p_j[order],
        valid=v_s,
        seg_id=seg_id,
        starts=starts,
        ends=ends,
        pair_i=jnp.where(pair_valid, img_i_s[starts], 0),
        pair_j=jnp.where(pair_valid, img_j_s[starts], 0),
        pair_valid=pair_valid,
        dropped=jnp.maximum(n_seg - max_pairs, 0) + extra_dropped,
    )


def build_sparse_pair_system(poses, sc: SortedCorrs, w_sqrt, n_live=None):
    """Per-GN-iteration reduction: exact per-corr Jacobians -> per-pair
    H [P, 12, 12] / b [P, 12] via a sorted segment-sum over the runs
    (``segment_sum`` with monotone ids — no global f32 prefix-sum
    differencing, so late segments keep full precision at high corr
    counts). Returns (H, b).

    ``n_live``: optional live-corr count. The sorted arrays hold all live
    corrs as a PREFIX (invalid sort to the end), so when given, the C-sized
    pass runs in chunks with a cond skip past the live prefix — cost scales
    with occupancy, not store capacity (the reference-capacity 262144-corr
    store made every GN iteration pay full price at ~2K live corrs)."""
    P_cap = sc.pair_valid.shape[0]
    C = sc.valid.shape[0]

    def contrib_of(valid, img_i, img_j, p_i, p_j, seg_id):
        vf = valid.astype(jnp.float32)[:, None] * w_sqrt
        pi = _gather_poses(poses, img_i)
        pj = _gather_poses(poses, img_j)
        r = _res_batch(pi, pj, p_i, p_j) * vf             # [c, 3]
        Ji, Jj = _jac_batch(pi, pj, p_i, p_j)             # [c, 3, 6]
        Ji = Ji * vf[..., None]
        Jj = Jj * vf[..., None]
        J = jnp.concatenate([Ji, Jj], axis=-1)            # [c, 3, 12]
        Hc = jnp.einsum("cri,crj->cij", J, J)             # [c, 12, 12]
        bc = jnp.einsum("cri,cr->ci", J, r)               # [c, 12]
        contrib = jnp.concatenate([Hc.reshape(-1, 144), bc], axis=-1)
        return jax.ops.segment_sum(
            contrib, seg_id, num_segments=P_cap + 1, indices_are_sorted=True
        )

    KB = _chunk_size(C)
    if n_live is None or KB is None:
        seg = contrib_of(
            sc.valid, sc.img_i, sc.img_j, sc.p_i, sc.p_j, sc.seg_id
        )[:P_cap]
    else:
        def body(cidx, acc):
            start = cidx * KB

            def do(acc):
                sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start, KB, 0)
                return acc + contrib_of(
                    sl(sc.valid), sl(sc.img_i), sl(sc.img_j),
                    sl(sc.p_i), sl(sc.p_j), sl(sc.seg_id),
                )

            return jax.lax.cond(start < n_live, do, lambda a: a, acc)

        acc = jax.lax.fori_loop(
            0, C // KB, body, jnp.zeros((P_cap + 1, 156), jnp.float32)
        )
        seg = acc[:P_cap]
    seg = jnp.where(sc.pair_valid[:, None], seg, 0.0)
    H = seg[:, :144].reshape(-1, 12, 12)
    b = seg[:, 144:156]
    return H, b


class PairSeg(NamedTuple):
    """Segment structure for pair->pose reductions, built once per solve.

    Replaces [P, N] one-hot incidence matmuls: at the capacity regime
    (P = 131072 pairs, N = 640 keyframes) the two one-hots would take
    ~670 MB, re-read by every PCG iteration. The
    segment-sum form is O(P) per matvec: two [P, 6] gathers, one
    [P, 12, 12] block contraction, two sorted segment reductions.
    """

    pair_i: jax.Array     # [P] pose index i (clamped for gathers)
    pair_j: jax.Array     # [P]
    order_i: jax.Array    # [P] permutation sorting pairs by i (identity
                          #     perm when pair_i arrives pre-sorted)
    seg_i: jax.Array      # [P] pair_i[order_i], invalid -> N (sorted)
    order_j: jax.Array    # [P] permutation sorting pairs by j
    seg_j: jax.Array      # [P] pair_j[order_j], invalid -> N (sorted)


def make_pair_seg(
    pair_i, pair_j, pair_valid, num_frames: int, assume_sorted_i: bool = True
) -> PairSeg:
    """Build the reduction structure. With ``assume_sorted_i`` (the
    ``sort_corrs_by_pair`` contract: pairs come from a sort by
    pid = i * N + j, invalid pairs form the tail) the i-side permutation is
    the identity; pass False for pair lists that are only piecewise sorted
    (e.g. all_gather-ed per-shard lists in the sharded solver)."""
    N = num_frames
    i_key = jnp.where(pair_valid, pair_i, N)
    j_key = jnp.where(pair_valid, pair_j, N)
    if assume_sorted_i:
        order_i = jnp.arange(pair_i.shape[0])
        seg_i = i_key
    else:
        order_i = jnp.argsort(i_key)
        seg_i = i_key[order_i]
    order_j = jnp.argsort(j_key)
    return PairSeg(
        pair_i=jnp.clip(pair_i, 0, N - 1),
        pair_j=jnp.clip(pair_j, 0, N - 1),
        order_i=order_i,
        seg_i=seg_i,
        order_j=order_j,
        seg_j=j_key[order_j],
    )


def _seg_reduce(ps: PairSeg, val_i, val_j, N: int):
    """Sum per-pair i-side / j-side contributions into per-pose rows.
    val_i / val_j: [P, D]. Returns [N, D]. ``N`` is static (PairSeg is a
    pytree that flows through scan/cond carries, so the frame count cannot
    live inside it without getting traced)."""
    yi = jax.ops.segment_sum(
        val_i[ps.order_i], ps.seg_i, num_segments=N + 1,
        indices_are_sorted=True,
    )
    yj = jax.ops.segment_sum(
        val_j[ps.order_j], ps.seg_j, num_segments=N + 1,
        indices_are_sorted=True,
    )
    return yi[:N] + yj[:N]


def _pair_matvec_f32(H, ps: PairSeg, x, n_pairs=None):
    """x [N, 6] -> sum_p S_p^T H_p S_p x via sorted segment reductions.
    Invalid pairs carry zero H blocks (zeroed in the system build), so
    their gathered x contributions vanish.

    ``n_pairs``: optional live-pair count. Valid pairs are a prefix in
    both the pid order and the j-sorted order (invalid keys sort last), so
    when given, the two reduction passes run as dynamic-bound while loops
    over the live prefix — per-PCG-iteration traffic scales with live
    pairs, not pair capacity (H alone is ~151 MB at P = 262144; live runs
    at the drift operating point are a few thousand to ~10^5 pairs)."""
    N = x.shape[0]
    P = ps.seg_i.shape[0]
    PB = _pair_chunk(P)
    if n_pairs is None or PB is None:
        xi = x[ps.pair_i]                                 # [P, 6]
        xj = x[ps.pair_j]
        xij = jnp.concatenate([xi, xj], axis=-1)          # [P, 12]
        y = jnp.einsum("pab,pb->pa", H, xij)              # [P, 12]
        return _seg_reduce(ps, y[:, :6], y[:, 6:], N)

    def y_of(Hc, pic, pjc):
        xij = jnp.concatenate([x[pic], x[pjc]], axis=-1)
        return jnp.einsum("pab,pb->pa", Hc, xij)

    def pass_i(state):
        start, acc = state
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start, PB, 0)
        # i-side: identity order (order_i is iota under the
        # sort_corrs_by_pair contract), slice H/pairs/segments directly
        y = y_of(sl(H), sl(ps.pair_i), sl(ps.pair_j))
        acc = acc + jax.ops.segment_sum(
            y[:, :6], sl(ps.seg_i), num_segments=N + 1,
            indices_are_sorted=True,
        )
        return start + PB, acc

    def pass_j(state):
        start, acc = state
        oc = jax.lax.dynamic_slice_in_dim(ps.order_j, start, PB, 0)
        y = y_of(H[oc], ps.pair_i[oc], ps.pair_j[oc])
        acc = acc + jax.ops.segment_sum(
            y[:, 6:],
            jax.lax.dynamic_slice_in_dim(ps.seg_j, start, PB, 0),
            num_segments=N + 1, indices_are_sorted=True,
        )
        return start + PB, acc

    cond = lambda state: state[0] < n_pairs
    z = jnp.zeros((N + 1, 6), jnp.float32)
    _, acc_i = jax.lax.while_loop(cond, pass_i, (jnp.asarray(0), z))
    _, acc_j = jax.lax.while_loop(cond, pass_j, (jnp.asarray(0), z))
    return acc_i[:N] + acc_j[:N]


def _pair_rhs(b, ps: PairSeg, N: int):
    return _seg_reduce(ps, b[:, :6], b[:, 6:], N)


def _pair_precond(H, ps: PairSeg, N: int):
    """Block-Jacobi 6x6 blocks: sum of each pose's ii/jj diagonal blocks."""
    Hii = H[:, :6, :6].reshape(-1, 36)
    Hjj = H[:, 6:, 6:].reshape(-1, 36)
    return _seg_reduce(ps, Hii, Hjj, N).reshape(N, 6, 6)


class PresortedProblem(NamedTuple):
    """One solve's sorted correspondence structure, reusable across the
    residual-pruning rounds of a submap boundary (pruning only flips
    validity bits, the sort order never changes)."""

    sc: SortedCorrs
    ps: PairSeg
    n_live: jax.Array   # chunk bound: one past the last valid entry in
                        # ``sc`` at sort time (holes may sit below it;
                        # invalidation never adds valid entries beyond it,
                        # so it stays a correct bound)
    inv_i: jax.Array    # [N*N] flat (i, j) -> pair index (P = none); the
                        # dense-assembly GATHER maps (built once per solve;
                        # they replace scatter-assembling the [6N, 6N])
    inv_j: jax.Array    # [N*N] flat (j, i) -> pair index


def _pair_inverse_maps(ps: PairSeg, pair_valid, num_frames: int):
    """Inverse maps for dense assembly: for each flat block position
    r = a * N + b, the index of the pair whose (i, j) == (a, b) (via the
    sorted unique pid list) and the pair whose (j, i) == (a, b)."""
    N = num_frames
    P = ps.seg_i.shape[0]
    NN = N * N
    idx = jnp.arange(P, dtype=jnp.int32)
    fi = jnp.where(pair_valid, ps.pair_i * N + ps.pair_j, NN)  # unique
    fj = jnp.where(pair_valid, ps.pair_j * N + ps.pair_i, NN)  # unique
    inv_i = jnp.full((NN + 1,), P, jnp.int32).at[fi].set(idx, mode="drop")
    inv_j = jnp.full((NN + 1,), P, jnp.int32).at[fj].set(idx, mode="drop")
    return inv_i[:NN], inv_j[:NN]


def presort_corrs(
    corrs: CorrStore, num_frames: int, params: SolverParams
) -> PresortedProblem:
    P_cap = min(params.max_pairs, num_frames * (num_frames + 1) // 2 + 1)
    sc = sort_corrs_by_pair(
        corrs, num_frames, P_cap, working=params.max_working_corrs
    )
    ps = make_pair_seg(sc.pair_i, sc.pair_j, sc.pair_valid, num_frames)
    # chunk bound for the working-set passes: one past the LAST valid
    # entry (the identity-order fast path keeps invalidation holes in
    # place, so "live count" is not a valid bound)
    Cw = sc.valid.shape[0]
    n_live = jnp.max(jnp.where(sc.valid, jnp.arange(Cw) + 1, 0))
    use_dense = params.linear == "dense" or (
        params.linear == "auto" and num_frames <= 2048
    )
    if use_dense:
        inv_i, inv_j = _pair_inverse_maps(ps, sc.pair_valid, num_frames)
    else:
        inv_i = inv_j = jnp.zeros((0,), jnp.int32)
    return PresortedProblem(
        sc=sc, ps=ps, n_live=n_live, inv_i=inv_i, inv_j=inv_j
    )


def _dense_reduced_solve(
    H, b, prob: PresortedProblem, free_f, N: int,
    A_extra=None, rhs_extra=None,
):
    """Assemble the reduced camera system A = J^T J [6N, 6N] from the
    per-pair 12x12 blocks and solve A delta = -J^T r DIRECTLY (LU).

    Replacement for the PCG inner loop when N is moderate (<= ~2048
    poses): a 150-iteration matrix-free PCG issues ~10 small device ops
    per iteration, while the direct solve is one dense factorization of
    at most 3840x3840 (N = 640). Which is faster on the GPU is not
    measured. The reference's PCG (``SolverBundling.cu:1024-1108``) is an
    implementation choice, not part of the behavioral contract — the
    energy and the GN outer loop are.

    Assembly: off-diagonal (i, j) blocks are unique per pair, so the
    [N, N] block grid is GATHERED through the precomputed inverse maps
    (``_pair_inverse_maps``) instead of scatter-added. Diagonal blocks are
    the block-Jacobi reduction we already have. LU (``jnp.linalg.solve``)
    and not Cholesky: an earlier build saw a Cholesky custom call
    miscompile when a program held more than one factorization chain
    (the first chain's inputs read as zero); LU was correct in the same
    program shapes. Fixed/invalid poses and poses with empty
    diagonal blocks get identity rows/cols so their delta is exactly 0.
    """
    P = H.shape[0]
    NN = N * N
    Hij = jnp.concatenate(
        [H[:, :6, 6:].reshape(P, 36), jnp.zeros((1, 36), jnp.float32)]
    )
    Hji = jnp.concatenate(
        [H[:, 6:, :6].reshape(P, 36), jnp.zeros((1, 36), jnp.float32)]
    )
    off = Hij[prob.inv_i] + Hji[prob.inv_j]            # [NN, 36]
    diag = _pair_precond(H, prob.ps, N)                # [N, 6, 6]

    A = off.reshape(N, N, 6, 6)
    A = A.at[jnp.arange(N), jnp.arange(N)].add(diag)
    rhs = -_pair_rhs(b, prob.ps, N)                    # [N, 6]
    if A_extra is not None:
        A = A + A_extra
        diag = diag + A_extra[jnp.arange(N), jnp.arange(N)]
    if rhs_extra is not None:
        rhs = rhs + rhs_extra

    # freeze fixed poses + poses with no constraints this solve
    strength = jnp.trace(diag, axis1=-2, axis2=-1)     # [N]
    act = (free_f[:, 0] > 0) & (strength > 1e-9)
    actf = act.astype(jnp.float32)
    A = A * (actf[:, None, None, None] * actf[None, :, None, None])
    A = A.at[jnp.arange(N), jnp.arange(N)].add(
        jnp.eye(6) * jnp.where(act, 1e-6 * jnp.maximum(strength, 1.0), 1.0)[:, None, None]
    )
    rhs = rhs * actf[:, None]

    Ad = A.transpose(0, 2, 1, 3).reshape(6 * N, 6 * N)
    delta = jnp.linalg.solve(Ad, rhs.reshape(6 * N)).reshape(N, 6)
    delta = delta * actf[:, None]
    # a failed factorization (singular after aggressive pruning) must not
    # poison the trajectory: fall back to no update
    return jnp.where(jnp.all(jnp.isfinite(delta)), delta, 0.0)


def solve_sparse_presorted(
    poses, pose_valid, prob: PresortedProblem, params: SolverParams
):
    """GN over a presorted problem; returns the updated poses only
    (no cost/max-residual passes — callers in the pruning loop use
    ``max_residual_sorted``). The linear step is a direct dense reduced
    solve for moderate N, PCG otherwise (``SolverParams.linear``)."""
    N = poses.shape[0]
    use_dense = params.linear == "dense" or (
        params.linear == "auto" and N <= 2048
    )
    w_sqrt = jnp.sqrt(jnp.asarray(params.sparse_weight, jnp.float32))
    free = pose_valid & (jnp.arange(N) != 0)
    free_f = free.astype(jnp.float32)[:, None]
    sc, ps, n_live = prob.sc, prob.ps, prob.n_live
    n_pairs = jnp.sum(sc.pair_valid.astype(jnp.int32))

    if use_dense:
        # unrolled (num_gn is static and small): a rolled fori_loop is the
        # shape in which the factorization miscompile above manifested.
        # Converged iterations are cond-skipped — the steady state
        # converges in one GN step.
        done = jnp.asarray(False)
        p = poses

        def gn_step(p):
            H, b = build_sparse_pair_system(p, sc, w_sqrt, n_live=n_live)
            delta = _dense_reduced_solve(H, b, prob, free_f, N)
            return p + delta * free_f, jnp.max(jnp.abs(delta))

        for _ in range(params.num_gn):
            p, max_delta = jax.lax.cond(
                done, lambda p: (p, jnp.asarray(0.0)), gn_step, p
            )
            done = done | (max_delta < params.gn_early_out_delta)
        return p

    def gn_iter(it, carry):
        poses, done = carry
        H, b = build_sparse_pair_system(poses, sc, w_sqrt, n_live=n_live)
        rhs = -_pair_rhs(b, ps, N) * free_f

        P = _pair_precond(H, ps, N) + jnp.eye(6) * 1e-6
        P_inv = jnp.linalg.inv(P)

        def apply_P(x):
            return jnp.einsum("nij,nj->ni", P_inv, x) * free_f

        def A(x):
            return _pair_matvec_f32(H, ps, x * free_f, n_pairs=n_pairs) * free_f

        # PCG
        x0 = jnp.zeros_like(poses)
        r0 = rhs
        z0 = apply_P(r0)
        rz0 = jnp.sum(r0 * z0)

        def pcg_body(state):
            k, x, rr, z, p, rz = state
            Ap = A(p)
            pAp = jnp.sum(p * Ap)
            alpha = jnp.where(jnp.abs(pAp) > 1e-20, rz / pAp, 0.0)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z = apply_P(rr)
            rz_new = jnp.sum(rr * z)
            beta = jnp.where(jnp.abs(rz) > 1e-20, rz_new / rz, 0.0)
            return k + 1, x, rr, z, z + beta * p, rz_new

        def pcg_cond(state):
            k, x, rr, z, p, rz = state
            return (k < params.num_pcg) & (jnp.abs(rz) > params.pcg_early_out)

        state = (jnp.asarray(0), x0, r0, z0, z0, rz0)
        _, delta, *_ = jax.lax.while_loop(pcg_cond, pcg_body, state)

        max_delta = jnp.max(jnp.abs(delta))
        new_poses = jnp.where(done, poses, poses + delta * free_f)
        new_done = done | (max_delta < params.gn_early_out_delta)
        return new_poses, new_done

    poses_out, _ = jax.lax.fori_loop(
        0, params.num_gn, gn_iter, (poses, jnp.asarray(False))
    )
    return poses_out


def max_residual_sorted(poses, prob: PresortedProblem):
    """Max |per-axis component| over the presorted working set + the image
    pair (fa, fb) of the argmax corr (fa = -1 when nothing is valid).
    The ``computeMaxResidual`` analog for the pruning loop — operating on
    the working set the solve actually saw."""
    sc, n_live = prob.sc, prob.n_live
    C = sc.valid.shape[0]
    KB = _chunk_size(C)

    def red(acc, r, v, start, img_i, img_j):
        best, fa, fb = acc
        m = jnp.where(v, jnp.max(jnp.abs(r), axis=-1), -1.0)
        i = jnp.argmax(m)
        better = m[i] > best
        return (
            jnp.where(better, m[i], best),
            jnp.where(better, img_i[i], fa),
            jnp.where(better, img_j[i], fb),
        )

    init = (jnp.asarray(-1.0), jnp.asarray(-1, jnp.int32),
            jnp.asarray(-1, jnp.int32))
    if KB is None:
        v = sc.valid
        pi = _gather_poses(poses, sc.img_i)
        pj = _gather_poses(poses, sc.img_j)
        r = jnp.where(
            v[:, None], _res_batch(pi, pj, sc.p_i, sc.p_j), 0.0
        )
        return red(init, r, v, 0, sc.img_i, sc.img_j)

    def body(cidx, acc):
        start = cidx * KB

        def do(acc):
            sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start, KB, 0)
            v = sl(sc.valid)
            ii, jj = sl(sc.img_i), sl(sc.img_j)
            pi = _gather_poses(poses, ii)
            pj = _gather_poses(poses, jj)
            r = jnp.where(
                v[:, None], _res_batch(pi, pj, sl(sc.p_i), sl(sc.p_j)), 0.0
            )
            return red(acc, r, v, start, ii, jj)

        return jax.lax.cond(start < n_live, do, lambda a: a, acc)

    return jax.lax.fori_loop(0, C // KB, body, init)


def invalidate_pair_sorted(prob: PresortedProblem, fa, fb) -> PresortedProblem:
    """Flip validity bits of all working-set corrs on pair (fa, fb) —
    the sorted structure is otherwise unchanged (fully-invalidated pairs
    contribute zero blocks through the validity weights)."""
    sc = prob.sc
    kill = ((sc.img_i == fa) & (sc.img_j == fb)) | (
        (sc.img_i == fb) & (sc.img_j == fa)
    )
    return prob._replace(sc=sc._replace(valid=sc.valid & ~kill))


def apply_pair_kill_sorted(
    prob: PresortedProblem, killed, num_frames: int
) -> PresortedProblem:
    """Apply a per-pair kill mask (``killed`` [N*N+1] bool, indexed by
    pid = i * N + j) to the working set."""
    sc = prob.sc
    pid = jnp.where(
        sc.valid, sc.img_i * num_frames + sc.img_j, num_frames * num_frames
    )
    return prob._replace(sc=sc._replace(valid=sc.valid & ~killed[pid]))


def corr_counts_per_frame_sorted(prob: PresortedProblem, num_frames: int):
    """Per-frame live-corr counts over the presorted WORKING set (the
    ``CheckForInvalidFrames`` input). The full-store twin
    (``residuals.corr_counts_per_frame``) scatter-adds over the whole
    store capacity (2^23 in the capacity run); this form does chunked
    SORTED segment sums over the live prefix only.
    Counts only cover the working set the solver actually saw — consistent
    with the reference, which counts over the solver's residual set
    (``CUDASolverBundling``'s corr table)."""
    sc = prob.sc
    C = sc.valid.shape[0]
    P_cap = sc.pair_valid.shape[0]
    KB = _chunk_size(C)

    def chunk_counts(acc, valid, seg_id):
        return acc + jax.ops.segment_sum(
            valid.astype(jnp.int32), seg_id, num_segments=P_cap + 1,
            indices_are_sorted=True,
        )

    if KB is None:
        pc = chunk_counts(
            jnp.zeros((P_cap + 1,), jnp.int32), sc.valid, sc.seg_id
        )
    else:
        def body(state):
            start, acc = state
            sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start, KB, 0)
            return start + KB, chunk_counts(acc, sl(sc.valid), sl(sc.seg_id))

        _, pc = jax.lax.while_loop(
            lambda s: s[0] < prob.n_live, body,
            (jnp.asarray(0), jnp.zeros((P_cap + 1,), jnp.int32)),
        )
    pcf = pc[:P_cap].astype(jnp.float32)[:, None]
    counts = _seg_reduce(prob.ps, pcf, pcf, num_frames)
    return counts[:, 0].astype(jnp.int32)


def guided_kill_mask(
    poses_now,
    poses_prev,
    prob: PresortedProblem,
    cur_frame,
    mr,
    num_frames: int,
    min_sep: int = 10,
    mr_gate: float = 0.2,
    prev_factor: float = 1.5,
):
    """NEW_GUIDED_REMOVE analog (CUDASolverBundling.cpp:298-427) over the
    presorted working set: per-pair kill flags [N*N+1] for long-range pairs
    of the newest keyframe whose residual is high NOW and was
    ``prev_factor``x higher under the previous trajectory (a bad loop
    closure, not drift). Chunked over the working arrays."""
    sc, n_live = prob.sc, prob.n_live
    C = sc.valid.shape[0]
    NN = num_frames * num_frames
    hi_thresh = jnp.clip(0.2 * mr, 0.1, 0.4)

    def add_kills(killed, v, img_i, img_j, p_i, p_j):
        pi_now = _gather_poses(poses_now, img_i)
        pj_now = _gather_poses(poses_now, img_j)
        m_now = jnp.max(jnp.abs(_res_batch(pi_now, pj_now, p_i, p_j)), -1)
        pi_prev = _gather_poses(poses_prev, img_i)
        pj_prev = _gather_poses(poses_prev, img_j)
        m_prev = jnp.max(jnp.abs(_res_batch(pi_prev, pj_prev, p_i, p_j)), -1)
        qual = (
            v & (mr > mr_gate)
            & (m_now > hi_thresh)
            & (img_i == cur_frame)
            & (jnp.abs(img_i - img_j) > min_sep)
            & (m_prev > prev_factor * m_now)
        )
        pid = jnp.where(qual, img_i * num_frames + img_j, NN)
        return killed.at[pid].set(True, mode="drop")

    killed0 = jnp.zeros((NN + 1,), bool)
    KB = _chunk_size(C)
    if KB is None:
        return add_kills(
            killed0, sc.valid, sc.img_i, sc.img_j, sc.p_i, sc.p_j
        ).at[NN].set(False)

    def body(cidx, killed):
        start = cidx * KB

        def do(killed):
            sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start, KB, 0)
            return add_kills(
                killed, sl(sc.valid), sl(sc.img_i), sl(sc.img_j),
                sl(sc.p_i), sl(sc.p_j),
            )

        return jax.lax.cond(start < n_live, do, lambda k: k, killed)

    killed = jax.lax.fori_loop(0, C // KB, body, killed0)
    return killed.at[NN].set(False)


def apply_pair_kill_store(corrs: CorrStore, killed, num_frames: int) -> CorrStore:
    """Apply a per-pair kill mask to the full store (bookkeeping twin of
    ``apply_pair_kill_sorted``)."""
    pid = jnp.where(
        corrs.valid_mask(),
        corrs.img_i * num_frames + corrs.img_j,
        num_frames * num_frames,
    )
    return corrs._replace(img_i=jnp.where(killed[pid], -1, corrs.img_i))


@partial(jax.jit, static_argnames=("params", "num_frames_static"))
def solve_sparse(
    poses,
    pose_valid,
    corrs: CorrStore,
    params: SolverParams = SolverParams(),
    num_frames_static: int | None = None,
):
    """Run GN/PCG over the sparse 3D-3D energy.

    Args:
      poses: [N, 6] initial pose estimates ([omega, t], frame->world).
      pose_valid: [N] bool; invalid poses are frozen (and their corrs should
        already be invalidated by the caller).
      corrs: correspondence store.

    Returns (poses, SolveStats).
    """
    N = poses.shape[0]
    prob = presort_corrs(corrs, N, params)
    c0 = cost(poses, corrs)
    poses_out = solve_sparse_presorted(poses, pose_valid, prob, params)
    c1 = cost(poses_out, corrs)
    mr, mr_idx = max_residual(poses_out, corrs)
    stats = SolveStats(
        initial_cost=c0,
        final_cost=c1,
        num_gn_done=jnp.asarray(params.num_gn),
        max_residual=mr,
        max_residual_corr=mr_idx,
        num_pairs_dropped=prob.sc.dropped,
    )
    return poses_out, stats


@partial(jax.jit, static_argnames=("params", "intr", "dense_params", "w_color"))
def solve_bundle(
    poses,
    pose_valid,
    corrs: CorrStore,
    cache,
    intr,
    params: SolverParams = SolverParams(),
    dense_params=None,
    dense_weights=None,
    w_color: float = 0.0,
):
    """Sparse + dense GN/PCG (the reference's full ``solveBundlingStub``:
    per GN iteration rebuild the dense pair system from current poses, then
    PCG on A = J_s^T J_s + w_d * J_d^T J_d with block-Jacobi preconditioning).

    Args:
      cache: DenseCache over the same frame indexing as ``corrs``/poses.
      dense_weights: [num_gn] per-iteration dense-depth weights (reference
        schedules: local = iter+1, global-at-end = 15; ``SBA.cpp:28-38``).
      w_color: photometric weight (reference: 0.1 in the global-at-end solve).

    Returns (poses, SolveStats).
    """
    from bundlefusion_tpu.solver.dense_term import (
        DenseTermParams,
        build_dense_system,
        dense_block_matrix,
        dense_matvec,
        dense_precond_blocks,
        dense_rhs,
        find_overlapping_pairs,
    )

    dp = dense_params or DenseTermParams()
    N = poses.shape[0]
    use_dense_lin = params.linear == "dense" or (
        params.linear == "auto" and N <= 2048
    )
    if dense_weights is None:
        dense_weights = jnp.arange(1, params.num_gn + 1, dtype=jnp.float32)
    dense_weights = jnp.asarray(dense_weights, jnp.float32)
    w_sqrt = jnp.sqrt(jnp.asarray(params.sparse_weight, jnp.float32))
    P_cap = min(params.max_pairs, N * (N + 1) // 2 + 1)

    free = pose_valid & (jnp.arange(N) != 0)
    free_f = free.astype(jnp.float32)[:, None]
    prob = presort_corrs(corrs, N, params)
    sc, ps, n_live = prob.sc, prob.ps, prob.n_live
    n_pairs = jnp.sum(sc.pair_valid.astype(jnp.int32))
    c0 = cost(poses, corrs)

    if use_dense_lin:
        # direct LU on the combined sparse + weighted-dense reduced system
        # (same rationale and same miscompile avoidance as
        # solve_sparse_presorted's dense path)
        done = jnp.asarray(False)
        p = poses
        for it in range(params.num_gn):
            w_dense = dense_weights[min(it, dense_weights.shape[0] - 1)]

            def gn_step(p, w_dense=w_dense):
                H, b = build_sparse_pair_system(p, sc, w_sqrt, n_live=n_live)
                pairs, pair_mask = find_overlapping_pairs(
                    p, pose_valid, cache, intr, dp
                )
                dsys = build_dense_system(
                    p, pairs, pair_mask, cache, intr, dp, 1.0, w_color
                )
                delta = _dense_reduced_solve(
                    H, b, prob, free_f, N,
                    A_extra=w_dense * dense_block_matrix(dsys, N),
                    rhs_extra=w_dense * dense_rhs(dsys, N),
                )
                return p + delta * free_f, jnp.max(jnp.abs(delta))

            p, max_delta = jax.lax.cond(
                done, lambda p: (p, jnp.asarray(0.0)), gn_step, p
            )
            done = done | (max_delta < params.gn_early_out_delta)
        c1 = cost(p, corrs)
        mr, mr_idx = max_residual(p, corrs)
        return p, SolveStats(
            initial_cost=c0,
            final_cost=c1,
            num_gn_done=jnp.asarray(params.num_gn),
            max_residual=mr,
            max_residual_corr=mr_idx,
            num_pairs_dropped=sc.dropped,
        )

    def gn_iter(it, carry):
        poses, done = carry
        w_dense = dense_weights[jnp.minimum(it, dense_weights.shape[0] - 1)]

        H, b = build_sparse_pair_system(poses, sc, w_sqrt, n_live=n_live)
        pairs, pair_mask = find_overlapping_pairs(poses, pose_valid, cache, intr, dp)
        dsys = build_dense_system(poses, pairs, pair_mask, cache, intr, dp, 1.0, w_color)

        rhs = (-_pair_rhs(b, ps, N) + w_dense * dense_rhs(dsys, N)) * free_f

        P = (
            _pair_precond(H, ps, N)
            + w_dense * dense_precond_blocks(dsys, N)
            + jnp.eye(6) * 1e-6
        )
        P_inv = jnp.linalg.inv(P)

        def apply_P(x):
            return jnp.einsum("nij,nj->ni", P_inv, x) * free_f

        def A(x):
            xf = x * free_f
            return (
                _pair_matvec_f32(H, ps, xf, n_pairs=n_pairs)
                + w_dense * dense_matvec(dsys, xf, N)
            ) * free_f

        x0 = jnp.zeros_like(poses)
        r0 = rhs
        z0 = apply_P(r0)
        rz0 = jnp.sum(r0 * z0)

        def pcg_body(state):
            k, x, rr, z, p_, rz = state
            Ap = A(p_)
            pAp = jnp.sum(p_ * Ap)
            alpha = jnp.where(jnp.abs(pAp) > 1e-20, rz / pAp, 0.0)
            x = x + alpha * p_
            rr = rr - alpha * Ap
            z = apply_P(rr)
            rz_new = jnp.sum(rr * z)
            beta = jnp.where(jnp.abs(rz) > 1e-20, rz_new / rz, 0.0)
            return k + 1, x, rr, z, z + beta * p_, rz_new

        def pcg_cond(state):
            k, x, rr, z, p_, rz = state
            return (k < params.num_pcg) & (jnp.abs(rz) > params.pcg_early_out)

        _, delta, *_ = jax.lax.while_loop(
            pcg_cond, pcg_body, (jnp.asarray(0), x0, r0, z0, z0, rz0)
        )
        max_delta = jnp.max(jnp.abs(delta))
        poses = jnp.where(done, poses, poses + delta * free_f)
        done = done | (max_delta < params.gn_early_out_delta)
        return poses, done

    poses_out, _ = jax.lax.fori_loop(
        0, params.num_gn, gn_iter, (poses, jnp.asarray(False))
    )
    c1 = cost(poses_out, corrs)
    mr, mr_idx = max_residual(poses_out, corrs)
    return poses_out, SolveStats(
        initial_cost=c0,
        final_cost=c1,
        num_gn_done=jnp.asarray(params.num_gn),
        max_residual=mr,
        max_residual_corr=mr_idx,
        num_pairs_dropped=sc.dropped,
    )

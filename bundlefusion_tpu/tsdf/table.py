"""Block-sparse TSDF voxel table: a sorted-key voxel hash.

The reference implements a bucketed spatial hash with linked-list collision
chains, per-bucket mutexes and an atomic free-block heap
(``DepthSensing/VoxelUtilHashSDF.h:56-350``). None of that maps to XLA's
static-shape, race-free model. This design replaces it with a **sorted key
table**:

- ``keys``:   int32[capacity], packed block coordinates, sorted ascending,
  with EMPTY = int32 max as the sentinel (sorts last).
- ``slots``:  int32[capacity], voxel-data slot for each key.
- lookup    = ``jnp.searchsorted`` (vectorized binary search — no probing,
  no collision chains, O(log capacity) gathers per query).
- alloc     = sort-unique the frame's candidate block coords, drop those
  already present, pop slots from a free-list stack, then merge by
  re-sorting (EMPTY sentinels fall off the end). One sort per integrated
  frame, fully parallel, no atomics.
- free      = mark keys EMPTY, push slots back, re-sort.

Voxel payload per block (8^3 voxels, SDF_BLOCK_SIZE=8 as in the reference):
``sdf`` float32, ``weight`` float32, ``color`` float32 RGB premultiplied by
weight (so de-integration is a plain subtraction; the reference instead blends
colors 0.2/0.8 on integrate and inverts the blend on de-integrate,
``CUDASceneRepHashSDF.cu:420-521`` — premultiplied storage makes
integrate/de-integrate exactly inverse operations, which the reference's color
path is not). Color is stored channel-major, one flat row of
``3 * BLOCK_VOLUME`` per block. Payload arrays carry one extra hidden
**dummy row** at index ``num_blocks``: reads of padding entries land there
instead of needing masked gathers.

Block coordinates live in [-GRID_HALF, GRID_HALF)^3 and pack into 30 bits.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

BLOCK_SIZE = 8  # voxels per side (SDF_BLOCK_SIZE)
BLOCK_VOLUME = BLOCK_SIZE**3
GRID_BITS = 10  # 1024 blocks per axis
GRID_DIM = 1 << GRID_BITS
GRID_HALF = GRID_DIM // 2
EMPTY_KEY = jnp.int32(2**31 - 1)


class VoxelBlockTable(NamedTuple):
    """Pytree of arrays holding the sparse TSDF volume.

    Beyond the sorted key index, the table keeps a **slot-major inverse map**
    (``slot_keys``: payload row -> packed block coords, ``slot_geo``: the
    same as float block coords + live flag) and a ``high_water`` occupancy
    bound, so the TSDF update (``apply_ops.py``) selects its rows by a
    frustum test over payload rows without touching the key index. Slots
    are handed out ascending (and freed slots are reused first), so
    ``high_water`` stays close to the live block count.
    """

    keys: jax.Array       # int32[capacity], sorted, EMPTY_KEY padded
    slots: jax.Array      # int32[capacity], voxel slot per key
    sdf: jax.Array        # float32[num_blocks + 1, BLOCK_VOLUME] (+1 dummy row)
    weight: jax.Array     # float32[num_blocks + 1, BLOCK_VOLUME]
    color: jax.Array      # float32[num_blocks + 1, 3 * BLOCK_VOLUME] premultiplied by
                          # weight, channel-major blocks (r | g | b)
    free_list: jax.Array  # int32[num_blocks] stack of free slots
    free_count: jax.Array # int32[] number of free slots
    num_alloc_failures: jax.Array  # int32[] overflow accounting
    slot_keys: jax.Array  # int32[num_blocks + 1] packed coords per slot (EMPTY = unused)
    slot_geo: jax.Array   # float32[num_blocks + 1, 128]: per-slot block coords
                          # in block units (lanes 0-2), live flag (lane 3), pad
    high_water: jax.Array # int32[] upper bound on occupied slot indices
    row_overflows: jax.Array  # int32[] TSDF op batches whose active rows
                              # exceeded the row capacity (run in extra passes)

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def num_blocks(self) -> int:
        return self.sdf.shape[0] - 1  # last row is the scatter/DMA dummy


def create_table(capacity: int, num_blocks: int) -> VoxelBlockTable:
    return VoxelBlockTable(
        keys=jnp.full((capacity,), EMPTY_KEY, jnp.int32),
        slots=jnp.full((capacity,), -1, jnp.int32),
        sdf=jnp.zeros((num_blocks + 1, BLOCK_VOLUME), jnp.float32),
        weight=jnp.zeros((num_blocks + 1, BLOCK_VOLUME), jnp.float32),
        color=jnp.zeros((num_blocks + 1, 3 * BLOCK_VOLUME), jnp.float32),
        # pops take the TOP of the stack; descending init hands out slots
        # 0, 1, 2, ... so occupancy stays a compact prefix (freed slots are
        # pushed back on top and reused first)
        free_list=jnp.arange(num_blocks - 1, -1, -1, dtype=jnp.int32),
        free_count=jnp.asarray(num_blocks, jnp.int32),
        num_alloc_failures=jnp.asarray(0, jnp.int32),
        slot_keys=jnp.full((num_blocks + 1,), EMPTY_KEY, jnp.int32),
        slot_geo=jnp.zeros((num_blocks + 1, 128), jnp.float32),
        high_water=jnp.asarray(0, jnp.int32),
        row_overflows=jnp.asarray(0, jnp.int32),
    )


def color_at(table: VoxelBlockTable, slot, lin):
    """Premultiplied RGB at (block slot, linear voxel index) -> [..., 3]."""
    return jnp.stack(
        [
            table.color[slot, lin],
            table.color[slot, BLOCK_VOLUME + lin],
            table.color[slot, 2 * BLOCK_VOLUME + lin],
        ],
        axis=-1,
    )


def pack_block_coords(coords):
    """int32 block coords [..., 3] -> packed int32 key (30 bits).

    Out-of-range coords map to EMPTY_KEY (treated as unallocatable), the
    analog of the reference's implicit world-extent limit.
    """
    c = coords + GRID_HALF
    in_range = jnp.all((c >= 0) & (c < GRID_DIM), axis=-1)
    packed = (c[..., 2] << (2 * GRID_BITS)) | (c[..., 1] << GRID_BITS) | c[..., 0]
    return jnp.where(in_range, packed, EMPTY_KEY)


def unpack_key(key):
    """Packed key -> int32 block coords [..., 3] (EMPTY yields garbage)."""
    x = (key & (GRID_DIM - 1)) - GRID_HALF
    y = ((key >> GRID_BITS) & (GRID_DIM - 1)) - GRID_HALF
    z = ((key >> (2 * GRID_BITS)) & (GRID_DIM - 1)) - GRID_HALF
    return jnp.stack([x, y, z], -1)


def world_to_voxel(pts, voxel_size: float):
    """World-space points [..., 3] -> fractional voxel coords."""
    return pts / voxel_size


def voxel_to_block(voxel_coords_int):
    """Integer voxel coords -> (block coords, local voxel index)."""
    block = jnp.floor_divide(voxel_coords_int, BLOCK_SIZE)
    local = voxel_coords_int - block * BLOCK_SIZE
    lin = (local[..., 2] * BLOCK_SIZE + local[..., 1]) * BLOCK_SIZE + local[..., 0]
    return block, lin


def block_to_world(block_coords, voxel_size: float):
    """Block coords -> world position of block corner (voxel [0,0,0] corner)."""
    return block_coords.astype(jnp.float32) * (BLOCK_SIZE * voxel_size)


def lookup_packed(table: VoxelBlockTable, packed_keys):
    """packed keys [...] -> voxel slots [...], -1 where absent."""
    pos = jnp.searchsorted(table.keys, packed_keys)
    pos = jnp.clip(pos, 0, table.capacity - 1)
    found = (table.keys[pos] == packed_keys) & (packed_keys != EMPTY_KEY)
    return jnp.where(found, table.slots[pos], -1)


def lookup_blocks(table: VoxelBlockTable, block_coords):
    return lookup_packed(table, pack_block_coords(block_coords))


def _unique_sorted_mask(sorted_keys):
    """Mask of first occurrences in a sorted key array (EMPTY excluded)."""
    prev = jnp.concatenate([jnp.full((1,), -1, jnp.int32), sorted_keys[:-1]])
    return (sorted_keys != prev) & (sorted_keys != EMPTY_KEY)


ALLOC_COMPACT = 6144  # deduped-candidate capacity per allocate() call


def allocate(table: VoxelBlockTable, candidate_coords, valid_mask) -> VoxelBlockTable:
    """Insert candidate blocks (dedup, skip existing). See allocate_packed."""
    packed_all = jnp.where(valid_mask, pack_block_coords(candidate_coords), EMPTY_KEY)
    return allocate_packed(table, packed_all)


def allocate_packed(
    table: VoxelBlockTable, packed_all, compact: int = ALLOC_COMPACT,
    blocked=None,
) -> VoxelBlockTable:
    """Insert candidate blocks given as packed keys [M] (EMPTY = invalid).

    The whole operation is a fixed-shape jittable program: run-dedup +
    compact the candidates, filter out already-present keys, pop free slots,
    concat + re-sort the key table. Overflow (free list exhausted or
    capacity full) is counted in ``num_alloc_failures`` instead of UB — the
    reference also silently drops on heap exhaustion. Newly popped slots
    need no clearing: ``free_blocks`` zeroes payload when a slot is freed,
    so the free list only ever holds zeroed slots.

    ``compact`` is the deduped-candidate capacity; callers batching several
    frames' candidates into one call must scale it by the frame count so
    each frame keeps its single-frame allocation budget.

    ``blocked``: optional ASCENDING-sorted int32 [B] of packed keys that
    are currently paged out to the host (EMPTY_KEY padded) — the
    ``isSDFBlockStreamedOut`` analog (``CUDASceneRepHashSDF.cu:153-163``):
    a candidate matching a paged-out block is dropped instead of being
    re-allocated empty (which would fork the block's state from its host
    copy). Only passed when streaming is enabled.
    """
    # Candidates arrive in image-scan order, so duplicates come in runs
    # (a block's footprint spans ~7 px); dropping consecutive repeats +
    # compacting shrinks the working set ~5x before any search. Distinct
    # survivors beyond ``compact`` are silently deferred to a later frame
    # (they stay visible and re-candidate while the surface is in view).
    prev = jnp.concatenate([jnp.full((1,), -1, jnp.int32), packed_all[:-1]])
    keep = (packed_all != prev) & (packed_all != EMPTY_KEY)
    cpos = jnp.cumsum(keep.astype(jnp.int32)) - 1
    M = compact
    packed_raw = jnp.full((M,), EMPTY_KEY, jnp.int32).at[
        jnp.where(keep & (cpos < M), cpos, M)
    ].set(packed_all, mode="drop")

    if blocked is not None:
        # drop candidates that are paged out (streamed-out block check)
        bpos = jnp.clip(
            jnp.searchsorted(blocked, packed_raw), 0, blocked.shape[0] - 1
        )
        hit = (blocked[bpos] == packed_raw) & (packed_raw != EMPTY_KEY)
        packed_raw = jnp.where(hit, EMPTY_KEY, packed_raw)

    # Presence check by binary search on the (always-sorted) key table:
    # after run-dedup the query set is only ``compact`` wide, so ~17 rounds
    # of small gathers replace re-sorting the whole key table every frame.
    cap = table.capacity
    qpos = jnp.clip(jnp.searchsorted(table.keys, packed_raw), 0, cap - 1)
    present = (table.keys[qpos] == packed_raw) & (packed_raw != EMPTY_KEY)
    missing = ~present & (packed_raw != EMPTY_KEY)
    num_missing = jnp.sum(missing.astype(jnp.int32))

    # The cond carries ONLY the small index arrays (keys/slots + scalars) —
    # every branch OUTPUT is materialized by XLA, so routing ``slot_geo``
    # (or the payload) through it would copy it. The slot-map
    # updates happen unconditionally below via drop-scatters: when nothing
    # is missing every index is out of bounds and the scatter is a cheap
    # no-op pass-through.
    num_blocks = table.free_list.shape[0]
    free_list = table.free_list  # closed over by merge; never modified

    def merge(keys0, slots0, free_count0, fails0, hw0):
        packed = jnp.sort(packed_raw)
        uniq = _unique_sorted_mask(packed)
        pos = jnp.clip(jnp.searchsorted(keys0, packed), 0, keys0.shape[0] - 1)
        existing = (keys0[pos] == packed) & (packed != EMPTY_KEY)
        is_new = uniq & ~existing
        num_new_req = jnp.sum(is_new.astype(jnp.int32))
        # rank of each new block among new blocks
        rank = jnp.cumsum(is_new.astype(jnp.int32)) - 1
        num_new = jnp.minimum(num_new_req, free_count0)
        can_alloc = is_new & (rank < num_new)
        # pop from the top of the free-list stack
        take_pos = free_count0 - 1 - rank
        new_slot = jnp.where(
            can_alloc, free_list[jnp.clip(take_pos, 0, num_blocks - 1)], -1
        )
        # merge: concat and re-sort; EMPTY keys sort to the tail, truncated
        new_keys = jnp.where(can_alloc, packed, EMPTY_KEY)
        all_keys = jnp.concatenate([keys0, new_keys])
        all_slots = jnp.concatenate([slots0, new_slot])
        order = jnp.argsort(all_keys)
        all_keys_sorted = all_keys[order]
        cap = keys0.shape[0]
        # capacity overflow check: a real key beyond capacity is dropped
        dropped = jnp.sum((all_keys_sorted[cap:] != EMPTY_KEY).astype(jnp.int32))
        fails = fails0 + (num_new_req - num_new) + dropped
        # slot-major scatter targets for the unconditional update below
        scatter_to = jnp.where(can_alloc, new_slot, num_blocks + 1)
        hw = jnp.maximum(
            hw0, jnp.max(jnp.where(can_alloc, new_slot + 1, 0))
        )
        return (
            all_keys_sorted[:cap],
            all_slots[order][:cap],
            free_count0 - num_new,
            fails,
            hw,
            scatter_to,
            packed,
        )

    def no_merge(keys0, slots0, free_count0, fails0, hw0):
        # all indices out of bounds -> both scatters below drop everything
        return (
            keys0,
            slots0,
            free_count0,
            fails0,
            hw0,
            jnp.full((packed_raw.shape[0],), num_blocks + 1, jnp.int32),
            packed_raw,
        )

    keys, slots, free_count, fails, hw, scatter_to, packed_vals = jax.lax.cond(
        num_missing > 0,
        merge,
        no_merge,
        table.keys,
        table.slots,
        table.free_count,
        table.num_alloc_failures,
        table.high_water,
    )
    # slot-major inverse map + per-slot geometry rows for the row selection:
    # block coords (in block units — readers scale by block size) +
    # live flag. Unconditional: out-of-bounds rows drop.
    slot_keys = table.slot_keys.at[scatter_to].set(packed_vals, mode="drop")
    coords = unpack_key(packed_vals).astype(jnp.float32)
    geo_rows = jnp.zeros((packed_vals.shape[0], 128), jnp.float32)
    geo_rows = geo_rows.at[:, :3].set(coords)
    geo_rows = geo_rows.at[:, 3].set(1.0)
    slot_geo = table.slot_geo.at[scatter_to].set(geo_rows, mode="drop")
    return table._replace(
        keys=keys,
        slots=slots,
        free_count=free_count,
        num_alloc_failures=fails,
        slot_keys=slot_keys,
        slot_geo=slot_geo,
        high_water=hw,
    )


FREE_COMPACT = 2048  # max slots whose payload is zeroed per free_blocks call


def free_blocks(table: VoxelBlockTable, free_mask) -> VoxelBlockTable:
    """Free all keys where ``free_mask`` [capacity] is True.

    Marks keys EMPTY, pushes their slots back onto the free list, re-sorts,
    and ZEROES the freed slots' payload — maintaining the invariant that
    free-list slots hold zeroed voxel data, so ``allocate`` never has to
    clear (clearing there cost a 24K-row scatter every frame). Frees beyond
    ``FREE_COMPACT`` per call keep their stale payload (counted in
    ``num_alloc_failures`` as a structural warning); garbage collection
    frees at most a few hundred blocks per frame in practice.
    """
    free_mask = free_mask & (table.keys != EMPTY_KEY)
    num_free = jnp.sum(free_mask.astype(jnp.int32))

    # cond over the small index arrays only (never route the voxel payload
    # through a lax.cond — it costs full copies)
    def do_free(keys0, slots0, free_list0, free_count0):
        num_blocks = free_list0.shape[0]
        rank = jnp.cumsum(free_mask.astype(jnp.int32)) - 1
        push_pos = free_count0 + rank
        slot_to_push = jnp.where(free_mask, slots0, -1)
        free_list = free_list0.at[
            jnp.where(free_mask, push_pos, num_blocks)
        ].set(slot_to_push, mode="drop")
        keys = jnp.where(free_mask, EMPTY_KEY, keys0)
        slots = jnp.where(free_mask, -1, slots0)
        order = jnp.argsort(keys)
        return keys[order], slots[order], free_list, free_count0 + num_free

    # nothing to free (the per-frame steady state under garbage collection)
    # -> skip the re-sort entirely
    keys, slots, free_list, free_count = jax.lax.cond(
        num_free > 0,
        do_free,
        lambda k, s, fl, fc: (k, s, fl, fc),
        table.keys,
        table.slots,
        table.free_list,
        table.free_count,
    )
    # zero the freed slots' payload (compacted row scatter; OOB pad = drop)
    frank = jnp.cumsum(free_mask.astype(jnp.int32)) - 1
    freed = jnp.full((FREE_COMPACT,), table.num_blocks + 1, jnp.int32).at[
        jnp.where(free_mask & (frank < FREE_COMPACT), frank, FREE_COMPACT)
    ].set(jnp.where(free_mask, table.slots, table.num_blocks + 1), mode="drop")
    uncleared = jnp.maximum(num_free - FREE_COMPACT, 0)
    # freed slots leave the slot-major inverse map (all freed slots, not just
    # the payload-cleared prefix: the row selection must skip them)
    freed_to = jnp.where(free_mask, table.slots, table.num_blocks + 1)
    slot_keys = table.slot_keys.at[freed_to].set(EMPTY_KEY, mode="drop")
    slot_geo = table.slot_geo.at[freed_to].set(0.0, mode="drop")
    return table._replace(
        keys=keys,
        slots=slots,
        free_list=free_list,
        free_count=free_count,
        sdf=table.sdf.at[freed].set(0.0, mode="drop"),
        weight=table.weight.at[freed].set(0.0, mode="drop"),
        color=table.color.at[freed].set(0.0, mode="drop"),
        num_alloc_failures=table.num_alloc_failures + uncleared,
        slot_keys=slot_keys,
        slot_geo=slot_geo,
    )


def garbage_collect(table: VoxelBlockTable, weight_thresh: float = 0.0) -> VoxelBlockTable:
    """Free blocks whose max voxel weight <= thresh.

    Mirrors ``garbageCollectIdentifyKernel`` (CUDASceneRepHashSDF.cu:584-631),
    which frees blocks with max weight 0 (de-integrated to emptiness).

    The per-block max runs in SLOT order (a sequential reduction over the
    payload); only the [num_blocks] summary is then gathered into key order.
    """
    maxw_by_slot = jnp.max(table.weight, axis=-1)  # [num_blocks + 1], slot order
    live_by_slot = table.slot_keys != EMPTY_KEY
    empty_by_slot = live_by_slot & (maxw_by_slot <= weight_thresh)
    slot = jnp.clip(table.slots, 0, table.num_blocks)
    mask = (table.keys != EMPTY_KEY) & empty_by_slot[slot]
    return free_blocks(table, mask)


def starve(table: VoxelBlockTable, amount: float = 1.0) -> VoxelBlockTable:
    """Decay all voxel weights (reference ``starveVoxelsKernel``)."""
    w = jnp.maximum(table.weight - amount, 0.0)
    scale = jnp.where(table.weight > 0, w / jnp.maximum(table.weight, 1e-12), 0.0)
    return table._replace(weight=w, color=table.color * jnp.tile(scale, (1, 3)))


def num_occupied(table: VoxelBlockTable):
    return jnp.sum((table.keys != EMPTY_KEY).astype(jnp.int32))


def check_invariants(table: VoxelBlockTable) -> dict:
    """Host-side structural validation, mirroring the reference's
    ``debugHash()`` (CUDASceneRepHashSDF.h:179-314): sortedness, key
    uniqueness, slot uniqueness, free-list/occupancy accounting.
    Returns a dict of violation counts (all zero = healthy).
    """
    import numpy as np

    keys = np.asarray(table.keys)
    slots = np.asarray(table.slots)
    occ = keys != int(EMPTY_KEY)
    n_occ = int(occ.sum())
    errs = {}
    errs["unsorted"] = int((np.diff(keys.astype(np.int64)) < 0).sum())
    occupied_keys = keys[occ]
    errs["duplicate_keys"] = int(n_occ - len(np.unique(occupied_keys)))
    occupied_slots = slots[occ]
    errs["duplicate_slots"] = int(n_occ - len(np.unique(occupied_slots)))
    errs["bad_slot_range"] = int(
        ((occupied_slots < 0) | (occupied_slots >= table.num_blocks)).sum()
    )
    free_count = int(table.free_count)
    errs["accounting"] = int(free_count + n_occ != table.num_blocks)
    fl = np.asarray(table.free_list)[:free_count]
    # a slot must not be both free and occupied
    errs["free_occupied_overlap"] = int(len(np.intersect1d(fl, occupied_slots)))
    errs["duplicate_free_slots"] = int(free_count - len(np.unique(fl)))
    # slot-major inverse map must mirror the key table exactly
    slot_keys = np.asarray(table.slot_keys)
    expect = np.full_like(slot_keys, int(EMPTY_KEY))
    expect[occupied_slots] = occupied_keys
    errs["slot_keys_mismatch"] = int((slot_keys != expect).sum())
    errs["high_water"] = int(
        n_occ > 0 and int(table.high_water) < occupied_slots.max() + 1
    )
    return errs

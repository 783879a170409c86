import jax.numpy as jnp
import numpy as np

from bundlefusion_tpu.tsdf.table import (
    EMPTY_KEY,
    allocate,
    check_invariants,
    create_table,
    free_blocks,
    garbage_collect,
    lookup_blocks,
    num_occupied,
    pack_block_coords,
    unpack_key,
)


def make_table(cap=1024, blocks=256):
    return create_table(cap, blocks)


def test_pack_unpack_roundtrip(rng):
    coords = rng.integers(-500, 500, size=(100, 3)).astype(np.int32)
    packed = pack_block_coords(jnp.asarray(coords))
    back = np.asarray(unpack_key(packed))
    np.testing.assert_array_equal(back, coords)


def test_pack_out_of_range():
    coords = jnp.asarray(np.array([[600, 0, 0], [0, -600, 0]], np.int32))
    packed = pack_block_coords(coords)
    assert np.all(np.asarray(packed) == int(EMPTY_KEY))


def test_alloc_and_lookup(rng):
    t = make_table()
    coords = rng.integers(-10, 10, size=(50, 3)).astype(np.int32)
    valid = np.ones(50, bool)
    t = allocate(t, jnp.asarray(coords), jnp.asarray(valid))
    uniq = np.unique(coords, axis=0)
    assert int(num_occupied(t)) == len(uniq)
    slots = np.asarray(lookup_blocks(t, jnp.asarray(uniq)))
    assert (slots >= 0).all()
    assert len(np.unique(slots)) == len(uniq)
    # absent block
    absent = np.asarray(lookup_blocks(t, jnp.asarray(np.array([[400, 400, 400]], np.int32))))
    assert absent[0] == -1
    assert all(v == 0 for v in check_invariants(t).values())


def test_alloc_idempotent(rng):
    t = make_table()
    coords = rng.integers(-5, 5, size=(30, 3)).astype(np.int32)
    t = allocate(t, jnp.asarray(coords), jnp.ones(30, bool))
    n1 = int(num_occupied(t))
    fc1 = int(t.free_count)
    t = allocate(t, jnp.asarray(coords), jnp.ones(30, bool))
    assert int(num_occupied(t)) == n1
    assert int(t.free_count) == fc1
    assert all(v == 0 for v in check_invariants(t).values())


def test_alloc_respects_valid_mask(rng):
    t = make_table()
    coords = np.array([[1, 1, 1], [2, 2, 2]], np.int32)
    t = allocate(t, jnp.asarray(coords), jnp.asarray(np.array([True, False])))
    assert int(num_occupied(t)) == 1
    assert int(lookup_blocks(t, jnp.asarray(coords[:1]))[0]) >= 0
    assert int(lookup_blocks(t, jnp.asarray(coords[1:]))[0]) == -1


def test_alloc_overflow_accounting():
    # create_table rounds num_blocks up to the kernel's 128-row DMA tile,
    # so the smallest payload is 128 slots; overflow it with 192 blocks
    t = make_table(cap=256, blocks=128)
    assert t.num_blocks == 128
    coords = np.stack(
        np.meshgrid(np.arange(8), np.arange(6), np.arange(4)), -1
    ).reshape(-1, 3).astype(np.int32)
    # 192 distinct blocks into 128 slots -> 64 failures
    t = allocate(t, jnp.asarray(coords), jnp.ones(192, bool))
    assert int(num_occupied(t)) == 128
    assert int(t.free_count) == 0
    assert int(t.num_alloc_failures) == 64
    assert all(v == 0 for v in check_invariants(t).values())


def test_free_blocks_roundtrip(rng):
    t = make_table()
    coords = rng.integers(-8, 8, size=(40, 3)).astype(np.int32)
    uniq = np.unique(coords, axis=0)
    t = allocate(t, jnp.asarray(coords), jnp.ones(40, bool))
    n = int(num_occupied(t))
    # free half the occupied keys
    occ = np.asarray(t.keys) != int(EMPTY_KEY)
    occ_pos = np.nonzero(occ)[0]
    mask = np.zeros(t.capacity, bool)
    mask[occ_pos[: n // 2]] = True
    t = free_blocks(t, jnp.asarray(mask))
    assert int(num_occupied(t)) == n - n // 2
    assert all(v == 0 for v in check_invariants(t).values())
    # freed slots can be reallocated
    t = allocate(t, jnp.asarray(uniq), jnp.ones(len(uniq), bool))
    assert int(num_occupied(t)) == len(uniq)
    assert all(v == 0 for v in check_invariants(t).values())


def test_garbage_collect(rng):
    t = make_table()
    coords = rng.integers(-5, 5, size=(20, 3)).astype(np.int32)
    uniq = np.unique(coords, axis=0)
    t = allocate(t, jnp.asarray(coords), jnp.ones(20, bool))
    # give weight to the first 3 blocks only
    slots = np.asarray(lookup_blocks(t, jnp.asarray(uniq)))
    w = np.asarray(t.weight).copy()
    w[slots[:3]] = 1.0
    t = t._replace(weight=jnp.asarray(w))
    t = garbage_collect(t)
    assert int(num_occupied(t)) == 3
    kept = np.asarray(lookup_blocks(t, jnp.asarray(uniq[:3])))
    assert (kept >= 0).all()
    assert all(v == 0 for v in check_invariants(t).values())

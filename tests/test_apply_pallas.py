"""Frustum-compacted multi-op TSDF update vs the full-sweep reference,
plus the exactness invariants of the op batch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bundlefusion_tpu.io.synthetic import default_intrinsics, make_sequence
from bundlefusion_tpu.tsdf.apply_ops import (
    active_rows,
    apply_tsdf_ops,
    apply_tsdf_ops_xla,
)
from bundlefusion_tpu.tsdf.integrate import TsdfParams, allocate_for_frame
from bundlefusion_tpu.tsdf.table import EMPTY_KEY, check_invariants, create_table

INTR_IN = default_intrinsics(160, 120)
INTR = INTR_IN.scaled(80, 60)
PARAMS = TsdfParams(voxel_size=0.04, truncation=0.12, max_integration_distance=4.0)
CAP = 4096


def _setup(n_frames=3):
    seq = make_sequence(n_frames, intr=INTR_IN)
    t = create_table(4096, 2048)
    depths, colors, poses = [], [], []
    for i in range(n_frames):
        d = jnp.asarray(seq["depth"][i][::2, ::2])
        c = jnp.asarray(seq["color"][i][::2, ::2])
        T = jnp.asarray(seq["poses"][i])
        t = allocate_for_frame(t, d, INTR, T, PARAMS)
        depths.append(d)
        colors.append(c)
        poses.append(T)
    return t, jnp.stack(depths), jnp.stack(colors), jnp.stack(poses)


def _apply(t, depths, colors, poses, signs, img, cap=CAP):
    return apply_tsdf_ops(t, depths, colors, poses, signs, img, INTR, PARAMS, cap)


def _assert_tables_match(t_a, t_b):
    np.testing.assert_allclose(np.asarray(t_a.sdf), np.asarray(t_b.sdf),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(t_a.weight), np.asarray(t_b.weight))
    np.testing.assert_allclose(np.asarray(t_a.color), np.asarray(t_b.color),
                               rtol=0, atol=1e-6)


def test_apply_ops_matches_xla_twin():
    t, depths, colors, poses = _setup()
    signs = jnp.asarray([1.0, 1.0, -1.0])
    img = jnp.asarray([0, 1, 0], jnp.int32)

    t_k = _apply(t, depths, colors, poses, signs, img)
    t_x = apply_tsdf_ops_xla(t, depths, colors, poses, signs, img, INTR, PARAMS)

    _assert_tables_match(t_k, t_x)
    assert float(jnp.max(t_k.weight)) > 0  # something was fused
    assert int(t_k.row_overflows) == 0


def test_sign_zero_is_exact_noop():
    t, depths, colors, poses = _setup()
    t1 = _apply(t, depths, colors, poses, jnp.asarray([1.0, 0.0, 0.0]),
                jnp.asarray([0, 1, 2], jnp.int32))
    t2 = _apply(t1, depths, colors, poses, jnp.zeros(3),
                jnp.asarray([0, 1, 2], jnp.int32))
    assert np.array_equal(np.asarray(t1.sdf), np.asarray(t2.sdf))
    assert np.array_equal(np.asarray(t1.weight), np.asarray(t2.weight))
    assert np.array_equal(np.asarray(t1.color), np.asarray(t2.color))


def test_deintegration_exact_inverse():
    """integrate(f0) -> integrate(f1) -> deintegrate(f1) == integrate(f0),
    all inside one fused dispatch vs separate dispatches."""
    t, depths, colors, poses = _setup()
    img = jnp.asarray([0], jnp.int32)
    one = jnp.ones(1)

    t_a = _apply(t, depths[:1], colors[:1], poses[:1], one, img)
    # fused: +f0, +f1, -f1 in one dispatch
    t_b = _apply(
        t, depths[:2], colors[:2],
        jnp.stack([poses[0], poses[1], poses[1]]),
        jnp.asarray([1.0, 1.0, -1.0]),
        jnp.asarray([0, 1, 1], jnp.int32))

    w_a, w_b = np.asarray(t_a.weight), np.asarray(t_b.weight)
    np.testing.assert_array_equal(w_a, w_b)
    # sdf matches exactly where weight > 0 (untouched voxels keep bitwise sdf)
    np.testing.assert_allclose(np.asarray(t_b.sdf), np.asarray(t_a.sdf),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(t_b.color), np.asarray(t_a.color),
                               rtol=0, atol=1e-5)


def test_ops_sequential_vs_separate_dispatches():
    t, depths, colors, poses = _setup()
    signs = jnp.ones(3)
    img = jnp.asarray([0, 1, 2], jnp.int32)
    t_fused = _apply(t, depths, colors, poses, signs, img)
    t_seq = t
    for i in range(3):
        t_seq = _apply(t_seq, depths[i:i+1], colors[i:i+1], poses[i:i+1],
                       jnp.ones(1), jnp.zeros(1, jnp.int32))
    np.testing.assert_allclose(np.asarray(t_fused.sdf), np.asarray(t_seq.sdf),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(t_fused.weight),
                                  np.asarray(t_seq.weight))


def test_active_tile_selection_is_conservative():
    """Rows outside the frustum row selection must be provably untouched:
    the full sweep (which applies the update rule to EVERY row) must leave
    every excluded row's payload bitwise unchanged."""
    from bundlefusion_tpu.geometry.lie import pose_inverse

    t, depths, colors, poses = _setup()
    signs = jnp.asarray([1.0, -1.0, 1.0])
    img = jnp.asarray([0, 1, 2], jnp.int32)
    w2c = jax.vmap(pose_inverse)(poses)
    H, W = depths.shape[1:]
    active = np.asarray(active_rows(t, w2c, signs, INTR, PARAMS, H, W))
    excluded = ~active

    t_x = apply_tsdf_ops_xla(t, depths, colors, poses, signs, img, INTR, PARAMS)
    for name in ("sdf", "weight", "color"):
        np.testing.assert_array_equal(
            np.asarray(getattr(t_x, name)[:-1])[excluded],
            np.asarray(getattr(t, name)[:-1])[excluded],
        )
    # the selection is a subset of the live rows, far below the table size
    live = np.asarray(t.slot_keys[:-1]) != int(EMPTY_KEY)
    assert not (active & ~live).any()
    assert 0 < int(active.sum()) < t.num_blocks // 4
    # a camera moved 20 m away sees none of the blocks
    far = w2c.at[:, 2, 3].add(-20.0)
    assert not np.asarray(active_rows(t, far, signs, INTR, PARAMS, H, W)).any()


def test_table_invariants_after_ops():
    t, depths, colors, poses = _setup()
    t = _apply(t, depths, colors, poses, jnp.ones(3),
               jnp.asarray([0, 1, 2], jnp.int32))
    errs = check_invariants(t)
    assert all(v == 0 for v in errs.values()), errs
    hw = int(t.high_water)
    occ = int(jnp.sum((t.keys != EMPTY_KEY).astype(jnp.int32)))
    assert hw >= occ  # ascending slot handout keeps occupancy a prefix
    assert hw <= occ + 64


@pytest.mark.parametrize("cap", [1, 37, 64])
def test_row_capacity_overflow_stays_exact(cap):
    """More active rows than one batch holds: extra batches run, the result
    equals the full sweep, and the overflow is counted once per call."""
    t, depths, colors, poses = _setup()
    signs = jnp.asarray([1.0, -1.0, 1.0])
    img = jnp.asarray([0, 1, 2], jnp.int32)
    t_k = _apply(t, depths, colors, poses, signs, img, cap=cap)
    t_x = apply_tsdf_ops_xla(t, depths, colors, poses, signs, img, INTR, PARAMS)
    _assert_tables_match(t_k, t_x)
    assert int(t_k.row_overflows) == 1
    t_k2 = _apply(t_k, depths, colors, poses, jnp.zeros(3), img, cap=cap)
    assert int(t_k2.row_overflows) == 1  # sign-0 ops select no rows

"""TSDF map-block sharding dryrun (SURVEY §7.2 step 7 north star).

Payload rows shard by slot range over the virtual 8-device mesh;
integration must match the single-device XLA twin exactly (row
independence given the packed block key). Reference spatial analog:
``CUDASceneRepChunkGrid.h:142-210``.
"""

import jax
import jax.numpy as jnp
import numpy as np

from bundlefusion_tpu.io.synthetic import default_intrinsics, make_sequence
from bundlefusion_tpu.parallel.ba_sharded import make_mesh
from bundlefusion_tpu.parallel.map_sharded import (
    make_sharded_apply,
    shard_table_payload,
)
from bundlefusion_tpu.tsdf.apply_ops import apply_tsdf_ops_xla
from bundlefusion_tpu.tsdf.integrate import TsdfParams, candidate_keys
from bundlefusion_tpu.tsdf.table import allocate_packed, create_table


def _setup():
    intr = default_intrinsics(80, 60)
    params = TsdfParams(voxel_size=0.04, truncation=0.12)
    seq = make_sequence(3, intr=intr)
    table = create_table(4096, 2048)
    return intr, params, seq, table


def test_sharded_integrate_matches_single_device():
    intr, params, seq, table = _setup()
    depths = jnp.asarray(seq["depth"][:2])
    colors = jnp.asarray(seq["color"][:2])
    poses = jnp.asarray(seq["poses"][:2])

    # allocate on the replicated index (single-writer semantics)
    for i in range(2):
        keys = candidate_keys(depths[i], intr, poses[i], params)
        table = allocate_packed(table, keys)

    signs = jnp.asarray([1.0, 1.0], jnp.float32)
    imgs = jnp.asarray([0, 1], jnp.int32)

    ref = apply_tsdf_ops_xla(
        table, depths, colors, poses, signs, imgs, intr, params
    )

    mesh = make_mesh()
    table_sh = shard_table_payload(table, mesh)
    apply = make_sharded_apply(mesh, table.num_blocks, intr, params)
    out = apply(table_sh, depths, colors, poses, signs, imgs)

    np.testing.assert_array_equal(np.asarray(out.sdf), np.asarray(ref.sdf))
    np.testing.assert_array_equal(
        np.asarray(out.weight), np.asarray(ref.weight)
    )
    np.testing.assert_array_equal(
        np.asarray(out.color), np.asarray(ref.color)
    )
    assert float(jnp.abs(ref.weight).sum()) > 0  # something integrated


def test_sharded_deintegrate_roundtrip():
    """Integrate then de-integrate the same frame on the mesh: weights
    return to zero exactly (the re-integration enabler, sharded)."""
    intr, params, seq, table = _setup()
    depths = jnp.asarray(seq["depth"][:1])
    colors = jnp.asarray(seq["color"][:1])
    poses = jnp.asarray(seq["poses"][:1])
    keys = candidate_keys(depths[0], intr, poses[0], params)
    table = allocate_packed(table, keys)

    mesh = make_mesh()
    table_sh = shard_table_payload(table, mesh)
    apply = make_sharded_apply(mesh, table.num_blocks, intr, params)
    ones = jnp.ones((1,), jnp.float32)
    zero = jnp.zeros((1,), jnp.int32)
    t1 = apply(table_sh, depths, colors, poses, ones, zero)
    assert float(jnp.abs(t1.weight).sum()) > 0
    t2 = apply(t1, depths, colors, poses, -ones, zero)
    np.testing.assert_array_equal(
        np.asarray(t2.weight), np.asarray(table.weight)
    )

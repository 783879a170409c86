"""TSDF map sharding over a device mesh (the SURVEY §7.2 step-7 /
§2.8 north-star axis: "map-block sharding + host offload").

Reference spatial analog: ``CUDASceneRepChunkGrid.h:142-210`` pages cold
TSDF blocks GPU<->CPU around the camera; the device-mesh scale-out of the
same axis shards the voxel-block PAYLOAD across a device mesh.

Design (dryrun scope, single-writer allocation):

- **Payload rows shard by slot range**: ``sdf/weight/color/slot_keys``
  rows are partitioned evenly across the mesh. Integration/de-integration
  is row-independent given the row's packed block key (the fused kernel
  and its XLA twin both iterate payload rows), so each device integrates
  its shard with ZERO collectives — the only cross-device data is the
  replicated input frame (~0.4-1.5 MB wire), which IS the frustum
  exchange: any shard's blocks may project anywhere in the image.
- **Key index + free list stay replicated** (single-writer semantics):
  allocation math is deterministic, so every device derives the identical
  index; only payload writes are sharded. This mirrors the reference's
  single-threaded alloc pass (``allocKernel`` + heap, driven from one
  host).
- Capacity argument for when NOT to shard: at the reference operating
  point (200K 8^3 blocks, ``zParametersDefault.txt:39-49``) the payload is
  ~2 GB — one card's memory holds the whole apt-scale map, and the engine
  additionally pages cold blocks to host RAM (``tsdf/streaming.py``).
  Map sharding is the growth axis beyond one card's memory, not a
  requirement at apt scale.

Equivalence is tested on the virtual 8-device CPU mesh
(``tests/test_map_sharded.py``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bundlefusion_tpu.geometry.camera import CameraIntrinsics
from bundlefusion_tpu.tsdf.apply_ops import apply_tsdf_ops_rows
from bundlefusion_tpu.tsdf.integrate import TsdfParams
from bundlefusion_tpu.tsdf.table import VoxelBlockTable


def shard_table_payload(
    table: VoxelBlockTable, mesh: Mesh, axis: str = "shard"
) -> VoxelBlockTable:
    """Place payload rows sharded along the slot axis; index structures
    replicated. (The +1 dummy row stays with the last shard via padding —
    callers use :func:`apply_tsdf_ops_sharded`, which only touches
    ``[:num_blocks]``.)"""
    N = table.num_blocks
    n_dev = int(np.prod(list(mesh.shape.values())))
    assert N % n_dev == 0, (N, n_dev)
    row_sh = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())

    def put_rows(a):
        # shard the first N rows; keep the dummy row replicated by
        # re-appending it after placement
        return jnp.concatenate(
            [jax.device_put(a[:N], row_sh), jax.device_put(a[N:], rep)]
        )

    return table._replace(
        sdf=put_rows(table.sdf),
        weight=put_rows(table.weight),
        color=put_rows(table.color),
        slot_keys=put_rows(table.slot_keys),
        slot_geo=put_rows(table.slot_geo),
        keys=jax.device_put(table.keys, rep),
        slots=jax.device_put(table.slots, rep),
        free_list=jax.device_put(table.free_list, rep),
        free_count=jax.device_put(table.free_count, rep),
        num_alloc_failures=jax.device_put(table.num_alloc_failures, rep),
        high_water=jax.device_put(table.high_water, rep),
        row_overflows=jax.device_put(table.row_overflows, rep),
    )


def make_sharded_apply(
    mesh: Mesh,
    num_blocks: int,
    intr: CameraIntrinsics,
    params: TsdfParams,
    axis: str = "shard",
):
    """Build the sharded (de)integration step: each device applies the op
    batch to ITS slot-range of payload rows. Returns
    ``apply(table, depths, colors, poses, signs, img_of_op) -> table``.
    """
    n_dev = int(mesh.shape[axis])
    assert num_blocks % n_dev == 0, (num_blocks, n_dev)
    N = num_blocks

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(axis), P(axis), P(axis), P(axis),   # payload row shards
            P(), P(), P(), P(), P(),              # replicated frame + ops
        ),
        out_specs=(P(axis), P(axis), P(axis)),
    )
    def run(keys_r, sdf_r, w_r, col_r, depths, colors, poses, signs, imgs):
        return apply_tsdf_ops_rows(
            keys_r, sdf_r, w_r, col_r, depths, colors, poses, signs,
            imgs, intr, params,
        )

    def apply(table: VoxelBlockTable, depths, colors, poses, signs, img_of_op):
        sdf, w, col = run(
            table.slot_keys[:N], table.sdf[:N], table.weight[:N],
            table.color[:N], depths, colors, poses, signs, img_of_op,
        )
        return table._replace(
            sdf=table.sdf.at[:N].set(sdf),
            weight=table.weight.at[:N].set(w),
            color=table.color.at[:N].set(col),
        )

    return apply

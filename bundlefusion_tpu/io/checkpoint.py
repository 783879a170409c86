"""Engine checkpoint / resume.

The reference has piecemeal save/load: the TSDF hash
(``StopScanningAndSaveSDFHash``, DepthSensing.cpp:380-423 +
``CUDASceneRepChunkGrid.h:122-141``), the SIFT state
(``SIFTImageManager::saveToFile/loadFromFile``, SIFTImageManager.h:277-279)
and the dense cache (``CUDACache.h:54-142``) — but no unified resume. This
module serializes the COMPLETE engine state (voxel table, keyframe stores,
correspondence stores, frame archive, trajectories, scheduler records) into
one ``.npz`` + JSON config header, so a half-finished scan resumes exactly:
save mid-sequence, reload, continue — identical trajectory.

bfloat16 leaves (descriptors) are stored as uint16 bit patterns.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np

# 2: the voxel table gained ``row_overflows`` and lost the 128-row rounding
FORMAT_VERSION = 2


def _pack_leaf(x):
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return a.view(np.uint16), "bf16"
    return a, a.dtype.str


def _unpack_leaf(a, tag):
    if tag == "bf16":
        return jnp.asarray(a.view(jnp.bfloat16))
    return jnp.asarray(a)


_TREES = ("local", "glob", "store", "table")


def save_engine(eng, path: str):
    """Serialize a BundleFusion engine to ``path`` (.npz)."""
    eng._flush_pending()

    arrays = {}
    tags = {}
    for name in _TREES:
        leaves = jax.tree.leaves(getattr(eng, name))
        for i, leaf in enumerate(leaves):
            a, tag = _pack_leaf(leaf)
            arrays[f"{name}.{i}"] = a
            tags[f"{name}.{i}"] = tag
    arrays["submap_base"] = np.asarray(eng.submap_base)
    arrays["keyframe_valid"] = eng.keyframe_valid
    arrays["sift_world"] = (
        np.stack(eng.sift_world) if eng.sift_world else np.zeros((0, 4, 4), np.float32)
    )
    arrays["complete_traj"] = (
        np.stack(eng.complete_traj)
        if eng.complete_traj
        else np.zeros((0, 4, 4), np.float32)
    )
    arrays["frame_valid"] = np.asarray(eng.frame_valid, bool)

    # trajectory-manager records (re-integration scheduler)
    recs = eng.traj_manager.records
    n = len(recs)
    states = np.array([int(r.state) for r in recs], np.int32)
    intT = np.full((n, 4, 4), np.nan, np.float32)
    optT = np.full((n, 4, 4), np.nan, np.float32)
    for i, r in enumerate(recs):
        if r.integrated_transform is not None:
            intT[i] = r.integrated_transform
        if r.optimized_transform is not None:
            optT[i] = r.optimized_transform
    arrays["tm_states"] = states
    arrays["tm_int"] = intT
    arrays["tm_opt"] = optT

    # host-paged TSDF blocks (streaming): the reference saves the FULL
    # chunked volume incl. CPU-resident chunks (CUDASceneRepChunkGrid.h:
    # 122-141); without these, save/load with streaming on loses the cold map
    if getattr(eng, "host_blocks", None) is not None and len(eng.host_blocks):
        hb = eng.host_blocks.blocks
        hkeys = np.fromiter(hb.keys(), np.int64)
        arrays["hb_keys"] = hkeys
        arrays["hb_sdf"] = np.stack([hb[int(k)][0] for k in hkeys])
        arrays["hb_weight"] = np.stack([hb[int(k)][1] for k in hkeys])
        arrays["hb_color"] = np.stack([hb[int(k)][2] for k in hkeys])

    meta = {
        "version": FORMAT_VERSION,
        "tags": tags,
        "app": dataclasses.asdict(eng.app),
        "bundling": dataclasses.asdict(eng.bundling),
        "sift": dataclasses.asdict(eng.sift_cfg),
        "intr": dataclasses.asdict(eng.intr_input),
        "max_keyframes": eng.G,
        "frame_idx": eng.frame_idx,
        "num_keyframes": eng.num_keyframes,
        "recorded_upto": eng._recorded_upto,
        "retry_list": eng.retry_list,
        "retry_attempts": {str(k): v for k, v in eng.retry_attempts.items()},
        "lost_count": eng.lost_count,
        "render_every": eng.render_every,
        "window_base": eng._window_base,
        "anchor_slot": eng._anchor_slot,
    }
    arrays["meta_json"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8
    )
    with open(path, "wb") as fh:
        np.savez(fh, **arrays)


def load_engine(path: str, mesh=None):
    """Reconstruct a BundleFusion engine from a checkpoint.

    Args:
      mesh: optional ``jax.sharding.Mesh`` — a checkpoint saved from a
        mesh-sharded engine records no device topology, so sharding must be
        re-requested at load; pass the mesh to restore the global state
        sharded (``_shard_global`` re-applies the keyframe/corr-axis
        placement). Without it, state loads replicated on one device.
    """
    from bundlefusion_tpu.config import AppConfig, BundlingConfig
    from bundlefusion_tpu.geometry.camera import CameraIntrinsics
    from bundlefusion_tpu.ops.sift import SiftConfig
    from bundlefusion_tpu.pipeline.online import BundleFusion
    from bundlefusion_tpu.pipeline.trajectory import FrameRecord, FrameState

    data = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(data["meta_json"]).decode("utf-8"))
    if meta["version"] != FORMAT_VERSION:
        raise ValueError(f"checkpoint version {meta['version']} != {FORMAT_VERSION}")

    app = AppConfig(**meta["app"])
    bundling = BundlingConfig(**meta["bundling"])
    sift = SiftConfig(**meta["sift"])
    intr = CameraIntrinsics(**meta["intr"])
    eng = BundleFusion(
        intr, app, bundling, sift_cfg=sift,
        max_keyframes=meta["max_keyframes"], mesh=mesh,
    )

    tags = meta["tags"]
    for name in _TREES:
        template = getattr(eng, name)
        treedef = jax.tree.structure(template)
        n_leaves = treedef.num_leaves
        leaves = [
            _unpack_leaf(data[f"{name}.{i}"], tags[f"{name}.{i}"])
            for i in range(n_leaves)
        ]
        setattr(eng, name, jax.tree.unflatten(treedef, leaves))
    if mesh is not None and mesh.devices.size > 1:
        eng.glob = eng._shard_global(eng.glob)

    eng.submap_base = jnp.asarray(data["submap_base"])
    eng.keyframe_valid = data["keyframe_valid"].copy()
    eng.sift_world = [t.copy() for t in data["sift_world"]]
    eng.complete_traj = [t.copy() for t in data["complete_traj"]]
    eng.frame_valid = [bool(b) for b in data["frame_valid"]]
    eng.frame_idx = meta["frame_idx"]
    eng.num_keyframes = meta["num_keyframes"]
    eng._recorded_upto = meta["recorded_upto"]
    eng.retry_list = list(meta["retry_list"])
    eng.retry_attempts = {int(k): v for k, v in meta["retry_attempts"].items()}
    eng.lost_count = meta["lost_count"]
    eng.render_every = meta["render_every"]
    eng._window_base = meta.get("window_base", 0)
    eng._anchor_slot = meta.get("anchor_slot", 0)
    eng.kf_valid_dev = jnp.asarray(eng.keyframe_valid)

    if "hb_keys" in data:
        eng.host_blocks.insert(
            data["hb_keys"], data["hb_sdf"], data["hb_weight"], data["hb_color"]
        )
        eng._refresh_blocked_dev()

    recs = []
    for i in range(len(data["tm_states"])):
        r = FrameRecord()
        r.state = FrameState(int(data["tm_states"][i]))
        iT = data["tm_int"][i]
        oT = data["tm_opt"][i]
        r.integrated_transform = iT.copy() if np.isfinite(iT).all() else None
        r.optimized_transform = oT.copy() if np.isfinite(oT).all() else None
        recs.append(r)
    eng.traj_manager.records = recs
    return eng

"""JAX greedy-Kabsch filter vs the NumPy oracle port of the reference CPU
filter (``tests/oracles/match_filter.py`` <-> ``cuda_kabschReference.h:429``).

The JAX filter deliberately replaces the reference's strip-worst inner loop
with accept/reject against the current consensus (ops/filters.py docstring),
so per-match sets can differ on adversarial inputs. The contract both must
meet, and what these tests check:
  - clean rigid pairs (inliers only): both accept, transforms agree;
  - rigid pairs with gross outliers mixed in: both accept, both exclude
    every outlier, transforms agree with ground truth;
  - degenerate / non-rigid pairs: both reject.
"""

import numpy as np
import pytest

from bundlefusion_tpu.ops.filters import kabsch_filter_pair
from tests.oracles.match_filter import filter_matches_oracle


def _rigid(rng):
    """Random small rigid transform."""
    w = rng.normal(scale=0.2, size=3)
    th = np.linalg.norm(w)
    k = w / max(th, 1e-12)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
    t = rng.normal(scale=0.3, size=3)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def _make_pair(rng, n_in, n_out, noise=1e-4, R_cap=128):
    """Synthetic matched pair: n_in inliers under a rigid T + n_out outliers,
    shuffled inliers-first-ish by 'descriptor distance' (inliers earlier),
    padded to R_cap. Returns (src, tgt, pix_s, pix_t, valid, T_gt, out_idx)."""
    T = _rigid(rng)
    src_in = rng.uniform([-0.8, -0.6, 1.0], [0.8, 0.6, 3.0], size=(n_in, 3))
    tgt_in = src_in @ T[:3, :3].T + T[:3, 3] + rng.normal(scale=noise, size=(n_in, 3))
    src_out = rng.uniform([-0.8, -0.6, 1.0], [0.8, 0.6, 3.0], size=(n_out, 3))
    tgt_out = rng.uniform([-0.8, -0.6, 1.0], [0.8, 0.6, 3.0], size=(n_out, 3))

    src = np.concatenate([src_in, src_out])
    tgt = np.concatenate([tgt_in, tgt_out])
    n = n_in + n_out
    # interleave outliers among inliers (descriptor distance doesn't
    # correlate perfectly with geometric correctness)
    perm = rng.permutation(n)
    src, tgt = src[perm], tgt[perm]
    is_out = perm >= n_in

    # well-separated fake pixel coords (no accidental 5px dedup)
    pix_s = rng.permutation(n)[:, None] * 13.0 + np.array([[7.0, 11.0]])
    pix_t = rng.permutation(n)[:, None] * 13.0 + np.array([[5.0, 3.0]])

    pad = R_cap - n
    src = np.concatenate([src, np.zeros((pad, 3))]).astype(np.float32)
    tgt = np.concatenate([tgt, np.zeros((pad, 3))]).astype(np.float32)
    pix_s = np.concatenate([pix_s, np.full((pad, 2), 1e6)]).astype(np.float32)
    pix_t = np.concatenate([pix_t, np.full((pad, 2), 1e6)]).astype(np.float32)
    valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    return src, tgt, pix_s, pix_t, valid, T, np.where(is_out)[0]


def _run_jax(src, tgt, pix_s, pix_t, valid):
    import jax.numpy as jnp

    out = kabsch_filter_pair(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(pix_s),
        jnp.asarray(pix_t), jnp.asarray(valid),
    )
    return {
        "valid_pair": bool(out["valid_pair"]),
        "inlier_idx": np.where(np.asarray(out["inlier_mask"]))[0],
        "transform": np.asarray(out["transform"]),
    }


@pytest.mark.parametrize("seed", range(6))
def test_clean_pair_both_accept(seed):
    rng = np.random.default_rng(seed)
    src, tgt, ps, pt, valid, T_gt, _ = _make_pair(rng, n_in=20, n_out=0)
    jx = _run_jax(src, tgt, ps, pt, valid)
    orc = filter_matches_oracle(src, tgt, ps, pt, valid)
    assert jx["valid_pair"] and orc["valid_pair"]
    # both transforms close to ground truth
    for T in (jx["transform"], orc["transform"]):
        assert np.allclose(T, T_gt, atol=5e-3)
    assert np.allclose(jx["transform"], orc["transform"], atol=5e-3)


@pytest.mark.parametrize("seed", range(6))
def test_outliers_excluded_by_both(seed):
    rng = np.random.default_rng(100 + seed)
    src, tgt, ps, pt, valid, T_gt, out_idx = _make_pair(rng, n_in=16, n_out=5)
    jx = _run_jax(src, tgt, ps, pt, valid)
    orc = filter_matches_oracle(src, tgt, ps, pt, valid)
    assert jx["valid_pair"] and orc["valid_pair"]
    assert not set(out_idx) & set(jx["inlier_idx"].tolist())
    assert not set(out_idx) & set(orc["inlier_idx"].tolist())
    for T in (jx["transform"], orc["transform"]):
        assert np.allclose(T, T_gt, atol=1e-2)


@pytest.mark.parametrize("seed", range(4))
def test_nonrigid_rejected_by_both(seed):
    rng = np.random.default_rng(200 + seed)
    # pure random associations: no rigid transform exists
    src, tgt, ps, pt, valid, _, _ = _make_pair(rng, n_in=0, n_out=24)
    jx = _run_jax(src, tgt, ps, pt, valid)
    orc = filter_matches_oracle(src, tgt, ps, pt, valid)
    assert not jx["valid_pair"]
    assert not orc["valid_pair"]


@pytest.mark.parametrize("seed", range(4))
def test_degenerate_collinear_rejected_by_both(seed):
    rng = np.random.default_rng(300 + seed)
    # matches along a 3D line: condition check must reject
    t = np.linspace(0, 1, 16)[:, None]
    d = rng.normal(size=3)
    src_in = t * d + rng.normal(scale=1e-5, size=(16, 3))
    T = _rigid(rng)
    tgt_in = src_in @ T[:3, :3].T + T[:3, 3]
    R_cap = 128
    pad = R_cap - 16
    src = np.concatenate([src_in, np.zeros((pad, 3))]).astype(np.float32)
    tgt = np.concatenate([tgt_in, np.zeros((pad, 3))]).astype(np.float32)
    ps = np.concatenate([np.arange(16)[:, None] * np.array([[17.0, 23.0]]),
                         np.full((pad, 2), 1e6)]).astype(np.float32)
    pt = ps + 2.0
    valid = np.concatenate([np.ones(16, bool), np.zeros(pad, bool)])
    jx = _run_jax(src, tgt, ps, pt, valid)
    orc = filter_matches_oracle(src, tgt, ps, pt, valid)
    assert not jx["valid_pair"]
    assert not orc["valid_pair"]

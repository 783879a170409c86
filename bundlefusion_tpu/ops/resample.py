"""Projective-association sampling without gathers (one-hot resample).

The dense BA term and dense verification each associate ~5K pixels x many
channels x many pairs per solve. ``onehot_gather2d`` samples them with two
separable one-hot contractions instead of per-pixel gathers
(``img[vi, ui]``):

    tmp[p, c, h] = sum_w onehot_u[p, w] * stack[c, h, w]   (matmul)
    out[p, c]    = sum_h tmp[p, c, h] * onehot_v[p, h]     (elementwise)

Selection is exact (every reduction has exactly one nonzero addend); at
cache resolution (80x60, C~9, P~5K, 64 pairs) the batched matmul is ~13
GFLOP. Its time on the GPU against a plain gather is not measured.

Used by the dense point-to-plane term (``solver/dense_term.py``,
reference ``findDenseCorr`` in SolverBundlingDenseUtil.h) and the dense
verification (``ops/filters.py``, reference ``computeProjError``,
SIFTImageManager.cu:424-487).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def onehot_gather2d(stack, vi, ui, valid):
    """Sample ``stack[c, vi, ui]`` for every (vi, ui) without gathers.

    Args:
      stack: [C, H, W] float32 channel stack (pre-sanitized: no NaN/inf).
      vi, ui: integer pixel indices, any shape S.
      valid: bool mask, shape S; invalid positions return 0.

    Returns [*S, C] float32 samples (treated as constants by autodiff —
    projective association is fixed within a GN iteration, matching the
    reference's Jacobian).
    """
    C, H, W = stack.shape
    shape = vi.shape
    u1 = jnp.where(valid, ui, -1).reshape(-1)
    v1 = jnp.where(valid, vi, -1).reshape(-1)
    P = u1.shape[0]
    oh_u = (u1[:, None] == jnp.arange(W)[None, :]).astype(jnp.float32)
    oh_v = (v1[:, None] == jnp.arange(H)[None, :]).astype(jnp.float32)
    # [P, W] x [C, H, W] -> [P, C, H] (one matmul over the W contraction)
    tmp = jnp.einsum(
        "pw,chw->pch", oh_u, stack, precision=jax.lax.Precision.HIGHEST
    )
    out = jnp.einsum(
        "pch,ph->pc", tmp, oh_v, precision=jax.lax.Precision.HIGHEST
    )
    return jax.lax.stop_gradient(out.reshape(*shape, C))

"""Batched all-anime rating prediction (model_recs hot path).

The reference runs model.predict over a [|unwatched|, 2] index array built
in Python (model_recs.py:159-192, :394). Here the whole computation —
embedding gather, cosine, Dense+BatchNorm+sigmoid head, watched-set
masking, top-k — happens on device. Because the trained head collapses to
an affine map of the cosine (z = w*cos + b, then the eval-mode BatchNorm is
another affine), the entire head folds into sigmoid(alpha*cos + beta) with

    alpha = gamma * w / sqrt(moving_var + eps)
    beta  = gamma * (b - moving_mean) / sqrt(moving_var + eps) + bn_beta

which is applied inside the top-k program (ops/topk.py, use_head=True).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from anime_recommendations_tpu.models.two_tower import (
    KERAS_BN_EPS,
    BNState,
    TwoTowerParams,
)
from anime_recommendations_tpu.ops.topk import masked_topk


def head_affine(params: TwoTowerParams, bn_state: BNState) -> jax.Array:
    """Fold Dense(1) + eval-mode BatchNorm into (alpha, beta)."""
    inv = jax.lax.rsqrt(bn_state.moving_var + KERAS_BN_EPS)
    alpha = params.bn_gamma * params.dense_w * inv
    beta = params.bn_gamma * (params.dense_b - bn_state.moving_mean) * inv + params.bn_beta
    return jnp.stack([alpha, beta])


def score_all_items(
    params: TwoTowerParams,
    bn_state: BNState,
    user_index: jax.Array,
) -> jax.Array:
    """Predicted rating of EVERY anime for one user (XLA path, [n_anime]).

    Used for parity testing and full-score exports; the serving path uses
    score_topk below.
    """
    u = params.user_emb[user_index]
    u = u / jnp.linalg.norm(u)
    a = params.anime_emb / jnp.linalg.norm(params.anime_emb, axis=1, keepdims=True)
    cos = jnp.dot(a, u, precision=jax.lax.Precision.HIGHEST)
    alpha, beta = head_affine(params, bn_state)
    return jax.nn.sigmoid(alpha * cos + beta)


def score_topk(
    anime_table_normalized,              # [N, D] rows / QuantizedTable / IVFIndex
    user_rows_normalized: jax.Array,     # [Qn, D] L2-normalized user rows
    head: jax.Array,                     # [2] (alpha, beta) from head_affine
    k: int,
    mask: jax.Array | None = None,       # [N] True keeps (e.g. NOT-watched & in-vocab)
    **kwargs,
) -> tuple[jax.Array, jax.Array]:
    """Fused predict-all + mask + top-k: returns (ratings [Qn,k], anime rows)."""
    if user_rows_normalized.ndim == 1:
        user_rows_normalized = user_rows_normalized[None, :]
    from anime_recommendations_tpu.ops.topk import _dispatch_topk

    return _dispatch_topk(
        anime_table_normalized, user_rows_normalized, mask,
        kwargs.pop("exclude", None), head, k=k, use_head=True, **kwargs,
    )

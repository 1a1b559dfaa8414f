"""Two-tower embedding dot-product rating model, pure JAX.

Architecture parity with /root/reference/neural_network/neural_network.py:66-106:

    user id  -> Embedding(n_users, D, L2-reg)  \\
                                                 Dot(normalize=True)  -> cos
    anime id -> Embedding(n_anime, D, L2-reg)  /
    cos -> Dense(1, he_normal) -> BatchNorm -> sigmoid -> predicted rating

Numerics choices that matter for parity:
  * Dot(normalize=True) == cosine: each embedding row is L2-normalized with
    TF's epsilon semantics (x / sqrt(max(sum(x^2), 1e-12))).
  * Dense(1) sees a scalar input, so the head is y = w*cos + b with
    he_normal(fan_in=1) init.
  * BatchNorm uses Keras defaults (momentum 0.99, eps 1e-3), batch statistics
    in training, moving averages at eval.
  * Loss = mean BCE (probabilities clipped to [1e-7, 1-1e-7], Keras
    backend semantics) + l2 * sum(W^2) over BOTH full embedding tables
    (Keras embeddings_regularizer applies to the whole matrix each step).
  * Embedding init: Keras Embedding default RandomUniform(-0.05, 0.05).

The hot path is two embedding-row gathers + a rowwise dot; all shapes are
static, everything jits into one XLA computation. The dense L2 term keeps
the table gradients dense, which XLA fuses with the optimizer update.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

TF_L2_NORM_EPS = 1e-12     # tf.linalg.l2_normalize clamp
KERAS_BCE_EPS = 1e-7       # Keras backend binary_crossentropy clip
KERAS_BN_MOMENTUM = 0.99
KERAS_BN_EPS = 1e-3


class TwoTowerParams(NamedTuple):
    user_emb: jax.Array    # [n_users, D] float32
    anime_emb: jax.Array   # [n_anime, D] float32
    dense_w: jax.Array     # [] scalar
    dense_b: jax.Array     # [] scalar
    bn_gamma: jax.Array    # [] scalar
    bn_beta: jax.Array     # [] scalar


class BNState(NamedTuple):
    moving_mean: jax.Array  # []
    moving_var: jax.Array   # []


def init_params(
    rng: jax.Array,
    n_users: int,
    n_anime: int,
    embedding_size: int = 128,
    dtype=jnp.float32,
) -> TwoTowerParams:
    k_user, k_anime, k_dense = jax.random.split(rng, 3)
    # Keras Embedding default init: uniform(-0.05, 0.05).
    user_emb = jax.random.uniform(
        k_user, (n_users, embedding_size), dtype, minval=-0.05, maxval=0.05
    )
    anime_emb = jax.random.uniform(
        k_anime, (n_anime, embedding_size), dtype, minval=-0.05, maxval=0.05
    )
    # he_normal on fan_in=1: truncated normal, stddev = sqrt(2/1).
    dense_w = jax.random.truncated_normal(k_dense, -2.0, 2.0, (), dtype) * jnp.sqrt(2.0)
    return TwoTowerParams(
        user_emb=user_emb,
        anime_emb=anime_emb,
        dense_w=dense_w,
        dense_b=jnp.zeros((), dtype),
        bn_gamma=jnp.ones((), dtype),
        bn_beta=jnp.zeros((), dtype),
    )


def init_bn_state(dtype=jnp.float32) -> BNState:
    return BNState(moving_mean=jnp.zeros((), dtype), moving_var=jnp.ones((), dtype))


def _l2_normalize(x: jax.Array) -> jax.Array:
    sq = jnp.sum(jnp.square(x), axis=-1, keepdims=True)
    return x * jax.lax.rsqrt(jnp.maximum(sq, TF_L2_NORM_EPS))


@jax.custom_vjp
def take_rows(table: jax.Array, idx: jax.Array) -> jax.Array:
    """Embedding-row gather whose backward scatter-adds with SORTED indices.

    Sorting the batch indices first lets XLA take the sorted-scatter path,
    which writes table rows in order. Summation order over duplicate rows
    changes (sorted instead of batch order) — identical math up to f32
    rounding.

    Opt-in via ``forward(..., sorted_scatter=True)`` / the trainer's
    ``sorted_scatter`` flag.
    """
    return table[idx]


def _take_rows_fwd(table, idx):
    return table[idx], (idx, table.shape)


def _take_rows_bwd(res, g):
    idx, shape = res
    order = jnp.argsort(idx, stable=False)  # grouping only for the scatter-add
    d_table = jnp.zeros(shape, g.dtype).at[idx[order]].add(
        g[order], indices_are_sorted=True, unique_indices=False
    )
    return d_table, None


take_rows.defvjp(_take_rows_fwd, _take_rows_bwd)


def cosine_merge(u_rows: jax.Array, a_rows: jax.Array) -> jax.Array:
    """Dot(normalize=True, axes=2): rowwise cosine similarity. [B,D]x[B,D]->[B]."""
    return jnp.sum(_l2_normalize(u_rows) * _l2_normalize(a_rows), axis=-1)


def dot_merge(u_rows: jax.Array, a_rows: jax.Array) -> jax.Array:
    """Unnormalized rowwise dot — NOT the reference architecture (its head
    is Dot(normalize=True)); a diagnostic variant for attributing the
    convergence-floor gap to the cosine head's expressiveness limit
    (train/convergence.py module docstring) vs optimization."""
    return jnp.sum(u_rows * a_rows, axis=-1)


def head(params: TwoTowerParams, cos: jax.Array, bn_state: BNState, train: bool,
         weights: jax.Array | None = None) -> tuple[jax.Array, BNState]:
    """Dense(1) -> BatchNorm -> sigmoid on the scalar cosine feature.

    ``weights`` masks padded rows out of the batch statistics so that a
    ragged final batch matches unpadded math exactly.
    """
    z = params.dense_w * cos + params.dense_b
    if train:
        if weights is None:
            mean = jnp.mean(z)
            var = jnp.mean(jnp.square(z - mean))
        else:
            denom = jnp.maximum(jnp.sum(weights), 1.0)
            mean = jnp.sum(z * weights) / denom
            var = jnp.sum(jnp.square(z - mean) * weights) / denom
        new_state = BNState(
            moving_mean=bn_state.moving_mean * KERAS_BN_MOMENTUM
            + mean * (1.0 - KERAS_BN_MOMENTUM),
            moving_var=bn_state.moving_var * KERAS_BN_MOMENTUM
            + var * (1.0 - KERAS_BN_MOMENTUM),
        )
    else:
        mean, var = bn_state.moving_mean, bn_state.moving_var
        new_state = bn_state
    z_hat = (z - mean) * jax.lax.rsqrt(var + KERAS_BN_EPS)
    out = params.bn_gamma * z_hat + params.bn_beta
    return jax.nn.sigmoid(out), new_state


def forward(
    params: TwoTowerParams,
    bn_state: BNState,
    users: jax.Array,
    anime: jax.Array,
    train: bool,
    weights: jax.Array | None = None,
    sorted_scatter: bool | str = False,
    merge: str = "cosine",
) -> tuple[jax.Array, BNState]:
    """Full forward pass: gathers -> cosine -> head. Returns (pred[B], bn_state).

    ``sorted_scatter``: False = plain gathers; True = sorted-scatter VJP on
    both tables; "user" = sorted VJP on the (large) user table only — the
    anime table's dense grad is small enough that the sort can cost more
    than the scatter saves.

    ``merge``: "cosine" (reference parity) or "dot" (diagnostic raw-dot
    head, dot_merge).
    """
    plain = lambda t, i: t[i]
    u_gather = take_rows if sorted_scatter else plain
    a_gather = take_rows if sorted_scatter is True else plain
    u_rows = u_gather(params.user_emb, users)
    a_rows = a_gather(params.anime_emb, anime)
    merge_fn = cosine_merge if merge == "cosine" else dot_merge
    cos = merge_fn(u_rows, a_rows)
    return head(params, cos, bn_state, train=train, weights=weights)


def predict(params: TwoTowerParams, bn_state: BNState,
            users: jax.Array, anime: jax.Array) -> jax.Array:
    """Inference-mode rating prediction (model.predict parity)."""
    pred, _ = forward(params, bn_state, users, anime, train=False)
    return pred


def bce(pred: jax.Array, target: jax.Array) -> jax.Array:
    p = jnp.clip(pred, KERAS_BCE_EPS, 1.0 - KERAS_BCE_EPS)
    return -(target * jnp.log(p) + (1.0 - target) * jnp.log1p(-p))


def loss_and_metrics(
    params: TwoTowerParams,
    bn_state: BNState,
    users: jax.Array,
    anime: jax.Array,
    ratings: jax.Array,
    weights: jax.Array,
    l2_reg_factor: float,
    train: bool,
    sorted_scatter: bool = False,
    merge: str = "cosine",
) -> tuple[jax.Array, tuple[jax.Array, BNState]]:
    """Weighted-mean BCE + full-table L2, plus the mse metric.

    Returns (loss, (mse, new_bn_state)) so it can feed jax.value_and_grad
    with has_aux=True.
    """
    pred, new_state = forward(params, bn_state, users, anime, train=train,
                              weights=weights, sorted_scatter=sorted_scatter,
                              merge=merge)
    denom = jnp.maximum(jnp.sum(weights), 1.0)
    data_loss = jnp.sum(bce(pred, ratings) * weights) / denom
    reg = l2_reg_factor * (
        jnp.sum(jnp.square(params.user_emb)) + jnp.sum(jnp.square(params.anime_emb))
    )
    mse = jnp.sum(jnp.square(pred - ratings) * weights) / denom
    return data_loss + reg, (mse, new_state)


def normalized_tables(params: TwoTowerParams) -> tuple[jax.Array, jax.Array]:
    """L2-row-normalized (anime, user) embedding tables.

    Parity with extract_weights / get_weights (neural_network.py:128-138,
    similar_anime.py:136-171): rows divided by their L2 norm so a dot
    product is cosine similarity — but with the model's own TF epsilon
    clamp (_l2_normalize). The reference's raw numpy division is a latent
    bug this engine must not inherit: the full-table L2 decay drives
    never-touched rows toward zero, and once a row's norm-squared
    underflows f32 (or denormals are flushed), raw division mints inf/NaN
    rows that then WIN every retrieval scan (measured: one NaN row capped
    trained-table top-10 overlap at exactly 0.9 before this clamp). Under
    the clamp a ~zero row normalizes to ~zero — cosine ~0, never top-k.
    """
    return _l2_normalize(params.anime_emb), _l2_normalize(params.user_emb)

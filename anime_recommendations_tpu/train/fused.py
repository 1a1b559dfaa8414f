"""Fused-Adam training step: dense-Adam semantics from row gradients.

Same MATH as the exact-parity dense path (train/trainer.py train_step):
every table row gets Adam moment decay and the full-table L2 regularizer's
gradient 2*l2*W every step, and the reported loss includes the L2 term's
value — unlike LazyAdam (train/lazy.py), nothing about the semantics is
row-sparse. What changes is the program: gradients are taken w.r.t. the
GATHERED rows (the table-shaped gradient of the loss is never built by
autodiff) and ops/fused_adam.sparse_adam_update scatters them, applies the
decay, the moment and weight updates, and returns the sumsq needed for the
loss's regularizer VALUE. The 4 scalar head parameters update via ordinary
Adam with the shared step count, exactly as the dense optimizer would.

Replaces the reference's Keras Adam
(/root/reference/neural_network/neural_network.py:102-104,142-144) at the
same semantics.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import optax

from anime_recommendations_tpu.models.two_tower import TwoTowerParams
from anime_recommendations_tpu.ops.fused_adam import sparse_adam_update
from anime_recommendations_tpu.train.lazy import _data_loss, _scalar_adam
from anime_recommendations_tpu.train.trainer import KERAS_ADAM_EPS, TrainState

B1, B2 = 0.9, 0.999
# Stochastic-rounding salts of the two tables' bf16 moments
# (ops/fused_adam.sparse_adam_update table_id).
USER_TABLE_ID, ANIME_TABLE_ID = 0, 1


def _apply_updates(state: TrainState, users, anime, d_u, d_a, d_head, lr,
                   l2_reg_factor):
    """Adam on both tables (sparse_adam_update) and the scalar head.
    Returns (new_params, new_opt, sumsq_u + sumsq_a)."""
    params = state.params
    opt: optax.ScaleByAdamState = state.opt_state
    t = opt.count + 1
    w_u, mu_u, nu_u, sumsq_u = sparse_adam_update(
        params.user_emb, opt.mu.user_emb, opt.nu.user_emb,
        users, d_u, t, lr, l2=l2_reg_factor,
        b1=B1, b2=B2, eps=KERAS_ADAM_EPS, table_id=USER_TABLE_ID,
    )
    w_a, mu_a, nu_a, sumsq_a = sparse_adam_update(
        params.anime_emb, opt.mu.anime_emb, opt.nu.anime_emb,
        anime, d_a, t, lr, l2=l2_reg_factor,
        b1=B1, b2=B2, eps=KERAS_ADAM_EPS, table_id=ANIME_TABLE_ID,
    )

    tf32 = t.astype(jnp.float32)
    bc1 = 1.0 - jnp.float32(B1) ** tf32
    bc2 = 1.0 - jnp.float32(B2) ** tf32
    names = ("dense_w", "dense_b", "bn_gamma", "bn_beta")
    new_scalars, new_mu_s, new_nu_s = {}, {}, {}
    for name, g in zip(names, d_head):
        p, m, v = _scalar_adam(
            getattr(params, name), getattr(opt.mu, name),
            getattr(opt.nu, name), g, bc1, bc2, lr,
        )
        new_scalars[name], new_mu_s[name], new_nu_s[name] = p, m, v

    new_params = TwoTowerParams(user_emb=w_u, anime_emb=w_a, **new_scalars)
    new_opt = optax.ScaleByAdamState(
        count=t,
        mu=TwoTowerParams(user_emb=mu_u, anime_emb=mu_a, **new_mu_s),
        nu=TwoTowerParams(user_emb=nu_u, anime_emb=nu_a, **new_nu_s),
    )
    return new_params, new_opt, sumsq_u + sumsq_a


@partial(jax.jit, donate_argnums=0, static_argnames=("l2_reg_factor",))
def fused_train_step(
    state: TrainState,
    users: jax.Array,
    anime: jax.Array,
    ratings: jax.Array,
    weights: jax.Array,
    lr: jax.Array,
    l2_reg_factor: float,
) -> tuple[TrainState, jax.Array, jax.Array]:
    """One fused dense-Adam step. Returns (new_state, batch_loss, batch_mse).

    ``batch_loss`` includes the full-table L2 regularizer's value at the
    pre-update parameters — identical in meaning to the dense path's
    history ``loss`` column (models/two_tower.py loss_and_metrics).
    """
    params = state.params
    u_rows = params.user_emb[users]
    a_rows = params.anime_emb[anime]
    head_params = (params.dense_w, params.dense_b,
                   params.bn_gamma, params.bn_beta)

    (data_loss, (mse, new_bn)), (d_u, d_a, d_head) = jax.value_and_grad(
        _data_loss, argnums=(0, 1, 2), has_aux=True
    )(u_rows, a_rows, head_params, state.bn_state, ratings, weights)

    new_params, new_opt, sumsq = _apply_updates(
        state, users, anime, d_u, d_a, d_head, lr, l2_reg_factor
    )
    loss = data_loss + l2_reg_factor * sumsq
    return TrainState(new_params, new_bn, new_opt), loss, mse


@partial(jax.jit, donate_argnums=(0, 1, 2), static_argnames=("l2_reg_factor",))
def fused_train_step_pipelined(
    state: TrainState,
    u_rows: jax.Array,        # [B, D] user rows for THIS batch (pre-gathered)
    a_rows: jax.Array,        # [B, D] anime rows for THIS batch
    users: jax.Array,
    anime: jax.Array,
    ratings: jax.Array,
    weights: jax.Array,
    next_users: jax.Array,    # [B] ids of the NEXT batch
    next_anime: jax.Array,
    lr: jax.Array,
    l2_reg_factor: float,
) -> tuple[TrainState, jax.Array, jax.Array, jax.Array, jax.Array]:
    """fused_train_step with the embedding gathers software-pipelined: this
    step consumes rows gathered at the END of the previous step (from the
    freshly updated tables) and returns the rows the NEXT step will consume.

    Why: with a gather at the TOP of the scan body, the carried table has
    two consumers per step (gather + in-place update) and XLA's
    copy-insertion can protect the gather with a full-table copy.
    Pipelined, the carry-in table's only consumer is the update and the
    gather reads the update's OUTPUT — no conflict, no copy.

    Returns (new_state, loss, mse, next_u_rows, next_a_rows).
    """
    params = state.params
    head_params = (params.dense_w, params.dense_b,
                   params.bn_gamma, params.bn_beta)

    (data_loss, (mse, new_bn)), (d_u, d_a, d_head) = jax.value_and_grad(
        _data_loss, argnums=(0, 1, 2), has_aux=True
    )(u_rows, a_rows, head_params, state.bn_state, ratings, weights)

    new_params, new_opt, sumsq = _apply_updates(
        state, users, anime, d_u, d_a, d_head, lr, l2_reg_factor
    )
    loss = data_loss + l2_reg_factor * sumsq
    next_u_rows = new_params.user_emb[next_users]
    next_a_rows = new_params.anime_emb[next_anime]
    new_state = TrainState(new_params, new_bn, new_opt)
    return new_state, loss, mse, next_u_rows, next_a_rows

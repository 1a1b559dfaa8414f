"""Device-resident epoch loop: one launch per epoch via lax.scan.

The per-step path (train/trainer.py) launches one XLA program per batch,
so host dispatch can bound throughput. Here the training data lives ON
DEVICE for the whole run and each epoch is ONE program:

  perm = jax.random.permutation(key, n_padded)       # device-side shuffle
  scan over batches: gather rows by perm slice -> train_step math

Padding rows (to a batch multiple) carry weight 0, so they are exact
no-ops in the loss, metrics and BatchNorm statistics — epochs are the same
math as the per-step path, only the shuffle's RNG differs (jax PRNG
instead of numpy).

The scan carries the full TrainState through jit with donated buffers:
tables never round-trip to the host; per-batch losses come back as one
[n_batches] array per epoch.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from anime_recommendations_tpu.data.dataset import RatingsDataset
from anime_recommendations_tpu.models.two_tower import loss_and_metrics
from anime_recommendations_tpu.train.trainer import TrainState, make_optimizer


SHUFFLE_BLOCK = 512  # granule of the device-side epoch shuffle (see stage())


class DeviceData(NamedTuple):
    users: jax.Array    # [n_pad] int32
    anime: jax.Array    # [n_pad] int32
    ratings: jax.Array  # [n_pad] f32
    weights: jax.Array  # [n_pad] f32; 0 marks padding

    @property
    def n(self) -> int:
        return self.users.shape[0]


def stage(
    ds: RatingsDataset, batch_size: int, seed: int | None = None
) -> DeviceData:
    """Upload a dataset once, padded to a batch multiple with weight-0 rows.

    With ``seed`` set, rows are host-shuffled once here; per-epoch
    reshuffling then permutes SHUFFLE_BLOCK-row granules on device (see
    train_epoch). ``seed=None`` keeps dataset order (for shuffle-off runs
    that must match the per-step path batch-for-batch). Permuting
    contiguous 2 KB granules reads memory in long runs, where an exact
    per-element permutation is a random gather per element. With the
    one-time host shuffle, granules are random example sets and epoch
    batches are random unions of granules (the standard shuffle-window
    trade).
    """
    n = len(ds)
    n_pad = -(-max(n, 1) // batch_size) * batch_size
    pad = n_pad - n
    order = (
        np.random.default_rng(seed).permutation(n)
        if (n and seed is not None) else np.arange(n)
    )
    return DeviceData(
        users=jax.device_put(
            jnp.asarray(np.pad(ds.users[order], (0, pad)), jnp.int32)
        ),
        anime=jax.device_put(
            jnp.asarray(np.pad(ds.anime[order], (0, pad)), jnp.int32)
        ),
        ratings=jax.device_put(
            jnp.asarray(np.pad(ds.ratings[order], (0, pad)), jnp.float32)
        ),
        weights=jax.device_put(
            jnp.asarray(np.pad(np.ones(n, np.float32), (0, pad)), jnp.float32)
        ),
    )


@partial(
    jax.jit,
    static_argnames=(
        "batch_size", "l2_reg_factor", "shuffle", "sorted_scatter", "optimizer"
    ),
    donate_argnums=(0,),
)
def train_epoch(
    state: TrainState,
    data: DeviceData,
    key: jax.Array,
    lr: jax.Array,
    batch_size: int,
    l2_reg_factor: float,
    shuffle: bool = True,
    sorted_scatter: bool | str = False,
    optimizer: str = "adam",
) -> tuple[TrainState, jax.Array, jax.Array, jax.Array]:
    """One full epoch on device. Returns (state, losses[nb], mses[nb], wsums[nb]).

    ``optimizer="lazy_adam"`` switches the step to train/lazy.py (row-sparse
    Adam; per-batch losses then exclude the L2 regularizer's value).
    """
    n = data.n
    nb = n // batch_size
    # Device-side shuffle at SHUFFLE_BLOCK granularity: one permuted copy per
    # epoch via contiguous-granule gathers instead of an exact per-element
    # permutation. stage() host-shuffled rows once, so granules are random
    # example sets.
    # Granule size never depends on n's factorization (an odd n used to
    # silently degrade to g=1 scalar gathers): full SHUFFLE_BLOCK granules
    # are permuted over the head and the sub-granule tail (< g rows, already
    # host-shuffled) keeps its position. Small datasets shrink g so there
    # are always >= ~64 granules to permute.
    if shuffle:
        g = int(max(1, min(SHUFFLE_BLOCK, n // 64)))
        n_head = (n // g) * g
        perm = jax.random.permutation(key, n_head // g)

        def _shuf(x):
            head = x[:n_head].reshape(n_head // g, g)[perm].reshape(n_head)
            return head if n_head == n else jnp.concatenate([head, x[n_head:]])

        data = DeviceData(*(_shuf(x) for x in data))

    if optimizer in ("fused_adam", "fused_adam_bf16m"):
        # (bf16m: same code path — the moments' dtype in ``state`` drives
        # the update's storage precision, train/trainer.cast_table_moments.)
        # Software-pipelined scan: step i updates the tables AND gathers
        # the rows step i+1 will consume from the updated tables, so the
        # tables have a single consumer per step (train/fused.py
        # fused_train_step_pipelined). The prologue gathers batch 0's rows
        # once per epoch.
        from anime_recommendations_tpu.train.fused import (
            fused_train_step_pipelined,
        )

        def sl_at(x, j):
            return jax.lax.dynamic_slice_in_dim(x, j * batch_size, batch_size)

        u_rows0 = state.params.user_emb[data.users[:batch_size]]
        a_rows0 = state.params.anime_emb[data.anime[:batch_size]]

        def fused_body(carry, i):
            state, u_rows, a_rows = carry
            nxt = jax.lax.rem(i + 1, nb)
            state, loss, mse, u_next, a_next = fused_train_step_pipelined(
                state, u_rows, a_rows,
                sl_at(data.users, i), sl_at(data.anime, i),
                sl_at(data.ratings, i), sl_at(data.weights, i),
                sl_at(data.users, nxt), sl_at(data.anime, nxt),
                lr, l2_reg_factor,
            )
            w = jnp.sum(sl_at(data.weights, i))
            return (state, u_next, a_next), (loss, mse, w)

        (state, _, _), (losses, mses, wsums) = jax.lax.scan(
            fused_body, (state, u_rows0, a_rows0),
            jnp.arange(nb, dtype=jnp.int32),
        )
        return state, losses, mses, wsums

    def body(state, i):
        sl = lambda x: jax.lax.dynamic_slice_in_dim(x, i * batch_size, batch_size)
        users = sl(data.users)
        anime = sl(data.anime)
        ratings = sl(data.ratings)
        weights = sl(data.weights)
        if optimizer == "lazy_adam":
            from anime_recommendations_tpu.train.lazy import lazy_train_step

            state, loss, mse = lazy_train_step(
                state, users, anime, ratings, weights, lr, l2_reg_factor
            )
            return state, (loss, mse, jnp.sum(weights))
        if optimizer != "adam":
            raise ValueError(f"unknown optimizer {optimizer!r}")
        (loss, (mse, new_bn)), grads = jax.value_and_grad(
            loss_and_metrics, has_aux=True
        )(state.params, state.bn_state, users, anime, ratings, weights,
          l2_reg_factor, True, sorted_scatter)
        updates, new_opt = make_optimizer().update(
            grads, state.opt_state, state.params
        )
        updates = jax.tree.map(lambda u: -lr * u, updates)
        new_params = optax.apply_updates(state.params, updates)
        return TrainState(new_params, new_bn, new_opt), (loss, mse, jnp.sum(weights))

    state, (losses, mses, wsums) = jax.lax.scan(
        body, state, jnp.arange(nb, dtype=jnp.int32)
    )
    return state, losses, mses, wsums


@partial(jax.jit, static_argnames=("batch_size", "l2_reg_factor"))
def eval_epoch(
    params,
    bn_state,
    data: DeviceData,
    batch_size: int,
    l2_reg_factor: float,
) -> tuple[jax.Array, jax.Array]:
    """Weighted-mean (loss, mse) over the staged holdout, one launch."""
    nb = data.n // batch_size

    def body(carry, i):
        sl = lambda x: jax.lax.dynamic_slice_in_dim(x, i * batch_size, batch_size)
        loss, (mse, _) = loss_and_metrics(
            params, bn_state, sl(data.users), sl(data.anime), sl(data.ratings),
            sl(data.weights), l2_reg_factor, False,
        )
        w = jnp.sum(sl(data.weights))
        l_sum, m_sum, w_sum = carry
        return (l_sum + loss * w, m_sum + mse * w, w_sum + w), None

    (l_sum, m_sum, w_sum), _ = jax.lax.scan(
        body, (jnp.float32(0), jnp.float32(0), jnp.float32(0)),
        jnp.arange(nb, dtype=jnp.int32),
    )
    w = jnp.maximum(w_sum, 1.0)
    return l_sum / w, m_sum / w

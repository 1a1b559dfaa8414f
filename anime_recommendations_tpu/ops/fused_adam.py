"""Sparse-gradient scatter + L2 decay + Adam update of one embedding table.

The training step differentiates the loss w.r.t. the GATHERED batch rows
([B, D]), never w.r.t. the table. This op turns those row gradients into
the dense-Adam update of the whole table::

    d      = scatter_add(zeros, ids, g_rows) (+ dense_grad)
    g      = d + 2*l2*W                                    # full-table L2
    mu'    = b1*mu + (1-b1)*g
    nu'    = b2*nu + (1-b2)*g^2
    W'     = W - lr * (mu'/bc1) / (sqrt(nu'/bc2) + eps)    # Adam
    sumsq  = sum(W^2)          # pre-update, for the loss's reg term

as one scatter-add plus one elementwise pass that XLA fuses, on every
backend and under ``shard_map``. Semantics match optax.scale_by_adam
(b1/b2/eps, bias correction by step count) + the trainer's -lr scale + the
analytic gradient 2*l2*W of the full-table L2 regularizer
(models/two_tower.py loss_and_metrics).

Moments may be stored bf16 (``fused_adam_bf16m``). The update math stays
f32 and the stores use STOCHASTIC rounding: round-to-nearest bf16 drops
EMA increments smaller than half an ulp of the running value (nu's
(1-b2)=1e-3-relative updates sit below bf16's 2^-9 half-ulp), so a
nearest-rounded nu freezes and the optimizer mis-scales. Adding uniform
random low-16 bits before truncating makes the rounded value unbiased, so
sub-ulp increments land with proportional probability.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def stochastic_round_bf16(val: jax.Array, bits16: jax.Array) -> jax.Array:
    """Round f32 ``val`` to bf16 stochastically with uniform uint32
    ``bits16`` in [0, 2^16): add them below the bf16 mantissa, truncate.
    A carry into the exponent is a correct round-up; sign-magnitude
    addition rounds magnitudes symmetrically."""
    b = jax.lax.bitcast_convert_type(val.astype(jnp.float32), jnp.uint32)
    b = (b + bits16) & jnp.uint32(0xFFFF0000)
    return jax.lax.bitcast_convert_type(b, jnp.float32).astype(jnp.bfloat16)


def _store(val: jax.Array, dtype, bits16: jax.Array | None) -> jax.Array:
    if dtype == jnp.bfloat16:
        return stochastic_round_bf16(val, bits16)
    return val.astype(dtype)


# b1/b2/eps are static so that 1-b1 and 1-b2 are formed in Python double
# precision, as optax does: 1 - f32(0.999) is 1.3e-5 off 0.001.
@functools.partial(jax.jit, static_argnames=("b1", "b2", "eps"))
def sparse_adam_update(
    w: jax.Array,           # [N, D] f32 table
    mu: jax.Array,          # [N, D] f32/bf16 Adam first moment
    nu: jax.Array,          # [N, D] f32/bf16 Adam second moment
    ids: jax.Array,         # [B] i32 row id per batch example (any order;
                            #     ids outside [0, N) are dropped)
    g_rows: jax.Array,      # [B, D] f32 gradient w.r.t. the gathered rows
    step: jax.Array,        # [] i32 Adam step count AFTER this update (t >= 1)
    lr: jax.Array,          # [] f32
    l2: float | jax.Array = 0.0,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-7,
    table_id: int | jax.Array = 0,
    dense_grad: jax.Array | None = None,   # [N, D] pre-accumulated grads
) -> tuple[jax.Array, ...]:
    """One sparse-Adam step. Returns (w', mu', nu', sumsq(w_before)).

    ``dense_grad`` (an already-materialized [N, D] gradient, e.g. the
    routed path's multi-round overflow accumulator) is added to the
    scattered rows. ``table_id`` salts the stochastic-rounding bits of
    bf16 moments, which are drawn from ``jax.random`` keyed by
    (table_id, step): deterministic per step, distinct per table.
    """
    dense = jnp.zeros(w.shape, jnp.float32).at[ids].add(
        g_rows.astype(jnp.float32), mode="drop"
    )
    if dense_grad is not None:
        dense = dense + dense_grad
    g = dense + 2.0 * jnp.asarray(l2, jnp.float32) * w
    t = step.astype(jnp.float32)
    bc1 = 1.0 - jnp.float32(b1) ** t
    bc2 = 1.0 - jnp.float32(b2) ** t
    mu2 = b1 * mu.astype(jnp.float32) + (1.0 - b1) * g
    nu2 = b2 * nu.astype(jnp.float32) + (1.0 - b2) * jnp.square(g)
    w2 = w - lr * (mu2 / bc1) / (jnp.sqrt(nu2 / bc2) + jnp.float32(eps))

    bits_mu = bits_nu = None
    if jnp.bfloat16 in (mu.dtype, nu.dtype):
        # One 32-bit draw per element feeds both moments: low half to mu,
        # high half to nu.
        key = jax.random.fold_in(
            jax.random.PRNGKey(table_id), step.astype(jnp.uint32)
        )
        bits = jax.random.bits(key, w.shape, jnp.uint32)
        bits_mu = bits & jnp.uint32(0xFFFF)
        bits_nu = bits >> jnp.uint32(16)
    return (
        w2,
        _store(mu2, mu.dtype, bits_mu),
        _store(nu2, nu.dtype, bits_nu),
        jnp.sum(jnp.square(w)),
    )

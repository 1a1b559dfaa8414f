"""L2 row-normalization of an embedding table.

Replacement for the reference's numpy normalization (get_weights,
similar_anime.py:136-171): one elementwise pass that XLA fuses.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("eps",))
def l2_normalize_rows(table: jax.Array, eps: float = 1e-24) -> jax.Array:
    """Rowwise x / ||x||_2 over an [N, D] table, computed in f32."""
    x = table.astype(jnp.float32)
    sq = jnp.sum(jnp.square(x), axis=-1, keepdims=True)
    return (x * jax.lax.rsqrt(jnp.maximum(sq, eps))).astype(table.dtype)

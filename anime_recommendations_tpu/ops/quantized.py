"""Two-stage int8 retrieval: quantized scan + exact f32 rescore.

The retrieval scan (ops/topk.py) reads the whole embedding table once per
query batch. Storing the table in int8 cuts that read 4x vs f32 (2x vs
bf16). int8 dot products carry ~1/127-per-element noise, so stage 1
over-selects a candidate pool of ``m = max(4k, k+8)`` rows from the int8
scores and stage 2 rescores just those m rows in exact f32 and takes the
true top-k. With m >= 4k the pool virtually always contains the exact
top-k (tests assert exact oracle overlap on random tables).

Quantization: symmetric per-row int8 over L2-NORMALIZED rows —
``q_r = round(127 * w_r / max|w_r|)``, ``scale_r = max|w_r| / 127``.
cos(q, r) ≈ (iq · ir) * scale_q * scale_r. Stage 1 is one int8 x int8 ->
int32 ``dot_general``; masks, self-exclusion and the optional sigmoid head
behave as in ops/topk.masked_topk.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from anime_recommendations_tpu.ops.topk import _mask_scores, _rescore_pool, _top_k


class QuantizedTable(NamedTuple):
    """int8 rows + per-row de-scale factors + the f32 original for rescore."""

    q: jax.Array        # [N, D] int8
    scale: jax.Array    # [N] f32 (q * scale ~= original row)
    f32: jax.Array      # [N, D] float32 (or bf16) exact rows


def quantize_rows(table: jax.Array) -> QuantizedTable:
    """Symmetric per-row int8 quantization (keep the original for rescore)."""
    absmax = jnp.maximum(jnp.max(jnp.abs(table), axis=1), 1e-12)
    scale = (absmax / 127.0).astype(jnp.float32)
    q = jnp.round(table / scale[:, None]).astype(jnp.int8)
    return QuantizedTable(q=q, scale=scale, f32=table)


@functools.partial(jax.jit, static_argnames=("k", "use_head"))
def quantized_topk(
    qt: QuantizedTable,
    queries: jax.Array,        # [Qn, D] float
    k: int,
    mask: jax.Array | None = None,
    exclude: jax.Array | None = None,
    head: jax.Array | None = None,
    use_head: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Exact-rescored top-k via an int8 scan. Same contract as masked_topk.

    Stage 1 scores the int8 table and keeps the best m candidates; stage 2
    gathers the m exact rows, rescores them in f32 and returns the true
    top-k of the pool.
    """
    if queries.ndim == 1:
        queries = queries[None, :]
    n = qt.q.shape[0]
    m = min(max(4 * k, k + 8), n)

    # Quantize the queries with their own per-row scales.
    q_abs = jnp.maximum(jnp.max(jnp.abs(queries), axis=1), 1e-12)
    q_scale = (q_abs / 127.0).astype(jnp.float32)
    q_int = jnp.round(queries / q_scale[:, None]).astype(jnp.int8)
    acc = jax.lax.dot_general(
        q_int, qt.q,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )                                                    # [Qn, N] exact int32
    approx = acc.astype(jnp.float32) * q_scale[:, None] * qt.scale[None, :]
    if use_head:
        # sigmoid(alpha*cos + beta) ranks like alpha*cos; alpha may be
        # negative, which flips the order.
        approx = head[0] * approx
    _, cand = _top_k(_mask_scores(approx, mask, exclude), m)
    # Dead candidates (masked/excluded) are re-marked here so the rescore
    # cannot promote them above live rows.
    alive = jnp.ones(cand.shape, bool)
    if mask is not None:
        alive &= mask.astype(jnp.float32)[cand] > 0.0
    if exclude is not None:
        alive &= cand != exclude.astype(jnp.int32)[:, None]
    return _rescore_pool(qt.f32, queries, cand, alive, k, head, use_head)

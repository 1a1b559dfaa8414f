"""Masked similarity top-k: one matmul, masks folded in, ``lax.top_k``.

The reference retrieval hot loop (similar_anime.py:404-408,
similar_users.py:293-296) materializes all N scores on the host and
argsorts them in numpy. Here the whole query runs as one XLA program on
the device: ``dot_general`` of the queries against the table, the
optional folded sigmoid head, the validity mask and per-query
self-exclusion applied as one elementwise pass, then a top-k (``_top_k``).
Filters (type/genre restriction, self-exclusion, watched-set masking) are
masks inside the program, replacing the reference's post-hoc pandas row
loops.

Numerics: f32 tables are scored at ``Precision.HIGHEST`` so the returned
values are exact f32 scores (a GPU f32 matmul without a stated precision
may run in TF32, ~3 decimal digits). bf16 tables multiply in bf16 and
accumulate in f32. int8 tables (ops/quantized.py) score a candidate pool
in int8 and rescore it exactly with ``_rescore_pool``.

Memory traffic: one read of the [N, D] table plus the [Q, N] f32 score
surface, which XLA writes and the top-k reads back. At serving widths
(q <= 8) the surface is small next to the table.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_NEG = -1e30  # masked-score sentinel (finite: avoids inf-inf NaNs)

# XLA's GPU top_k spreads its work over rows, so a few long rows keep most
# of the card idle. Measured on one H100 (PERF.md, PR 1): q=1 over 350K
# scores took 0.59 ms in one top_k and 0.14 ms as a top-k of each
# 256-wide chunk followed by a top-k of the chunk winners; q=8 0.60 vs
# 0.25 ms. With many rows and k <= 16 the single call is faster (q=256,
# k=10: 1.22 vs 3.44 ms); at k=40 the chunks still win (5.32 vs 4.16 ms).
_CHUNK = 256
_DIRECT_MIN_ROWS, _DIRECT_MAX_K = 64, 16


def _top_k(scores: jax.Array, k: int) -> tuple[jax.Array, jax.Array]:
    """``lax.top_k`` over the last axis of [Q, N] scores (k <= N), split
    into chunks when Q is small or k large (see _CHUNK). Exact: every
    global top-k entry is in its chunk's top-k, and ties keep the lower
    index first as in one top_k."""
    q, n = scores.shape
    if n <= _CHUNK or (q >= _DIRECT_MIN_ROWS and k <= _DIRECT_MAX_K):
        return jax.lax.top_k(scores, k)
    nc = -(-n // _CHUNK)
    padded = jnp.pad(scores, ((0, 0), (0, nc * _CHUNK - n)),
                     constant_values=-jnp.inf)
    kc = min(k, _CHUNK)
    vals, idx = jax.lax.top_k(padded.reshape(q, nc, _CHUNK), kc)
    idx = idx + (jnp.arange(nc, dtype=idx.dtype) * _CHUNK)[None, :, None]
    top_v, pos = jax.lax.top_k(vals.reshape(q, nc * kc), k)
    return top_v, jnp.take_along_axis(idx.reshape(q, nc * kc), pos, axis=1)


def _mask_scores(scores, mask, exclude):
    """Replace invalid [Q, N] entries with the sentinel: rows the [N] mask
    drops, and each query's excluded row (-1: none)."""
    valid = jnp.ones(scores.shape, bool)
    if mask is not None:
        valid &= (mask.astype(jnp.float32) > 0.0)[None, :]
    if exclude is not None:
        rows = jax.lax.broadcasted_iota(jnp.int32, scores.shape, 1)
        valid &= rows != exclude.astype(jnp.int32)[:, None]
    return jnp.where(valid, scores, _NEG)


def _top_k_padded(scores, cand, k):
    """Top-k over the last axis, padded with (sentinel, -1) when fewer
    than k columns exist. ``cand`` maps column -> row id (None: the column
    IS the row id)."""
    kk = min(k, scores.shape[1])
    top_s, pos = _top_k(scores, kk)
    top_i = pos if cand is None else jnp.take_along_axis(cand, pos, axis=1)
    top_i = top_i.astype(jnp.int32)
    if k > kk:
        top_s = jnp.pad(top_s, ((0, 0), (0, k - kk)), constant_values=_NEG)
        top_i = jnp.pad(top_i, ((0, 0), (0, k - kk)), constant_values=-1)
    return top_s, top_i


def _rescore_pool(
    table_f32: jax.Array,        # [N, D] exact rows (f32 or bf16)
    queries: jax.Array,          # [Qn, D]
    cand: jax.Array,             # [Qn, m]
    alive: jax.Array,            # [Qn, m]
    k: int,
    head: jax.Array | None,
    use_head: bool,
) -> tuple[jax.Array, jax.Array]:
    """Exact f32 rescore of a candidate pool, true top-k of it."""
    n = table_f32.shape[0]
    safe = jnp.clip(cand, 0, n - 1)
    rows = table_f32[safe].astype(jnp.float32)                # [Qn, m, D]
    scores = jnp.einsum(
        "qd,qmd->qm", queries.astype(jnp.float32), rows,
        precision=jax.lax.Precision.HIGHEST,
    )
    if use_head:
        scores = jax.nn.sigmoid(head[0] * scores + head[1])
    scores = jnp.where(alive, scores, _NEG)
    cand = jnp.where(alive, cand, -1)
    return _top_k_padded(scores, cand, k)


@functools.partial(jax.jit, static_argnames=("k", "use_head"))
def masked_topk(
    table: jax.Array,            # [N, D] f32 or bf16
    queries: jax.Array,          # [Qn, D]
    k: int,
    mask: jax.Array | None = None,      # [N] bool/float; True/.>0 keeps the row
    exclude: jax.Array | None = None,   # [Qn] int32 row index to drop (-1: none)
    head: jax.Array | None = None,      # [2] (alpha, beta) -> sigmoid(alpha*s+beta)
    use_head: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Top-k of (optionally transformed) ``queries @ table.T`` scores.

    Returns (values [Qn, k], indices [Qn, k]) sorted descending; values are
    exact f32 scores for f32 tables. Rows masked out / excluded can only
    appear when fewer than k valid rows exist; they carry score <= -1e30.
    When k > N the result is padded with (-1e30, -1).
    """
    if use_head and head is None:
        raise ValueError("use_head=True requires a head=(alpha, beta) array")
    f32_inputs = table.dtype == jnp.float32
    scores = jax.lax.dot_general(
        queries.astype(table.dtype), table,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=(
            jax.lax.Precision.HIGHEST if f32_inputs else jax.lax.Precision.DEFAULT
        ),
    )  # [Qn, N]
    if use_head:
        scores = jax.nn.sigmoid(head[0] * scores + head[1])
    return _top_k_padded(_mask_scores(scores, mask, exclude), None, k)


@functools.partial(jax.jit, static_argnames=("k", "use_head", "probes"))
def _dispatch_topk(
    table,                        # array | QuantizedTable | IVFIndex
    queries: jax.Array,           # [Qn, D] float
    mask,
    exclude,
    head,
    *,
    k: int,
    use_head: bool = False,
    probes: int | None = None,
) -> tuple[jax.Array, jax.Array]:
    """One jitted entry for every retrieval flavor: the table's pytree
    STRUCTURE (plain array, QuantizedTable, or IVFIndex) is static under
    jit, so each flavor compiles to one program — one dispatch per
    request."""
    from anime_recommendations_tpu.ops.ivf import IVFIndex, ivf_topk
    from anime_recommendations_tpu.ops.quantized import QuantizedTable, quantized_topk

    if isinstance(table, IVFIndex):
        return ivf_topk(
            table, queries, k,
            probes=table.n_clusters if probes is None else probes,
            mask=mask, exclude=exclude, head=head, use_head=use_head,
        )
    if isinstance(table, QuantizedTable):
        return quantized_topk(
            table, queries, k, mask=mask, exclude=exclude, head=head,
            use_head=use_head,
        )
    return masked_topk(
        table, queries, k, mask=mask, exclude=exclude, head=head,
        use_head=use_head,
    )


def cosine_topk(
    table_normalized,
    query_rows: jax.Array,
    k: int,
    mask: jax.Array | None = None,
    exclude: jax.Array | None = None,
    **kwargs,
) -> tuple[jax.Array, jax.Array]:
    """Top-k cosine similarity of query rows against a row-normalized table.

    The reference computes np.dot(weights, weights[idx]) + full argsort
    (similar_anime.py:404-408); here the query rows are assumed to be rows
    of the normalized table (or any normalized vectors) and the scan is
    one device program. Accepts a plain array, a QuantizedTable or an
    IVFIndex (``probes=`` then sets the clusters probed).
    """
    if query_rows.ndim == 1:
        query_rows = query_rows[None, :]
    head = kwargs.pop("head", None)
    return _dispatch_topk(
        table_normalized, query_rows, mask, exclude, head, k=k, **kwargs
    )

"""IVF (inverted-file) clustered retrieval for beyond-catalog-scale tables.

The exact scan (ops/topk.py) reads the whole table once per query batch,
so its cost grows linearly with the table: 350K x 128 f32 rows are 179 MB,
4M rows 2 GB, 40M rows 20 GB. Past ~1M rows, serving wants a SUBLINEAR
scan. IVF:
spherical-k-means cluster the L2-normalized rows at build time, store each
cluster's member row ids in a fixed-capacity bucket grid; a query scores
the C centroids (one small matmul), probes its top-p buckets, gathers
just those rows and rescores them EXACTLY. HBM traffic per query drops
from N*D to C*D + (p*cap + spill)*D — 20-60x less at 4M rows — at a
measured recall cost (bench records recall@10 next to every latency key).

Design choices:
  * static shapes end to end: buckets are a dense [C, cap] int32 grid
    padded with -1; rows of clusters that overflow cap go to one shared
    SPILL list that is appended to every query's candidate pool (scanned
    every query, so capacity overflow degrades latency, never recall).
  * the k-means build is jitted Lloyd's with blocked matmul assignment
    (the [N, C] score surface never materializes — rows are assigned in
    chunks under lax.map), centroids renormalized each iteration
    (spherical k-means: rows are L2-normalized, so cosine == dot).
  * probe+gather+rescore is one jitted XLA program per query chunk:
    top-p centroid probe, bucket gather, row gather, batched dot,
    lax.top_k. Queries are chunked (static chunk) to bound the gathered
    [chunk, M, D] intermediate.

This replaces nothing in the reference — its catalog tops out at ~350K
rows (README.md:45) where the exact scan wins and stays the default; IVF
is the scale-out serving path for catalogs beyond ~1M rows. The hot loop
it generalizes is the same one the exact scan replaces:
/root/reference/similar_users/similar_users.py:293-295 (full-table
np.dot + argsort per query).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class IVFIndex(NamedTuple):
    """Clustered index over an L2-row-normalized table.

    centroids : [C, D]  f32, L2-normalized cluster directions
    buckets   : [C, cap] int32 member row ids, -1 padded
    spill     : [S] int32 overflow row ids (-1 padded to a lane multiple;
                appended to every candidate pool — exactness ballast)
    table     : [N, D]  the original rows, used for exact rescore
    q8/scale  : optional int8 rows + per-row de-scale (storage="int8"):
                the candidate gather — the batched query path's dominant
                memory cost — reads 4x fewer bytes; a slim
                top-max(4k, k+8) pool per query is then rescored from the
                exact f32 rows (the ops/quantized.py recipe).
    """

    centroids: jax.Array
    buckets: jax.Array
    spill: jax.Array
    table: jax.Array
    q8: jax.Array | None = None
    scale: jax.Array | None = None

    @property
    def n_clusters(self) -> int:
        return self.buckets.shape[0]

    @property
    def bucket_cap(self) -> int:
        return self.buckets.shape[1]


@functools.partial(jax.jit, static_argnames=("n_clusters", "iters", "chunk"))
def _kmeans(table, init_ids, n_clusters: int, iters: int, chunk: int):
    """Spherical Lloyd's on device. Returns (centroids [C,D], assign [N]).

    Everything is matmuls: assignment is a blocked [chunk, D] @ [D, C]
    argmax (the [N, C] score surface never materializes), and the centroid
    update accumulates per-chunk one-hot.T @ rows partial sums — a second
    matmul — instead of a scatter-add segment_sum.
    """
    n, d = table.shape
    # Centroids live in f32 whatever the table dtype (IVFIndex contract;
    # also keeps the scan carry dtype stable — the update produces f32).
    cent = table[init_ids].astype(jnp.float32)
    # Pad to a chunk multiple with zero rows rather than shrinking chunk
    # (an awkward n could otherwise collapse chunk toward 1 and unroll a
    # multi-million-block scan). Zero rows contribute zero to the sums
    # and the centroid update normalizes by direction, not count, so the
    # padding is inert; assignments are sliced back to n below.
    pad = (-n) % chunk
    padded = jnp.pad(table, ((0, pad), (0, 0))) if pad else table
    blocks = padded.reshape((n + pad) // chunk, chunk, d)
    cids = jnp.arange(n_clusters, dtype=jnp.int32)

    def assign_all(cent):
        def one(block):
            return jnp.argmax(block @ cent.T, axis=1).astype(jnp.int32)

        return jax.lax.map(one, blocks).reshape(n + pad)[:n]

    def body(cent, _):
        def accumulate(carry, block):
            sums, counts = carry
            assign = jnp.argmax(block @ cent.T, axis=1).astype(jnp.int32)
            onehot = (assign[:, None] == cids[None, :]).astype(jnp.float32)
            return (sums + onehot.T @ block, counts + jnp.sum(onehot, axis=0)), None

        (sums, counts), _ = jax.lax.scan(
            accumulate,
            (jnp.zeros((n_clusters, d), jnp.float32),
             jnp.zeros((n_clusters,), jnp.float32)),
            blocks,
        )
        norm = jnp.linalg.norm(sums, axis=1, keepdims=True)
        new = jnp.where(
            (counts[:, None] > 0) & (norm > 1e-12),
            sums / jnp.maximum(norm, 1e-12), cent,
        )
        return new, None

    cent, _ = jax.lax.scan(body, cent, None, length=iters)
    return cent, assign_all(cent)


def build_ivf(
    table,
    n_clusters: int | None = None,
    iters: int = 8,
    seed: int = 0,
    cap_factor: float = 3.0,
    chunk: int = 16_384,
    storage: str = "f32",
) -> IVFIndex:
    """Build an IVF index (offline; one host sync for the bucket layout).

    cap_factor bounds bucket memory at cap = cap_factor * N/C rows
    (rounded up to 8); cluster members beyond cap land in the shared
    spill list, which every query scans — skewed clusterings cost
    latency, never recall of bucketed rows. storage="int8" additionally
    keeps a symmetric per-row int8 copy for the candidate gather (4x less
    gather traffic; candidates are still rescored from the exact rows).
    """
    if storage not in ("f32", "int8"):
        raise ValueError(f"storage must be 'f32' or 'int8', got {storage!r}")
    table = jnp.asarray(table)
    n, d = table.shape
    if n_clusters is None:
        # ~sqrt(N) clusters, power of two, within [64, 8192].
        n_clusters = min(8192, max(64, 1 << int(round(math.log2(max(64, math.isqrt(n)))))))
    n_clusters = min(n_clusters, n)
    rng = np.random.default_rng(seed)
    init_ids = jnp.asarray(
        rng.choice(n, size=n_clusters, replace=False).astype(np.int32)
    )
    chunk = min(chunk, n)
    cent, assign = _kmeans(table, init_ids, n_clusters, iters, chunk)
    assign = np.asarray(assign)

    cap = int(np.ceil(cap_factor * n / n_clusters / 8) * 8)
    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    starts = np.searchsorted(sorted_assign, np.arange(n_clusters))
    ends = np.searchsorted(sorted_assign, np.arange(n_clusters), side="right")
    buckets = np.full((n_clusters, cap), -1, np.int32)
    spill: list[np.ndarray] = []
    for c in range(n_clusters):
        members = order[starts[c]:ends[c]]
        take = min(len(members), cap)
        buckets[c, :take] = members[:take]
        if len(members) > cap:
            spill.append(members[cap:])
    spill_ids = (
        np.concatenate(spill).astype(np.int32) if spill else np.empty(0, np.int32)
    )
    s_pad = int(np.ceil(max(len(spill_ids), 1) / 8) * 8)
    spill_arr = np.full(s_pad, -1, np.int32)
    spill_arr[: len(spill_ids)] = spill_ids
    q8 = scale = None
    if storage == "int8":
        from anime_recommendations_tpu.ops.quantized import quantize_rows

        qt = quantize_rows(table)
        q8, scale = qt.q, qt.scale
    return IVFIndex(
        centroids=cent,
        buckets=jnp.asarray(buckets),
        spill=jnp.asarray(spill_arr),
        table=table,
        q8=q8,
        scale=scale,
    )


def add_rows(index: IVFIndex, new_rows) -> IVFIndex:
    """Append rows WITHOUT re-clustering (production table growth).

    Each new row is assigned to its nearest existing centroid (one
    device matmul) and appended to that bucket — or to the spill list
    when the bucket is full, so additions degrade latency, never recall.
    Centroids are unchanged: retrieval quality for the new rows matches
    a fresh build while additions remain a modest fraction of the table;
    rebuild with build_ivf when the distribution drifts. Row ids of the
    new rows follow the existing table (old ids are stable). Removal is
    the mask: pass a validity mask to ivf_topk / the recommenders rather
    than rebuilding (the whole retrieval stack already mask-composes).
    """
    new_rows = jnp.asarray(new_rows, index.table.dtype)
    if new_rows.ndim == 1:
        new_rows = new_rows[None, :]
    n_old = index.table.shape[0]
    assign = np.asarray(
        jnp.argmax(new_rows @ index.centroids.T, axis=1)
    )
    buckets = np.asarray(index.buckets).copy()
    cap = buckets.shape[1]
    fill = (buckets >= 0).sum(axis=1)
    spill_old = np.asarray(index.spill)
    spill_ids = list(spill_old[spill_old >= 0])
    for i, c in enumerate(assign):
        rid = n_old + i
        if fill[c] < cap:
            buckets[c, fill[c]] = rid
            fill[c] += 1
        else:
            spill_ids.append(np.int32(rid))
    s_pad = int(np.ceil(max(len(spill_ids), 1) / 8) * 8)
    spill_arr = np.full(s_pad, -1, np.int32)
    if spill_ids:
        spill_arr[: len(spill_ids)] = np.asarray(spill_ids, np.int32)
    table = jnp.concatenate([index.table, new_rows])
    q8 = scale = None
    if index.q8 is not None:
        from anime_recommendations_tpu.ops.quantized import quantize_rows

        qt_new = quantize_rows(new_rows)
        q8 = jnp.concatenate([index.q8, qt_new.q])
        scale = jnp.concatenate([index.scale, qt_new.scale])
    return IVFIndex(
        centroids=index.centroids,
        buckets=jnp.asarray(buckets),
        spill=jnp.asarray(spill_arr),
        table=table,
        q8=q8,
        scale=scale,
    )


@functools.partial(
    jax.jit, static_argnames=("k", "probes", "query_chunk", "use_head")
)
def ivf_topk(
    index: IVFIndex,
    queries: jax.Array,
    k: int,
    probes: int = 8,
    mask: jax.Array | None = None,
    exclude: jax.Array | None = None,
    head: jax.Array | None = None,
    use_head: bool = False,
    query_chunk: int = 16,
) -> tuple[jax.Array, jax.Array]:
    """Approximate cosine top-k: probe top-`probes` clusters, rescore exact.

    Same return contract as ops.topk.masked_topk ([Q, k] scores and row
    ids); `mask` is an optional full-vocab [N] bool validity mask (applied
    to gathered candidates), `exclude` optionally drops one row id per
    query (self-match). With ``use_head`` the returned scores are
    sigmoid(alpha*cos + beta) (the folded model head, ops/scoring.py);
    the probe and pool stages order by sign(alpha)*cos so a negative
    slope still probes the right end of the cosine axis. Recall is a
    function of `probes` — the bench records it; probing all C clusters
    is exact by construction (every row is in a bucket or the spill
    list).
    """
    squeeze = queries.ndim == 1
    if squeeze:
        queries = queries[None, :]
    qn, d = queries.shape
    probes = min(probes, index.n_clusters)
    if exclude is None:
        excl = jnp.full((qn,), -1, jnp.int32)
    else:
        excl = jnp.broadcast_to(jnp.asarray(exclude, jnp.int32).reshape(-1), (qn,))
    qc = max(1, min(query_chunk, qn))
    pad = (-qn) % qc
    q_p = jnp.pad(queries, ((0, pad), (0, 0)))
    e_p = jnp.pad(excl, (0, pad), constant_values=-1)
    nb = (qn + pad) // qc
    cap = index.bucket_cap
    spill = index.spill
    # Probe/pool stages order by cosine; with a folded head the final
    # score is sigmoid(alpha*cos + beta), monotone in sign(alpha)*cos, so
    # a negative alpha must probe the OTHER end of the cosine axis.
    if use_head:
        if head is None:
            raise ValueError("use_head=True requires head=(alpha, beta)")
        h = jnp.asarray(head, jnp.float32).reshape(2)
        sgn = jnp.where(h[0] >= 0, 1.0, -1.0)
    else:
        sgn = jnp.float32(1.0)

    def one_chunk(args):
        q, e = args                                     # [qc, D], [qc]
        cs = sgn * (q @ index.centroids.T)              # [qc, C]
        _, pid = jax.lax.top_k(cs, probes)              # [qc, p]
        cand = index.buckets[pid].reshape(qc, probes * cap)
        cand = jnp.concatenate(
            [cand, jnp.broadcast_to(spill, (qc, spill.shape[0]))], axis=1
        )                                               # [qc, M]
        alive = (cand >= 0) & (cand != e[:, None])
        safe = jnp.maximum(cand, 0)
        if mask is not None:
            alive &= jnp.asarray(mask, bool)[safe]
        if index.q8 is not None:
            # int8 stage 1: gather 4x fewer bytes, score with the int8 matmul
            # path (per-row symmetric de-scale, ops/quantized.py noise
            # model), keep a slim top-m pool, rescore it from exact rows.
            q_abs = jnp.maximum(jnp.max(jnp.abs(q), axis=1), 1e-12)
            q_sc = (q_abs / 127.0).astype(jnp.float32)
            q_i8 = jnp.round(q / q_sc[:, None]).astype(jnp.int8)
            rows8 = index.q8[safe]                      # [qc, M, D] int8
            s1 = jnp.einsum(
                "qd,qmd->qm", q_i8, rows8, preferred_element_type=jnp.int32
            ).astype(jnp.float32)
            s1 = s1 * q_sc[:, None] * index.scale[safe] * sgn
            s1 = jnp.where(alive, s1, -jnp.inf)
            m_pool = min(max(4 * k, k + 8), s1.shape[1])
            _, loc1 = jax.lax.top_k(s1, m_pool)
            cand = jnp.take_along_axis(cand, loc1, axis=1)   # [qc, m]
            alive = jnp.take_along_axis(alive, loc1, axis=1)
            safe = jnp.maximum(cand, 0)
        rows = index.table[safe]                        # [qc, M|m, D]
        scores = jnp.einsum(
            "qd,qmd->qm", q, rows, preferred_element_type=jnp.float32
        )
        if use_head:
            scores = jax.nn.sigmoid(h[0] * scores + h[1])
        scores = jnp.where(alive, scores, -jnp.inf)
        if scores.shape[1] < k:  # pool smaller than k: pad dead slots
            short = k - scores.shape[1]
            scores = jnp.pad(scores, ((0, 0), (0, short)),
                             constant_values=-jnp.inf)
            cand = jnp.pad(cand, ((0, 0), (0, short)), constant_values=-1)
        vals, loc = jax.lax.top_k(scores, k)
        ids = jnp.take_along_axis(cand, loc, axis=1)
        ids = jnp.where(jnp.isfinite(vals), ids, -1)
        return vals, ids

    vals, ids = jax.lax.map(
        one_chunk, (q_p.reshape(nb, qc, d), e_p.reshape(nb, qc))
    )
    vals = vals.reshape(nb * qc, k)[:qn]
    ids = ids.reshape(nb * qc, k)[:qn]
    if squeeze:
        return vals[0], ids[0]
    return vals, ids

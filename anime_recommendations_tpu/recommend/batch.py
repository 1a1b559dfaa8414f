"""Batched retrieval entry points (production serving path).

The per-request functions (similar_anime/model_recs/...) each dispatch one
top-k program per query for reference-parity ergonomics. These batched
variants amortize: MANY queries ride ONE top-k call (one matmul reads the
table once for all of them), then one vectorized metadata join.
"""

from __future__ import annotations

import numpy as np

from anime_recommendations_tpu.ops.scoring import score_topk
from anime_recommendations_tpu.ops.topk import cosine_topk
from anime_recommendations_tpu.recommend.context import RecContext


def similar_anime_batch(
    ctx: RecContext,
    names: list,
    count: int = 10,
    types: list[str] | None = None,
    genres: list | None = None,
) -> list[dict]:
    """Similar-anime for many queries in one top-k call.

    Returns one record per query: {"query", "anime_ids", "names",
    "similarities"}. Unknown names raise KeyError (same as the scalar
    path).
    """
    ids = [ctx.catalog.resolve_query(n) for n in names]
    q_idx = np.asarray([ctx.anime_index(a) for a in ids], np.int32)

    mask = ctx.in_catalog_mask()
    if types is not None:
        mask &= ctx.type_mask(types)
    if genres is not None:
        mask &= ctx.genre_mask(genres)

    vals, idx = cosine_topk(
        ctx.anime_table(),
        ctx.anime_norm[q_idx],
        k=min(count, ctx.vocab.n_anime),
        mask=np.asarray(mask),
        exclude=q_idx,
        **ctx.topk_kwargs,
    )
    vals = np.asarray(vals)
    idx = np.asarray(idx)
    out = []
    for row, (name, aid) in enumerate(zip(names, ids)):
        keep = vals[row] > -1e29
        anime_ids = ctx.vocab.anime_ids[idx[row][keep]]
        rows = ctx.catalog.rows_for_ids(anime_ids)
        out.append(
            {
                "query": name,
                "anime_ids": rows["anime_id"].tolist(),
                "names": rows["Name"].tolist(),
                "similarities": vals[row][keep][: len(rows)].tolist(),
            }
        )
    return out


def model_recs_batch(
    ctx: RecContext,
    user_ids: list[int],
    n_recs: int = 10,
    types: list[str] | None = None,
    genres: list | None = None,
) -> list[dict]:
    """Model-predicted top-n for many users in one top-k call per shared
    filter set. Each user still gets an individual watched-set mask; users
    are grouped so the shared row mask holds the common filters
    and per-user exclusion happens by post-masking candidate overlap.

    For exactness with per-user watched sets, the top-k call asks for
    ``n_recs + max_watched_overlap`` candidates and drops watched ones; if
    a user has watched more than the candidate buffer allows, their result
    may be shorter (guarded below by a generous buffer).
    """
    user_idx = np.asarray([ctx.user_index(u) for u in user_ids], np.int32)
    shared = ctx.in_catalog_mask()
    if types is not None:
        shared &= ctx.type_mask(types)
    if genres is not None:
        shared &= ctx.genre_mask(genres)

    watched_masks = [ctx.watched_mask(int(u)) for u in user_ids]
    buffer = max(int(m.sum()) for m in watched_masks) if watched_masks else 0
    k = min(n_recs + buffer, ctx.vocab.n_anime)

    vals, idx = score_topk(
        ctx.anime_table(),
        ctx.user_norm[user_idx],
        ctx.head,
        k=k,
        mask=np.asarray(shared),
        **ctx.topk_kwargs,
    )
    vals = np.asarray(vals)
    idx = np.asarray(idx)
    out = []
    for row, uid in enumerate(user_ids):
        watched = watched_masks[row]
        keep = (vals[row] > -1e29) & ~watched[np.clip(idx[row], 0, None)]
        sel = idx[row][keep][:n_recs]
        anime_ids = ctx.vocab.anime_ids[sel]
        rows = ctx.catalog.rows_for_ids(anime_ids)
        out.append(
            {
                "user_id": int(uid),
                "anime_ids": rows["anime_id"].tolist(),
                "names": rows["Name"].tolist(),
                "predictions": vals[row][keep][: len(rows)].tolist(),
            }
        )
    return out


def similar_users_batch(
    ctx: RecContext,
    user_ids: list[int],
    n_users: int = 10,
    num_faves: int = 2,
    TV_only: bool = True,
    include_faves: bool = True,
) -> list[dict]:
    """Similar-users for many query users in one top-k call.

    One cosine scan over the user table for ALL queries (per-query
    self-exclusion as a mask), then the vectorized favorite-anime
    summaries (similar_users.get_fave_anime) per result row.
    ``include_faves=False`` skips the favorites strings for id-only
    workloads. Returns one record per query: {"query", "similar_users",
    "similarities"[, "favorite_animes"]}. Unknown users raise KeyError
    (same as the scalar path).
    """
    from anime_recommendations_tpu.recommend.similar_users import get_fave_anime

    q_idx = np.asarray([ctx.user_index(int(u)) for u in user_ids], np.int32)
    vals, idx = cosine_topk(
        ctx.user_table(),
        ctx.user_norm[q_idx],
        k=min(n_users, ctx.vocab.n_users),
        exclude=q_idx,
        **ctx.topk_kwargs,
    )
    vals = np.asarray(vals)
    idx = np.asarray(idx)
    out = []
    for row, uid in enumerate(user_ids):
        keep = vals[row] > -1e29
        sim_ids = ctx.vocab.user_ids[idx[row][keep]]
        rec = {
            "query": int(uid),
            "similar_users": [int(s) for s in sim_ids],
            "similarities": vals[row][keep].tolist(),
        }
        if include_faves:
            rec["favorite_animes"] = [
                get_fave_anime(ctx, int(s), num_faves, TV_only)
                for s in sim_ids
            ]
        out.append(rec)
    return out

"""Similar-users retrieval.

Behavior parity with /root/reference/similar_users/similar_users.py
find_similar_users (:262-314) + get_fave_anime (:203-256), with the cosine
scan running as one masked top-k program (self-exclusion as a mask
instead of post-filtering) and favorite-anime selection vectorized.

Note: the reference's go() crashes as written (get_weights() called with no
model, similar_users.py:322, recorded in SURVEY.md); this implements the
intended behavior.

Output schema matches figure_file/User_153695_similar_users.csv:
similar_users, similarity, favorite_animes — sorted by similarity desc.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from anime_recommendations_tpu.ops.topk import cosine_topk
from anime_recommendations_tpu.recommend.context import RecContext

OUTPUT_COLUMNS = ["similar_users", "similarity", "favorite_animes"]


def similar_users(
    ctx: RecContext,
    user_id: int,
    n_users: int = 10,
    num_faves: int = 2,
    TV_only: bool = True,
) -> tuple[pd.DataFrame, str, int]:
    """Top-``n_users`` most similar users plus their favorite anime.

    Returns (frame, csv_filename, user_id) like find_similar_users.
    """
    filename = f"User_{user_id}.csv"
    query_index = ctx.user_index(user_id)

    vals, idx = cosine_topk(
        ctx.user_table(),
        ctx.user_norm[query_index],
        k=min(n_users, ctx.vocab.n_users),
        exclude=np.asarray([query_index], np.int32),
        **ctx.topk_kwargs,
    )
    vals = np.asarray(vals)[0]
    idx = np.asarray(idx)[0]
    keep = vals > -1e29
    vals, idx = vals[keep], idx[keep]

    similar_ids = ctx.vocab.user_ids[idx]
    frame = pd.DataFrame(
        {
            "similar_users": similar_ids,
            "similarity": vals,
            "favorite_animes": [
                get_fave_anime(ctx, int(uid), num_faves, TV_only)
                for uid in similar_ids
            ],
        }
    )
    return frame.reset_index(drop=True), filename, user_id


def get_fave_anime(
    ctx: RecContext, user_id: int, num_faves: int, TV_only: bool
) -> str:
    """A user's favorite anime as a bracket-stripped list string.

    Reference rules (similar_users.py:203-256): take the max-rated anime;
    when watched_episodes data exists, keep only rows with the highest
    percent-of-episodes-watched; if TV_only, order by episode count
    descending; return the first ``num_faves`` names via str(list)[1:-1].
    Anime absent from the catalog are skipped (the reference would crash).
    """
    r, aid, _ = ctx.user_rating_arrays(user_id)
    if r.size == 0:
        return ""
    at_max = r == r.max()
    fave_ids = aid[at_max]
    # Catalog rows for the max-rated anime via the precomputed position
    # index (this runs once PER similar user per cold /similar_users scan —
    # the pandas get_group + rows_for_ids version dominated that latency).
    pos, src = ctx.catalog.positions_for_ids_ordered(fave_ids)
    if len(pos) == 0:
        return ""
    names = ctx.catalog.column_arrays["Name"][pos]
    episodes = ctx.catalog.episodes_numeric[pos]

    watched = ctx.user_watched_episodes(user_id)
    if watched is not None:
        percent = watched[at_max][src] / episodes
        pmax = np.nanmax(percent) if np.any(~np.isnan(percent)) else np.nan
        if not np.isnan(pmax):
            keep = percent == pmax
            names, episodes = names[keep], episodes[keep]
    if TV_only:
        names = names[_pandas_desc_order(episodes)]
    all_faves = list(names)
    return str(all_faves[:num_faves])[1:-1]


def _pandas_desc_order(values: np.ndarray) -> np.ndarray:
    """Index order of pandas sort_values(ascending=False, kind='quicksort',
    na_position='last') — the reference's episode-count tie-break sort —
    replicated step for step (reverse, ascending quicksort, reverse, NaNs
    appended) so tie behavior matches the frame-based implementation."""
    idx = np.arange(len(values))
    nan = np.isnan(values)
    non_nans = values[~nan][::-1]
    non_nan_idx = idx[~nan][::-1]
    order = non_nan_idx[non_nans.argsort(kind="quicksort")][::-1]
    return np.concatenate([order, idx[nan]])

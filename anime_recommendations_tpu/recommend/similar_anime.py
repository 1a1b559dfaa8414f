"""Similar-anime retrieval.

Behavior parity with /root/reference/similar_anime/similar_anime.py
anime_recs (:364-471), re-architected for the device: the full-scores
np.dot + argsort + O(N) Python enrichment loop becomes one masked top-k
program with type/genre/self filters applied as row masks, followed by a
single vectorized metadata join.

Output schema matches figure_file/anime_similar_to_SilentMöbius.csv:
Name, Similarity, Genres, Sypnopsis, Episodes, Japanese name, Studios,
Premiered, Score, Type, Source, Rating — sorted by Similarity descending.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from anime_recommendations_tpu.ops.topk import cosine_topk
from anime_recommendations_tpu.recommend.context import RecContext
from anime_recommendations_tpu.utils.text import clean_name

OUTPUT_COLUMNS = [
    "Name", "Similarity", "Genres", "Sypnopsis", "Episodes", "Japanese name",
    "Studios", "Premiered", "Score", "Type", "Source", "Rating",
]


def similar_anime(
    ctx: RecContext,
    name: str,
    count: int = 10,
    types: list[str] | None = None,
    genres: list | None = None,
) -> tuple[pd.DataFrame, str, str]:
    """Top-``count`` anime most similar to ``name`` by embedding cosine.

    ``types``/``genres`` of None disable that filter (spec_types /
    an_spec_genres False in the reference).
    Returns (frame, csv_filename, cleaned_name) like anime_recs.
    """
    translated = clean_name(name)
    filename = translated + ".csv"

    anime_id = ctx.catalog.resolve_query(name)
    query_index = ctx.anime_index(anime_id)

    mask = ctx.in_catalog_mask()
    if types is not None:
        mask &= ctx.type_mask(types)
    if genres is not None:
        mask &= ctx.genre_mask(genres)

    vals, idx = cosine_topk(
        ctx.anime_table(),
        ctx.anime_norm[query_index],
        k=min(count, ctx.vocab.n_anime),
        mask=np.asarray(mask),
        exclude=np.asarray([query_index], np.int32),
        **ctx.topk_kwargs,
    )
    vals = np.asarray(vals)[0]
    idx = np.asarray(idx)[0]
    keep = vals > -1e29  # fewer valid rows than k -> trim sentinels
    vals, idx = vals[keep], idx[keep]

    anime_ids = ctx.vocab.anime_ids[idx]
    frame = enrich_anime_rows(
        ctx, anime_ids, extra={"Similarity": vals}, columns=OUTPUT_COLUMNS
    )
    return frame, filename, translated


_DEFAULT_ENRICH_COLUMNS = [
    "anime_id", "Name", "Genres", "Sypnopsis", "Episodes", "Japanese name",
    "Studios", "Premiered", "Score", "Type", "Source", "Rating",
]
_COLUMN_SOURCES = {"Japanese name": "japanese_name"}


def enrich_anime_rows(
    ctx: RecContext,
    anime_ids: np.ndarray,
    extra: dict[str, np.ndarray],
    columns: list[str] | None = None,
) -> pd.DataFrame:
    """Vectorized metadata + synopsis join, replacing the reference's
    per-anime pandas row extraction loop (similar_anime.py:413-455): k
    gathers from the catalog's cached column arrays, no pandas row lookups.
    ``extra`` columns are per-input-id and get aligned to the produced rows
    (ids absent from the catalog drop their extra values too). ``columns``
    fixes the output column order directly (extra names included), saving
    the caller a frame reindex copy."""
    pos, src = ctx.catalog.positions_for_ids_ordered(anime_ids)
    cols = ctx.catalog.column_arrays
    aid = cols["anime_id"][pos]
    if columns is None:
        columns = _DEFAULT_ENRICH_COLUMNS + list(extra)
    data = {}
    for c in columns:
        if c in extra:
            data[c] = np.asarray(extra[c])[src]
        elif c == "Sypnopsis":
            data[c] = [ctx.catalog.synopsis_of(int(a)) for a in aid]
        elif c == "anime_id":
            data[c] = aid
        else:
            data[c] = cols[_COLUMN_SOURCES.get(c, c)][pos]
    return pd.DataFrame(data)

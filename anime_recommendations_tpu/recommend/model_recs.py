"""Model-based recommendations (batched rating prediction over unwatched).

Behavior parity with /root/reference/model_recs/model_recs.py
recommendations (:373-456) + get_unwatched (:132-156): predicted rating of
every anime the user hasn't rated (intersected with the trained vocab),
ranked descending, optionally restricted by type/genre.

The reference builds a [|unwatched|, 2] host array and calls
model.predict; here the unwatched set is a row MASK over the anime table
and the whole predict-all + mask + top-n runs as one device program
(ops/scoring.score_topk) with the Dense+BatchNorm+sigmoid head folded to
an affine-sigmoid inside it.

Output schema matches figure_file/User_ID_153695_model_recs.csv:
Name, Prediction, Genres, Source, anime_id, Sypnopsis, Episodes,
Japanese name, Studios, Premiered, Score, Type. (The reference's
specify_types=False branch emits a misspelled "Prediciton_rating" column
and then crashes sorting on "Prediction" — model_recs.py:441 vs :451; this
implementation always emits "Prediction".)
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from anime_recommendations_tpu.ops.scoring import score_topk
from anime_recommendations_tpu.recommend.context import RecContext

OUTPUT_COLUMNS = [
    "Name", "Prediction", "Genres", "Source", "anime_id", "Sypnopsis",
    "Episodes", "Japanese name", "Studios", "Premiered", "Score", "Type",
]


def model_recs(
    ctx: RecContext,
    user_id: int,
    n_recs: int = 10,
    types: list[str] | None = None,
    genres: list | None = None,
    min_score: float | None = None,
    max_score: float | None = None,
) -> tuple[pd.DataFrame, str]:
    """Top-``n_recs`` unwatched anime by predicted rating for ``user_id``.

    ``min_score``/``max_score`` bound the catalog Score column (declared in
    the reference config at model_recs:164-165 but never applied there;
    honored here when provided).
    Returns (frame, csv_filename).
    """
    filename = f"User_ID_{user_id}_model_recs.csv"
    user_index = ctx.user_index(user_id)

    mask = ctx.in_catalog_mask() & ~ctx.watched_mask(user_id)
    if types is not None:
        mask &= ctx.type_mask(types)
    if genres is not None:
        mask &= ctx.genre_mask(genres)
    if min_score is not None or max_score is not None:
        score = pd.to_numeric(
            ctx.vocab_meta()["Score"], errors="coerce"
        ).to_numpy(np.float64)
        if min_score is not None:
            mask &= score >= float(min_score)
        if max_score is not None:
            mask &= score <= float(max_score)

    vals, idx = score_topk(
        ctx.anime_table(),
        ctx.user_norm[user_index],
        ctx.head,
        k=min(n_recs, ctx.vocab.n_anime),
        mask=np.asarray(mask),
        **ctx.topk_kwargs,
    )
    vals = np.asarray(vals)[0]
    idx = np.asarray(idx)[0]
    keep = vals > -1e29
    vals, idx = vals[keep], idx[keep]

    anime_ids = ctx.vocab.anime_ids[idx]
    pos, src = ctx.catalog.positions_for_ids_ordered(anime_ids)
    cols = ctx.catalog.column_arrays
    aid = cols["anime_id"][pos]
    frame = pd.DataFrame(
        {
            "Name": cols["Name"][pos],
            "Prediction": vals[src],
            "Genres": cols["Genres"][pos],
            "Source": cols["Source"][pos],
            "anime_id": aid,
            "Sypnopsis": [ctx.catalog.synopsis_of(int(a)) for a in aid],
            "Episodes": cols["Episodes"][pos],
            "Japanese name": cols["japanese_name"][pos],
            "Studios": cols["Studios"][pos],
            "Premiered": cols["Premiered"][pos],
            "Score": cols["Score"][pos],
            "Type": cols["Type"][pos],
        }
    )
    return frame[OUTPUT_COLUMNS].reset_index(drop=True), filename

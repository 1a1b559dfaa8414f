"""Shared retrieval context.

Replaces the reference's per-step re-downloading and re-deriving of the
model, weights, vocab, rating frame, anime frame and synopses (every one of
similar_anime/similar_users/user_prefs/user_recs/model_recs reloads all of
them from W&B — e.g. similar_anime.py:376-379): one object holds the
normalized embedding tables on device, the canonical vocab, the
preprocessed rating frame, and the catalog, and every recommender reads
from it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd

from anime_recommendations_tpu.data.catalog import Catalog
from anime_recommendations_tpu.data.vocab import Vocab
from anime_recommendations_tpu.models.two_tower import (
    BNState,
    TwoTowerParams,
    normalized_tables,
)
from anime_recommendations_tpu.ops.scoring import head_affine


@dataclass
class RecContext:
    vocab: Vocab
    catalog: Catalog
    ratings: pd.DataFrame          # preprocessed + encoded: user, anime, rating, user_id, anime_id
    anime_norm: jax.Array          # [n_anime, D] L2-normalized rows, on device
    user_norm: jax.Array           # [n_users, D]
    head: jax.Array                # [2] (alpha, beta) folded eval-mode head
    # int8 two-stage retrieval companions (ops/quantized.py); None = dense.
    anime_qt: object = None
    user_qt: object = None
    # Scan handles (what anime_table()/user_table() return): a plain array,
    # a QuantizedTable, or an IVFIndex.
    anime_scan: object = None
    user_scan: object = None
    # Extra kwargs merged into every cosine_topk/score_topk call the
    # recommenders make ({"probes": n} on an IVF context).
    topk_kwargs: dict = field(default_factory=dict)
    _by_user: "pd.core.groupby.DataFrameGroupBy" = field(default=None, repr=False)
    _vocab_anime_meta: pd.DataFrame = field(default=None, repr=False)

    def __post_init__(self):
        self._by_user = self.ratings.groupby("user_id")
        # Catalog metadata aligned to vocab rows (NaN rows for anime that are
        # trained but absent from the catalog).
        meta = self.catalog.anime.set_index("anime_id", drop=False)
        self._vocab_anime_meta = meta.reindex(self.vocab.anime_ids)

    # ---- constructors ---------------------------------------------------------

    @classmethod
    def build(
        cls,
        params: TwoTowerParams,
        bn_state: BNState,
        vocab: Vocab,
        catalog: Catalog,
        ratings: pd.DataFrame,
        retrieval_dtype=None,
        device=None,
        ann: str = "off",
        ann_probes: int = 16,
    ) -> "RecContext":
        """Retrieval numerics: None/"f32" = exact-oracle scans;
        "bf16"/jnp.bfloat16 halves scan HBM traffic at ~1e-3 score error;
        "int8" stores tables quantized (4x less scan traffic) and rescores
        a candidate pool in exact f32 (ops/quantized.py) — final scores and
        near-always the exact top-k match f32.

        ``ann="ivf"`` swaps the scan handles for IVF cluster indexes
        (ops/ivf.py): queries probe the top-``ann_probes`` clusters and
        exact-rescore just those rows — the sublinear serving path for
        catalogs beyond ~1M rows, where even the int8 full scan exceeds
        the latency budget. Approximate (recall set by ann_probes); the
        default exact scans remain right for reference-scale tables.
        """
        from anime_recommendations_tpu.ops.quantized import quantize_rows

        anime_norm, user_norm = normalized_tables(params)
        int8 = retrieval_dtype in ("int8", "i8")
        if retrieval_dtype in ("bf16", "bfloat16"):
            import jax.numpy as jnp

            anime_norm = anime_norm.astype(jnp.bfloat16)
            user_norm = user_norm.astype(jnp.bfloat16)
        elif not int8 and retrieval_dtype not in (None, "f32", "float32"):
            import numpy as _np

            try:
                _np.dtype(retrieval_dtype)
            except TypeError:
                raise ValueError(
                    f"unknown retrieval_dtype {retrieval_dtype!r}: choose "
                    "'f32' (exact), 'bf16' (2x less scan traffic), or "
                    "'int8' (4x, exact-rescored)"
                ) from None
            anime_norm = anime_norm.astype(retrieval_dtype)
            user_norm = user_norm.astype(retrieval_dtype)

        def put(x):
            return jax.device_put(x, device) if device is not None else (
                jax.device_put(x)
            )

        if ann not in ("off", "ivf"):
            raise ValueError(f"ann must be 'off' or 'ivf', got {ann!r}")

        def scan_handle(norm, seed):
            """(scan_handle, quantized_inner_or_None) for one table."""
            if ann == "ivf":
                from anime_recommendations_tpu.ops.ivf import build_ivf

                # int8 storage reuses the quantized recipe.
                index = build_ivf(
                    norm, seed=seed,
                    storage="int8" if int8 else "f32",
                )
                return index, None
            if int8:
                qt = put(quantize_rows(norm))
                return qt, qt
            return norm, None

        anime_scan, anime_qt = scan_handle(anime_norm, seed=11)
        user_scan, user_qt = scan_handle(user_norm, seed=13)
        topk_kwargs = {"probes": ann_probes} if ann == "ivf" else {}

        return cls(
            vocab=vocab,
            catalog=catalog,
            ratings=ratings,
            anime_norm=put(anime_norm),
            user_norm=put(user_norm),
            head=put(head_affine(params, bn_state)),
            anime_qt=anime_qt,
            user_qt=user_qt,
            anime_scan=put(anime_scan),
            user_scan=put(user_scan),
            topk_kwargs=topk_kwargs,
        )

    # ---- retrieval-table accessors (array / QuantizedTable / IVFIndex) ----

    def anime_table(self):
        """The anime table to hand to cosine_topk/score_topk."""
        if self.anime_scan is not None:
            return self.anime_scan
        return self.anime_qt if self.anime_qt is not None else self.anime_norm

    def user_table(self):
        if self.user_scan is not None:
            return self.user_scan
        return self.user_qt if self.user_qt is not None else self.user_norm

    # ---- per-user views -------------------------------------------------------

    def user_rows(self, user_id: int) -> pd.DataFrame:
        """All rating rows of one user (reference df[df.user_id == user])."""
        try:
            return self._by_user.get_group(user_id)
        except KeyError:
            return self.ratings.iloc[0:0]

    @cached_property
    def _user_csr(self):
        """Per-user rating slices as flat arrays sorted by user_id:
        (uid_sorted, rating, anime_id, anime_vocab_idx). Two searchsorteds
        replace a pandas groupby get_group + column extraction on the serve
        hot path (the frames are immutable for the context's lifetime)."""
        uid = np.asarray(self.ratings["user_id"].to_numpy(), dtype=np.int64)
        order = np.argsort(uid, kind="stable")
        we = None
        if "watched_episodes" in self.ratings.columns:
            we = self.ratings["watched_episodes"].to_numpy()[order]
        return (
            uid[order],
            self.ratings["rating"].to_numpy()[order].astype(np.float64),
            np.asarray(self.ratings["anime_id"].to_numpy(), np.int64)[order],
            np.asarray(self.ratings["anime"].to_numpy(), np.int64)[order],
            we,
        )

    def _user_slice(self, user_id: int) -> slice:
        uid_sorted = self._user_csr[0]
        lo = np.searchsorted(uid_sorted, user_id, "left")
        hi = np.searchsorted(uid_sorted, user_id, "right")
        return slice(lo, hi)

    def user_rating_arrays(self, user_id: int):
        """(ratings, anime_ids, anime_vocab_idx) of one user — numpy views,
        original row order within the user preserved (stable sort)."""
        _, r, aid, aenc, _ = self._user_csr
        s = self._user_slice(user_id)
        return r[s], aid[s], aenc[s]

    def user_watched_episodes(self, user_id: int):
        """watched_episodes of one user's rating rows (aligned with
        user_rating_arrays), or None when the frame lacks the column."""
        we = self._user_csr[4]
        return None if we is None else we[self._user_slice(user_id)]

    def favorite_positions(self, user_id: int, percentile: float) -> np.ndarray:
        """Catalog row positions of the user's >= percentile-rated anime,
        in catalog order — the vectorized core of fave_rows (reference
        fave_genres/fave_sources, user_prefs.py:222-261)."""
        r, aid, _ = self.user_rating_arrays(user_id)
        if r.size == 0:
            return np.empty(0, np.int64)
        cut = np.percentile(r, float(percentile))
        return self.catalog.positions_for_ids(aid[r >= cut])

    def random_user(self, rng: np.random.Generator | None = None) -> int:
        rng = rng or np.random.default_rng()
        return int(self.vocab.user_ids[rng.integers(len(self.vocab.user_ids))])

    def random_anime_name(self, rng: np.random.Generator | None = None) -> str:
        rng = rng or np.random.default_rng()
        names = self.catalog.anime["Name"].unique()
        return str(names[rng.integers(len(names))])

    # ---- masks over vocab rows ------------------------------------------------

    def vocab_meta(self) -> pd.DataFrame:
        """Catalog metadata frame aligned to anime-vocab row order."""
        return self._vocab_anime_meta

    @cached_property
    def _in_catalog(self) -> np.ndarray:
        return np.array(self._vocab_anime_meta["anime_id"].notna().to_numpy())

    def in_catalog_mask(self) -> np.ndarray:
        """Vocab rows whose anime exists in the catalog (the reference would
        crash on these during enrichment; we mask them out). Returns a
        fresh copy — callers &= filters into it."""
        return self._in_catalog.copy()

    def type_mask(self, types: list[str]) -> np.ndarray:
        """Vocab-row mask for catalog Type membership."""
        catalog_mask = np.array(self.catalog.type_mask(list(types)))
        return self._catalog_mask_to_vocab(catalog_mask)

    def genre_mask(self, genres: list) -> np.ndarray:
        """Vocab-row mask for the 3-genre restriction."""
        catalog_mask = self.catalog.genre_mask(list(genres))
        return self._catalog_mask_to_vocab(catalog_mask)

    def watched_mask(self, user_id: int) -> np.ndarray:
        """Vocab rows the user has rated."""
        watched = np.zeros(self.vocab.n_anime, dtype=bool)
        _, _, idx = self.user_rating_arrays(user_id)
        watched[idx[idx >= 0]] = True
        return watched

    def _catalog_mask_to_vocab(self, catalog_mask: np.ndarray) -> np.ndarray:
        ids_ok = set(self.catalog.anime.loc[catalog_mask, "anime_id"].tolist())
        return np.fromiter(
            (int(a) in ids_ok for a in self.vocab.anime_ids),
            dtype=bool,
            count=self.vocab.n_anime,
        )

    # ---- encoded indices ------------------------------------------------------

    def user_index(self, user_id: int) -> int:
        idx = int(self.vocab.encode_users(np.asarray([user_id]))[0])
        if idx < 0:
            raise KeyError(f"User {user_id} not in training vocab")
        return idx

    def anime_index(self, anime_id: int) -> int:
        idx = int(self.vocab.encode_anime(np.asarray([anime_id]))[0])
        if idx < 0:
            raise KeyError(f"Anime {anime_id} not in training vocab")
        return idx

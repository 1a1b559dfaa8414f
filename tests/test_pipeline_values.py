"""Pipeline-level VALUE parity against independent numpy oracles.

The golden/schema tests (test_goldens.py, test_pipeline.py) pin column
contracts; these tests pin the NUMBERS. Each oracle recomputes a
recommender's output from the run's stored artifacts alone (the npz model
weights + vocab + data frames) using plain numpy/pandas — none of the
package's kernels, contexts, or recommenders — and compares values in the
emitted CSVs. Semantics under test:

  similar_anime — L2-normalize the anime table, cosine vs the query row,
                  argsort, drop self, top-k
                  (/root/reference/similar_anime/similar_anime.py:404-408)
  similar_users — same over the user table, drop self
                  (/root/reference/similar_users/similar_users.py:293-303)
  model_recs    — two-tower forward (cosine -> scalar dense -> inference
                  BatchNorm -> sigmoid) over every unwatched vocab anime,
                  rank by prediction
                  (/root/reference/model_recs/model_recs.py:373-396)
"""

import json

import numpy as np
import pandas as pd
import pytest

from tests.test_pipeline import finished_run  # noqa: F401  (module fixture)

BN_EPS = 1e-3  # Keras BatchNorm default, models/two_tower.py KERAS_BN_EPS


@pytest.fixture(scope="module")
def run_artifacts(finished_run):  # noqa: F811
    store = finished_run.store
    model_dir = store.get("anime_nn_model.npz:latest")
    with np.load(model_dir.file("anime_nn_model.npz")) as z:
        weights = {k: np.asarray(z[k], np.float64) for k in z.files}
    vocab = json.loads(model_dir.file("vocab.json").read_text())
    anime_ids = np.asarray(vocab["anime_ids"], np.int64)
    user_ids = np.asarray(vocab["user_ids"], np.int64)
    catalog = pd.read_csv(store.get("all_anime.csv:latest").file())
    stats = pd.read_pickle(store.get("preprocessed_stats.pkl:latest").file())
    return store, weights, user_ids, anime_ids, catalog, stats


def _norm_rows(t: np.ndarray) -> np.ndarray:
    return t / np.linalg.norm(t, axis=1, keepdims=True)


def test_similar_anime_values_match_numpy_oracle(finished_run, run_artifacts):  # noqa: F811
    store, w, _, anime_ids, catalog, _ = run_artifacts
    # Locate the query-named artifact via its logged metadata.
    arts = [
        store.get(f"{name}:latest")
        for name in store.names()
        if store.get(f"{name}:latest").metadata.get("Queried anime")
    ]
    assert len(arts) == 1
    art = arts[0]
    got = pd.read_csv(art.file())
    query_name = art.metadata["Queried anime"]

    # Independent oracle: resolve the query through the catalog only.
    q_id = int(catalog.loc[catalog["Name"] == query_name, "MAL_ID"].iloc[0])
    q_idx = int(np.flatnonzero(anime_ids == q_id)[0])
    nt = _norm_rows(w["anime_emb"])
    scores = nt @ nt[q_idx]
    scores[q_idx] = -np.inf
    k = len(got)
    top = np.argsort(-scores)[:k]

    # Same ids in the same order (strict: scores at this scale are distinct)
    want_ids = anime_ids[top]
    id_by_name = catalog.set_index("Name")["MAL_ID"]
    got_ids = got["Name"].map(id_by_name).to_numpy()
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(
        got["Similarity"].to_numpy(), scores[top], rtol=1e-5, atol=1e-6
    )


def test_similar_users_values_match_numpy_oracle(finished_run, run_artifacts):  # noqa: F811
    store, w, user_ids, _, _, _ = run_artifacts
    got = pd.read_csv(store.get("similar_users.csv:latest").file())
    uid = int(store.get("similar_users.csv:latest").metadata["Queried user"])

    q_idx = int(np.flatnonzero(user_ids == uid)[0])
    nt = _norm_rows(w["user_emb"])
    scores = nt @ nt[q_idx]
    scores[q_idx] = -np.inf
    top = np.argsort(-scores)[: len(got)]

    np.testing.assert_array_equal(
        got["similar_users"].to_numpy(), user_ids[top]
    )
    np.testing.assert_allclose(
        got["similarity"].to_numpy(), scores[top], rtol=1e-5, atol=1e-6
    )


def _oracle_predict(w, u_idx: int, a_idx: np.ndarray) -> np.ndarray:
    """Numpy re-derivation of models/two_tower.forward at inference."""
    u = w["user_emb"][u_idx]
    a = w["anime_emb"][a_idx]
    cos = (a @ u) / (np.linalg.norm(a, axis=1) * np.linalg.norm(u))
    z = w["dense_w"] * cos + w["dense_b"]
    z_hat = (z - w["moving_mean"]) / np.sqrt(w["moving_var"] + BN_EPS)
    out = w["bn_gamma"] * z_hat + w["bn_beta"]
    return 1.0 / (1.0 + np.exp(-out))


def test_model_recs_values_match_numpy_oracle(finished_run, run_artifacts):  # noqa: F811
    store, w, user_ids, anime_ids, _, stats = run_artifacts
    got = pd.read_csv(store.get("model_recs.csv:latest").file())
    uid = int(store.get("model_recs.csv:latest").metadata["Queried user"])
    u_idx = int(np.flatnonzero(user_ids == uid)[0])

    watched = set(stats.loc[stats["user_id"] == uid, "anime_id"].tolist())
    unwatched_rows = np.flatnonzero(
        ~np.isin(anime_ids, np.fromiter(watched, np.int64, len(watched)))
    )
    preds = _oracle_predict(w, u_idx, unwatched_rows)

    # Every listed prediction must match the oracle's forward for that id...
    got_rows = np.asarray(
        [int(np.flatnonzero(anime_ids == i)[0]) for i in got["anime_id"]]
    )
    np.testing.assert_allclose(
        got["Prediction"].to_numpy(),
        _oracle_predict(w, u_idx, got_rows),
        rtol=1e-5, atol=1e-6,
    )
    # ...come only from the unwatched set, and BE the top-k of it.
    assert set(got_rows).issubset(set(unwatched_rows.tolist()))
    want = unwatched_rows[np.argsort(-preds)[: len(got)]]
    assert set(got_rows) == set(want.tolist())

"""IVF clustered retrieval (ops/ivf.py): recall, exactness, spill, shapes.

The IVF path serves catalogs beyond the exact scan's latency budget;
these tests pin its contracts on CPU: probe-all is
exact by construction, clustered data gives high recall at small probe
counts, bucket overflow spills (never drops) rows, the query-chunk
padding never leaks into results, and an ann="ivf" RecContext at
probe-all reproduces the exact context's recommendations through every
recommender (incl. the folded-head model_recs path).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from anime_recommendations_tpu.ops.ivf import add_rows, build_ivf, ivf_topk


def _blob_table(rng, n=4096, d=32, n_centers=64, noise=0.15):
    centers = rng.normal(size=(n_centers, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    rows = centers[rng.integers(0, n_centers, n)] + noise * rng.normal(size=(n, d))
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    return rows.astype(np.float32)


def _recall(ids, oracle):
    return np.mean(
        [len(set(ids[i]) & set(oracle[i])) / oracle.shape[1]
         for i in range(len(ids))]
    )


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(11)
    W = _blob_table(rng)
    index = build_ivf(W, n_clusters=64, iters=8, seed=3)
    q = W[rng.integers(0, len(W), 50)]
    oracle = np.argsort(-(q @ W.T), axis=1)[:, :10]
    return W, index, q, oracle


def test_recall_on_clustered_data(blobs):
    _, index, q, oracle = blobs
    _, ids = ivf_topk(index, q, k=10, probes=8)
    assert _recall(np.asarray(ids), oracle) >= 0.95


def test_probe_all_is_exact(blobs):
    W, index, q, _ = blobs
    vals, _ = ivf_topk(index, q, k=10, probes=index.n_clusters)
    oracle_vals = -np.sort(-(q @ W.T), axis=1)[:, :10]
    np.testing.assert_allclose(np.asarray(vals), oracle_vals, atol=1e-5)


def test_every_row_is_bucketed_or_spilled(blobs):
    _, index, _, _ = blobs
    ids = np.concatenate(
        [np.asarray(index.buckets).ravel(), np.asarray(index.spill)]
    )
    ids = ids[ids >= 0]
    assert len(ids) == len(index.table)
    assert len(np.unique(ids)) == len(index.table)


def test_spill_preserves_exactness_under_tiny_caps():
    rng = np.random.default_rng(5)
    W = _blob_table(rng, n=1024, d=16, n_centers=8)
    # cap_factor 0.5 forces most rows of each cluster into the spill list.
    index = build_ivf(W, n_clusters=16, iters=4, seed=1, cap_factor=0.5)
    assert int(np.sum(np.asarray(index.spill) >= 0)) > 0
    q = W[:20]
    vals, _ = ivf_topk(index, q, k=5, probes=16)
    oracle_vals = -np.sort(-(q @ W.T), axis=1)[:, :5]
    np.testing.assert_allclose(np.asarray(vals), oracle_vals, atol=1e-5)


def test_int8_storage_matches_f32_path(blobs):
    W, _, q, oracle = blobs
    index8 = build_ivf(W, n_clusters=64, iters=8, seed=3, storage="int8")
    assert index8.q8 is not None and index8.q8.dtype == np.int8
    # probe-all: the int8 stage-1 pool (top max(4k, k+8)) is rescored from
    # exact rows, so the true top-k survives the quantization noise on
    # well-separated data.
    vals, ids = ivf_topk(index8, q, k=10, probes=index8.n_clusters)
    oracle_vals = -np.sort(-(q @ W.T), axis=1)[:, :10]
    np.testing.assert_allclose(np.asarray(vals), oracle_vals, atol=1e-5)
    # probed recall matches the f32-storage path's ballpark.
    _, ids_p = ivf_topk(index8, q, k=10, probes=8)
    assert _recall(np.asarray(ids_p), oracle) >= 0.95


def test_exclude_drops_self(blobs):
    W, index, _, _ = blobs
    qi = np.arange(8)
    _, ids = ivf_topk(
        index, W[qi], k=10, probes=index.n_clusters, exclude=qi.astype(np.int32)
    )
    ids = np.asarray(ids)
    for r, i in enumerate(qi):
        assert i not in ids[r]


def test_single_query_squeezes(blobs):
    _, index, q, _ = blobs
    vals, ids = ivf_topk(index, q[0], k=10, probes=8)
    assert vals.shape == (10,) and ids.shape == (10,)


def test_query_chunk_padding_is_inert(blobs):
    _, index, q, _ = blobs
    # 33 queries with chunk 16 forces a padded final chunk; results must
    # equal the unchunked run exactly.
    v1, i1 = ivf_topk(index, q[:33], k=10, probes=8, query_chunk=16)
    v2, i2 = ivf_topk(index, q[:33], k=10, probes=8, query_chunk=33)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), atol=1e-6)
    assert np.array_equal(np.asarray(i1), np.asarray(i2))


def test_headed_scoring_matches_oracle_for_both_slopes(blobs):
    W, index, q, _ = blobs
    for alpha in (1.7, -1.7):
        head = jnp.asarray([alpha, 0.3], jnp.float32)
        vals, ids = ivf_topk(
            index, q[:16], k=5, probes=index.n_clusters, head=head,
            use_head=True,
        )
        sc = 1.0 / (1.0 + np.exp(-(alpha * (q[:16] @ W.T) + 0.3)))
        oracle_vals = -np.sort(-sc, axis=1)[:, :5]
        np.testing.assert_allclose(
            np.asarray(vals), oracle_vals, atol=1e-5,
            err_msg=f"alpha={alpha}",
        )


def test_ivf_context_matches_exact_recommendations(
    ratings_frame, anime_catalog_frame, synopses_frame
):
    from anime_recommendations_tpu.data.catalog import Catalog
    from anime_recommendations_tpu.data.preprocess import preprocess_ratings
    from anime_recommendations_tpu.data.vocab import build_vocab, encode_frame
    from anime_recommendations_tpu.models import two_tower as tt
    from anime_recommendations_tpu.recommend import (
        RecContext, model_recs, similar_anime, similar_users,
    )

    clean, _ = preprocess_ratings(ratings_frame, num_reviews=50)
    vocab = build_vocab(clean)
    encoded = encode_frame(clean, vocab)
    catalog = Catalog.from_frames(anime_catalog_frame, synopses_frame)
    params = tt.init_params(
        jax.random.PRNGKey(11), vocab.n_users, vocab.n_anime, embedding_size=32
    )
    params = params._replace(dense_w=jnp.float32(2.0), dense_b=jnp.float32(0.1))
    bn = tt.BNState(moving_mean=jnp.float32(0.05), moving_var=jnp.float32(0.8))
    ctx = RecContext.build(params, bn, vocab, catalog, encoded)
    # probe-all makes the IVF context exact — recommendation parity is
    # deterministic, not recall-dependent.
    ctx_ivf = RecContext.build(
        params, bn, vocab, catalog, encoded, ann="ivf", ann_probes=10_000
    )
    from anime_recommendations_tpu.ops.ivf import IVFIndex

    assert isinstance(ctx_ivf.anime_table(), IVFIndex)

    name = ctx.catalog.anime["Name"].iloc[3]
    f_a, _, _ = similar_anime(ctx, name, count=8)
    i_a, _, _ = similar_anime(ctx_ivf, name, count=8)
    assert list(f_a["Name"]) == list(i_a["Name"])
    np.testing.assert_allclose(
        f_a["Similarity"].to_numpy(), i_a["Similarity"].to_numpy(), rtol=1e-5
    )

    uid = int(ctx.ratings["user_id"].iloc[0])
    f_u, _, _ = similar_users(ctx, uid, n_users=6)
    i_u, _, _ = similar_users(ctx_ivf, uid, n_users=6)
    assert list(f_u["similar_users"]) == list(i_u["similar_users"])

    f_m, _ = model_recs(ctx, uid, n_recs=6)
    i_m, _ = model_recs(ctx_ivf, uid, n_recs=6)
    assert list(f_m["Name"]) == list(i_m["Name"])
    np.testing.assert_allclose(
        f_m["Prediction"].to_numpy(), i_m["Prediction"].to_numpy(), rtol=1e-5
    )


def test_add_rows_probe_all_stays_exact(blobs):
    W, index, _, _ = blobs
    rng = np.random.default_rng(21)
    new = _blob_table(rng, n=64, d=W.shape[1], n_centers=8)
    grown = add_rows(index, new)
    W2 = np.concatenate([W, new])
    assert grown.table.shape[0] == len(W2)
    # every row (old and new) bucketed-or-spilled exactly once
    ids = np.concatenate(
        [np.asarray(grown.buckets).ravel(), np.asarray(grown.spill)]
    )
    ids = ids[ids >= 0]
    assert len(np.unique(ids)) == len(ids) == len(W2)
    q = np.concatenate([W[:10], new[:10]])
    vals, _ = ivf_topk(grown, q, k=10, probes=grown.n_clusters)
    oracle_vals = -np.sort(-(q @ W2.T), axis=1)[:, :10]
    np.testing.assert_allclose(np.asarray(vals), oracle_vals, atol=1e-5)


def test_add_rows_new_rows_findable_at_small_probes(blobs):
    W, index, _, _ = blobs
    rng = np.random.default_rng(22)
    new = _blob_table(rng, n=32, d=W.shape[1], n_centers=4)
    grown = add_rows(index, new)
    # a new row probes its own nearest cluster first: retrieving with the
    # row itself must find it at probes=1.
    _, ids = ivf_topk(grown, new[:8], k=1, probes=1)
    expect = np.arange(len(W), len(W) + 8)
    assert np.array_equal(np.asarray(ids).ravel(), expect)


def test_add_rows_overflow_goes_to_spill():
    rng = np.random.default_rng(23)
    W = _blob_table(rng, n=256, d=16, n_centers=4)
    index = build_ivf(W, n_clusters=4, iters=4, seed=1, cap_factor=1.0)
    new = _blob_table(rng, n=200, d=16, n_centers=4)
    grown = add_rows(index, new)
    assert int(np.sum(np.asarray(grown.spill) >= 0)) > int(
        np.sum(np.asarray(index.spill) >= 0)
    )
    q = new[:5]
    vals, _ = ivf_topk(grown, q, k=5, probes=4)
    W2 = np.concatenate([W, new])
    oracle_vals = -np.sort(-(q @ W2.T), axis=1)[:, :5]
    np.testing.assert_allclose(np.asarray(vals), oracle_vals, atol=1e-5)


def test_add_rows_int8_index_grows_quantized(blobs):
    W, _, _, _ = blobs
    index8 = build_ivf(W, n_clusters=64, iters=4, seed=3, storage="int8")
    rng = np.random.default_rng(24)
    new = _blob_table(rng, n=16, d=W.shape[1], n_centers=4)
    grown = add_rows(index8, new)
    assert grown.q8.shape[0] == grown.table.shape[0] == len(W) + 16
    assert grown.q8.dtype == np.int8 and grown.scale.shape[0] == len(W) + 16


def test_bf16_table_builds_and_probe_all_matches_bf16_scores(blobs):
    W, _, q, _ = blobs
    Wb = jnp.asarray(W, jnp.bfloat16)
    index = build_ivf(Wb, n_clusters=64, iters=4, seed=3)
    assert index.centroids.dtype == jnp.float32  # carry-stable f32 centroids
    vals, _ = ivf_topk(index, jnp.asarray(q[:8], jnp.bfloat16), k=5,
                       probes=index.n_clusters)
    oracle = np.asarray(
        jnp.asarray(q[:8], jnp.bfloat16) @ jnp.asarray(W, jnp.bfloat16).T,
        np.float32,
    )
    oracle_vals = -np.sort(-oracle, axis=1)[:, :5]
    np.testing.assert_allclose(np.asarray(vals, np.float32), oracle_vals,
                               atol=2e-2)


def test_fewer_live_candidates_than_k_pads_with_dead_slots():
    rng = np.random.default_rng(9)
    W = _blob_table(rng, n=256, d=16, n_centers=4)
    index = build_ivf(W, n_clusters=64, iters=4, seed=2, cap_factor=1.0)
    # probes=1 over a tiny bucket can expose < k live candidates.
    vals, ids = ivf_topk(index, W[0], k=200, probes=1)
    dead = ~np.isfinite(np.asarray(vals))
    assert np.all(np.asarray(ids)[dead] == -1)

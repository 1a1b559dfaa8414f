"""Engine (in-process API) + bf16 retrieval context."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from anime_recommendations_tpu.config import Config
from anime_recommendations_tpu.data.catalog import Catalog
from anime_recommendations_tpu.data.preprocess import preprocess_ratings
from anime_recommendations_tpu.data.vocab import build_vocab, encode_frame
from anime_recommendations_tpu.models import two_tower as tt
from anime_recommendations_tpu.recommend import RecContext
from anime_recommendations_tpu.serve.api import Engine


@pytest.fixture(scope="module")
def built(ratings_frame, anime_catalog_frame, synopses_frame):
    clean, _ = preprocess_ratings(ratings_frame, num_reviews=50)
    vocab = build_vocab(clean)
    encoded = encode_frame(clean, vocab)
    catalog = Catalog.from_frames(anime_catalog_frame, synopses_frame)
    params = tt.init_params(jax.random.PRNGKey(2), vocab.n_users, vocab.n_anime, 16)
    bn = tt.init_bn_state()
    return params, bn, vocab, catalog, encoded


def test_engine_methods(built):
    ctx = RecContext.build(*built)
    engine = Engine(ctx, Config())
    uid = int(ctx.vocab.user_ids[1])
    name = ctx.catalog.anime["Name"].iloc[2]

    sims = engine.similar_anime(name, k=4)
    assert len(sims) == 4 and {"Name", "Similarity"} <= set(sims[0])
    users = engine.similar_users(uid, k=3)
    assert len(users) == 3
    prefs = engine.user_prefs(uid)
    assert prefs["user_id"] == uid and isinstance(prefs["genre_frequencies"], dict)
    recs = engine.model_recs(uid, k=5)
    assert len(recs) == 5 and "Prediction" in recs[0]
    urecs = engine.user_recs(uid, k=5)
    assert isinstance(urecs, list)


def test_engine_similar_users_cache(built):
    ctx = RecContext.build(*built)
    engine = Engine(ctx, Config())
    uid = int(ctx.vocab.user_ids[1])

    first = engine.similar_users(uid, k=3)
    info = engine.cache_info()
    assert info["misses"] == 1 and info["hits"] == 0
    assert engine.similar_users(uid, k=3) == first
    assert engine.cache_info()["hits"] == 1
    # /similar_users and /user_recs share ONE cache entry per user: both
    # cache the scan at max(k, recs_n_sim_ID) and slice, so user_recs HITS
    # the entry the similar_users call above created (round-4 fix for the
    # k-default mismatch that halved the hit rate).
    engine.user_recs(uid, k=5)
    engine.user_recs(uid, k=5)
    info = engine.cache_info()
    assert info["misses"] == 1 and info["hits"] == 3
    # cache_size=0 disables caching entirely.
    uncached = Engine(ctx, Config(), cache_size=0)
    uncached.similar_users(uid, k=3)
    assert uncached.cache_info() is None


def test_engine_on_ivf_context_matches_exact(built):
    params, bn, vocab, catalog, encoded = built
    exact = Engine(RecContext.build(params, bn, vocab, catalog, encoded),
                   Config())
    ivf = Engine(
        RecContext.build(params, bn, vocab, catalog, encoded,
                         ann="ivf", ann_probes=100_000),
        Config(),
    )
    name = catalog.anime["Name"].iloc[2]
    uid = int(vocab.user_ids[1])
    a = exact.similar_anime(name, k=5)
    b = ivf.similar_anime(name, k=5)
    assert [r["Name"] for r in a] == [r["Name"] for r in b]
    ra = exact.model_recs(uid, k=5)
    rb = ivf.model_recs(uid, k=5)
    assert [r["Name"] for r in ra] == [r["Name"] for r in rb]


def test_bf16_retrieval_context_close_to_f32(built):
    params, bn, vocab, catalog, encoded = built
    f32 = RecContext.build(params, bn, vocab, catalog, encoded)
    b16 = RecContext.build(
        params, bn, vocab, catalog, encoded, retrieval_dtype=jnp.bfloat16
    )
    assert b16.anime_norm.dtype == jnp.bfloat16
    from anime_recommendations_tpu.recommend import similar_anime

    name = catalog.anime["Name"].iloc[5]
    a, _, _ = similar_anime(f32, name, count=10)
    b, _, _ = similar_anime(b16, name, count=10)
    # bf16 scores agree to ~1e-2; the top sets overlap heavily.
    overlap = len(set(a["Name"]) & set(b["Name"])) / 10
    assert overlap >= 0.8
    np.testing.assert_allclose(
        a["Similarity"].to_numpy()[:3], b["Similarity"].to_numpy()[:3], atol=2e-2
    )


def test_cpu_hosted_context_matches_default(ratings_frame, anime_catalog_frame,
                                            synopses_frame):
    """A RecContext placed explicitly on the CPU device (``device=``)
    answers exactly like the default context."""
    import jax

    from anime_recommendations_tpu.data.catalog import Catalog
    from anime_recommendations_tpu.data.preprocess import preprocess_ratings
    from anime_recommendations_tpu.data.vocab import build_vocab, encode_frame
    from anime_recommendations_tpu.models import two_tower as tt
    from anime_recommendations_tpu.recommend import RecContext, similar_anime

    clean, _ = preprocess_ratings(ratings_frame, num_reviews=40)
    vocab = build_vocab(clean)
    encoded = encode_frame(clean, vocab)
    catalog = Catalog.from_frames(anime_catalog_frame, synopses_frame)
    params = tt.init_params(jax.random.PRNGKey(3), vocab.n_users,
                            vocab.n_anime, 16)
    cpu = jax.devices("cpu")[0]
    default_ctx = RecContext.build(params, tt.init_bn_state(), vocab, catalog,
                                   encoded)
    with jax.default_device(cpu):
        cpu_ctx = RecContext.build(
            params, tt.init_bn_state(), vocab, catalog, encoded, device=cpu,
        )
        name = catalog.anime["Name"].iloc[3]
        a = similar_anime(default_ctx, name, count=5)[0]
        b = similar_anime(cpu_ctx, name, count=5)[0]
    assert list(a["Name"]) == list(b["Name"])
    import numpy as np

    np.testing.assert_allclose(a["Similarity"].to_numpy(),
                               b["Similarity"].to_numpy(), rtol=1e-5)

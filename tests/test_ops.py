"""Retrieval ops vs numpy oracles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from anime_recommendations_tpu.models import two_tower as tt
from anime_recommendations_tpu.ops.normalize import l2_normalize_rows
from anime_recommendations_tpu.ops.scoring import head_affine, score_all_items, score_topk
from anime_recommendations_tpu.ops.topk import cosine_topk, masked_topk


def normed(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(1)
    return normed(rng.normal(size=(500, 64)).astype(np.float32))


def test_l2_normalize_rows_matches_numpy():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 48)).astype(np.float32) * 10
    out = np.asarray(l2_normalize_rows(jnp.asarray(x)))
    np.testing.assert_allclose(out, normed(x), rtol=1e-5)


def test_l2_normalize_rows_unaligned_rows():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(37, 16)).astype(np.float32)
    out = np.asarray(l2_normalize_rows(jnp.asarray(x)))
    np.testing.assert_allclose(out, normed(x), rtol=1e-5)


def oracle_topk(scores, k):
    idx = np.argsort(-scores, kind="stable")[:k]
    return scores[idx], idx


def test_cosine_topk_matches_oracle(table):
    q = table[[3, 77, 123]]
    vals, idx = cosine_topk(jnp.asarray(table), jnp.asarray(q), k=7)
    vals, idx = np.asarray(vals), np.asarray(idx)
    for row, qi in enumerate([3, 77, 123]):
        ref_scores = table @ table[qi]
        ref_v, _ = oracle_topk(ref_scores, 7)
        np.testing.assert_allclose(vals[row], ref_v, rtol=1e-5)
        # Self is included when not excluded (reference drops it afterwards).
        assert idx[row, 0] == qi
        np.testing.assert_allclose(
            ref_scores[idx[row]], vals[row], rtol=1e-5
        )


def test_exclude_self(table):
    q = table[[10, 20]]
    vals, idx = cosine_topk(
        jnp.asarray(table), jnp.asarray(q), k=5,
        exclude=jnp.asarray([10, 20]),
    )
    idx = np.asarray(idx)
    assert 10 not in idx[0] and 20 not in idx[1]
    ref = np.delete(table @ table[10], 10)
    np.testing.assert_allclose(np.asarray(vals)[0, 0], ref.max(), rtol=1e-5)


def test_row_mask(table):
    keep = np.zeros(len(table), bool)
    keep[:100] = True
    vals, idx = cosine_topk(
        jnp.asarray(table), jnp.asarray(table[[5]]), k=4,
        mask=jnp.asarray(keep),
    )
    assert np.asarray(idx).max() < 100
    ref_v, ref_i = oracle_topk((table @ table[5])[:100], 4)
    np.testing.assert_allclose(np.asarray(vals)[0], ref_v, rtol=1e-5)


def test_fewer_valid_rows_than_k(table):
    keep = np.zeros(len(table), bool)
    keep[:3] = True
    vals, idx = masked_topk(
        jnp.asarray(table), jnp.asarray(table[[0]]), k=8,
        mask=jnp.asarray(keep),
    )
    vals = np.asarray(vals)[0]
    assert (vals[:3] > -1e29).all() and (vals[3:] <= -1e29).all()


def test_unaligned_table_size():
    rng = np.random.default_rng(2)
    tab = normed(rng.normal(size=(333, 32)).astype(np.float32))
    vals, idx = cosine_topk(jnp.asarray(tab), jnp.asarray(tab[[7]]), k=5)
    ref_v, _ = oracle_topk(tab @ tab[7], 5)
    np.testing.assert_allclose(np.asarray(vals)[0], ref_v, rtol=1e-5)
    assert np.asarray(idx).max() < 333


def test_score_topk_matches_model_predict():
    params = tt.init_params(jax.random.PRNGKey(3), n_users=40, n_anime=200,
                            embedding_size=32)
    # Perturb head/bn so the affine fold is non-trivial.
    params = params._replace(dense_w=jnp.float32(1.7), dense_b=jnp.float32(-0.3),
                             bn_gamma=jnp.float32(0.9), bn_beta=jnp.float32(0.2))
    bn = tt.BNState(moving_mean=jnp.float32(0.1), moving_var=jnp.float32(1.4))

    user_index = 17
    full = np.asarray(score_all_items(params, bn, jnp.int32(user_index)))
    # Oracle: the model's own predict over every anime.
    preds = np.asarray(
        tt.predict(params, bn,
                   jnp.full(200, user_index, jnp.int32), jnp.arange(200))
    )
    np.testing.assert_allclose(full, preds, rtol=1e-5)

    anime_n, user_n = tt.normalized_tables(params)
    watched = np.zeros(200, bool)
    watched[[5, 6, 7]] = True
    vals, idx = score_topk(
        anime_n, user_n[user_index], head_affine(params, bn), k=6,
        mask=jnp.asarray(~watched),
    )
    vals, idx = np.asarray(vals)[0], np.asarray(idx)[0]
    masked = preds.copy()
    masked[watched] = -np.inf
    ref_v, ref_i = oracle_topk(masked, 6)
    np.testing.assert_allclose(vals, ref_v, rtol=1e-5)
    assert not set(idx) & {5, 6, 7}


def test_batched_queries_independent(table):
    qs = table[[1, 2, 3, 4, 5, 6, 7, 8, 9]]
    vals, idx = cosine_topk(jnp.asarray(table), jnp.asarray(qs), k=3)
    for row, qi in enumerate(range(1, 10)):
        ref_v, _ = oracle_topk(table @ table[qi], 3)
        np.testing.assert_allclose(np.asarray(vals)[row], ref_v, rtol=1e-5)


def test_topk_k1_and_tiny_table():
    tab = normed(np.random.default_rng(5).normal(size=(12, 16)).astype(np.float32))
    vals, idx = cosine_topk(jnp.asarray(tab), jnp.asarray(tab[[3]]), k=1)
    assert np.asarray(idx)[0, 0] == 3  # self is its own best match
    vals, idx = cosine_topk(jnp.asarray(tab), jnp.asarray(tab[[3]]), k=12)
    assert sorted(np.asarray(idx)[0].tolist()) == list(range(12))


def test_topk_large_k_across_blocks():
    rng = np.random.default_rng(6)
    tab = normed(rng.normal(size=(600, 32)).astype(np.float32))
    vals, idx = cosine_topk(jnp.asarray(tab), jnp.asarray(tab[[0]]), k=50)
    ref = np.sort(tab @ tab[0])[::-1][:50]
    np.testing.assert_allclose(np.asarray(vals)[0], ref, rtol=1e-5)


def test_topk_bf16_table_close_to_f32(table):
    q = table[[9]]
    v32, i32 = cosine_topk(jnp.asarray(table), jnp.asarray(q), k=5)
    v16, i16 = cosine_topk(
        jnp.asarray(table, dtype=jnp.bfloat16),
        jnp.asarray(q, dtype=jnp.bfloat16), k=5,
    )
    np.testing.assert_allclose(np.asarray(v16)[0], np.asarray(v32)[0], atol=2e-2)
    assert len(set(np.asarray(i16)[0]) & set(np.asarray(i32)[0])) >= 3


def test_quantized_topk_exact_after_rescore():
    from anime_recommendations_tpu.ops.quantized import quantize_rows, quantized_topk

    rng = np.random.default_rng(21)
    n, d, qn, k = 3000, 64, 6, 10
    W = rng.standard_normal((n, d)).astype(np.float32)
    W /= np.linalg.norm(W, axis=1, keepdims=True)
    qt = quantize_rows(jnp.asarray(W))
    q = W[:qn]
    mask = rng.uniform(size=n) > 0.25
    excl = np.arange(qn, dtype=np.int32)

    vals, idx = quantized_topk(
        qt, jnp.asarray(q), k, mask=jnp.asarray(mask),
        exclude=jnp.asarray(excl),
    )
    scores = q @ W.T
    scores[:, ~mask] = -np.inf
    for r, e in enumerate(excl):
        scores[r, e] = -np.inf
    oracle = np.argsort(-scores, axis=1)[:, :k]
    np.testing.assert_array_equal(np.asarray(idx), oracle)
    # Rescored values are exact f32 cosines, not int8 approximations.
    np.testing.assert_allclose(
        np.asarray(vals),
        np.take_along_axis(scores, oracle, axis=1),
        rtol=1e-5,
    )


def test_quantized_topk_default_block_covers_tail_rows():
    """Queries drawn from the last rows of a 3000-row table: every row is a
    stage-1 candidate, so each query's exact self-match comes back."""
    from anime_recommendations_tpu.ops.quantized import quantize_rows, quantized_topk

    rng = np.random.default_rng(33)
    n, d, k = 3000, 64, 10
    W = rng.standard_normal((n, d)).astype(np.float32)
    W /= np.linalg.norm(W, axis=1, keepdims=True)
    qt = quantize_rows(jnp.asarray(W))
    # Queries ARE tail rows: their self-match (cosine 1.0) must come back.
    tail_rows = np.arange(2560, 3000, 40, dtype=np.int32)
    vals, idx = quantized_topk(qt, jnp.asarray(W[tail_rows]), k)
    idx = np.asarray(idx)
    for r, row in enumerate(tail_rows):
        assert row in idx[r], f"self-match {row} missing from top-{k}: {idx[r]}"
    scores = W[tail_rows] @ W.T
    oracle = np.argsort(-scores, axis=1)[:, :k]
    np.testing.assert_array_equal(idx, oracle)


def test_quantized_topk_single_block_and_k_gt_valid():
    from anime_recommendations_tpu.ops.quantized import quantize_rows, quantized_topk

    rng = np.random.default_rng(22)
    W = rng.standard_normal((100, 32)).astype(np.float32)
    W /= np.linalg.norm(W, axis=1, keepdims=True)
    qt = quantize_rows(jnp.asarray(W))
    mask = np.zeros(100, bool)
    mask[:5] = True  # only 5 valid rows, k=8 -> sentinel tail
    vals, idx = quantized_topk(
        qt, jnp.asarray(W[:2]), 8, mask=jnp.asarray(mask)
    )
    vals, idx = np.asarray(vals), np.asarray(idx)
    assert (idx[:, :5] < 5).all()
    assert (vals[:, 5:] <= -1e29).all()


def test_midsize_table_between_group_and_block():
    """Table sizes that are not multiples of any tile (the serving user
    table on small corpora) return the exact top-k."""
    rng = np.random.default_rng(3)
    for n in (1147, 513, 1536, 2040):
        W = rng.standard_normal((n, 32)).astype(np.float32)
        W /= np.linalg.norm(W, axis=1, keepdims=True)
        vals, idx = masked_topk(jnp.asarray(W), jnp.asarray(W[:3]), 5)
        sc = W[:3] @ W.T
        oracle = np.argsort(-sc, axis=1)[:, :5]
        np.testing.assert_array_equal(np.asarray(idx), oracle)


# ---- the plain top-k against a float64 oracle --------------------------------


def _oracle_case(n=700, d=32, qn=5, seed=40):
    rng = np.random.default_rng(seed)
    W = normed(rng.standard_normal((n, d))).astype(np.float32)
    rows = rng.choice(n, qn, replace=False)
    return W, rows, rng


def _f64_oracle(W, Q, k, mask=None, exclude=None, head=None):
    s = Q.astype(np.float64) @ W.astype(np.float64).T
    if head is not None:
        s = 1.0 / (1.0 + np.exp(-(head[0] * s + head[1])))
    if mask is not None:
        s[:, ~mask] = -np.inf
    if exclude is not None:
        s[np.arange(len(exclude)), exclude] = -np.inf
    idx = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, idx, axis=1), idx


@pytest.mark.parametrize("case", ["plain", "mask", "exclude", "head", "all"])
def test_masked_topk_matches_float64_oracle(case):
    W, rows, rng = _oracle_case()
    Q = W[rows]
    mask = rng.uniform(size=len(W)) > 0.3 if case in ("mask", "all") else None
    excl = rows.astype(np.int32) if case in ("exclude", "all") else None
    head = np.asarray([-1.7, 0.4], np.float32) if case in ("head", "all") else None
    vals, idx = masked_topk(
        jnp.asarray(W), jnp.asarray(Q), 9,
        mask=None if mask is None else jnp.asarray(mask),
        exclude=None if excl is None else jnp.asarray(excl),
        head=None if head is None else jnp.asarray(head),
        use_head=head is not None,
    )
    ref_v, ref_i = _f64_oracle(W, Q, 9, mask, excl, head)
    np.testing.assert_array_equal(np.asarray(idx), ref_i)
    np.testing.assert_allclose(np.asarray(vals), ref_v, rtol=0, atol=1e-6)


def test_masked_topk_k_greater_than_n_pads_sentinels():
    W, rows, _ = _oracle_case(n=6)
    vals, idx = masked_topk(jnp.asarray(W), jnp.asarray(W[:2]), 9)
    vals, idx = np.asarray(vals), np.asarray(idx)
    assert vals.shape == idx.shape == (2, 9)
    assert sorted(idx[0, :6].tolist()) == list(range(6))
    assert (idx[:, 6:] == -1).all() and (vals[:, 6:] <= -1e29).all()


def test_bf16_topk_matches_bf16_rounded_oracle():
    """A bf16 table scores bf16 products exactly and accumulates in f32, so
    it matches the oracle over the bf16-ROUNDED rows far inside bf16's own
    rounding error."""
    W, rows, _ = _oracle_case(n=900, d=64)
    Wb = jnp.asarray(W, jnp.bfloat16)
    wb = np.asarray(Wb.astype(jnp.float32))
    vals, idx = cosine_topk(Wb, Wb[rows], 7)
    ref_v, ref_i = _f64_oracle(wb, wb[rows], 7)
    np.testing.assert_array_equal(np.asarray(idx), ref_i)
    np.testing.assert_allclose(np.asarray(vals), ref_v, rtol=0, atol=1e-5)


@pytest.mark.parametrize("use_head", [False, True])
def test_quantized_topk_rescore_equals_f32_result(use_head):
    """The int8 pool, rescored in f32, returns exactly the f32 top-k —
    also through a negative-slope head, which reverses the cosine order."""
    from anime_recommendations_tpu.ops.quantized import quantize_rows, quantized_topk

    W, rows, rng = _oracle_case(n=2500, d=64, qn=8)
    mask = rng.uniform(size=len(W)) > 0.2
    head = jnp.asarray([-2.1, 0.3], jnp.float32) if use_head else None
    kw = dict(mask=jnp.asarray(mask), exclude=jnp.asarray(rows.astype(np.int32)),
              head=head, use_head=use_head)
    v8, i8 = quantized_topk(quantize_rows(jnp.asarray(W)), jnp.asarray(W[rows]),
                            10, **kw)
    v32, i32 = masked_topk(jnp.asarray(W), jnp.asarray(W[rows]), 10, **kw)
    np.testing.assert_array_equal(np.asarray(i8), np.asarray(i32))
    np.testing.assert_allclose(np.asarray(v8), np.asarray(v32), rtol=0, atol=1e-6)


@pytest.mark.parametrize("q,k", [(1, 10), (3, 300), (70, 10), (70, 40)])
def test_chunked_top_k_equals_one_top_k(q, k):
    """The chunked top-k (few rows, or large k) returns what one
    lax.top_k returns, ties included; many rows with small k take the
    single call."""
    from anime_recommendations_tpu.ops.topk import _top_k

    rng = np.random.default_rng(q + k)
    s = rng.standard_normal((q, 1000)).astype(np.float32)
    s[:, 500:540] = s[:, 100:140]          # exact ties across chunks
    s[:, -3:] = -1e30                      # sentinels in the ragged chunk
    v, i = _top_k(jnp.asarray(s), k)
    rv, ri = jax.lax.top_k(jnp.asarray(s), k)
    np.testing.assert_array_equal(np.asarray(v), np.asarray(rv))
    np.testing.assert_array_equal(np.asarray(i), np.asarray(ri))

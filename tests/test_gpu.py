"""Checks that only a GPU can answer: the compiled ops at real widths.

Marked ``gpu``; they skip elsewhere. Run on a machine with a card:
``ANIMEREC_TEST_GPU=1 python -m pytest -m gpu``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from anime_recommendations_tpu.ops.fused_adam import sparse_adam_update
from anime_recommendations_tpu.ops.quantized import quantize_rows, quantized_topk
from anime_recommendations_tpu.ops.topk import masked_topk

pytestmark = pytest.mark.gpu


def _table(n=350_000, d=128, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, d))
    return (w / np.linalg.norm(w, axis=1, keepdims=True)).astype(np.float32)


def test_f32_topk_is_exact_on_the_card(gpu):
    """HIGHEST keeps f32 scores exact (a TF32 matmul would not)."""
    w = _table()
    q = w[:8]
    vals, idx = masked_topk(jnp.asarray(w), jnp.asarray(q), 10)
    s = q.astype(np.float64) @ w.astype(np.float64).T
    ref = np.sort(s, axis=1)[:, ::-1][:, :10]
    np.testing.assert_allclose(np.asarray(vals), ref, rtol=0, atol=1e-5)


def test_int8_topk_equals_f32_on_the_card(gpu):
    w = jnp.asarray(_table())
    q = w[:8]
    v8, i8 = quantized_topk(quantize_rows(w), q, 10)
    v32, i32 = masked_topk(w, q, 10)
    np.testing.assert_array_equal(np.asarray(i8), np.asarray(i32))
    np.testing.assert_allclose(np.asarray(v8), np.asarray(v32), atol=1e-6)


def test_bf16_moments_round_stochastically_on_the_card(gpu):
    n, d = 4096, 128
    w = jnp.zeros((n, d), jnp.float32)
    mu = jnp.zeros((n, d), jnp.bfloat16)
    nu = jnp.ones((n, d), jnp.bfloat16)
    dense = jnp.full((n, d), np.sqrt(2.0), jnp.float32)
    ids, g = jnp.zeros((1,), jnp.int32), jnp.zeros((1, d), jnp.float32)
    for t in range(1, 101):
        w, mu, nu, _ = sparse_adam_update(w, mu, nu, ids, g, jnp.asarray(t),
                                          jnp.float32(0.0), dense_grad=dense)
    want = 2.0 - 0.999 ** 100
    assert abs(float(jnp.mean(nu.astype(jnp.float32))) - want) < 0.01 * want

"""Two-tower model numerics + training-loop behavior."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from anime_recommendations_tpu.data.dataset import RatingsDataset
from anime_recommendations_tpu.models import two_tower as tt
from anime_recommendations_tpu.train.trainer import Trainer, init_train_state


@pytest.fixture(scope="module")
def tiny_params():
    return tt.init_params(jax.random.PRNGKey(0), n_users=50, n_anime=30,
                          embedding_size=16)


def test_init_shapes_and_ranges(tiny_params):
    p = tiny_params
    assert p.user_emb.shape == (50, 16)
    assert p.anime_emb.shape == (30, 16)
    # Keras Embedding default uniform(-0.05, 0.05).
    assert float(jnp.abs(p.user_emb).max()) <= 0.05
    assert p.dense_w.shape == () and p.bn_gamma == 1.0 and p.bn_beta == 0.0


def test_cosine_merge_matches_numpy(tiny_params):
    rng = np.random.default_rng(0)
    u = rng.normal(size=(8, 16)).astype(np.float32)
    a = rng.normal(size=(8, 16)).astype(np.float32)
    cos = tt.cosine_merge(jnp.asarray(u), jnp.asarray(a))
    expected = np.sum(
        u / np.linalg.norm(u, axis=1, keepdims=True)
        * a / np.linalg.norm(a, axis=1, keepdims=True),
        axis=1,
    )
    np.testing.assert_allclose(np.asarray(cos), expected, atol=1e-6)
    assert np.all(np.abs(np.asarray(cos)) <= 1.0 + 1e-6)


def test_head_matches_manual_batchnorm(tiny_params):
    cos = jnp.asarray(np.linspace(-1, 1, 10, dtype=np.float32))
    state = tt.init_bn_state()
    pred, new_state = tt.head(tiny_params, cos, state, train=True)
    z = np.asarray(tiny_params.dense_w) * np.asarray(cos) + np.asarray(tiny_params.dense_b)
    mean, var = z.mean(), z.var()
    manual = 1.0 / (1.0 + np.exp(-((z - mean) / np.sqrt(var + 1e-3))))
    np.testing.assert_allclose(np.asarray(pred), manual, atol=1e-5)
    # Moving stats follow Keras update rule with momentum 0.99.
    np.testing.assert_allclose(float(new_state.moving_mean), 0.01 * mean, atol=1e-7)
    np.testing.assert_allclose(float(new_state.moving_var), 0.99 + 0.01 * var, atol=1e-6)


def test_eval_uses_moving_stats(tiny_params):
    cos = jnp.asarray(np.linspace(-1, 1, 10, dtype=np.float32))
    state = tt.BNState(moving_mean=jnp.float32(0.3), moving_var=jnp.float32(2.0))
    pred, out_state = tt.head(tiny_params, cos, state, train=False)
    assert out_state is state
    z = np.asarray(tiny_params.dense_w) * np.asarray(cos) + np.asarray(tiny_params.dense_b)
    manual = 1.0 / (1.0 + np.exp(-((z - 0.3) / np.sqrt(2.0 + 1e-3))))
    np.testing.assert_allclose(np.asarray(pred), manual, atol=1e-5)


def test_loss_includes_full_table_l2(tiny_params):
    users = jnp.arange(4)
    anime = jnp.arange(4)
    ratings = jnp.asarray([0.2, 0.4, 0.6, 0.8], jnp.float32)
    w = jnp.ones(4, jnp.float32)
    state = tt.init_bn_state()
    loss0, _ = tt.loss_and_metrics(
        tiny_params, state, users, anime, ratings, w, 0.0, True
    )
    loss1, _ = tt.loss_and_metrics(
        tiny_params, state, users, anime, ratings, w, 1e-2, True
    )
    reg = 1e-2 * (
        float(jnp.sum(tiny_params.user_emb**2)) + float(jnp.sum(tiny_params.anime_emb**2))
    )
    np.testing.assert_allclose(float(loss1 - loss0), reg, rtol=1e-5)


def test_padded_rows_do_not_change_loss(tiny_params):
    state = tt.init_bn_state()
    users = jnp.asarray([1, 2, 3, 0, 0])
    anime = jnp.asarray([4, 5, 6, 0, 0])
    ratings = jnp.asarray([0.1, 0.5, 0.9, 0.0, 0.0], jnp.float32)
    w = jnp.asarray([1, 1, 1, 0, 0], jnp.float32)
    loss_pad, (mse_pad, _) = tt.loss_and_metrics(
        tiny_params, state, users, anime, ratings, w, 1e-4, True
    )
    loss_ref, (mse_ref, _) = tt.loss_and_metrics(
        tiny_params, state, users[:3], anime[:3], ratings[:3],
        jnp.ones(3, jnp.float32), 1e-4, True,
    )
    np.testing.assert_allclose(float(loss_pad), float(loss_ref), rtol=1e-6)
    np.testing.assert_allclose(float(mse_pad), float(mse_ref), rtol=1e-6)


def make_learnable_dataset(n_users=60, n_anime=40, n=6000, seed=0):
    """Planted low-rank ratings the model can fit."""
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(n_users, 4))
    V = rng.normal(size=(n_anime, 4))
    users = rng.integers(0, n_users, n)
    anime = rng.integers(0, n_anime, n)
    logits = np.einsum("ij,ij->i", U[users], V[anime])
    ratings = (1 / (1 + np.exp(-logits))).astype(np.float32)
    return RatingsDataset(users.astype(np.int32), anime.astype(np.int32), ratings)


def test_training_reduces_loss():
    ds = make_learnable_dataset()
    holdout = RatingsDataset(ds.users[:500], ds.anime[:500], ds.ratings[:500])
    train = RatingsDataset(ds.users[500:], ds.anime[500:], ds.ratings[500:])
    trainer = Trainer(
        embedding_size=16, batch_size=512, epochs=8, patience=8,
        start_lr=3e-3, max_lr=1e-2, min_lr=3e-3, rampup_epochs=2,
        l2_reg_factor=1e-6, verbose=False,
    )
    result = trainer.fit(train, holdout, n_users=60, n_anime=40)
    hist = result.history
    assert hist["loss"].iloc[-1] < hist["loss"].iloc[0] * 0.98
    assert hist["val_mse"].min() < 0.08  # beats predict-the-mean (~0.09+)
    assert list(hist.columns) == ["loss", "mse", "val_loss", "val_mse", "lr"]
    assert result.best_epoch == int(np.argmin(hist["val_loss"].to_numpy()))


def test_early_stopping_and_best_restore():
    ds = make_learnable_dataset(n=2000)
    holdout = RatingsDataset(ds.users[:300], ds.anime[:300], ds.ratings[:300])
    train = RatingsDataset(ds.users[300:], ds.anime[300:], ds.ratings[300:])
    # Absurd LR after ramp forces divergence -> early stop.
    trainer = Trainer(
        embedding_size=8, batch_size=256, epochs=20, patience=2,
        start_lr=1e-3, max_lr=5.0, min_lr=5.0, rampup_epochs=1,
        l2_reg_factor=0.0, verbose=False,
    )
    result = trainer.fit(train, holdout, n_users=60, n_anime=40)
    assert result.epochs_run < 20
    # Restored best state reproduces the recorded best val_loss.
    val_loss, _ = trainer.evaluate(
        result.state.params, result.state.bn_state, holdout
    )
    np.testing.assert_allclose(val_loss, result.best_val_loss, rtol=1e-5)


def test_normalized_tables_rows_unit_norm(tiny_params):
    anime_w, user_w = tt.normalized_tables(tiny_params)
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(anime_w), axis=1), 1.0, atol=1e-5
    )
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(user_w), axis=1), 1.0, atol=1e-5
    )


@pytest.mark.parametrize("mode", [True, "user"])
def test_sorted_scatter_grads_match_plain(tiny_params, mode):
    # The sorted-scatter VJP reorders only the f32 summation over duplicate
    # in-batch ids; gradients must match the plain-gather path numerically.
    bn = tt.init_bn_state()
    rng = np.random.default_rng(3)
    b = 64
    users = jnp.asarray(rng.integers(0, 50, b), jnp.int32)   # many duplicates
    anime = jnp.asarray(rng.integers(0, 30, b), jnp.int32)
    ratings = jnp.asarray(rng.uniform(0, 1, b), jnp.float32)
    weights = jnp.ones(b, jnp.float32)

    def grads(sorted_scatter):
        (_, _), g = jax.value_and_grad(tt.loss_and_metrics, has_aux=True)(
            tiny_params, bn, users, anime, ratings, weights, 1e-4, True,
            sorted_scatter,
        )
        return g

    g0, g1 = grads(False), grads(mode)
    for a, b_ in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b_), atol=1e-6)


def test_normalized_tables_near_zero_rows_stay_finite():
    """The full-table L2 decay drives untouched rows toward zero over long
    fits; once a row's norm-squared underflows f32 (or denormals are flushed),
    raw norm division mints inf/NaN rows that win every retrieval scan
    (round-4 bench caught exactly this: one NaN row capped trained-table
    overlap at 0.9). normalized_tables must clamp like the model's own
    _l2_normalize: tiny rows become ~zero vectors, never inf/NaN, and
    never a top-k hit."""
    import numpy as np

    from anime_recommendations_tpu.models import two_tower as tt
    from anime_recommendations_tpu.ops.topk import cosine_topk

    rng = np.random.default_rng(0)
    user = rng.normal(size=(64, 16)).astype(np.float32)
    user[7] *= 1e-25            # norm^2 underflows f32
    user[8] = 0.0               # exactly zero
    anime = rng.normal(size=(32, 16)).astype(np.float32)
    params = tt.init_params(jax.random.PRNGKey(0), 64, 32, 16)._replace(
        user_emb=jnp.asarray(user), anime_emb=jnp.asarray(anime)
    )
    a_n, u_n = tt.normalized_tables(params)
    a_n, u_n = np.asarray(a_n), np.asarray(u_n)
    assert np.isfinite(u_n).all() and np.isfinite(a_n).all()
    # Degenerate rows are ~zero, so they can never outrank a real match.
    assert np.abs(u_n[7]).max() < 1e-3 and np.abs(u_n[8]).max() == 0.0
    _, idx = cosine_topk(jnp.asarray(u_n), jnp.asarray(u_n[:4]), k=5)
    assert 7 not in np.asarray(idx) and 8 not in np.asarray(idx)

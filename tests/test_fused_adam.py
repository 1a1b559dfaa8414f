"""Sparse Adam update vs the dense optax-equivalent reference."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from anime_recommendations_tpu.ops.fused_adam import sparse_adam_update

B1, B2, EPS = 0.9, 0.999, 1e-7


def dense_reference(w, mu, nu, ids, g_rows, t, lr, l2):
    """Exactly what the trainer's XLA path does: dense grad -> scale_by_adam."""
    dense = jnp.zeros_like(w).at[ids].add(g_rows) + 2.0 * l2 * w
    opt = optax.scale_by_adam(b1=B1, b2=B2, eps=EPS)
    state = optax.ScaleByAdamState(
        count=jnp.asarray(t - 1, jnp.int32), mu=mu, nu=nu
    )
    updates, new_state = opt.update(dense, state, w)
    return w - lr * updates, new_state.mu, new_state.nu


def make_case(n, d, b, seed, dup_heavy=False):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, d)).astype(np.float32) * 0.05
    mu = rng.standard_normal((n, d)).astype(np.float32) * 0.01
    nu = (rng.standard_normal((n, d)).astype(np.float32) * 0.01) ** 2
    hi = max(n // 20, 2) if dup_heavy else n
    ids = rng.integers(0, hi, b).astype(np.int32)
    g = rng.standard_normal((b, d)).astype(np.float32) * 0.1
    return map(jnp.asarray, (w, mu, nu, ids, g))


@pytest.mark.parametrize("dup_heavy", [False, True])
def test_matches_dense_optax(dup_heavy):
    tol = 5e-6
    w, mu, nu, ids, g = make_case(300, 32, 128, seed=0, dup_heavy=dup_heavy)
    t, lr, l2 = 3, jnp.float32(1e-3), 1e-4
    w_ref, mu_ref, nu_ref = dense_reference(w, mu, nu, ids, g, t, lr, l2)
    w2, mu2, nu2, sumsq = sparse_adam_update(
        w, mu, nu, ids, g, jnp.asarray(t), lr, l2=l2, b1=B1, b2=B2, eps=EPS,
    )
    np.testing.assert_allclose(np.asarray(mu2), np.asarray(mu_ref),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(np.asarray(nu2), np.asarray(nu_ref),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(np.asarray(w2), np.asarray(w_ref),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(
        float(sumsq), float(jnp.sum(w * w)), rtol=1e-5
    )


def test_unpadded_shapes_and_step_one():
    # First Adam step (t=1, strongest bias correction); every gradient on
    # one row (maximal duplicate skew).
    w, mu, nu, _, g = make_case(100, 16, 64, seed=1)
    mu = jnp.zeros_like(mu)
    nu = jnp.zeros_like(nu)
    ids = jnp.asarray(np.full(64, 7, np.int32))  # all grads on one row
    t, lr, l2 = 1, jnp.float32(1e-2), 0.0
    w_ref, mu_ref, nu_ref = dense_reference(w, mu, nu, ids, g, t, lr, l2)
    w2, mu2, nu2, _ = sparse_adam_update(
        w, mu, nu, ids, g, jnp.asarray(t), lr, l2=l2, b1=B1, b2=B2, eps=EPS,
    )
    np.testing.assert_allclose(np.asarray(w2), np.asarray(w_ref),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(mu2), np.asarray(mu_ref),
                               rtol=1e-5, atol=1e-7)
    # nu accumulates 64 duplicate-row squares; summation order may differ
    # at the last f32 ulp.
    np.testing.assert_allclose(np.asarray(nu2), np.asarray(nu_ref),
                               rtol=5e-5, atol=1e-9)


def test_sequential_steps_converge_like_dense():
    # Run 5 chained fused steps vs 5 dense steps; trajectories must track.
    w, mu, nu, ids, g = make_case(200, 8, 96, seed=2, dup_heavy=True)
    wf, muf, nuf = w, mu, nu
    wd, mud, nud = w, mu, nu
    for t in range(1, 6):
        wd, mud, nud = dense_reference(wd, mud, nud, ids, g, t,
                                       jnp.float32(1e-3), 1e-4)
        wf, muf, nuf, _ = sparse_adam_update(
            wf, muf, nuf, ids, g, jnp.asarray(t), jnp.float32(1e-3),
            l2=1e-4, b1=B1, b2=B2, eps=EPS,
        )
    np.testing.assert_allclose(np.asarray(wf), np.asarray(wd),
                               rtol=3e-4, atol=3e-5)


# ---- fused_train_step: full training-step parity vs the dense path ---------

from anime_recommendations_tpu.train.fused import fused_train_step
from anime_recommendations_tpu.train.trainer import init_train_state, train_step


def _batch(n_users, n_anime, b, seed):
    rng = np.random.default_rng(seed)
    return (
        jnp.asarray(rng.integers(0, n_users, b), jnp.int32),
        jnp.asarray(rng.integers(0, n_anime, b), jnp.int32),
        jnp.asarray(rng.uniform(0, 1, b), jnp.float32),
        jnp.ones(b, jnp.float32),
    )


def test_fused_train_step_matches_dense_trajectory():
    """Chained fused steps track the dense train_step: params, moments, BN,
    reported loss (incl. the L2 regularizer's value) and mse."""
    n_users, n_anime, d, b, l2 = 150, 40, 16, 64, 1e-4
    lr = jnp.float32(1e-3)
    sf = init_train_state(jax.random.PRNGKey(0), n_users, n_anime, d)
    sd = init_train_state(jax.random.PRNGKey(0), n_users, n_anime, d)
    for step in range(4):
        u, a, r, w = _batch(n_users, n_anime, b, seed=step)
        sd, loss_d, mse_d = train_step(sd, u, a, r, w, lr, l2)
        sf, loss_f, mse_f = fused_train_step(sf, u, a, r, w, lr, l2)
        np.testing.assert_allclose(float(loss_f), float(loss_d),
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(float(mse_f), float(mse_d),
                                   rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(sf.params.user_emb),
                               np.asarray(sd.params.user_emb),
                               rtol=3e-3, atol=2e-5)
    np.testing.assert_allclose(np.asarray(sf.params.anime_emb),
                               np.asarray(sd.params.anime_emb),
                               rtol=3e-3, atol=2e-5)
    np.testing.assert_allclose(np.asarray(sf.params.dense_w),
                               np.asarray(sd.params.dense_w),
                               rtol=1e-3, atol=1e-5)
    # moving_mean is near zero; rtol is meaningless there — bound absolutely.
    np.testing.assert_allclose(np.asarray(sf.bn_state.moving_mean),
                               np.asarray(sd.bn_state.moving_mean),
                               rtol=1e-3, atol=5e-6)
    assert int(sf.opt_state.count) == int(sd.opt_state.count) == 4


def test_fused_adam_in_device_loop_epoch():
    """optimizer='fused_adam' inside the device-resident epoch scan matches
    the dense epoch's loss curve (same data, shuffle off)."""
    from anime_recommendations_tpu.data.dataset import RatingsDataset
    from anime_recommendations_tpu.train import device_loop as dl

    rng = np.random.default_rng(3)
    n_users, n_anime, d, batch, rows, l2 = 120, 30, 8, 50, 400, 1e-4
    ds = RatingsDataset(
        users=rng.integers(0, n_users, rows).astype(np.int32),
        anime=rng.integers(0, n_anime, rows).astype(np.int32),
        ratings=rng.uniform(0, 1, rows).astype(np.float32),
    )
    data = dl.stage(ds, batch, seed=None)
    key = jax.random.PRNGKey(0)
    lr = jnp.float32(1e-3)
    out = {}
    for opt in ("adam", "fused_adam"):
        st = init_train_state(jax.random.PRNGKey(1), n_users, n_anime, d)
        st, losses, mses, wsums = dl.train_epoch(
            st, data, key, lr, batch, l2, shuffle=False, optimizer=opt
        )
        out[opt] = (np.asarray(losses), np.asarray(st.params.user_emb))
    np.testing.assert_allclose(out["fused_adam"][0], out["adam"][0],
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(out["fused_adam"][1], out["adam"][1],
                               rtol=3e-3, atol=2e-5)


def test_bf16_moments_match_dense_with_bf16_rounding():
    """mu/nu stored bf16 (fused_adam_bf16m): the stored moments are the
    dense reference's f32 moments rounded to an adjacent bf16 value
    (stochastic rounding picks one of the two), and the weight update is
    the f32 update from the bf16-read moments."""
    w, mu, nu, ids, g = make_case(300, 32, 128, seed=4)
    mu_b = mu.astype(jnp.bfloat16)
    nu_b = nu.astype(jnp.bfloat16)
    t, lr, l2 = 3, jnp.float32(1e-3), 1e-4
    # Reference: identical math from the bf16-rounded starting moments.
    w_ref, mu_ref, nu_ref = dense_reference(
        w, mu_b.astype(jnp.float32), nu_b.astype(jnp.float32), ids, g, t,
        lr, l2,
    )
    w2, mu2, nu2, sumsq = sparse_adam_update(
        w, mu_b, nu_b, ids, g, jnp.asarray(t), lr, l2=l2, b1=B1, b2=B2,
        eps=EPS,
    )
    assert mu2.dtype == jnp.bfloat16 and nu2.dtype == jnp.bfloat16
    # Within one bf16 ulp (2^-7 relative) of the nearest-rounded value.
    np.testing.assert_allclose(
        np.asarray(mu2, np.float32),
        np.asarray(mu_ref.astype(jnp.bfloat16), np.float32),
        rtol=1 / 128, atol=1e-9,
    )
    np.testing.assert_allclose(np.asarray(w2), np.asarray(w_ref), rtol=5e-5,
                               atol=5e-6)
    np.testing.assert_allclose(
        float(sumsq), float(jnp.sum(jnp.square(w))), rtol=1e-5
    )


def test_trainer_fused_adam_bf16m_fits():
    """End-to-end: the bf16-moment optimizer trains through the device-loop
    epoch path, loss decreases, and the state carries bf16 table moments."""
    from anime_recommendations_tpu.data.dataset import RatingsDataset
    from anime_recommendations_tpu.train.trainer import Trainer

    rng = np.random.default_rng(0)
    n_users, n_anime, n = 300, 120, 40_000
    U = rng.normal(size=(n_users, 4))
    V = rng.normal(size=(n_anime, 4))
    users = rng.integers(0, n_users, n)
    anime = rng.integers(0, n_anime, n)
    y = (1 / (1 + np.exp(-np.einsum("ij,ij->i", U[users], V[anime])))).astype(
        np.float32
    )
    train = RatingsDataset(users[:36_000].astype(np.int32),
                           anime[:36_000].astype(np.int32), y[:36_000])
    holdout = RatingsDataset(users[36_000:].astype(np.int32),
                             anime[36_000:].astype(np.int32), y[36_000:])
    result = Trainer(
        optimizer="fused_adam_bf16m", embedding_size=16, batch_size=2_000,
        epochs=3, patience=3, start_lr=1e-3, max_lr=3e-3, min_lr=1e-3,
        rampup_epochs=1, l2_reg_factor=1e-5, verbose=False,
    ).fit(train, holdout, n_users, n_anime)
    hist = result.history
    assert hist["loss"].iloc[-1] < hist["loss"].iloc[0]
    assert result.state.opt_state.mu.user_emb.dtype == jnp.bfloat16
    assert result.state.opt_state.nu.anime_emb.dtype == jnp.bfloat16
    # Scalar-head moments stay f32.
    assert result.state.opt_state.mu.dense_w.dtype == jnp.float32


# ---- stochastic rounding of bf16 moments -------------------------------------


def test_stochastic_rounding_unbiased_where_nearest_freezes():
    """nu = 1 with g^2 = 2: each step adds (1-b2)*(g^2 - nu) ~ 1e-3, below
    bf16's half-ulp at 1.0 (2^-8). Round-to-nearest drops every increment
    and nu stays frozen at 1; stochastic rounding keeps the bf16 EMA
    unbiased, so its mean tracks the f32 EMA 2 - b2^t."""
    n, d, steps = 64, 128, 200
    w = jnp.zeros((n, d), jnp.float32)
    nu = jnp.ones((n, d), jnp.bfloat16)
    mu = jnp.zeros((n, d), jnp.bfloat16)
    dense = jnp.full((n, d), np.sqrt(2.0), jnp.float32)
    ids = jnp.zeros((1,), jnp.int32)
    g = jnp.zeros((1, d), jnp.float32)
    nu_near = jnp.ones((n, d), jnp.bfloat16)
    for t in range(1, steps + 1):
        w, mu, nu, _ = sparse_adam_update(
            w, mu, nu, ids, g, jnp.asarray(t), jnp.float32(0.0), b1=B1, b2=B2,
            eps=EPS, dense_grad=dense,
        )
        nu_near = (B2 * nu_near.astype(jnp.float32)
                   + (1 - B2) * jnp.square(dense)).astype(jnp.bfloat16)
    f32_ema = 2.0 - B2 ** steps
    assert (np.asarray(nu_near, np.float32) == 1.0).all()
    mean = float(jnp.mean(nu.astype(jnp.float32)))
    assert abs(mean - f32_ema) < 0.01 * f32_ema, (mean, f32_ema)


def test_stochastic_rounding_deterministic_per_step_and_table():
    w, mu, nu, ids, g = make_case(200, 16, 64, seed=5)
    mu, nu = mu.astype(jnp.bfloat16), nu.astype(jnp.bfloat16)

    def run(step, table_id):
        return sparse_adam_update(w, mu, nu, ids, g, jnp.asarray(step),
                                  jnp.float32(1e-3), l2=1e-4,
                                  table_id=table_id)

    a, b = run(4, 0), run(4, 0)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x, np.float32),
                                      np.asarray(y, np.float32))
    other_table, other_step = run(4, 1), run(5, 0)
    assert not np.array_equal(np.asarray(a[2], np.float32),
                              np.asarray(other_table[2], np.float32))
    assert not np.array_equal(np.asarray(a[2], np.float32),
                              np.asarray(other_step[2], np.float32))


@pytest.mark.parametrize("moment_dtype", [jnp.float32, jnp.bfloat16])
def test_sparse_adam_update_under_shard_map(moment_dtype):
    """Row-sharded over the 8-device mesh with shard-local ids (the routed
    trainer's owner-side update): each shard's result equals the update of
    that shard alone, and the psum'd sumsq is the full table's."""
    from jax.sharding import Mesh, PartitionSpec as P

    n_dev, rows, d, b = 8, 40, 16, 24
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("x",))
    rng = np.random.default_rng(6)
    w = jnp.asarray(rng.standard_normal((n_dev * rows, d)).astype(np.float32) * 0.05)
    mu = jnp.asarray(rng.standard_normal((n_dev * rows, d)) * 0.01, moment_dtype)
    nu = jnp.asarray((rng.standard_normal((n_dev * rows, d)) * 0.01) ** 2,
                     moment_dtype)
    ids = jnp.asarray(rng.integers(0, rows, n_dev * b), jnp.int32)
    g = jnp.asarray(rng.standard_normal((n_dev * b, d)).astype(np.float32) * 0.1)
    step, lr = jnp.asarray(2), jnp.float32(1e-3)

    def local(w, mu, nu, ids, g):
        w2, mu2, nu2, ss = sparse_adam_update(w, mu, nu, ids, g, step, lr,
                                              l2=1e-4, table_id=1)
        return w2, mu2, nu2, jax.lax.psum(ss, "x")

    sharded = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(P("x"),) * 5,
        out_specs=(P("x"), P("x"), P("x"), P()),
    ))(w, mu, nu, ids, g)
    for i in range(n_dev):
        r, q = slice(i * rows, (i + 1) * rows), slice(i * b, (i + 1) * b)
        ref = sparse_adam_update(w[r], mu[r], nu[r], ids[q], g[q], step, lr,
                                 l2=1e-4, table_id=1)
        for got, want in zip(sharded[:3], ref[:3]):
            np.testing.assert_allclose(np.asarray(got[r], np.float32),
                                       np.asarray(want, np.float32),
                                       rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(float(sharded[3]), float(jnp.sum(w * w)),
                               rtol=1e-5)

"""ShardedTrainer end-to-end on the virtual CPU mesh."""

import numpy as np
import pytest

from anime_recommendations_tpu.data.dataset import RatingsDataset
from anime_recommendations_tpu.parallel.trainer import ShardedTrainer
from anime_recommendations_tpu.train.trainer import Trainer


def make_ds(n_users=96, n_anime=40, n=8000, seed=0):
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(n_users, 4))
    V = rng.normal(size=(n_anime, 4))
    users = rng.integers(0, n_users, n)
    anime = rng.integers(0, n_anime, n)
    y = (1 / (1 + np.exp(-np.einsum("ij,ij->i", U[users], V[anime])))).astype(np.float32)
    ds = RatingsDataset(users.astype(np.int32), anime.astype(np.int32), y)
    return (
        RatingsDataset(ds.users[1000:], ds.anime[1000:], ds.ratings[1000:]),
        RatingsDataset(ds.users[:1000], ds.anime[:1000], ds.ratings[:1000]),
        n_users,
        n_anime,
    )


def test_sharded_trainer_fits_and_matches_history_schema():
    train, holdout, n_users, n_anime = make_ds()
    trainer = ShardedTrainer(
        data_axis=4, model_axis=2,
        embedding_size=16, batch_size=512, epochs=4, patience=4,
        start_lr=3e-3, max_lr=1e-2, min_lr=3e-3, rampup_epochs=1,
        l2_reg_factor=1e-6, verbose=False,
    )
    result = trainer.fit(train, holdout, n_users, n_anime)
    hist = result.history
    assert list(hist.columns) == ["loss", "mse", "val_loss", "val_mse", "lr"]
    assert hist["loss"].iloc[-1] < hist["loss"].iloc[0]
    # alltoall routing: BOTH tables padded to a multiple of the WHOLE mesh
    # (8 shards); the fitted state comes back host-resident in logical order.
    assert isinstance(result.state.params.user_emb, np.ndarray)
    assert result.state.params.user_emb.shape[0] % 8 == 0
    assert result.state.params.anime_emb.shape[0] % 8 == 0


def test_sharded_trainer_tracks_single_chip_loss():
    train, holdout, n_users, n_anime = make_ds(seed=3)
    kwargs = dict(
        embedding_size=8, batch_size=1024, epochs=3, patience=3,
        start_lr=1e-3, max_lr=3e-3, min_lr=1e-3, rampup_epochs=1,
        l2_reg_factor=1e-5, verbose=False, seed=11,
    )
    single = Trainer(**kwargs).fit(train, holdout, n_users, n_anime)
    sharded = ShardedTrainer(data_axis=2, model_axis=4, **kwargs).fit(
        train, holdout, n_users, n_anime
    )
    # Same seeds, same batch order, exact-parity math: loss curves should
    # agree to f32 reduction noise amplified by a few Adam steps.
    np.testing.assert_allclose(
        single.history["loss"].to_numpy(),
        sharded.history["loss"].to_numpy(),
        rtol=2e-2,
    )


def test_batch_size_must_divide_batch_shards():
    with pytest.raises(ValueError):
        ShardedTrainer(data_axis=8, model_axis=1, batch_size=1001)


def test_psum_routing_still_trains():
    train, holdout, n_users, n_anime = make_ds(n=3000, seed=9)
    result = ShardedTrainer(
        routing="psum", data_axis=4, model_axis=2,
        embedding_size=8, batch_size=512, epochs=2, patience=3,
        start_lr=3e-3, max_lr=3e-3, min_lr=3e-3, rampup_epochs=1,
        l2_reg_factor=1e-6, verbose=False,
    ).fit(train, holdout, n_users, n_anime)
    assert result.history["loss"].iloc[-1] < result.history["loss"].iloc[0]


def test_lazy_adam_requires_alltoall():
    with pytest.raises(ValueError):
        ShardedTrainer(routing="psum", optimizer="lazy_adam",
                       data_axis=4, model_axis=2, batch_size=512)


def test_sharded_lazy_adam_trains_and_matches_single_chip_lazy():
    train, holdout, n_users, n_anime = make_ds(n=4096, seed=12)
    kwargs = dict(
        embedding_size=8, batch_size=1024, epochs=3, patience=3,
        start_lr=1e-3, max_lr=3e-3, min_lr=1e-3, rampup_epochs=1,
        l2_reg_factor=1e-5, verbose=False, seed=4, optimizer="lazy_adam",
    )
    single = Trainer(**kwargs).fit(train, holdout, n_users, n_anime)
    sharded = ShardedTrainer(data_axis=2, model_axis=4, **kwargs).fit(
        train, holdout, n_users, n_anime
    )
    np.testing.assert_allclose(
        single.history["loss"].to_numpy(),
        sharded.history["loss"].to_numpy(),
        rtol=2e-2,
    )


def test_sharded_device_loop_matches_per_step():
    # One-launch-per-epoch SPMD scan vs per-batch SPMD launches: identical
    # batches (shuffle off) must give identical-to-noise history.
    train, holdout, n_users, n_anime = make_ds(n=4096, seed=6)
    kwargs = dict(
        embedding_size=8, batch_size=512, epochs=3, patience=5,
        start_lr=1e-3, max_lr=3e-3, min_lr=1e-3, rampup_epochs=1,
        l2_reg_factor=1e-5, verbose=False, shuffle_each_epoch=False,
        data_axis=4, model_axis=2,
    )
    per_step = ShardedTrainer(**kwargs).fit(train, holdout, n_users, n_anime)
    scanned = ShardedTrainer(device_loop=True, **kwargs).fit(
        train, holdout, n_users, n_anime
    )
    np.testing.assert_allclose(
        per_step.history.to_numpy(), scanned.history.to_numpy(), rtol=2e-4
    )


def test_sharded_device_loop_converges_with_shuffle():
    train, holdout, n_users, n_anime = make_ds(n=6000, seed=7)
    result = ShardedTrainer(
        embedding_size=16, batch_size=512, epochs=5, patience=6,
        start_lr=3e-3, max_lr=1e-2, min_lr=3e-3, rampup_epochs=2,
        l2_reg_factor=1e-6, verbose=False, device_loop=True,
        data_axis=2, model_axis=4, shard_anime=True,
    ).fit(train, holdout, n_users, n_anime)
    hist = result.history
    assert hist["loss"].iloc[-1] < hist["loss"].iloc[0] * 0.98


def test_measured_capacity_matches_default_capacity_losses():
    """capacity=-1 sizes exchange slots from plan_stats of sampled real
    batches; the fitted loss curve must match the 2x-expectation default
    exactly (slot count never changes semantics — overflow rounds are
    accounted exactly)."""
    train, holdout, n_users, n_anime = make_ds(seed=5)
    kwargs = dict(
        data_axis=2, model_axis=4, optimizer="fused_adam",
        embedding_size=8, batch_size=512, epochs=2, patience=2,
        start_lr=1e-3, max_lr=3e-3, min_lr=1e-3, rampup_epochs=1,
        l2_reg_factor=1e-5, verbose=False, seed=11,
    )
    default = ShardedTrainer(**kwargs).fit(train, holdout, n_users, n_anime)
    auto = ShardedTrainer(capacity=-1, **kwargs)
    result = auto.fit(train, holdout, n_users, n_anime)
    # The measured capacity is real and tighter than the 2x default for
    # this uniform workload.
    assert auto.capacity is not None and 8 <= auto.capacity
    assert auto.capacity <= 2 * ((512 // 8 // 8) + 8) + 8
    np.testing.assert_allclose(
        default.history["loss"].to_numpy(),
        result.history["loss"].to_numpy(),
        rtol=1e-5,
    )


def test_sharded_bf16m_tracks_single_chip_bf16m():
    """fused_adam_bf16m on the mesh: the routed owner-side update adapts to
    the state's bf16 moment storage; loss curve tracks the single-chip
    bf16m fit (both round the moments stochastically)."""
    import jax.numpy as jnp

    train, holdout, n_users, n_anime = make_ds(seed=7)
    kwargs = dict(
        optimizer="fused_adam_bf16m", embedding_size=8, batch_size=1024,
        epochs=3, patience=3, start_lr=1e-3, max_lr=3e-3, min_lr=1e-3,
        rampup_epochs=1, l2_reg_factor=1e-5, verbose=False, seed=11,
    )
    single = Trainer(**kwargs).fit(train, holdout, n_users, n_anime)
    trainer = ShardedTrainer(data_axis=2, model_axis=4, **kwargs)
    sharded = trainer.fit(train, holdout, n_users, n_anime)
    assert single.state.opt_state.mu.user_emb.dtype == jnp.bfloat16
    assert sharded.state.opt_state.mu.user_emb.dtype == jnp.bfloat16
    np.testing.assert_allclose(
        single.history["loss"].to_numpy(),
        sharded.history["loss"].to_numpy(),
        rtol=2e-2,
    )

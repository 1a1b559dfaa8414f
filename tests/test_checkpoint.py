"""Checkpoint save/restore + trainer resume."""

import numpy as np

from anime_recommendations_tpu.train.checkpoint import AsyncCheckpointer
from anime_recommendations_tpu.train.trainer import Trainer, init_train_state
from tests.test_sharded_trainer import make_ds
import jax


def test_checkpointer_roundtrip(tmp_path):
    state = init_train_state(jax.random.PRNGKey(0), 20, 10, 8)
    ckptr = AsyncCheckpointer(tmp_path / "ck")
    ckptr.save(3, state)
    ckptr.wait()
    assert ckptr.latest_step() == 3
    restored = ckptr.restore(template=state)
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ckptr.close()


def test_best_only_retention(tmp_path):
    state = init_train_state(jax.random.PRNGKey(0), 20, 10, 8)
    ckptr = AsyncCheckpointer(tmp_path / "ck", max_to_keep=1)
    ckptr.save(0, state)
    ckptr.save(5, state)
    ckptr.wait()
    assert ckptr.latest_step() == 5
    ckptr.close()


def test_trainer_resume(tmp_path):
    train, holdout, n_users, n_anime = make_ds(n=3000)
    kwargs = dict(
        embedding_size=8, batch_size=512, epochs=3, patience=5,
        start_lr=1e-3, max_lr=3e-3, min_lr=1e-3, rampup_epochs=1,
        l2_reg_factor=1e-5, verbose=False,
        checkpoint_dir=str(tmp_path / "ck"),
    )
    first = Trainer(**kwargs).fit(train, holdout, n_users, n_anime)
    assert first.epochs_run == 3

    # Resume continues from the checkpointed epoch, not from scratch.
    kwargs2 = dict(kwargs, epochs=5)
    second = Trainer(**kwargs2).fit(
        train, holdout, n_users, n_anime, resume=True
    )
    assert second.epochs_run <= 5 - (first.best_epoch + 1)
    # Resumed training should not be worse than where we left off.
    assert second.best_val_loss <= first.best_val_loss * 1.05


def test_bf16_leaves_roundtrip_and_only_whole_files(tmp_path):
    """bf16 moments survive the .npz round trip bit-exactly, and the
    directory only ever holds complete, renamed checkpoints."""
    import jax.numpy as jnp

    from anime_recommendations_tpu.train.trainer import cast_table_moments

    state = cast_table_moments(
        init_train_state(jax.random.PRNGKey(1), 20, 10, 8), jnp.bfloat16
    )
    ckptr = AsyncCheckpointer(tmp_path / "ck", max_to_keep=2)
    for step in (1, 2, 3):
        ckptr.save(step, state)
    ckptr.wait()
    names = sorted(p.name for p in (tmp_path / "ck").iterdir())
    assert names == ["step_2.npz", "step_3.npz"]
    restored = ckptr.restore(template=state)
    assert restored.opt_state.mu.user_emb.dtype == jnp.bfloat16
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    ckptr.close()

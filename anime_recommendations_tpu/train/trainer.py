"""Single-program training loop (jitted, donated state).

Replaces the reference's Keras model.fit stack (neural_network.py:141-217):
  * per-epoch LearningRateScheduler  -> lr_for_epoch, lr fed as a traced scalar
  * ModelCheckpoint(best val_loss)   -> best-state retention (+ .npz on disk)
  * EarlyStopping(patience=3,
      restore_best_weights=True)     -> patience counter + best-state restore
  * history csv/json                 -> history frame with the golden header
                                        (",loss,mse,val_loss,val_mse,lr")

One jitted train step with donated state (no host round-trips of the
tables), static batch shapes, Adam expressed as optax.scale_by_adam with
the learning rate applied inside the step so the schedule never retriggers
compilation. Optimizer epsilon matches Keras Adam (1e-7).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd

from anime_recommendations_tpu.data.dataset import RatingsDataset
from anime_recommendations_tpu.models.two_tower import (
    BNState,
    TwoTowerParams,
    init_bn_state,
    init_params,
    loss_and_metrics,
)
from anime_recommendations_tpu.train.schedule import lr_for_epoch

KERAS_ADAM_EPS = 1e-7


class TrainState(NamedTuple):
    params: TwoTowerParams
    bn_state: BNState
    opt_state: Any


@dataclass
class TrainResult:
    state: TrainState
    history: pd.DataFrame
    best_epoch: int
    best_val_loss: float
    epochs_run: int
    examples_per_sec: float


def make_optimizer() -> optax.GradientTransformation:
    return optax.scale_by_adam(b1=0.9, b2=0.999, eps=KERAS_ADAM_EPS)


def init_train_state(
    rng: jax.Array, n_users: int, n_anime: int, embedding_size: int
) -> TrainState:
    params = init_params(rng, n_users, n_anime, embedding_size)
    return TrainState(
        params=params,
        bn_state=init_bn_state(),
        opt_state=make_optimizer().init(params),
    )


def cast_table_moments(state: TrainState, dtype) -> TrainState:
    """Store the EMBEDDING tables' Adam moments in ``dtype`` (bf16 for the
    fused_adam_bf16m optimizer — halves the moment memory traffic; the
    update math stays f32). Scalar-head moments stay f32."""
    opt = state.opt_state

    def cast(p: TwoTowerParams) -> TwoTowerParams:
        return p._replace(
            user_emb=p.user_emb.astype(dtype),
            anime_emb=p.anime_emb.astype(dtype),
        )

    return state._replace(
        opt_state=opt._replace(mu=cast(opt.mu), nu=cast(opt.nu))
    )


@partial(jax.jit, donate_argnums=0, static_argnames=("l2_reg_factor", "merge"))
def train_step(
    state: TrainState,
    users: jax.Array,
    anime: jax.Array,
    ratings: jax.Array,
    weights: jax.Array,
    lr: jax.Array,
    l2_reg_factor: float,
    merge: str = "cosine",
) -> tuple[TrainState, jax.Array, jax.Array]:
    """One SGD step. Returns (new_state, batch_loss, batch_mse)."""
    (loss, (mse, new_bn)), grads = jax.value_and_grad(
        loss_and_metrics, has_aux=True
    )(state.params, state.bn_state, users, anime, ratings, weights,
      l2_reg_factor, True, False, merge)
    updates, new_opt = make_optimizer().update(grads, state.opt_state, state.params)
    updates = jax.tree.map(lambda u: -lr * u, updates)
    new_params = optax.apply_updates(state.params, updates)
    return TrainState(new_params, new_bn, new_opt), loss, mse


@partial(jax.jit, static_argnames=("l2_reg_factor", "merge"))
def eval_step(
    params: TwoTowerParams,
    bn_state: BNState,
    users: jax.Array,
    anime: jax.Array,
    ratings: jax.Array,
    weights: jax.Array,
    l2_reg_factor: float,
    merge: str = "cosine",
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Weighted sums for exact epoch-level validation aggregates."""
    loss, (mse, _) = loss_and_metrics(
        params, bn_state, users, anime, ratings, weights, l2_reg_factor, False,
        False, merge,
    )
    w = jnp.sum(weights)
    return loss * w, mse * w, w


@dataclass
class Trainer:
    embedding_size: int = 128
    l2_reg_factor: float = 1e-4
    batch_size: int = 10_000
    epochs: int = 20
    start_lr: float = 1e-5
    max_lr: float = 5e-5
    min_lr: float = 1e-5
    rampup_epochs: int = 5
    sustain_epochs: int = 0
    exp_decay: float = 0.8
    patience: int = 3
    seed: int = 0
    shuffle_each_epoch: bool = True
    verbose: bool = True
    checkpoint_dir: str | None = None
    log_fn: Any = field(default=print)
    # Run each epoch as ONE device program (train/device_loop.py): data
    # stays resident on device, shuffling is device-side, and host launch
    # overhead is paid once per epoch instead of once per batch. Same math;
    # only the shuffle's RNG differs from the per-step path.
    device_loop: bool = False
    # Sorted-scatter embedding VJP in the device loop (True = both tables,
    # "user" = big table only, False = plain). Changes only f32 summation
    # order over duplicate in-batch ids.
    sorted_scatter: bool | str = True
    # "adam" = exact Keras-parity dense Adam (full-table L2 every step).
    # "lazy_adam" = row-sparse Adam (train/lazy.py): only touched rows get
    # moments/decay/updates — the TF-Addons-LazyAdam semantics used by
    # production recommenders. Much faster at scale; documented deviations.
    # "fused_adam" = dense-Adam SEMANTICS from the gathered rows' grads
    # (train/fused.py, ops/fused_adam.sparse_adam_update): same math as
    # "adam" up to f32 summation order.
    # "fused_adam_bf16m" = fused_adam with the embedding-table Adam
    # moments STORED bf16 (update math stays f32), halving the moments'
    # memory traffic. The stores use STOCHASTIC rounding on every backend
    # (ops/fused_adam.stochastic_round_bf16): nearest-rounded bf16
    # silently freezes nu's 1e-3-relative EMA increments; SR keeps the
    # EMA unbiased. Scalar-head moments stay f32. Also accepted by
    # ShardedTrainer (the routed owner-side fused update adapts by the
    # state's moment dtype).
    optimizer: str = "adam"
    # "cosine" = the reference's Dot(normalize=True) head (parity).
    # "dot" = diagnostic unnormalized-dot head (two_tower.dot_merge) for
    # attributing the convergence-floor gap; per-step path only.
    merge: str = "cosine"

    def __post_init__(self):
        if self.optimizer not in ("adam", "lazy_adam", "fused_adam",
                                  "fused_adam_bf16m"):
            raise ValueError(
                f"unknown optimizer {self.optimizer!r}: choose 'adam' "
                "(exact Keras parity), 'fused_adam' (same semantics from "
                "row gradients), 'fused_adam_bf16m' (bf16-stored table "
                "moments), or 'lazy_adam' (row-sparse)"
            )
        if self.merge not in ("cosine", "dot"):
            raise ValueError(f"unknown merge {self.merge!r}")
        if self.merge != "cosine" and (self.device_loop or
                                       self.optimizer != "adam"):
            raise ValueError(
                "merge='dot' is a per-step-path diagnostic: use "
                "optimizer='adam' with device_loop=False"
            )

    # ---- overridable backend hooks (ShardedTrainer overrides these) -----------

    def _init_state(self, rng, n_users: int, n_anime: int) -> TrainState:
        state = init_train_state(rng, n_users, n_anime, self.embedding_size)
        if self.optimizer == "fused_adam_bf16m":
            state = cast_table_moments(state, jnp.bfloat16)
        return state

    def _train_step(self, state, batch, lr):
        if self.optimizer == "lazy_adam":
            from anime_recommendations_tpu.train.lazy import lazy_train_step

            return lazy_train_step(
                state, batch.users, batch.anime, batch.ratings,
                batch.weights, lr, self.l2_reg_factor,
            )
        if self.optimizer in ("fused_adam", "fused_adam_bf16m"):
            from anime_recommendations_tpu.train.fused import fused_train_step

            return fused_train_step(
                state, batch.users, batch.anime, batch.ratings,
                batch.weights, lr, self.l2_reg_factor,
            )
        return train_step(
            state, batch.users, batch.anime, batch.ratings, batch.weights,
            lr, self.l2_reg_factor, self.merge,
        )

    def _eval_sums(self, params, bn_state, batch):
        return eval_step(
            params, bn_state, batch.users, batch.anime, batch.ratings,
            batch.weights, self.l2_reg_factor, self.merge,
        )

    def lr(self, epoch: int) -> float:
        return lr_for_epoch(
            epoch,
            start_lr=self.start_lr,
            max_lr=self.max_lr,
            min_lr=self.min_lr,
            rampup_epochs=self.rampup_epochs,
            sustain_epochs=self.sustain_epochs,
            exp_decay=self.exp_decay,
        )

    def fit(
        self,
        train: RatingsDataset,
        holdout: RatingsDataset,
        n_users: int,
        n_anime: int,
        initial_state: TrainState | None = None,
        resume: bool = False,
    ) -> TrainResult:
        """Train with early stopping; ``resume=True`` restores the latest
        checkpoint under checkpoint_dir (epoch-level resume — a
        capability the reference lacks, SURVEY.md §5.4)."""
        rng = jax.random.PRNGKey(self.seed)
        state = initial_state or self._init_state(rng, n_users, n_anime)
        start_epoch = 0
        if resume and self.checkpoint_dir is not None and initial_state is None:
            restored = self._try_restore(state)
            if restored is not None:
                state, start_epoch = restored

        staged = self._stage_device(train, holdout) if self.device_loop else None

        ckptr = None
        if self.checkpoint_dir is not None:
            from anime_recommendations_tpu.train.checkpoint import AsyncCheckpointer

            ckptr = AsyncCheckpointer(self.checkpoint_dir)

        best_val = float("inf")
        best_epoch = -1
        best_params = state.params
        best_bn = state.bn_state
        bad_epochs = 0
        rows = []
        examples_seen = 0
        t0 = time.perf_counter()

        for epoch in range(start_epoch, self.epochs):
            lr = jnp.float32(self.lr(epoch))
            if staged is not None:
                (state, loss_sum, mse_sum, w_total,
                 val_loss, val_mse) = self._device_epoch(staged, state, epoch, lr)
            else:
                # Device scalars are accumulated without host sync; the
                # transfer happens once per epoch so the step pipeline
                # never stalls.
                losses, mses, bws = [], [], []
                for batch in train.iter_batches(
                    self.batch_size,
                    shuffle=self.shuffle_each_epoch,
                    seed=self.seed * 1000 + epoch,
                ):
                    state, loss, mse = self._train_step(state, batch, lr)
                    losses.append(loss)
                    mses.append(mse)
                    bws.append(batch.weights.sum())
                bw_arr = np.asarray(bws, np.float64)
                loss_sum = float(np.asarray(jnp.stack(losses)) @ bw_arr)
                mse_sum = float(np.asarray(jnp.stack(mses)) @ bw_arr)
                w_total = float(bw_arr.sum())
                val_loss, val_mse = self.evaluate(
                    state.params, state.bn_state, holdout
                )
            examples_seen += int(w_total)
            rows.append(
                {
                    "loss": loss_sum / max(w_total, 1.0),
                    "mse": mse_sum / max(w_total, 1.0),
                    "val_loss": val_loss,
                    "val_mse": val_mse,
                    "lr": float(lr),
                }
            )
            if self.verbose:
                self.log_fn(
                    f"epoch {epoch}: loss={rows[-1]['loss']:.5f} "
                    f"mse={rows[-1]['mse']:.5f} val_loss={val_loss:.5f} "
                    f"val_mse={val_mse:.5f} lr={float(lr):.3g}"
                )

            # Best-checkpoint retention + early stopping (patience, min mode).
            if val_loss < best_val:
                best_val = val_loss
                best_epoch = epoch
                best_params = jax.tree.map(jnp.copy, state.params)
                best_bn = jax.tree.map(jnp.copy, state.bn_state)
                bad_epochs = 0
                if ckptr is not None:
                    ckptr.save(
                        epoch, TrainState(best_params, best_bn, state.opt_state)
                    )
            else:
                bad_epochs += 1
                if bad_epochs >= self.patience:
                    if self.verbose:
                        self.log_fn(f"early stop at epoch {epoch} (patience {self.patience})")
                    break

        elapsed = time.perf_counter() - t0
        if ckptr is not None:
            ckptr.wait()
        # restore_best_weights=True semantics.
        state = TrainState(best_params, best_bn, state.opt_state)
        history = pd.DataFrame(rows)
        return TrainResult(
            state=state,
            history=history,
            best_epoch=best_epoch,
            best_val_loss=best_val,
            epochs_run=len(rows),
            examples_per_sec=examples_seen / max(elapsed, 1e-9),
        )

    # ---- device-resident epoch hooks (ShardedTrainer overrides these) ---------

    def _stage_device(self, train: RatingsDataset, holdout: RatingsDataset):
        from anime_recommendations_tpu.train import device_loop as dl

        bs = min(self.batch_size, max(len(train), 1))
        eval_bs = self._eval_batch_size(len(holdout))
        stage_seed = self.seed if self.shuffle_each_epoch else None
        return (
            dl.stage(train, bs, seed=stage_seed),
            dl.stage(holdout, eval_bs),
            bs, eval_bs,
        )

    def _device_epoch(self, staged, state, epoch: int, lr):
        """One staged epoch + holdout eval. Returns
        (state, loss_sum, mse_sum, w_total, val_loss, val_mse)."""
        from anime_recommendations_tpu.train import device_loop as dl

        train_data, holdout_data, bs, eval_bs = staged
        key = jax.random.fold_in(jax.random.PRNGKey(self.seed), epoch)
        state, ep_losses, ep_mses, ep_ws = dl.train_epoch(
            state, train_data, key, lr, bs, self.l2_reg_factor,
            shuffle=self.shuffle_each_epoch,
            sorted_scatter=self.sorted_scatter,
            optimizer=self.optimizer,
        )
        bw_arr = np.asarray(ep_ws, np.float64)
        loss_sum = float(np.asarray(ep_losses) @ bw_arr)
        mse_sum = float(np.asarray(ep_mses) @ bw_arr)
        w_total = float(bw_arr.sum())
        vl, vm = dl.eval_epoch(
            state.params, state.bn_state, holdout_data, eval_bs,
            self.l2_reg_factor,
        )
        return state, loss_sum, mse_sum, w_total, float(vl), float(vm)

    def evaluate(
        self, params: TwoTowerParams, bn_state: BNState, ds: RatingsDataset
    ) -> tuple[float, float]:
        loss_sum = jnp.float32(0)
        mse_sum = jnp.float32(0)
        w_sum = jnp.float32(0)
        for batch in ds.iter_batches(self._eval_batch_size(len(ds)), shuffle=False):
            ls, ms, w = self._eval_sums(params, bn_state, batch)
            loss_sum += ls
            mse_sum += ms
            w_sum += w
        w = float(np.maximum(float(w_sum), 1.0))
        return float(loss_sum) / w, float(mse_sum) / w

    def _eval_batch_size(self, n_rows: int) -> int:
        return min(self.batch_size, max(n_rows, 1))

    def _try_restore(self, template: TrainState) -> tuple[TrainState, int] | None:
        from anime_recommendations_tpu.train.checkpoint import AsyncCheckpointer

        ckptr = AsyncCheckpointer(self.checkpoint_dir)
        step = ckptr.latest_step()
        if step is None:
            return None
        state = ckptr.restore(step, template=template)
        if self.verbose:
            self.log_fn(f"resumed from checkpoint epoch {step}")
        return state, step + 1

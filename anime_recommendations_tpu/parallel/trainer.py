"""Multi-chip trainer: the single-chip epoch loop over SPMD steps.

Drop-in replacement for train.Trainer on a ('data','model') mesh. Handles:
  * table row padding to a shard multiple (zero rows are inert under the
    L2 term — parallel/mesh.pad_table); in all-to-all routing mode BOTH
    tables are sharded over the WHOLE mesh in the mod-striped physical
    layout (parallel/routing.py)
  * state placement with NamedShardings (striping included) and
    de-striping of the fitted state back to logical row order
  * global batches sharded over the step's batch axes ('data' in psum
    mode, the whole mesh in alltoall mode)
  * optimizer="lazy_adam": owner-side row-sparse Adam on the routed path
    (routing.route_grads_lazy_adam) — per-step table traffic stays
    O(touched rows), never O(table)
  * optimizer="fused_adam" (production): owner-side fused dense-Adam —
    per-unique-row grad sums routed home (routing.route_grad_rows), one
    sparse_adam_update per local table shard, exact dense semantics even
    under multi-round overflow

The reference scaled lr/batch by num_replicas_in_sync but then never used
the scaled values (neural_network.py:176-177 vs :213 — dead code, SURVEY.md
§3.2); here scaling is explicit and opt-in via scale_lr_by_data_shards.

Checkpoints written during a sharded fit hold the mesh-PHYSICAL layout
(resume must use the same mesh shape); the returned TrainResult.state is
always host-resident in LOGICAL row order (allgathered when the mesh
spans processes). Both properties are exercised by a real 2-OS-process
fit + same-mesh restore in tests/test_distributed.py
(test_two_process_full_fit_matches_single_process).
"""

from __future__ import annotations

from dataclasses import dataclass

from anime_recommendations_tpu.parallel import routing as rt
from anime_recommendations_tpu.parallel.mesh import (
    MODEL_AXIS,
    make_mesh,
    pad_rows_for_shards,
)
from anime_recommendations_tpu.parallel.sharded_train import (
    ShardedTrainStep,
    build_epoch_fn,
    build_plans_fn,
    place_state,
    unstripe_state,
)
from anime_recommendations_tpu.train.trainer import (
    Trainer,
    TrainResult,
    TrainState,
    init_train_state,
)


@dataclass
class ShardedTrainer(Trainer):
    data_axis: int = -1
    model_axis: int = 1
    shard_anime: bool = False
    scale_lr_by_data_shards: bool = False
    # "alltoall" (default): tables sharded over the whole mesh, lookups
    # routed so each row crosses the wire once. "psum": legacy dense
    # [B, D] all-reduce routing over 'model' (comparison baseline).
    routing: str = "alltoall"
    # Per-(sender, owner) all-to-all slot count; None = auto (2x the uniform
    # expectation, routing.default_capacity); -1 = MEASURED per fit: sample
    # real batches through routing.plan_stats and size slots to the
    # observed max bucket (+25% + 8 skew margin) — on uniform batches this
    # halves the exchange's row movement vs the 2x-expectation default,
    # and a rare overflow still
    # resolves exactly via an extra round. Lower = less wire per round but
    # more overflow rounds under skew; see the plan-stats log.
    capacity: int | None = None

    def __post_init__(self):
        super().__post_init__()  # optimizer validation
        # bf16+stochastic-rounding moments ride the fused_adam machinery
        # untouched: the moments' dtype in the placed STATE drives the
        # update's stores (ops/fused_adam.sparse_adam_update), so normalize
        # the name here and cast at _init_state.
        self._bf16_moments = self.optimizer == "fused_adam_bf16m"
        if self._bf16_moments:
            self.optimizer = "fused_adam"
        self._auto_capacity = self.capacity == -1
        if self._auto_capacity:
            self.capacity = None  # placeholder until fit measures
        self.mesh = make_mesh(self.data_axis, self.model_axis)
        self._n_model = self.mesh.shape[MODEL_AXIS]
        self._n_data = self.mesh.shape["data"]
        n_dev = int(self.mesh.devices.size)
        # Shards the batch splits over / tables split over.
        self._n_batch_shards = n_dev if self.routing == "alltoall" else self._n_data
        self._n_table_shards = n_dev if self.routing == "alltoall" else self._n_model
        if self.batch_size % self._n_batch_shards:
            raise ValueError(
                f"batch_size {self.batch_size} must divide by batch shards "
                f"{self._n_batch_shards}"
            )
        self._step = ShardedTrainStep(
            self.mesh,
            l2_reg_factor=self.l2_reg_factor,
            shard_anime=self.shard_anime,
            routing=self.routing,
            optimizer=self.optimizer,
            capacity=self.capacity,
        )
        if self.verbose:
            self._log_comm_budget()

    def _effective_capacity(self) -> int:
        b_dev = max(self.batch_size // self._n_batch_shards, 1)
        return self._step._capacity(b_dev) if self.routing == "alltoall" else 0

    def _log_comm_budget(self):
        b_dev = max(self.batch_size // self._n_batch_shards, 1)
        m = self._n_table_shards
        cap = self._effective_capacity() or rt.default_capacity(b_dev, m)
        a2a = rt.exchange_comm_bytes(b_dev, self.embedding_size, m, cap)
        ps = rt.psum_comm_bytes(
            max(self.batch_size // max(self._n_data, 1), 1),
            self.embedding_size, max(self._n_model, 2),
        )
        self.log_fn(
            f"routing={self.routing}: per-device per-table lookup comm "
            f"~{a2a/1e6:.2f} MB/step (all-to-all, capacity {cap}) vs "
            f"~{ps/1e6:.2f} MB/step (psum block all-reduce)"
        )

    def _log_plan_stats(self, train):
        """Measured (not estimated) routing stats on sampled real batches:
        unique ids, the largest per-owner request bucket, and the all-to-all
        round count the exchange will take at the configured capacity
        (routing.plan_stats — 1 round is the steady state; >1 means skew
        overflowed capacity and lazy-Adam semantics split per round)."""
        import numpy as np

        if self.routing != "alltoall":
            return
        m = self._n_table_shards
        bs = min(self.batch_size, max(len(train), 1))
        b_dev = max(bs // self._n_batch_shards, 1)
        cap = self._step._capacity(b_dev)
        rng = np.random.default_rng(self.seed)
        n = len(train)
        for name, ids in (("user", train.users), ("anime", train.anime)):
            rounds_seen = []
            for _ in range(min(4, max(n // bs, 1))):
                sel = rng.choice(n, size=min(bs, n), replace=False)
                # Per-device plan: stats for one device's batch shard.
                shard = ids[sel][:b_dev]
                uniq, mx, rounds = rt.plan_stats(shard, m, cap)
                rounds_seen.append(int(rounds))
                self.log_fn(
                    f"plan[{name}]: B/dev={b_dev} unique={int(uniq)} "
                    f"max_bucket={int(mx)} capacity={cap} rounds={int(rounds)}"
                )
            if max(rounds_seen) > 1:
                self.log_fn(
                    f"plan[{name}]: WARNING skew overflow — raise "
                    f"parallel.capacity above {cap} to keep 1-round exchanges"
                )

    # ---- backend hooks --------------------------------------------------------

    def _init_state(self, rng, n_users: int, n_anime: int) -> TrainState:
        m = self._n_table_shards
        n_users_p = pad_rows_for_shards(n_users, m)
        shard_anime = self.shard_anime or self.routing == "alltoall"
        n_anime_p = pad_rows_for_shards(n_anime, m) if shard_anime else n_anime
        state = init_train_state(rng, n_users_p, n_anime_p, self.embedding_size)
        if self._bf16_moments:
            from anime_recommendations_tpu.train.trainer import (
                cast_table_moments,
            )
            import jax.numpy as jnp

            state = cast_table_moments(state, jnp.bfloat16)
        return place_state(state, self.mesh, self.shard_anime, self.routing)

    def _measure_capacity(self, train) -> int:
        """Slot count from MEASURED per-owner buckets of sampled batches
        (capacity=-1): max bucket over both tables' sampled device shards,
        +25% + 8 margin, rounded up to 8. Exactness never depends on the
        choice — an underestimate costs extra exchange rounds, which
        route_grad_rows accounts exactly."""
        import numpy as np

        m = self._n_table_shards
        bs = min(self.batch_size, max(len(train), 1))
        b_dev = max(bs // self._n_batch_shards, 1)
        rng = np.random.default_rng(self.seed)
        n = len(train)
        worst = 1
        for ids in (train.users, train.anime):
            for _ in range(min(8, max(n // bs, 1))):
                sel = rng.choice(n, size=min(bs, n), replace=False)
                _, mx, _ = rt.plan_stats(
                    ids[sel][:b_dev], m, rt.default_capacity(b_dev, m)
                )
                worst = max(worst, int(mx))
        cap = -(-(worst + worst // 4 + 8) // 8) * 8
        return max(8, min(b_dev, cap))

    def fit(self, *args, **kwargs) -> TrainResult:
        if self._auto_capacity and args and self.routing == "alltoall":
            cap = self._measure_capacity(args[0])
            if self.verbose:
                self.log_fn(f"measured capacity: {cap} slots/(sender,owner)")
            self.capacity = cap
            self._step = ShardedTrainStep(
                self.mesh,
                l2_reg_factor=self.l2_reg_factor,
                shard_anime=self.shard_anime,
                routing=self.routing,
                optimizer=self.optimizer,
                capacity=cap,
            )
        if self.verbose and args:
            self._log_plan_stats(args[0])
        result = super().fit(*args, **kwargs)
        result.state = unstripe_state(result.state, self.mesh, self.routing)
        return result

    def _train_step(self, state, batch, lr):
        if self.scale_lr_by_data_shards:
            lr = lr * self._n_batch_shards
        return self._step.train_step(
            state, batch.users, batch.anime, batch.ratings, batch.weights, lr
        )

    def _eval_sums(self, params, bn_state, batch):
        return self._step.eval_sums(
            params, bn_state, batch.users, batch.anime, batch.ratings,
            batch.weights,
        )

    def _eval_batch_size(self, n_rows: int) -> int:
        k = self._n_batch_shards
        size = min(self.batch_size, max(n_rows, k))
        return max(size - size % k, k)

    # ---- device-resident SPMD epoch (one launch per epoch) ---------------------

    def _stage_device(self, train, holdout):
        """Stage train AND holdout as [nb, B] arrays with B sharded over the
        batch axes; the epoch fn scans train steps and the holdout eval in
        ONE device program (sharded_train.build_epoch_fn).

        Rows are host-shuffled once (seeded), fixing batch COMPOSITION for
        the run; per-epoch shuffling permutes batch order on device.
        Re-mixing examples across sharded batches each epoch would pay
        cross-shard all-to-alls; with the seeded host shuffle each batch is
        already a uniform random sample.
        """
        import numpy as np
        from jax.sharding import NamedSharding, PartitionSpec as P

        from anime_recommendations_tpu.parallel.sharded_train import put_global

        sh = NamedSharding(self.mesh, P(None, self._step._baxes))

        def stage(ds, bs, order):
            n = len(ds)
            nb = max(-(-n // bs), 1)
            pad = nb * bs - n

            def put(x, dtype):
                return put_global(
                    np.pad(x[order], (0, pad)).astype(dtype).reshape(nb, bs), sh
                )

            return (
                put(ds.users, np.int32),
                put(ds.anime, np.int32),
                put(ds.ratings, np.float32),
                put_global(
                    np.pad(np.ones(n, np.float32), (0, pad)).reshape(nb, bs), sh
                ),
            )

        bs = min(self.batch_size, max(len(train), 1))
        bs = max(bs - bs % self._n_batch_shards, self._n_batch_shards)
        order = (
            np.random.default_rng(self.seed).permutation(len(train))
            if self.shuffle_each_epoch else np.arange(len(train))
        )
        train_arrays = stage(train, bs, order)
        ev_arrays = stage(
            holdout, self._eval_batch_size(len(holdout)), np.arange(len(holdout))
        )
        # Routed owner-side optimizers: precompute every batch's exchange
        # plan ONCE per fit (sharded_train.build_plans_fn) — batch
        # composition is frozen above, so the plans stay valid for every
        # epoch and the per-step plan machinery leaves the scan body.
        planned = self._step._train_planned_mapped is not None
        plans = (
            build_plans_fn(self._step)(train_arrays[0], train_arrays[1])
            if planned else None
        )
        epoch_fn = build_epoch_fn(self._step, self.shuffle_each_epoch, planned)
        return (train_arrays, plans, ev_arrays, epoch_fn)

    def _device_epoch(self, staged, state, epoch: int, lr):
        import jax as _jax
        import jax.numpy as jnp
        import numpy as np

        train_arrays, plans, ev_arrays, epoch_fn = staged
        if self.scale_lr_by_data_shards:
            lr = lr * self._n_batch_shards
        key = _jax.random.fold_in(_jax.random.PRNGKey(self.seed), epoch)
        extra = {} if plans is None else {
            "plans_u": plans[0], "plans_a": plans[1]
        }
        state, losses, mses, wsums, val_loss, val_mse = epoch_fn(
            state, *train_arrays, ev_arrays, key, jnp.float32(lr), **extra
        )
        bw = np.asarray(wsums, np.float64)
        loss_sum = float(np.asarray(losses) @ bw)
        mse_sum = float(np.asarray(mses) @ bw)
        return (
            state, loss_sum, mse_sum, float(bw.sum()),
            float(val_loss), float(val_mse),
        )

"""SPMD training step: row-sharded embedding tables over a 2-axis mesh.

Replacement for the reference's data-parallel-only distribution-strategy
training (neural_network.py:142-178). Two routing modes
(SURVEY.md §2 parallelism table, BASELINE.json north star):

``routing="alltoall"`` (default, the production path):
  * batch           : split over the WHOLE mesh ('data','model')
  * user table      : row-sharded over the WHOLE mesh, MOD-STRIPED
                      physical layout (parallel/routing.py) so popular
                      low-id rows spread across shards
  * anime table     : likewise sharded over the whole mesh
  * head + BN       : replicated
  Lookups are routed with all-to-all collectives: each row crosses the
  interconnect ONCE to its requester (deduped per sender), and the VJP
  routes per-row gradient sums back to the single owning shard — no dense
  table gradient ever crosses the wire. Comm per device per step is
  ~2 * (B/m) * D floats (requestward + response), shrinking with shard
  count, vs the psum path's constant 2 * B_local * D.

``routing="psum"`` (legacy, kept for comparison benchmarks):
  * batch over 'data', user table row-sharded over 'model' only, anime
    replicated; every shard gathers against the full local batch and an
    all-reduce over 'model' assembles rows. Simple, and fine at
    model<=2; its dense [B, D] psum and the data-axis reduction of the
    table-shard gradient do not scale.

Gradient reduction: grads of replicated leaves (head, BN; plus the anime
table in psum mode) are reduced over the batch axes by the vma-aware
shard_map transpose of the psum'd loss. The Keras-style L2 term
(full-table) is added analytically as 2*lambda*W AFTER that reduction —
exact, and it keeps per-shard autodiff free of cross-shard regularizer
terms. In alltoall mode each table row has exactly ONE physical copy, so
table grads need no cross-device reduction at all.

BatchNorm uses GLOBAL batch statistics (psum over the batch axes), so the
multi-chip step is bit-compatible with the single-chip math — a deliberate
deviation from TF's per-replica default, recorded in SURVEY.md hard
part (d).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

from anime_recommendations_tpu.models.two_tower import (
    KERAS_BN_EPS,
    KERAS_BN_MOMENTUM,
    BNState,
    TwoTowerParams,
    bce,
    cosine_merge,
)
from anime_recommendations_tpu.parallel import routing as rt
from anime_recommendations_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS
from anime_recommendations_tpu.train.trainer import TrainState, make_optimizer

FULL_AXES = (DATA_AXIS, MODEL_AXIS)


def param_specs(shard_anime: bool = False, routing: str = "alltoall") -> TwoTowerParams:
    """PartitionSpecs for each model leaf."""
    if routing == "alltoall":
        table = P(FULL_AXES, None)
        return TwoTowerParams(
            user_emb=table, anime_emb=table,
            dense_w=P(), dense_b=P(), bn_gamma=P(), bn_beta=P(),
        )
    return TwoTowerParams(
        user_emb=P(MODEL_AXIS, None),
        anime_emb=P(MODEL_AXIS, None) if shard_anime else P(),
        dense_w=P(),
        dense_b=P(),
        bn_gamma=P(),
        bn_beta=P(),
    )


def state_specs(shard_anime: bool = False, routing: str = "alltoall") -> TrainState:
    p = param_specs(shard_anime, routing)
    bn = BNState(moving_mean=P(), moving_var=P())
    opt = optax.ScaleByAdamState(count=P(), mu=p, nu=p)
    return TrainState(params=p, bn_state=bn, opt_state=opt)


def state_shardings(mesh, shard_anime: bool = False, routing: str = "alltoall") -> TrainState:
    return jax.tree.map(
        lambda spec: NamedSharding(mesh, spec),
        state_specs(shard_anime, routing),
        is_leaf=lambda x: isinstance(x, P),
    )


def _map_tables(state: TrainState, fn) -> TrainState:
    """Apply ``fn`` to every user/anime table leaf (params + Adam moments)."""
    def on_params(p: TwoTowerParams) -> TwoTowerParams:
        return p._replace(user_emb=fn(p.user_emb), anime_emb=fn(p.anime_emb))

    opt = state.opt_state
    return TrainState(
        params=on_params(state.params),
        bn_state=state.bn_state,
        opt_state=optax.ScaleByAdamState(
            count=opt.count, mu=on_params(opt.mu), nu=on_params(opt.nu)
        ),
    )


def put_global(x, sharding):
    """Place identical host data under a (possibly multi-host) sharding.

    Single-process shardings take the plain device_put path; a sharding
    with non-addressable devices (a mesh spanning processes) goes through
    make_array_from_callback — every process holds the SAME host value and
    materializes only the shards its own devices own (the pattern of
    parallel/distributed.worker_step, generalized)."""
    if getattr(sharding, "is_fully_addressable", True):
        return jax.device_put(x, sharding)
    host = np.asarray(x)
    return jax.make_array_from_callback(
        host.shape, sharding, lambda idx: host[idx]
    )


def to_host(x) -> np.ndarray:
    """Fetch a (possibly multi-host) array to every process' host memory.

    Fully-addressable arrays are a plain np.asarray; cross-process arrays
    are allgathered so every process sees the full value (the multi-host
    analog of pulling the fitted state off-device)."""
    if getattr(x, "is_fully_addressable", True):
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def place_state(
    state: TrainState, mesh, shard_anime: bool = False, routing: str = "alltoall"
) -> TrainState:
    """Place a LOGICAL-order TrainState onto the mesh (multi-host safe).

    In alltoall mode both tables are permuted to the mod-striped physical
    layout first (routing.to_physical) so the contiguous NamedSharding
    split realizes the striping. Table row counts must already be padded
    to a multiple of the shard count (parallel.mesh.pad_rows_for_shards).
    """
    if routing == "alltoall":
        m = mesh.devices.size
        state = _map_tables(
            state, lambda t: rt.to_physical(np.asarray(t), m)
        )
    return jax.tree.map(
        put_global, state, state_shardings(mesh, shard_anime, routing)
    )


def unstripe_state(state: TrainState, mesh, routing: str = "alltoall") -> TrainState:
    """Pull a mesh-placed TrainState to host in LOGICAL row order (cross-
    process arrays are allgathered so every host gets the full tables)."""
    state = jax.tree.map(to_host, state)
    if routing == "alltoall":
        m = mesh.devices.size
        state = _map_tables(state, lambda t: rt.from_physical(t, m))
    return state


def _sharded_lookup(table_local: jax.Array, idx: jax.Array, axis: str) -> jax.Array:
    """Legacy psum routing: masked local gather + psum(axis) of the dense
    [B, D] block (contiguous block layout over 'model')."""
    rows_local = table_local.shape[0]
    shard = jax.lax.axis_index(axis)
    local = idx - shard * rows_local
    owned = (local >= 0) & (local < rows_local)
    safe = jnp.clip(local, 0, rows_local - 1)
    gathered = table_local[safe] * owned[:, None].astype(table_local.dtype)
    return jax.lax.psum(gathered, axis)


class ShardedTrainStep:
    """Compiled SPMD train/eval steps over a ('data','model') mesh."""

    def __init__(
        self,
        mesh,
        l2_reg_factor: float = 1e-4,
        shard_anime: bool = False,
        routing: str = "alltoall",
        optimizer: str = "adam",
        capacity: int | None = None,
    ):
        if routing not in ("alltoall", "psum"):
            raise ValueError(f"unknown routing {routing!r}")
        if optimizer not in ("adam", "lazy_adam", "fused_adam"):
            raise ValueError(
                f"unknown sharded optimizer {optimizer!r}: choose 'adam', "
                "'lazy_adam', or 'fused_adam'"
            )
        if optimizer in ("lazy_adam", "fused_adam") and routing != "alltoall":
            raise ValueError(
                f"{optimizer} requires routing='alltoall' (owner-side "
                "updates need the exchange plan; the psum path has no row "
                "ownership for the gathered block)"
            )
        self.mesh = mesh
        self.l2 = float(l2_reg_factor)
        self.shard_anime = shard_anime
        self.routing = routing
        self.optimizer = optimizer
        # Per-(sender, owner) all-to-all slot count; None = default_capacity
        # (2x the uniform expectation). Lower trades wire bytes for more
        # overflow rounds under skew; tune with routing.plan_stats logs.
        self.capacity = capacity
        self._n_shards = int(mesh.devices.size) if routing == "alltoall" else None
        # Axes the batch is split over == axes batch statistics reduce over.
        self._baxes = FULL_AXES if routing == "alltoall" else DATA_AXIS
        self._train = self._build_train()
        self._eval = self._build_eval()
        self._grads = self._build_grads()
        self._train_planned_mapped = self._build_train_planned()

    # ---- public API -----------------------------------------------------------

    def train_step(self, state, users, anime, ratings, weights, lr):
        return self._train(state, users, anime, ratings, weights, lr)

    def eval_sums(self, params, bn_state, users, anime, ratings, weights):
        """Returns (loss_sum, mse_sum, weight_sum) over the global batch."""
        return self._eval(params, bn_state, users, anime, ratings, weights)

    def grads(self, state, users, anime, ratings, weights):
        """Debug/verification entry: the exact global gradient pytree
        (batch-axes-reduced + analytic L2), before any optimizer transform.
        In alltoall mode table grads come back in PHYSICAL (striped) order."""
        return self._grads(state, users, anime, ratings, weights)

    def _batch_spec(self) -> P:
        return P(self._baxes)

    def batch_sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, self._batch_spec())

    # ---- lookups ----------------------------------------------------------------

    def _capacity(self, batch_per_device: int) -> int:
        if self.capacity is not None:
            return max(1, min(batch_per_device, self.capacity))
        return rt.default_capacity(batch_per_device, self._n_shards)

    def _lookup_user(self, table_local, ids):
        if self.routing == "alltoall":
            return rt.exchange_rows(
                table_local, ids, axis=FULL_AXES, n_shards=self._n_shards,
                capacity=self._capacity(ids.shape[0]),
            )
        return _sharded_lookup(table_local, ids, MODEL_AXIS)

    def _lookup_anime(self, table_local, ids):
        if self.routing == "alltoall":
            return rt.exchange_rows(
                table_local, ids, axis=FULL_AXES, n_shards=self._n_shards,
                capacity=self._capacity(ids.shape[0]),
            )
        if self.shard_anime:
            return _sharded_lookup(table_local, ids, MODEL_AXIS)
        return table_local[ids]

    # ---- forward / loss ---------------------------------------------------------

    def _global_weighted_moments(self, z, w):
        """Weighted batch mean/var across the full global batch."""
        denom = jax.lax.psum(jnp.sum(w), self._baxes)
        denom = jnp.maximum(denom, 1.0)
        mean = jax.lax.psum(jnp.sum(z * w), self._baxes) / denom
        var = jax.lax.psum(jnp.sum(jnp.square(z - mean) * w), self._baxes) / denom
        return mean, var, denom

    def _head(self, params, cos, weights, bn_stats):
        z = params.dense_w * cos + params.dense_b
        if bn_stats is None:
            mean, var, _ = self._global_weighted_moments(z, weights)
        else:
            mean, var = bn_stats
        z_hat = (z - mean) * jax.lax.rsqrt(var + KERAS_BN_EPS)
        pred = jax.nn.sigmoid(params.bn_gamma * z_hat + params.bn_beta)
        return pred, (mean, var)

    def _forward_local(self, params, users, anime, weights, bn_stats):
        """Per-shard forward to predictions; bn_stats None -> use batch stats."""
        u_rows = self._lookup_user(params.user_emb, users)
        a_rows = self._lookup_anime(params.anime_emb, anime)
        cos = cosine_merge(u_rows, a_rows)
        return self._head(params, cos, weights, bn_stats)

    def _data_loss_and_metrics(self, params, users, anime, ratings, weights,
                               bn_stats):
        pred, stats = self._forward_local(params, users, anime, weights, bn_stats)
        denom = jnp.maximum(jax.lax.psum(jnp.sum(weights), self._baxes), 1.0)
        loss = jax.lax.psum(
            jnp.sum(bce(pred, ratings) * weights), self._baxes
        ) / denom
        mse = jax.lax.psum(
            jnp.sum(jnp.square(pred - ratings) * weights), self._baxes
        ) / denom
        return loss, (mse, stats)

    def _reg_sum(self, params):
        if self.routing == "alltoall":
            local = jnp.sum(jnp.square(params.user_emb)) + jnp.sum(
                jnp.square(params.anime_emb)
            )
            return self.l2 * jax.lax.psum(local, FULL_AXES)
        user_sq = jax.lax.psum(jnp.sum(jnp.square(params.user_emb)), MODEL_AXIS)
        anime_sq = jnp.sum(jnp.square(params.anime_emb))
        if self.shard_anime:
            anime_sq = jax.lax.psum(anime_sq, MODEL_AXIS)
        return self.l2 * (user_sq + anime_sq)

    def _new_bn(self, bn, mean, var):
        return BNState(
            moving_mean=bn.moving_mean * KERAS_BN_MOMENTUM
            + mean * (1.0 - KERAS_BN_MOMENTUM),
            moving_var=bn.moving_var * KERAS_BN_MOMENTUM
            + var * (1.0 - KERAS_BN_MOMENTUM),
        )

    # ---- step builders ----------------------------------------------------------

    def _step_specs(self):
        return state_specs(self.shard_anime, self.routing)

    def _dense_step(self, state: TrainState, users, anime, ratings, weights, lr):
        def loss_fn(params):
            return self._data_loss_and_metrics(
                params, users, anime, ratings, weights, None
            )

        (data_loss, (mse, (mean, var))), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(state.params)

        # The vma-aware shard_map transpose already reduces grads of
        # replicated leaves over the batch axes (the loss is psum'd
        # there); only the analytic L2 term is added here. Table grads in
        # alltoall mode live on exactly one shard (custom VJP routed them
        # home), so 2*l2*W_local is the exact full-table term.
        grads = grads._replace(
            user_emb=grads.user_emb + 2.0 * self.l2 * state.params.user_emb,
            anime_emb=grads.anime_emb + 2.0 * self.l2 * state.params.anime_emb,
        )

        updates, new_opt = make_optimizer().update(
            grads, state.opt_state, state.params
        )
        updates = jax.tree.map(lambda u: -lr * u, updates)
        new_params = optax.apply_updates(state.params, updates)
        loss = data_loss + self._reg_sum(state.params)
        return (
            TrainState(new_params, self._new_bn(state.bn_state, mean, var), new_opt),
            loss,
            mse,
        )

    def _routed_forward_grads(self, params, users, anime, ratings, weights,
                              plans=None):
        """Shared forward+backward of the routed (owner-side-update) steps:
        exchange both tables' rows, differentiate the data loss w.r.t. the
        EXCHANGED rows and head params — no dense table gradient ever
        exists on any shard. Returns
        (loss, mse, (mean, var), d_u, d_a, d_head, plans).

        ``plans=(plan_u, plan_a)`` reuses PRECOMPUTED exchange plans (the
        staged-epoch path: plans are pure functions of the batch ids, and
        batch COMPOSITION is fixed at stage time, so the per-step batch
        argsort + segment machinery — a non-bandwidth cost of the routed
        step — is paid once per fit instead of
        once per step)."""
        m = self._n_shards
        cap_u = self._capacity(users.shape[0])
        cap_a = self._capacity(anime.shape[0])
        if plans is not None:
            plan_u, plan_a = plans
        else:
            # ONE exchange plan per table, shared with the owner-side grad
            # routing below — the batch argsort + segment machinery is
            # paid once per table per step instead of twice.
            plan_u = rt.make_plan(users, m, cap_u, FULL_AXES)
            plan_a = rt.make_plan(anime, m, cap_a, FULL_AXES)
        u_rows = rt.exchange_rows_planned(
            params.user_emb, users, plan_u,
            axis=FULL_AXES, n_shards=m, capacity=cap_u,
        )
        a_rows = rt.exchange_rows_planned(
            params.anime_emb, anime, plan_a,
            axis=FULL_AXES, n_shards=m, capacity=cap_a,
        )
        head_params = (params.dense_w, params.dense_b,
                       params.bn_gamma, params.bn_beta)

        def data_loss(u_rows, a_rows, head_params):
            dense_w, dense_b, bn_gamma, bn_beta = head_params
            proxy = params._replace(
                dense_w=dense_w, dense_b=dense_b,
                bn_gamma=bn_gamma, bn_beta=bn_beta,
            )
            cos = cosine_merge(u_rows, a_rows)
            pred, stats = self._head(proxy, cos, weights, None)
            denom = jnp.maximum(
                jax.lax.psum(jnp.sum(weights), self._baxes), 1.0
            )
            loss = jax.lax.psum(
                jnp.sum(bce(pred, ratings) * weights), self._baxes
            ) / denom
            mse = jax.lax.psum(
                jnp.sum(jnp.square(pred - ratings) * weights), self._baxes
            ) / denom
            return loss, (mse, stats)

        (loss, (mse, stats)), (d_u, d_a, d_head) = jax.value_and_grad(
            data_loss, argnums=(0, 1, 2), has_aux=True
        )(u_rows, a_rows, head_params)
        return loss, mse, stats, d_u, d_a, d_head, (cap_u, plan_u), (cap_a, plan_a)

    @staticmethod
    def _head_adam(params, opt, d_head, t, lr):
        """Ordinary Adam on the 4 scalar head params with the shared step
        count; returns (new_scalars, new_mu, new_nu) name->value dicts."""
        from anime_recommendations_tpu.train.lazy import B1, B2, _scalar_adam

        tf32 = t.astype(jnp.float32)
        bc1 = 1.0 - jnp.float32(B1) ** tf32
        bc2 = 1.0 - jnp.float32(B2) ** tf32
        names = ("dense_w", "dense_b", "bn_gamma", "bn_beta")
        new_scalars, new_mu_s, new_nu_s = {}, {}, {}
        for name, g in zip(names, d_head):
            p, mu_, nu_ = _scalar_adam(
                getattr(params, name), getattr(opt.mu, name),
                getattr(opt.nu, name), g, bc1, bc2, lr,
            )
            new_scalars[name], new_mu_s[name], new_nu_s[name] = p, mu_, nu_
        return new_scalars, new_mu_s, new_nu_s

    def _lazy_step(self, state: TrainState, users, anime, ratings, weights, lr,
                   plans=None):
        """Row-sparse Adam on the routed path (train/lazy.py semantics).

        Per-unique-row grad sums travel back to the owning shard over the
        same all-to-all plan, and owners apply lazy Adam only to the rows
        a round delivers (multi-round overflow applies Adam per round —
        exact dedup in the single-round steady state; see
        routing.route_grads_lazy_adam).
        """
        params = state.params
        opt: optax.ScaleByAdamState = state.opt_state
        m = self._n_shards
        loss, mse, (mean, var), d_u, d_a, d_head, (cap_u, plan_u), (cap_a, plan_a) = (
            self._routed_forward_grads(params, users, anime, ratings, weights,
                                       plans)
        )

        t = opt.count + 1
        new_u = rt.route_grads_lazy_adam(
            params.user_emb, opt.mu.user_emb, opt.nu.user_emb,
            users, d_u, t, lr, self.l2,
            axis=FULL_AXES, n_shards=m, capacity=cap_u, plan=plan_u,
        )
        new_a = rt.route_grads_lazy_adam(
            params.anime_emb, opt.mu.anime_emb, opt.nu.anime_emb,
            anime, d_a, t, lr, self.l2,
            axis=FULL_AXES, n_shards=m, capacity=cap_a, plan=plan_a,
        )

        new_scalars, new_mu_s, new_nu_s = self._head_adam(
            params, opt, d_head, t, lr
        )
        new_params = TwoTowerParams(
            user_emb=new_u[0], anime_emb=new_a[0], **new_scalars
        )
        new_opt = optax.ScaleByAdamState(
            count=t,
            mu=TwoTowerParams(user_emb=new_u[1], anime_emb=new_a[1], **new_mu_s),
            nu=TwoTowerParams(user_emb=new_u[2], anime_emb=new_a[2], **new_nu_s),
        )
        new_state = TrainState(
            new_params, self._new_bn(state.bn_state, mean, var), new_opt
        )
        return new_state, loss, mse

    def _fused_step(self, state: TrainState, users, anime, ratings, weights, lr,
                    plans=None):
        """Owner-side FUSED dense-Adam on the routed path: exact dense-Adam
        semantics (every local row decays + updates moments each step, the
        loss includes the L2 value), one sparse_adam_update per local table
        shard (ops/fused_adam.py).

        Gradients are taken w.r.t. the exchanged rows; per-unique-row grad
        sums travel back to the owning shard (routing.route_grad_rows) and
        land in the owner's single update as a scatter-add.
        Because ALL overflow rounds are staged before that one application,
        multi-round overflow under skew is EXACT — no per-round deviation
        (unlike lazy_adam's route_grads_lazy_adam).
        """
        from anime_recommendations_tpu.ops.fused_adam import sparse_adam_update
        from anime_recommendations_tpu.train.fused import (
            ANIME_TABLE_ID,
            USER_TABLE_ID,
        )
        from anime_recommendations_tpu.train.lazy import B1, B2
        from anime_recommendations_tpu.train.trainer import KERAS_ADAM_EPS

        params = state.params
        opt: optax.ScaleByAdamState = state.opt_state
        m = self._n_shards
        loss, mse, (mean, var), d_u, d_a, d_head, (cap_u, plan_u), (cap_a, plan_a) = (
            self._routed_forward_grads(params, users, anime, ratings, weights,
                                       plans)
        )

        t = opt.count + 1
        # Receipts are staged for the first staged_rounds overflow rounds;
        # rarer deeper overflow comes back as a dense per-shard gradient
        # added to the scatter — exact dense-Adam semantics at ANY
        # skew/shard count (routing.route_grad_rows docstring).
        oid_u, og_u, dense_u = rt.route_grad_rows(
            users, d_u, axis=FULL_AXES, n_shards=m, capacity=cap_u,
            r_local=params.user_emb.shape[0], plan=plan_u,
        )
        oid_a, og_a, dense_a = rt.route_grad_rows(
            anime, d_a, axis=FULL_AXES, n_shards=m, capacity=cap_a,
            r_local=params.anime_emb.shape[0], plan=plan_a,
        )
        w_u, mu_u, nu_u, sumsq_u = sparse_adam_update(
            params.user_emb, opt.mu.user_emb, opt.nu.user_emb,
            oid_u, og_u, t, lr, l2=self.l2,
            b1=B1, b2=B2, eps=KERAS_ADAM_EPS, table_id=USER_TABLE_ID,
            dense_grad=dense_u,
        )
        w_a, mu_a, nu_a, sumsq_a = sparse_adam_update(
            params.anime_emb, opt.mu.anime_emb, opt.nu.anime_emb,
            oid_a, og_a, t, lr, l2=self.l2,
            b1=B1, b2=B2, eps=KERAS_ADAM_EPS, table_id=ANIME_TABLE_ID,
            dense_grad=dense_a,
        )
        # Per-shard sumsq -> full-table L2 value (dense-path loss parity).
        loss = loss + self.l2 * jax.lax.psum(sumsq_u + sumsq_a, self._baxes)

        new_scalars, new_mu_s, new_nu_s = self._head_adam(
            params, opt, d_head, t, lr
        )
        new_params = TwoTowerParams(user_emb=w_u, anime_emb=w_a, **new_scalars)
        new_opt = optax.ScaleByAdamState(
            count=t,
            mu=TwoTowerParams(user_emb=mu_u, anime_emb=mu_a, **new_mu_s),
            nu=TwoTowerParams(user_emb=nu_u, anime_emb=nu_a, **new_nu_s),
        )
        new_state = TrainState(
            new_params, self._new_bn(state.bn_state, mean, var), new_opt
        )
        return new_state, loss, mse

    def _build_train(self):
        specs = self._step_specs()
        batch_spec = self._batch_spec()
        step = {
            "lazy_adam": self._lazy_step,
            "fused_adam": self._fused_step,
        }.get(self.optimizer, self._dense_step)

        mapped = jax.shard_map(
            step,
            mesh=self.mesh,
            in_specs=(specs, batch_spec, batch_spec, batch_spec, batch_spec, P()),
            out_specs=(specs, P(), P()),
        )
        self._train_mapped = mapped  # unjitted, for nesting inside lax.scan
        return jax.jit(mapped, donate_argnums=0)

    def plan_batch_spec(self) -> "rt._Plan":
        """shard_map PartitionSpecs for ONE batch's exchange plan
        (routing._Plan): per-element arrays (seg_orig/uids) split over the
        batch axes; per-owner tables (hoff/hcnt, [m] per device) likewise —
        each device's stripe is ITS OWN bucket table; ``rounds`` replicated
        (it is pmax'd across the mesh)."""
        b = P(self._baxes)
        return rt._Plan(seg_orig=b, uids=b, hoff=b, hcnt=b, rounds=P())

    def _build_train_planned(self):
        """shard_map'd train step taking PRECOMPUTED exchange plans —
        (state, u, a, r, w, lr, plan_u, plan_a). Only the owner-side-update
        optimizers (lazy_adam, fused_adam) route through plans; None
        otherwise."""
        if self.routing != "alltoall" or self.optimizer not in (
            "lazy_adam", "fused_adam"
        ):
            return None
        specs = self._step_specs()
        batch_spec = self._batch_spec()
        pspec = self.plan_batch_spec()
        routed_step = (self._lazy_step if self.optimizer == "lazy_adam"
                       else self._fused_step)

        def fn(state, users, anime, ratings, weights, lr, plan_u, plan_a):
            return routed_step(
                state, users, anime, ratings, weights, lr,
                plans=(plan_u, plan_a),
            )

        return jax.shard_map(
            fn,
            mesh=self.mesh,
            in_specs=(specs, batch_spec, batch_spec, batch_spec, batch_spec,
                      P(), pspec, pspec),
            out_specs=(specs, P(), P()),
        )

    def _build_grads(self):
        specs = self._step_specs()
        batch_spec = self._batch_spec()

        def step(state: TrainState, users, anime, ratings, weights):
            def loss_fn(params):
                return self._data_loss_and_metrics(
                    params, users, anime, ratings, weights, None
                )

            _, grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
            return grads._replace(
                user_emb=grads.user_emb + 2.0 * self.l2 * state.params.user_emb,
                anime_emb=grads.anime_emb + 2.0 * self.l2 * state.params.anime_emb,
            )

        mapped = jax.shard_map(
            step,
            mesh=self.mesh,
            in_specs=(specs, batch_spec, batch_spec, batch_spec, batch_spec),
            out_specs=specs.params,
        )
        return jax.jit(mapped)

    def _build_eval(self):
        specs = self._step_specs()
        batch_spec = self._batch_spec()

        def step(params, bn, users, anime, ratings, weights):
            pred, _ = self._forward_local(
                params, users, anime, weights,
                (bn.moving_mean, bn.moving_var),
            )
            w_sum = jax.lax.psum(jnp.sum(weights), self._baxes)
            loss_sum = jax.lax.psum(
                jnp.sum(bce(pred, ratings) * weights), self._baxes
            )
            mse_sum = jax.lax.psum(
                jnp.sum(jnp.square(pred - ratings) * weights), self._baxes
            )
            loss_sum = loss_sum + self._reg_sum(params) * w_sum
            return loss_sum, mse_sum, w_sum

        mapped = jax.shard_map(
            step,
            mesh=self.mesh,
            in_specs=(specs.params, specs.bn_state, batch_spec, batch_spec,
                      batch_spec, batch_spec),
            out_specs=(P(), P(), P()),
        )
        self._eval_mapped = mapped
        return jax.jit(mapped)


def build_plans_fn(step: ShardedTrainStep):
    """jitted (users [nb, B], anime [nb, B]) -> (plans_u, plans_a): the
    exchange plan of EVERY staged batch, computed once per fit.

    Plans are pure functions of (batch ids, shard count, capacity); the
    staged epoch fixes batch composition at stage time (per-epoch shuffle
    permutes batch ORDER only), so this one-time lax.map amortizes the
    per-step batch argsort + segment machinery across all epochs. Stacked
    plan pytrees have leading dim nb and ride the epoch scan as xs.
    """
    m = step._n_shards

    def per_table(ids_all, cap):
        return jax.lax.map(
            lambda ids: rt.make_plan(ids, m, cap, FULL_AXES), ids_all
        )

    def fn(users, anime):  # device-local [nb, B_local]
        cap_u = step._capacity(users.shape[1])
        cap_a = step._capacity(anime.shape[1])
        return per_table(users, cap_u), per_table(anime, cap_a)

    stacked = jax.tree.map(
        lambda s: P(None, *tuple(s)), step.plan_batch_spec(),
        is_leaf=lambda x: isinstance(x, P),
    )
    in_spec = P(None, step._baxes)
    mapped = jax.shard_map(
        fn, mesh=step.mesh,
        in_specs=(in_spec, in_spec),
        out_specs=(stacked, stacked),
    )
    return jax.jit(mapped)


def build_epoch_fn(step: ShardedTrainStep, shuffle: bool, planned: bool = False):
    """Device-resident SPMD epoch: lax.scan over the shard_map train step,
    then the holdout eval scanned on-mesh in the SAME program — the
    multi-chip analog of train/device_loop (one launch per epoch, no
    per-batch host dispatch anywhere in a sharded fit).

    Batch arrays are [nb, B] with B sharded over the step's batch axes (so
    lax.scan slices batches without resharding). Per-epoch shuffling
    permutes BATCH ORDER (batch composition is fixed by the staging
    host-shuffle; re-mixing examples across sharded batches each epoch
    would need cross-shard all-to-alls — a deliberate trade, see
    ShardedTrainer._stage_device).

    ``planned=True`` (routed owner-side optimizers): the epoch also scans
    the PRECOMPUTED per-batch exchange plans (build_plans_fn) — the signa-
    ture gains (plans_u, plans_a) after the batch arrays, and the per-step
    grouping argsorts disappear from the scan body entirely.
    """
    import functools

    mapped = step._train_mapped
    planned_mapped = step._train_planned_mapped
    eval_mapped = step._eval_mapped
    if planned and planned_mapped is None:
        raise ValueError(
            "planned epoch requires routing='alltoall' with a routed "
            "owner-side optimizer (lazy_adam / fused_adam)"
        )

    def _scan_train(state, xs, lr):
        if planned:
            def body(state, batch):
                u, a, r, w, pu, pa = batch
                new_state, loss, mse = planned_mapped(state, u, a, r, w, lr,
                                                      pu, pa)
                return new_state, (loss, mse, jnp.sum(w))
        else:
            def body(state, batch):
                u, a, r, w = batch
                new_state, loss, mse = mapped(state, u, a, r, w, lr)
                return new_state, (loss, mse, jnp.sum(w))
        return jax.lax.scan(body, state, xs)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def epoch(state, users, anime, ratings, weights, ev, key, lr,
              plans_u=None, plans_a=None):
        xs = (users, anime, ratings, weights)
        if planned:
            xs = xs + (plans_u, plans_a)
        if shuffle:
            perm = jax.random.permutation(key, users.shape[0])
            xs = jax.tree.map(lambda x: x[perm], xs)

        state, (losses, mses, wsums) = _scan_train(state, xs, lr)

        def ebody(carry, batch):
            u, a, r, w = batch
            ls, ms, ws = eval_mapped(state.params, state.bn_state, u, a, r, w)
            l_sum, m_sum, w_sum = carry
            return (l_sum + ls, m_sum + ms, w_sum + ws), None

        (vl_sum, vm_sum, vw_sum), _ = jax.lax.scan(
            ebody,
            (jnp.float32(0), jnp.float32(0), jnp.float32(0)),
            ev,
        )
        vw = jnp.maximum(vw_sum, 1.0)
        return state, losses, mses, wsums, vl_sum / vw, vm_sum / vw

    return epoch

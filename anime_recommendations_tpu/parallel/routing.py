"""All-to-all embedding-row routing for sharded tables.

Replacement for the reference's implicit single-replica embedding lookup
(neural_network.py:142-144 simply replicates the whole Keras model on
every replica): the big user table is row-sharded across
ALL mesh devices and batch lookups are routed to owning shards with
all-to-all collectives, so each row's data crosses the interconnect once —
instead of the legacy psum routing (parallel/sharded_train._sharded_lookup)
whose [B, D] all-reduce moves ~2·B·D bytes per device regardless of shard
count and makes every shard gather against the full batch.

Layout: MOD-STRIPED. Global row g lives on shard ``g % m`` at local row
``g // m``. Striping spreads popular rows across shards (vocab order is
first-appearance, so low ids — the popular users/anime — would all land on
shard 0 under contiguous-block sharding): the hot-row-skew mitigation of
SURVEY.md hard part (a). ``to_physical`` permutes a host table so that
NamedSharding's contiguous block-split realizes the striping.

Exchange protocol (static shapes, EXACT for arbitrary id multisets):
  1. sort local ids by (owner, id); mark the head of each equal-id run —
     duplicate ids are requested ONCE (in-batch hot rows cost one row of
     traffic no matter how often they repeat);
  2. bucket unique ids by owner; per round, each (sender, owner) bucket
     sends up to ``capacity`` ids via all_to_all; owners gather their rows
     locally and all_to_all them straight back to the requesting slots;
  3. rounds = pmax(ceil(max bucket / capacity)) — a lax.while_loop with a
     globally-uniform trip count, so overflowing buckets never drop rows;
     with striped rows + deduped requests one round is the steady state.
  4. responses land in a per-unique-id buffer; ONE composed gather keyed
     by the plan's original-position head ranks (seg_orig) fills
     duplicates and restores batch order in the same pass.

The backward pass (custom VJP) reverses the routing: per-unique-id grad
row sums (segment-sum over duplicates) travel back to the owning shard,
which scatter-ADDS them into its local table gradient. With the table
sharded over the WHOLE mesh there is exactly one physical copy of each
row, so no further cross-device grad reduction is needed.

Replaces (by design, not translation): reference embedding gather
neural_network.py:74-85 + the replicas' gradient all-reduce.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


# ---- mod-striped layout ---------------------------------------------------------


def owner_of(ids: jax.Array, n_shards: int) -> jax.Array:
    """Shard (flat mesh rank) owning each global row id."""
    return jax.lax.rem(ids, jnp.int32(n_shards))


def local_of(ids: jax.Array, n_shards: int) -> jax.Array:
    """Local row index of each global id on its owning shard."""
    return jax.lax.div(ids, jnp.int32(n_shards))


def to_physical(table: np.ndarray | jax.Array, n_shards: int):
    """Permute [N, D] host rows so a contiguous block-split = mod striping.

    Physical block s (what NamedSharding places on flat-rank-s's device)
    holds global rows {s, s+m, s+2m, ...} as local rows {0, 1, 2, ...}.
    N must be a multiple of n_shards (parallel.mesh.pad_rows_for_shards).
    """
    n, d = table.shape
    assert n % n_shards == 0, (n, n_shards)
    return table.reshape(n // n_shards, n_shards, d).swapaxes(0, 1).reshape(n, d)


def from_physical(table: np.ndarray | jax.Array, n_shards: int):
    """Inverse of to_physical (physical row order -> global id order)."""
    n, d = table.shape
    assert n % n_shards == 0, (n, n_shards)
    return table.reshape(n_shards, n // n_shards, d).swapaxes(0, 1).reshape(n, d)


def pad_sentinel(n_rows_padded: int, n_shards: int, shard: int) -> int:
    """A global id that shard ``shard`` treats as locally out-of-bounds.

    owner_of(sentinel) == shard and local_of(sentinel) == R (one past the
    local table), so locality-staged padding rows are gather-clamped in the
    forward (weight 0 kills their loss) and dropped by row-sparse updates.
    """
    assert n_rows_padded % n_shards == 0
    return n_rows_padded + shard


def default_capacity(batch_per_device: int, n_shards: int) -> int:
    """Per-(sender, owner) slot count: 2x the uniform expectation with a
    floor of 8, capped at the batch itself (a sender can never have more
    unique ids in a bucket than its whole batch). One round is then the
    steady state — small batches are single-round by construction, and
    the rounds while_loop only triggers on heavy skew at scale (which
    mod-striping already dilutes)."""
    want = max(8, 2 * (-(-batch_per_device // n_shards)))
    return max(1, min(batch_per_device, want))


# ---- exchange plan (shared by forward and backward) -----------------------------


class _Plan(NamedTuple):
    seg_orig: jax.Array   # [B] head rank of each ORIGINAL batch position
    uids: jax.Array       # [B] unique id per head rank (padded tail arbitrary)
    hoff: jax.Array       # [m] first head rank per owner
    hcnt: jax.Array       # [m] unique ids per owner
    rounds: jax.Array     # [] uniform round count (pmax'd)


def _sort_key(ids: jax.Array, n_shards: int) -> jax.Array:
    """int32 key ordering by (owner, id) without int64 (x64 is off by
    default): owner*K + local with K = 2^31//m keeps every term < 2^31
    for int32 ids (equal ids => equal keys, so run detection and the
    per-run segment sums are invariant to the unstable sort's order
    within a run)."""
    if n_shards == 1:
        return ids
    k = (2**31) // n_shards
    return owner_of(ids, n_shards) * jnp.int32(k) + local_of(ids, n_shards)


def _make_plan(ids: jax.Array, n_shards: int, capacity: int, axis) -> _Plan:
    b = ids.shape[0]
    m = n_shards
    owner = owner_of(ids, m)
    order = jnp.argsort(_sort_key(ids, m), stable=False)
    ids_s = ids[order]
    owner_s = owner[order]
    is_start = jnp.concatenate(
        [jnp.ones((1,), bool), ids_s[1:] != ids_s[:-1]]
    )
    seg = jnp.cumsum(is_start) - 1                      # [B] head rank per elem
    # seg_orig[i] = head rank of ORIGINAL position i — the one index map
    # the exchange needs at runtime (response fill AND grad-sum scatter are
    # both keyed by it), so the plan carries no sorted-domain arrays.
    seg_orig = jnp.zeros((b,), jnp.int32).at[order].set(seg.astype(jnp.int32))
    # uids[h] = id of the h-th head (duplicate writers store the same value).
    uids = jnp.zeros((b,), ids.dtype).at[seg].set(ids_s)
    hcnt = jnp.bincount(
        jnp.where(is_start, owner_s, m), length=m + 1
    )[:m].astype(jnp.int32)
    hoff = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(hcnt)[:-1].astype(jnp.int32)]
    )
    need = -(-jnp.max(hcnt) // jnp.int32(capacity))     # ceil div
    rounds = jax.lax.pmax(need, axis)
    return _Plan(seg_orig, uids, hoff, hcnt, rounds)


def _unique_grad_sums(g_rows: jax.Array, plan: _Plan, b: int) -> jax.Array:
    """[B, D] per-unique-id grad sums indexed by head rank: duplicates of
    an id accumulate onto its head rank via one scatter-add over
    seg_orig (order-free; no sorted-domain gather)."""
    return jnp.zeros((b, g_rows.shape[1]), g_rows.dtype).at[
        plan.seg_orig
    ].add(g_rows)


def _send_slot_ids(plan: _Plan, r: jax.Array, capacity: int, m: int) -> tuple:
    """(send_ids [m, C], slot_pos [m, C]): round-r request ids per owner and
    the head rank each response row belongs to; invalid slots id=-1/pos=B."""
    b = plan.uids.shape[0]
    j = jnp.arange(capacity, dtype=jnp.int32)[None, :]
    k = r * jnp.int32(capacity) + j                      # [1, C] in-bucket pos
    pos = plan.hoff[:, None] + k                         # [m, C] head rank
    valid = k < plan.hcnt[:, None]
    send_ids = jnp.where(valid, plan.uids[jnp.clip(pos, 0, b - 1)], -1)
    # Invalid slots get DISTINCT out-of-bounds positions (b + lane) so the
    # scatter's unique_indices promise holds (duplicated OOB drops are
    # documented UB even with mode='drop').
    lane = jnp.arange(m * capacity, dtype=jnp.int32).reshape(m, capacity)
    slot_pos = jnp.where(valid, pos, b + lane)
    return send_ids, slot_pos


# ---- the exchange op (custom VJP) ------------------------------------------------


def exchange_rows(
    table_local: jax.Array,   # [R, D] mod-striped local shard
    ids: jax.Array,           # [B] global row ids (any multiset; OOB -> zeros)
    *,
    axis,                     # shard_map axis name or tuple, e.g. ('data','model')
    n_shards: int,
    capacity: int,
) -> jax.Array:
    """Gather rows of a mesh-sharded table for arbitrary ids, [B, D].

    Must be called inside shard_map with ``table_local`` sharded over
    ``axis`` (mod-striped physical layout) and ``ids`` the device's batch
    shard. Differentiable w.r.t. table_local (reverse routing + local
    scatter-add).
    """
    fn = _exchange_fn(
        _axis_names(axis), n_shards, capacity,
        table_local.shape[0], str(table_local.dtype),
    )
    return fn(table_local, ids)


def exchange_rows_planned(
    table_local: jax.Array,
    ids: jax.Array,
    plan: "_Plan",
    *,
    axis,
    n_shards: int,
    capacity: int,
) -> jax.Array:
    """Forward-only exchange_rows reusing a precomputed ``make_plan`` plan.

    NOT differentiable (no VJP): for the owner-side-optimizer steps, which
    take gradients w.r.t. the RETURNED rows and route them back themselves
    (route_grad_rows / route_grads_lazy_adam with the same plan). Sharing
    one plan per (ids, capacity) avoids paying the batch argsort + segment
    machinery twice per table per step."""
    return _planned_gather(
        table_local, ids, plan, _axis_names(axis), n_shards, capacity,
        table_local.shape[0],
    )


def make_plan(ids: jax.Array, n_shards: int, capacity: int, axis) -> "_Plan":
    """Public alias of the exchange-plan builder, for plan sharing across
    exchange_rows_planned / route_grad_rows / route_grads_lazy_adam."""
    return _make_plan(ids, n_shards, capacity, _axis_names(axis))


def _axis_names(axis) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _pvary(x, axis):
    """Mark a fresh array as device-varying over ``axis`` so it can carry
    through a while_loop whose body emits varying values (shard_map VMA)."""
    names = _axis_names(axis)
    if hasattr(jax.lax, "pcast"):
        return jax.lax.pcast(x, names, to="varying")
    return jax.lax.pvary(x, names)


import functools


def _planned_gather(table_local, ids, plan, axis, m, cap, r_local):
    """The exchange forward pass for a given plan: round-looped all-to-all
    row requests + responses, then unsort back to batch order.

    m == 1 specializes to identity routing: every id is local, so the
    whole send/serve/respond/unsort machinery algebraically collapses to
    ``table_local[ids]`` (with the same OOB -> zeros contract). This is
    the production single-shard case — it removes the response scatter and
    the dup-fill gather entirely (~3 of the 4 [B, D] row ops per table per
    step)."""
    b = ids.shape[0]
    d = table_local.shape[1]
    if m == 1:
        ok = (ids >= 0) & (ids < r_local)
        rows = table_local[jnp.clip(ids, 0, r_local - 1)]
        return jnp.where(ok[:, None], rows, jnp.zeros((), table_local.dtype))

    def body(carry):
        r, uresp = carry
        send_ids, slot_pos = _send_slot_ids(plan, r, cap, m)
        recv_ids = jax.lax.all_to_all(send_ids, axis, 0, 0)      # [m, C]
        lid = local_of(jnp.maximum(recv_ids, 0), m)
        ok = (recv_ids >= 0) & (lid < r_local)
        rows = jnp.where(
            ok[:, :, None],
            table_local[jnp.clip(lid, 0, r_local - 1)],
            jnp.zeros((), table_local.dtype),
        )                                                        # [m, C, D]
        resp = jax.lax.all_to_all(rows, axis, 0, 0)              # [m, C, D]
        uresp = uresp.at[slot_pos.reshape(-1)].set(
            resp.reshape(-1, d), mode="drop", unique_indices=True
        )
        return r + 1, uresp

    _, uresp = jax.lax.while_loop(
        lambda c: c[0] < plan.rounds,
        body,
        (jnp.int32(0), _pvary(jnp.zeros((b, d), table_local.dtype), axis)),
    )
    # ONE composed gather fills duplicates AND restores batch order
    # (seg_orig = seg∘inv precomputed in the plan — a second [B, D] row
    # gather here measured ~0.2 ms/step at B=10k).
    return uresp[plan.seg_orig]


@functools.cache
def _exchange_fn(axis, n_shards: int, capacity: int, r_local: int, dtype: str):
    m, cap = n_shards, capacity

    def _forward(table_local, ids):
        plan = _make_plan(ids, m, cap, axis)
        return _planned_gather(table_local, ids, plan, axis, m, cap, r_local)

    @jax.custom_vjp
    def ex(table_local, ids):
        return _forward(table_local, ids)

    def fwd(table_local, ids):
        return _forward(table_local, ids), ids

    def bwd(ids, g):
        if m == 1:
            # Identity routing (see _planned_gather): duplicates accumulate
            # directly; OOB targets drop. One scatter-add, no plan at all.
            r_loc = r_local
            ok = (ids >= 0) & (ids < r_loc)
            tgt = jnp.where(ok, ids, r_loc)
            d_table = jnp.zeros((r_loc, g.shape[1]), g.dtype).at[tgt].add(
                g, mode="drop"
            )
            return d_table.astype(dtype), None
        plan = _make_plan(ids, m, cap, axis)
        b = ids.shape[0]
        d = g.shape[1]
        # Per-unique-id grad sum (duplicates accumulate onto the head
        # rank): one scatter-add keyed by seg_orig — no sorted-order
        # gather of g needed.
        ugrad = _unique_grad_sums(g, plan, b)

        def body(carry):
            r, d_table = carry
            send_ids, slot_pos = _send_slot_ids(plan, r, cap, m)
            recv_ids = jax.lax.all_to_all(send_ids, axis, 0, 0)
            send_g = jnp.where(
                (slot_pos < b)[:, :, None],
                ugrad[jnp.clip(slot_pos, 0, b - 1)],
                jnp.zeros((), g.dtype),
            )                                                        # [m, C, D]
            recv_g = jax.lax.all_to_all(send_g, axis, 0, 0)
            lid = local_of(jnp.maximum(recv_ids, 0), m)
            ok = (recv_ids >= 0) & (lid < r_local)
            tgt = jnp.where(ok, lid, r_local)
            d_table = d_table.at[tgt.reshape(-1)].add(
                recv_g.reshape(-1, d), mode="drop"
            )
            return r + 1, d_table

        _, d_table = jax.lax.while_loop(
            lambda c: c[0] < plan.rounds,
            body,
            (jnp.int32(0), _pvary(jnp.zeros((r_local, d), dtype), axis)),
        )
        return d_table.astype(dtype), None

    ex.defvjp(fwd, bwd)
    return ex


def received_rows(
    table_local: jax.Array,
    ids: jax.Array,
    *,
    axis,
    n_shards: int,
    capacity: int,
    owner_capacity: int,
):
    """Owner-side view of one exchange: (local_ids [S], present) where S =
    owner_capacity — the local rows of ``table_local`` this shard would
    serve for the global batch, deduped per requester. Used by row-sparse
    optimizers to know which rows a step touches without a dense gradient.
    Rounds beyond owner_capacity/ (n_shards*capacity) are dropped — size
    owner_capacity generously (it is ids metadata, not row data)."""
    m, cap = n_shards, capacity
    plan = _make_plan(ids, m, cap, axis)
    r_local = table_local.shape[0]
    n_rounds_fit = owner_capacity // (m * cap)

    def body(carry):
        r, buf = carry
        send_ids, _ = _send_slot_ids(plan, r, cap, m)
        recv_ids = jax.lax.all_to_all(send_ids, axis, 0, 0)
        lid = local_of(jnp.maximum(recv_ids, 0), m)
        ok = (recv_ids >= 0) & (lid < r_local) & (r < n_rounds_fit)
        base = (r % jnp.int32(max(n_rounds_fit, 1))) * jnp.int32(m * cap)
        pos = base + jnp.arange(m * cap, dtype=jnp.int32)
        buf = buf.at[pos].set(
            jnp.where(ok.reshape(-1), lid.reshape(-1), r_local), mode="drop"
        )
        return r + 1, buf

    _, buf = jax.lax.while_loop(
        lambda c: c[0] < plan.rounds,
        body,
        (jnp.int32(0), _pvary(jnp.full((owner_capacity,), r_local, jnp.int32), axis)),
    )
    return buf


def route_grads_lazy_adam(
    w: jax.Array,        # [R, D] local shard (mod-striped)
    mu: jax.Array,       # [R, D]
    nu: jax.Array,       # [R, D]
    ids: jax.Array,      # [B] global ids this device looked up
    g_rows: jax.Array,   # [B, D] grads w.r.t. the exchanged rows
    t: jax.Array,        # [] Adam step count AFTER this update
    lr: jax.Array,
    l2: float,
    *,
    axis,
    n_shards: int,
    capacity: int,
    plan: _Plan | None = None,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Reverse of exchange_rows for ROW-SPARSE optimizers: per-unique-id
    gradient sums travel back to the owning shard, which applies lazy Adam
    (train/lazy.lazy_row_adam) to exactly the rows it receives — no dense
    table gradient is ever materialized on any shard.

    In the single-round steady state this is exact lazy-Adam: every global
    row gets ONE update from its total cross-device grad sum (duplicates
    within a round are segment-summed by lazy_row_adam). Under multi-round
    overflow (heavy skew beyond capacity) a row served in two rounds gets
    two smaller Adam applications instead of one — a bounded deviation the
    2x-slack default_capacity plus mod-striping makes rare.
    """
    from anime_recommendations_tpu.train.lazy import lazy_row_adam

    m, cap = n_shards, capacity
    if plan is None:
        plan = _make_plan(ids, m, cap, axis)
    b = ids.shape[0]
    r_local = w.shape[0]
    ugrad = _unique_grad_sums(g_rows, plan, b)

    def body(carry):
        r, w, mu, nu = carry
        send_ids, slot_pos = _send_slot_ids(plan, r, cap, m)
        recv_ids = jax.lax.all_to_all(send_ids, axis, 0, 0)      # [m, C]
        send_g = jnp.where(
            (slot_pos < b)[:, :, None],
            ugrad[jnp.clip(slot_pos, 0, b - 1)],
            jnp.zeros((), g_rows.dtype),
        )
        recv_g = jax.lax.all_to_all(send_g, axis, 0, 0)          # [m, C, D]
        lid = local_of(jnp.maximum(recv_ids, 0), m)
        ok = (recv_ids >= 0) & (lid < r_local)
        # Rows not served this round go to the OOB marker r_local, which
        # lazy_row_adam drops (its scatter routes them out of bounds).
        owner_ids = jnp.where(ok, lid, r_local).reshape(-1).astype(jnp.int32)
        upd = lazy_row_adam(
            w, mu, nu, owner_ids, recv_g.reshape(-1, recv_g.shape[-1]),
            t, lr, l2,
        )
        return r + 1, upd.w, upd.mu, upd.nu

    _, w, mu, nu = jax.lax.while_loop(
        lambda c: c[0] < plan.rounds,
        body,
        (jnp.int32(0), w, mu, nu),
    )
    return w, mu, nu


def route_grad_rows(
    ids: jax.Array,      # [B] global ids this device looked up
    g_rows: jax.Array,   # [B, D] grads w.r.t. the exchanged rows
    *,
    axis,
    n_shards: int,
    capacity: int,
    r_local: int,        # rows in the receiving shard's local table
    max_rounds: int | None = None,
    staged_rounds: int = 4,
    plan: _Plan | None = None,
) -> tuple[jax.Array, jax.Array, jax.Array | None]:
    """Reverse of exchange_rows WITHOUT an optimizer baked in: routes
    per-unique-id gradient sums back to the owning shards and returns
    ``(local_ids [T], grads [T, D], dense_overflow [R, D] | None)`` with
    ``T = min(max_rounds, staged_rounds) * n_shards * capacity``.

    Undelivered slots carry the drop marker ``local_id == r_local`` (one
    past the local table) and ZERO gradients, so any scatter-ADD consumer
    — ops/fused_adam.sparse_adam_update in particular — treats them as
    no-ops. Because receipts from ALL rounds are accounted before a single
    optimizer application, the result is EXACT dense-Adam (or exact
    one-update-per-row lazy) semantics even under multi-round overflow,
    unlike route_grads_lazy_adam's bounded per-round deviation.

    ``max_rounds`` defaults to ceil(B / capacity) — the static worst case
    (a sender's whole batch landing in one owner bucket), so no round is
    ever dropped. An explicitly SMALLER ``max_rounds`` truncates the
    exchange loop itself: rounds past it are not exchanged at all (their
    gradient contribution is dropped, deterministically — assert the
    plan's rounds fit if that matters to you).

    ``staged_rounds`` bounds the receipt buffer: rounds below it stage
    per-slot receipts (T stays O(staged_rounds * m * capacity) instead of
    growing ~B * m with shard count); any round at or past it scatter-adds
    into the returned [r_local, D] dense overflow gradient instead, which
    the consumer adds to its scatter (ops/fused_adam.sparse_adam_update
    ``dense_grad``).
    ``dense_overflow`` is None — statically absent, costing nothing —
    whenever every possible round fits the staged buffer.
    """
    m, cap = n_shards, capacity
    b = ids.shape[0]
    d = g_rows.shape[1]
    if max_rounds is None:
        max_rounds = -(-b // cap)
    staged = min(max_rounds, staged_rounds)
    has_overflow = max_rounds > staged
    if plan is None:
        plan = _make_plan(ids, m, cap, axis)
    ugrad = _unique_grad_sums(g_rows, plan, b)
    t_slots = staged * m * cap
    if m == 1 and t_slots >= b:
        # Identity routing: the owner IS the sender, so the receipt buffer
        # is just (head-rank local ids, per-unique grad sums) — the exact
        # slot layout the general loop produces at m=1 (pos = r*cap + j =
        # head rank), with no send gather, no response scatter and no
        # all-to-alls.
        k = jnp.arange(b, dtype=jnp.int32)
        lid = plan.uids.astype(jnp.int32)
        valid = (k < plan.hcnt[0]) & (lid >= 0) & (lid < r_local)
        oid = jnp.where(valid, lid, r_local)
        og = jnp.where(valid[:, None], ugrad, jnp.zeros((), g_rows.dtype))
        if t_slots > b:
            oid = jnp.concatenate(
                [oid, jnp.full((t_slots - b,), r_local, jnp.int32)]
            )
            og = jnp.concatenate(
                [og, jnp.zeros((t_slots - b, d), g_rows.dtype)]
            )
        return oid, og, None

    def body(carry):
        r, oid, og, dense = carry
        send_ids, slot_pos = _send_slot_ids(plan, r, cap, m)
        recv_ids = jax.lax.all_to_all(send_ids, axis, 0, 0)          # [m, C]
        send_g = jnp.where(
            (slot_pos < b)[:, :, None],
            ugrad[jnp.clip(slot_pos, 0, b - 1)],
            jnp.zeros((), g_rows.dtype),
        )
        recv_g = jax.lax.all_to_all(send_g, axis, 0, 0)              # [m, C, D]
        lid = local_of(jnp.maximum(recv_ids, 0), m)
        ok = (recv_ids >= 0) & (lid < r_local)
        staged_round = r < staged
        # Staged rounds land in their own receipt segment; overflow rounds
        # write to DISTINCT out-of-buffer positions (dropped) and
        # scatter-add into the dense gradient instead.
        base = jnp.where(staged_round, r, staged) * jnp.int32(m * cap)
        pos = base + jnp.arange(m * cap, dtype=jnp.int32)
        oid = oid.at[pos].set(
            jnp.where(ok.reshape(-1), lid.reshape(-1), r_local).astype(jnp.int32),
            mode="drop", unique_indices=True,
        )
        og = og.at[pos].set(
            jnp.where(ok.reshape(-1)[:, None], recv_g.reshape(-1, d), 0.0),
            mode="drop", unique_indices=True,
        )
        if has_overflow:
            tgt = jnp.where(ok & jnp.logical_not(staged_round), lid, r_local)
            dense = dense.at[tgt.reshape(-1)].add(
                recv_g.reshape(-1, d), mode="drop"
            )
        return r + 1, oid, og, dense

    dense0 = (
        _pvary(jnp.zeros((r_local, d), g_rows.dtype), axis)
        if has_overflow else jnp.zeros((), g_rows.dtype)
    )
    _, oid, og, dense = jax.lax.while_loop(
        lambda c: c[0] < jnp.minimum(plan.rounds, max_rounds),
        body,
        (
            jnp.int32(0),
            _pvary(jnp.full((t_slots,), r_local, jnp.int32), axis),
            _pvary(jnp.zeros((t_slots, d), g_rows.dtype), axis),
            dense0,
        ),
    )
    return oid, og, (dense if has_overflow else None)


# ---- comm accounting --------------------------------------------------------------


def exchange_comm_bytes(
    batch_per_device: int,
    emb_dim: int,
    n_shards: int,
    capacity: int,
    rounds: int = 1,
    itemsize: int = 4,
) -> int:
    """Wire bytes per device per step for the all-to-all exchange: row data
    out and back per round ((m-1)/m of slots cross a link; self-chunks are
    local), plus the id request lanes. Steady state rounds=1."""
    m, c = n_shards, capacity
    cross = (m - 1) * c  # slots that actually leave the device, per direction
    ids_bytes = cross * 4 * rounds
    row_bytes = 2 * cross * emb_dim * itemsize * rounds  # requestward + response
    return ids_bytes + row_bytes


def psum_comm_bytes(
    batch_per_device: int, emb_dim: int, n_shards: int, itemsize: int = 4
) -> int:
    """Wire bytes per device per step for the legacy psum routing: a ring
    all-reduce of the dense [B_local, D] gathered block (send+recv)."""
    return 2 * 2 * (n_shards - 1) * batch_per_device * emb_dim * itemsize // n_shards


@partial(jax.jit, static_argnames=("n_shards", "capacity"))
def plan_stats(ids: jax.Array, n_shards: int, capacity: int):
    """(unique_ids, max_bucket, rounds) for a batch — host-side diagnostics
    for the comm log (no collectives; callable outside shard_map)."""
    ids_s = ids[jnp.argsort(_sort_key(ids, n_shards), stable=False)]
    is_start = jnp.concatenate([jnp.ones((1,), bool), ids_s[1:] != ids_s[:-1]])
    owner_s = owner_of(ids_s, n_shards)
    hcnt = jnp.bincount(
        jnp.where(is_start, owner_s, n_shards), length=n_shards + 1
    )[:n_shards]
    mx = jnp.max(hcnt)
    return jnp.sum(is_start), mx, -(-mx // capacity)

"""All-to-all embedding-row exchange (parallel/routing.py) on the virtual mesh.

The exchange must be EXACT for arbitrary id multisets — duplicates, skewed
owners (multi-round), out-of-bounds sentinels — and its VJP must equal the
dense gather's scatter-add grad. Oracle: plain numpy table[ids].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from anime_recommendations_tpu.parallel import routing
from anime_recommendations_tpu.parallel.mesh import make_mesh

AXES = ("data", "model")


def _mapped_exchange(mesh, n_shards, capacity):
    def f(table_local, ids):
        return routing.exchange_rows(
            table_local, ids, axis=AXES, n_shards=n_shards, capacity=capacity
        )

    return jax.jit(
        jax.shard_map(
            f,
            mesh=mesh,
            in_specs=(P(AXES, None), P(AXES)),
            out_specs=P(AXES),
        )
    )


def _setup(n_rows, d, mesh_shape, seed=0):
    mesh = make_mesh(*mesh_shape)
    m = mesh_shape[0] * mesh_shape[1]
    assert n_rows % m == 0
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(n_rows, d)).astype(np.float32)
    phys = routing.to_physical(table, m)
    return mesh, m, table, jnp.asarray(phys)


def test_physical_roundtrip():
    t = np.arange(24, dtype=np.float32).reshape(12, 2)
    for m in (1, 2, 3, 4, 6, 12):
        p = routing.to_physical(t, m)
        np.testing.assert_array_equal(routing.from_physical(p, m), t)
        # Block s of the physical layout holds global rows s, s+m, ...
        blocks = p.reshape(m, 12 // m, 2)
        for s in range(m):
            np.testing.assert_array_equal(blocks[s], t[s::m])


@pytest.mark.parametrize("mesh_shape", [(2, 4), (8, 1), (1, 8), (4, 2)])
def test_exchange_matches_gather(mesh_shape):
    mesh, m, table, phys = _setup(64, 8, mesh_shape)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 64, 128).astype(np.int32)  # many duplicates
    out = _mapped_exchange(mesh, m, capacity=routing.default_capacity(128 // m, m))(
        phys, jnp.asarray(ids)
    )
    np.testing.assert_allclose(np.asarray(out), table[ids], rtol=1e-6)


def test_exchange_multi_round_skew():
    """All ids owned by ONE shard with a tiny capacity: the rounds
    while_loop must deliver every row (overflow never drops)."""
    mesh, m, table, phys = _setup(64, 4, (2, 4))
    ids = (np.arange(24, dtype=np.int32) * m) % 64  # all owner 0, 16 unique
    out = _mapped_exchange(mesh, m, capacity=2)(phys, jnp.asarray(ids))
    np.testing.assert_allclose(np.asarray(out), table[ids], rtol=1e-6)


def test_exchange_oob_sentinel_rows_are_zero():
    mesh, m, table, phys = _setup(64, 4, (4, 2))
    ids = np.array([1, 64 + 0, 5, 64 + 7, 63, 64, 64, 2] * 2, np.int32)
    out = np.asarray(_mapped_exchange(mesh, m, capacity=4)(phys, jnp.asarray(ids)))
    for i, g in enumerate(ids):
        if g >= 64:
            np.testing.assert_array_equal(out[i], 0.0)
        else:
            np.testing.assert_allclose(out[i], table[g], rtol=1e-6)


@pytest.mark.parametrize("mesh_shape,capacity", [((2, 4), 0), ((8, 1), 2)])
def test_exchange_vjp_matches_dense_scatter_add(mesh_shape, capacity):
    mesh, m, table, phys = _setup(32, 4, mesh_shape, seed=1)
    rng = np.random.default_rng(4)
    b = 64
    ids = rng.integers(0, 34, b).astype(np.int32)  # incl. OOB ids 32/33
    cot = rng.normal(size=(b, 4)).astype(np.float32)
    cap = capacity or routing.default_capacity(b // m, m)
    ex = _mapped_exchange(mesh, m, cap)

    g_phys = jax.grad(
        lambda t: jnp.vdot(ex(t, jnp.asarray(ids)), jnp.asarray(cot))
    )(phys)
    g_logical = routing.from_physical(np.asarray(g_phys), m)

    oracle = np.zeros_like(table)
    for i, g in enumerate(ids):
        if g < 32:
            oracle[g] += cot[i]
    np.testing.assert_allclose(g_logical, oracle, rtol=1e-5, atol=1e-6)


def test_plan_stats_and_comm_accounting():
    ids = jnp.asarray(np.array([0, 8, 16, 1, 1, 1, 2, 3], np.int32))
    uniq, mx, rounds = routing.plan_stats(ids, n_shards=8, capacity=4)
    assert int(uniq) == 6          # {0,8,16,1,2,3}
    assert int(mx) == 3            # owner 0 owns {0,8,16}
    assert int(rounds) == 1
    # At the no-slack capacity (deduped uniform batch), a2a moves ~1/m of
    # the psum path's dense [B, D] all-reduce.
    a2a = routing.exchange_comm_bytes(1024, 128, 8, capacity=128)
    ps = routing.psum_comm_bytes(1024, 128, 8)
    assert a2a < ps / 1.9


def test_pad_sentinel_is_oob_for_its_owner():
    for m in (1, 2, 8):
        n = 64
        for s in range(m):
            g = routing.pad_sentinel(n, m, s)
            assert int(routing.owner_of(jnp.int32(g), m)) == s
            assert int(routing.local_of(jnp.int32(g), m)) >= n // m


@pytest.mark.parametrize("staged_rounds", [1, 2, 64])
def test_route_grad_rows_staged_plus_overflow(staged_rounds):
    """route_grad_rows under forced deep overflow (capacity=2, one hot
    owner): the staged receipts PLUS the dense overflow gradient must
    together equal the dense scatter-add oracle, for any staged_rounds —
    including 1 (everything past round 0 goes dense) and a huge value
    (overflow branch statically absent, third output None)."""
    mesh, m, table, phys = _setup(64, 4, (2, 4))
    rng = np.random.default_rng(7)
    b = 32
    ids = ((np.arange(b, dtype=np.int32) * m) % 64)  # all owner 0 -> skew
    g_rows = rng.normal(size=(b, 4)).astype(np.float32)
    r_local = 64 // m
    cap = 2

    def f(ids_l, g_l):
        oid, og, dense = routing.route_grad_rows(
            ids_l, g_l, axis=AXES, n_shards=m, capacity=cap,
            r_local=r_local, staged_rounds=staged_rounds,
        )
        acc = jnp.zeros((r_local, 4), jnp.float32).at[oid].add(og, mode="drop")
        if dense is not None:
            acc = acc + dense
        return acc

    mapped = jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(P(AXES), P(AXES)),
        out_specs=P(AXES, None),
    ))
    got_phys = np.asarray(mapped(jnp.asarray(ids), jnp.asarray(g_rows)))
    got = routing.from_physical(got_phys, m)

    oracle = np.zeros_like(table)
    for i, g in enumerate(ids):
        oracle[g] += g_rows[i]
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-6)


def test_single_shard_identity_routing():
    """m=1 (identity specialization): forward == table[ids] with OOB ->
    zeros, the VJP == the dense scatter-add, and route_grad_rows' receipts
    reconstruct the same dense gradient."""
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    rng = np.random.default_rng(9)
    n, d, b = 24, 4, 40
    table = rng.normal(size=(n, d)).astype(np.float32)
    ids = rng.integers(0, n + 2, b).astype(np.int32)   # incl. OOB n / n+1
    cot = rng.normal(size=(b, d)).astype(np.float32)
    cap = routing.default_capacity(b, 1)
    ex = _mapped_exchange(mesh, 1, cap)

    out = np.asarray(ex(jnp.asarray(table), jnp.asarray(ids)))
    oracle = np.where((ids < n)[:, None], table[np.clip(ids, 0, n - 1)], 0.0)
    np.testing.assert_allclose(out, oracle, rtol=1e-6)

    g = np.asarray(jax.grad(
        lambda t: jnp.vdot(ex(t, jnp.asarray(ids)), jnp.asarray(cot))
    )(jnp.asarray(table)))
    goracle = np.zeros_like(table)
    for i, gid in enumerate(ids):
        if gid < n:
            goracle[gid] += cot[i]
    np.testing.assert_allclose(g, goracle, rtol=1e-5, atol=1e-6)

    # route_grad_rows shortcut: receipts reconstruct the same dense grad.
    def f(ids_l, g_l):
        oid, og, dense = routing.route_grad_rows(
            ids_l, g_l, axis=AXES, n_shards=1, capacity=cap, r_local=n,
        )
        assert dense is None
        return oid, og

    oid, og = jax.jit(jax.shard_map(
        f, mesh=mesh,
        in_specs=(P(AXES), P(AXES, None)),
        out_specs=(P(AXES), P(AXES, None)),
    ))(jnp.asarray(ids), jnp.asarray(cot))
    oid, og = np.asarray(oid), np.asarray(og)
    dense_from_receipts = np.zeros_like(table)
    for j in range(len(oid)):
        if oid[j] < n:
            dense_from_receipts[oid[j]] += og[j]
    np.testing.assert_allclose(dense_from_receipts, goracle, rtol=1e-5,
                               atol=1e-6)

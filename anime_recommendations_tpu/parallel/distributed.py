"""Multi-process runtime initialization.

Replacement for the reference's cluster-resolver connect
(neural_network.py:142-144). With several processes, every process calls
initialize() before any jax op; afterwards jax.devices() spans all of
them and the ('data','model') mesh from parallel.mesh lays collectives
across processes. Single-process (or already-initialized) runs no-op.

On GPUs each process owns one card: pass
``jax.distributed.initialize(..., local_device_ids=[i])`` for process i
of a host. One process can also drive all the cards of a host by itself,
which is what the benchmark and chip_smoke.py do. The 2-process run in
tests/test_distributed.py is a rehearsal on virtual CPU devices.

Data loading stays host-local: each host feeds only the batch rows for its
addressable devices (host_batch_slice), so no global batch ever
materializes on one host — the SPMD equivalent of tf.data sharding.
"""

from __future__ import annotations

import logging
import os

import jax

logger = logging.getLogger(__name__)


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize jax.distributed when running multi-host; returns True when
    a multi-process runtime is active after the call.

    With no arguments, reads the JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID env vars; nothing detects a
    cluster by itself.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        # Single-host run; nothing to initialize. (Do NOT probe
        # jax.process_count() before this point — it would boot the XLA
        # backend and make a later distributed init impossible.)
        return jax.process_count() > 1
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        # Already initialized by the launcher, or the backend was already
        # booted by earlier single-process work in this interpreter.
        logger.warning("jax.distributed.initialize skipped: %s", e)
    logger.info(
        "jax.distributed initialized: process %d/%d, %d local / %d global devices",
        jax.process_index(), jax.process_count(),
        jax.local_device_count(), jax.device_count(),
    )
    return jax.process_count() > 1


def host_batch_slice(global_batch: int) -> slice:
    """The slice of a global batch this host is responsible for feeding.

    Batches are sharded over the 'data' axis; with jax.Array + NamedSharding
    each host only needs to materialize the rows for its addressable
    devices. The global batch must divide evenly by process count — for a
    ragged batch (e.g. the reference's 10,000 rows on a host count that
    doesn't divide it) pad FIRST with pad_batch_for_hosts: zero-weight
    rows are exactly inert in every loss/metric (weighted sums) and in the
    row-sparse/fused updates (zero grads), so padding is the supported
    ragged-tail story — the multi-host analog of the single-chip path's
    weight-padded final batch (train/device_loop.stage).
    """
    n = jax.process_count()
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} not divisible by {n} hosts; "
            "pad with pad_batch_for_hosts (zero-weight rows are inert)"
        )
    per = global_batch // n
    i = jax.process_index()
    return slice(i * per, (i + 1) * per)


def pad_batch_for_hosts(
    users, anime, ratings, weights=None, n_shards: int | None = None
):
    """Zero-weight-pad a global batch to a multiple of ``n_shards``
    (default: the global device count — the unit every batch axis splits
    over). Returns (users, anime, ratings, weights) with padded rows
    carrying weight 0, user/anime id 0 and rating 0 — inert under the
    weighted loss/metrics and under every optimizer path (dense Adam sees
    a zero grad contribution for them; lazy/fused route a zero grad-sum).
    """
    import numpy as np

    if n_shards is None:
        n_shards = jax.device_count()
    b = len(users)
    target = -(-b // n_shards) * n_shards
    pad = target - b
    if weights is None:
        weights = np.ones(b, np.float32)
    if pad == 0:
        # Same dtype contract as the padded path below: float32 ratings /
        # weights regardless of the input dtype (integer ratings would
        # otherwise come back int here and float32 when padding happened).
        return (np.asarray(users), np.asarray(anime),
                np.asarray(ratings, dtype=np.float32),
                np.asarray(weights, dtype=np.float32))
    return (
        np.pad(np.asarray(users), (0, pad)),
        np.pad(np.asarray(anime), (0, pad)),
        np.pad(np.asarray(ratings, dtype=np.float32), (0, pad)),
        np.pad(np.asarray(weights, dtype=np.float32), (0, pad)),
    )


# ---- multi-process worker ----------------------------------------------------------
#
# `python -m anime_recommendations_tpu.parallel.distributed --worker ...` runs
# ONE ShardedTrainStep under a real multi-process jax runtime: every host
# process calls initialize(), builds the same global mesh, feeds ONLY its
# host_batch_slice of the global batch, and executes the SPMD step whose
# collectives now cross process boundaries. This is the executable template
# for a multi-process launch and the target of the 2-process CPU test
# (tests/test_distributed.py) — the engine equivalent of the reference's
# cluster connect + strategy.scope() training
# (neural_network.py:142-144,174-178).


def worker_step(
    data_axis: int,
    model_axis: int,
    n_users: int = 1024,
    n_anime: int = 256,
    batch: int = 512,
    steps: int = 2,
    optimizer: str = "adam",
    seed: int = 0,
) -> dict:
    """Run ``steps`` sharded train steps across all processes; returns
    {process, n_processes, devices, loss, mse} (loss/mse identical on every
    process — they are psum'd over the whole mesh)."""
    import numpy as np
    from jax.sharding import Mesh

    from anime_recommendations_tpu.parallel.mesh import (
        DATA_AXIS,
        MODEL_AXIS,
        pad_rows_for_shards,
    )
    from anime_recommendations_tpu.parallel.sharded_train import (
        ShardedTrainStep,
        _map_tables,
        state_shardings,
    )
    from anime_recommendations_tpu.parallel import routing as rt
    from anime_recommendations_tpu.train.trainer import init_train_state

    n_dev = data_axis * model_axis
    devices = jax.devices()[:n_dev]
    if len(devices) != n_dev:
        raise ValueError(f"need {n_dev} devices, have {len(devices)}")
    # Plain row-major device order (NOT mesh_utils): device ids are
    # process-contiguous, so the batch's 'data' split lines up with
    # host_batch_slice — each host feeds exactly its own devices.
    mesh = Mesh(np.array(devices).reshape(data_axis, model_axis),
                (DATA_AXIS, MODEL_AXIS))
    step = ShardedTrainStep(mesh, l2_reg_factor=1e-4, optimizer=optimizer)

    # Identical host-side init on every process (same seed), placed shard-
    # by-shard: make_array_from_callback materializes only the shards this
    # process' devices own.
    n_users_p = pad_rows_for_shards(n_users, n_dev)
    n_anime_p = pad_rows_for_shards(n_anime, n_dev)
    state = init_train_state(jax.random.PRNGKey(seed), n_users_p, n_anime_p, 32)
    state = _map_tables(state, lambda t: rt.to_physical(np.asarray(t), n_dev))

    def place(x, sharding):
        host = np.asarray(x)
        return jax.make_array_from_callback(host.shape, sharding,
                                            lambda idx: host[idx])

    state = jax.tree.map(place, state, state_shardings(mesh))

    # Host-local feeding: each process materializes ONLY its slice of the
    # global batch (the tf.data-sharding analog, SURVEY.md §5.8).
    rng = np.random.default_rng(seed + 1)
    bspec = step.batch_sharding()
    sl = host_batch_slice(batch)

    def feed(col):
        return jax.make_array_from_process_local_data(bspec, col[sl])

    loss = mse = None
    lr = np.float32(5e-5)
    for i in range(steps):
        # Same stream on every process; each keeps only its slice.
        users = rng.integers(0, n_users, batch).astype(np.int32)
        anime = rng.integers(0, n_anime, batch).astype(np.int32)
        ratings = rng.uniform(0, 1, batch).astype(np.float32)
        weights = np.ones(batch, np.float32)
        state, loss, mse = step.train_step(
            state, feed(users), feed(anime), feed(ratings), feed(weights), lr
        )
    return {
        "process": jax.process_index(),
        "n_processes": jax.process_count(),
        "devices": jax.device_count(),
        "loss": float(loss),
        "mse": float(mse),
    }


def worker_fit(
    data_axis: int,
    model_axis: int,
    n_users: int = 512,
    n_anime: int = 128,
    rows: int = 8192,
    batch: int = 512,
    epochs: int = 3,
    optimizer: str = "fused_adam",
    seed: int = 0,
    checkpoint_dir: str | None = None,
    resume: bool = False,
) -> dict:
    """A FULL ``ShardedTrainer.fit`` across all processes: device epoch
    scan (train + on-mesh holdout eval in one program per epoch, with
    precomputed exchange plans for the routed optimizers), best-checkpoint
    saves, and optional same-mesh resume — the engine equivalent of the
    reference's complete distributed ``model.fit``
    (neural_network.py:174-217), not just isolated steps.

    Every process builds the identical synthetic dataset (same seed) and
    stages it via put_global (each host materializes only its own devices'
    shards); loss/val metrics are mesh-psum'd, so the returned history must
    be identical on every process AND identical to a single-process run on
    the same mesh size.
    """
    import numpy as np

    from anime_recommendations_tpu.data.dataset import RatingsDataset
    from anime_recommendations_tpu.parallel.trainer import ShardedTrainer

    rng = np.random.default_rng(seed + 17)
    users = rng.integers(0, n_users, rows).astype(np.int32)
    anime = rng.integers(0, n_anime, rows).astype(np.int32)
    ratings = rng.uniform(0, 1, rows).astype(np.float32)
    cut = rows - max(rows // 8, batch)
    train = RatingsDataset(users[:cut], anime[:cut], ratings[:cut])
    holdout = RatingsDataset(users[cut:], anime[cut:], ratings[cut:])

    trainer = ShardedTrainer(
        embedding_size=16,
        batch_size=batch,
        epochs=epochs,
        data_axis=data_axis,
        model_axis=model_axis,
        device_loop=True,
        optimizer=optimizer,
        seed=seed,
        patience=max(epochs, 3),   # no early stop inside the short test
        verbose=False,
        checkpoint_dir=checkpoint_dir,
        max_lr=5e-3, start_lr=1e-3, min_lr=1e-3, rampup_epochs=2,
    )
    result = trainer.fit(train, holdout, n_users, n_anime, resume=resume)
    return {
        "process": jax.process_index(),
        "n_processes": jax.process_count(),
        "devices": jax.device_count(),
        "loss": result.history["loss"].round(6).tolist(),
        "val_loss": result.history["val_loss"].round(6).tolist(),
        "best_epoch": result.best_epoch,
        "epochs_run": result.epochs_run,
        # Fingerprint of the fitted (allgathered, unstriped) user table:
        # identical across processes iff the SPMD fit and the cross-process
        # state pull both worked.
        "user_emb_absum": float(np.abs(result.state.params.user_emb).sum()),
    }


def main(argv=None) -> None:
    import argparse
    import json

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--worker", action="store_true")
    parser.add_argument("--fit", action="store_true",
                        help="run a full ShardedTrainer.fit instead of raw steps")
    parser.add_argument("--cpu-devices", type=int, default=0,
                        help="local virtual CPU devices for this process")
    parser.add_argument("--data-axis", type=int, default=-1)
    parser.add_argument("--model-axis", type=int, default=1)
    parser.add_argument("--batch", type=int, default=512)
    parser.add_argument("--steps", type=int, default=2)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--optimizer", default="adam")
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument("--resume", action="store_true")
    args = parser.parse_args(argv)

    if args.cpu_devices:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.cpu_devices)
    initialize()
    data_axis = args.data_axis
    if data_axis == -1:
        data_axis = jax.device_count() // args.model_axis
    if args.fit:
        out = worker_fit(
            data_axis, args.model_axis, batch=args.batch, epochs=args.epochs,
            optimizer=args.optimizer, checkpoint_dir=args.checkpoint_dir,
            resume=args.resume,
        )
    else:
        out = worker_step(
            data_axis, args.model_axis, batch=args.batch, steps=args.steps,
            optimizer=args.optimizer,
        )
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

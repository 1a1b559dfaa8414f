"""Scaling-efficiency benchmark harness.

Measures sustained training examples/s for a set of mesh shapes and
reports parallel efficiency relative to the smallest shape
(BASELINE.md target: >=80% examples/s/chip efficiency 1 chip -> N).

On several hosts run one process per host with
``jax.distributed.initialize()`` and the full device set; without the
cards the same harness runs against virtual CPU devices
(JAX_PLATFORMS=cpu + jax_num_cpu_devices), which validates the
sharding/collective structure but NOT real interconnect bandwidth.

Usage:
    python -m anime_recommendations_tpu.parallel.scaling_bench \
        --meshes 1x1 2x1 4x1 4x2 --steps 30 --batch 8192 --cpu-devices 8

``--cpu-devices N`` flips jax to an N-device virtual CPU topology
in-process. Omit it to run on the real device(s).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def measure_mesh(
    data_axis: int,
    model_axis: int,
    n_users: int,
    n_anime: int,
    embedding_size: int,
    batch: int,
    steps: int,
    seed: int = 0,
    routing: str = "alltoall",
    optimizer: str = "adam",
) -> dict:
    import jax

    from anime_recommendations_tpu.parallel.mesh import make_mesh, pad_rows_for_shards
    from anime_recommendations_tpu.parallel.sharded_train import (
        ShardedTrainStep,
        place_state,
    )
    from anime_recommendations_tpu.train.trainer import init_train_state

    n_dev = data_axis * model_axis
    mesh = make_mesh(data_axis, model_axis, devices=jax.devices()[:n_dev])
    step = ShardedTrainStep(
        mesh, l2_reg_factor=1e-4, routing=routing, optimizer=optimizer
    )
    # alltoall row-shards BOTH tables over the whole mesh; psum shards only
    # the user table over 'model' and replicates the anime table.
    if routing == "alltoall":
        n_users_p = pad_rows_for_shards(n_users, n_dev)
        n_anime_p = pad_rows_for_shards(n_anime, n_dev)
    else:
        n_users_p = pad_rows_for_shards(n_users, model_axis)
        n_anime_p = n_anime
    state = place_state(
        init_train_state(jax.random.PRNGKey(seed), n_users_p, n_anime_p,
                         embedding_size),
        mesh,
        routing=routing,
    )
    rng = np.random.default_rng(seed)
    bspec = step.batch_sharding()
    n_batches = 4
    batches = [
        (
            jax.device_put(rng.integers(0, n_users, batch).astype(np.int32), bspec),
            jax.device_put(rng.integers(0, n_anime, batch).astype(np.int32), bspec),
            jax.device_put(rng.uniform(0, 1, batch).astype(np.float32), bspec),
            jax.device_put(np.ones(batch, np.float32), bspec),
        )
        for _ in range(n_batches)
    ]
    lr = np.float32(5e-5)

    def run(state, n):
        loss = None
        for i in range(n):
            u, a, r, w = batches[i % n_batches]
            state, loss, _ = step.train_step(state, u, a, r, w, lr)
        return state, loss

    state, loss = run(state, 3)  # compile + warm
    float(loss)
    t0 = time.perf_counter()
    state, loss = run(state, steps)
    float(loss)
    dt = time.perf_counter() - t0
    return {
        "mesh": f"{data_axis}x{model_axis}",
        "devices": n_dev,
        "routing": routing,
        "optimizer": optimizer,
        "examples_per_sec": steps * batch / dt,
        "step_ms": dt / steps * 1e3,
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--meshes", nargs="+", default=["1x1", "2x1", "4x1", "4x2"])
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--batch", type=int, default=8192)
    parser.add_argument("--users", type=int, default=91_641)
    parser.add_argument("--anime", type=int, default=17_560)
    parser.add_argument("--emb", type=int, default=128)
    parser.add_argument("--routing", choices=["alltoall", "psum"],
                        default="alltoall")
    parser.add_argument("--optimizer", choices=["adam", "lazy_adam", "fused_adam"],
                        default="adam")
    parser.add_argument("--cpu-devices", type=int, default=0,
                        help="force an N-device virtual CPU topology")
    parser.add_argument("--weak", action="store_true",
                        help="weak scaling: global batch = --batch * devices "
                             "(the reference's num_replicas_in_sync scaling, "
                             "neural_network.py:176-177)")
    args = parser.parse_args(argv)

    if args.cpu_devices:
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.cpu_devices)

    results = []
    for shape in args.meshes:
        d, m = (int(x) for x in shape.split("x"))
        batch = args.batch * (d * m if args.weak else 1)
        res = measure_mesh(
            d, m, args.users, args.anime, args.emb, batch, args.steps,
            routing=args.routing, optimizer=args.optimizer,
        )
        results.append(res)
        print(json.dumps(res), flush=True)

    base = results[0]
    for res in results:
        scale = res["devices"] / base["devices"]
        ideal = base["examples_per_sec"] * scale
        res["efficiency_vs_first"] = res["examples_per_sec"] / ideal
    print(
        json.dumps(
            {
                "summary": [
                    {
                        "mesh": r["mesh"],
                        "examples_per_sec": round(r["examples_per_sec"]),
                        "efficiency": round(r["efficiency_vs_first"], 3),
                    }
                    for r in results
                ]
            }
        )
    )


if __name__ == "__main__":
    main()

"""Benchmark: training throughput and retrieval latency on one GPU.

    python bench.py

Prints the card's name and power limit, then ONE JSON line:
  {"metric": "train_examples_per_sec", "value": N, "unit": "examples/s",
   "device": {...}, "details": {...}}

Model/table shapes match the reference's trained tables (91,641x128 users,
17,560x128 anime, batch 10,000 — similar_anime.py:156,165,
config.yaml:59) and the full MyAnimeList scale (350,000 users,
SURVEY.md:240). Every time is host wall clock around work that ends in
``block_until_ready``; a one-read floor (table bytes over the H100's
3.35 TB/s) is printed beside each retrieval time, never substituted for
it. Without a GPU the benchmark stops: it has no CPU fallback.
"""

import json
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory, NVIDIA data sheet
D, BATCH, L2 = 128, 10_000, 1e-4
N_USERS, N_ANIME = 91_641, 17_560
N_USERS_FULL = 350_000
EPOCH_ROWS, EPOCH_ROWS_FULL = 2_000_000, 1_000_000
ROUTED_BATCHES = 50
IVF_ROWS = 2_000_000
ITERS = 20


def _epoch_secs(run_epoch, state, reps: int = 3):
    """Best-of-``reps`` seconds of one device epoch (after a compile run);
    returns (seconds, final state)."""
    import jax

    state, losses = run_epoch(state, 0)
    jax.block_until_ready(losses)
    best = np.inf
    for rep in range(1, reps + 1):
        t0 = time.perf_counter()
        state, losses = run_epoch(state, rep)
        jax.block_until_ready(losses)
        best = min(best, time.perf_counter() - t0)
    return best, state


def bench_training(details: dict, rng) -> float:
    import jax
    import jax.numpy as jnp

    from anime_recommendations_tpu.data.dataset import RatingsDataset
    from anime_recommendations_tpu.train import device_loop as dl
    from anime_recommendations_tpu.train.trainer import (
        cast_table_moments, init_train_state, train_step,
    )
    from anime_recommendations_tpu.utils.profiling import time_per_call

    lr = jnp.float32(5e-5)
    key = jax.random.PRNGKey(0)

    # Per-step path: one launch per batch.
    state = init_train_state(jax.random.PRNGKey(0), N_USERS, N_ANIME, D)
    batch = (
        jnp.asarray(rng.integers(0, N_USERS, BATCH), jnp.int32),
        jnp.asarray(rng.integers(0, N_ANIME, BATCH), jnp.int32),
        jnp.asarray(rng.uniform(0, 1, BATCH), jnp.float32),
        jnp.ones(BATCH, jnp.float32),
    )
    box = [state]

    def step():
        box[0], loss, _ = train_step(box[0], *batch, lr, L2)
        return loss

    details["train_step_ms"] = time_per_call(step, iters=30) * 1e3

    def dataset(n_users, rows):
        return RatingsDataset(
            users=rng.integers(0, n_users, rows).astype(np.int32),
            anime=rng.integers(0, N_ANIME, rows).astype(np.int32),
            ratings=rng.uniform(0, 1, rows).astype(np.float32),
        )

    # Device-resident epoch loop (the production path), per optimizer.
    epoch_ex_per_s = {}
    for n_users, rows, tag, opts in (
        (N_USERS, EPOCH_ROWS, "train",
         ("adam", "fused_adam", "fused_adam_bf16m")),
        (N_USERS_FULL, EPOCH_ROWS_FULL, "train350k",
         ("adam", "lazy_adam", "fused_adam", "fused_adam_bf16m")),
    ):
        data = dl.stage(dataset(n_users, rows), BATCH, seed=0)
        for opt in opts:
            st = init_train_state(jax.random.PRNGKey(1), n_users, N_ANIME, D)
            if opt == "fused_adam_bf16m":
                st = cast_table_moments(st, jnp.bfloat16)

            def run(st, rep, opt=opt, data=data):
                st, losses, _, _ = dl.train_epoch(
                    st, data, jax.random.fold_in(key, rep), lr, BATCH, L2,
                    sorted_scatter=True, optimizer=opt,
                )
                return st, losses

            secs, _ = _epoch_secs(run, st)
            details[f"{tag}_epoch_{opt}_step_ms"] = secs / (rows / BATCH) * 1e3
            details[f"{tag}_epoch_{opt}_examples_per_sec"] = rows / secs
            if tag == "train":
                epoch_ex_per_s[opt] = rows / secs
        del data

    # Routed SPMD trainer on a 1x1 mesh at 350K: the multi-card program's
    # machinery (all-to-all exchange plan + owner-side fused Adam), per
    # step and as a planned epoch.
    from jax.sharding import NamedSharding, PartitionSpec as P

    from anime_recommendations_tpu.parallel.mesh import make_mesh
    from anime_recommendations_tpu.parallel.sharded_train import (
        ShardedTrainStep, build_epoch_fn, build_plans_fn, place_state,
    )

    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    sstep = ShardedTrainStep(mesh, l2_reg_factor=L2, routing="alltoall",
                             optimizer="fused_adam")
    sh = NamedSharding(mesh, P(None, ("data", "model")))
    rows = ROUTED_BATCHES * BATCH
    ru = jax.device_put(jnp.asarray(
        rng.integers(0, N_USERS_FULL, rows), jnp.int32).reshape(-1, BATCH), sh)
    ra = jax.device_put(jnp.asarray(
        rng.integers(0, N_ANIME, rows), jnp.int32).reshape(-1, BATCH), sh)
    rr = jax.device_put(jnp.asarray(
        rng.uniform(0, 1, rows), jnp.float32).reshape(-1, BATCH), sh)
    rw = jax.device_put(jnp.ones((ROUTED_BATCHES, BATCH), jnp.float32), sh)
    box = [place_state(
        init_train_state(jax.random.PRNGKey(3), N_USERS_FULL, N_ANIME, D),
        mesh, routing="alltoall",
    )]

    def sharded_step():
        box[0], loss, _ = sstep.train_step(box[0], ru[0], ra[0], rr[0], rw[0], lr)
        return loss

    details["train350k_sharded_fused_step_ms"] = (
        time_per_call(sharded_step, iters=30) * 1e3)
    del box

    plans_u, plans_a = build_plans_fn(sstep)(ru, ra)
    epoch = build_epoch_fn(sstep, shuffle=True, planned=True)
    ev = (ru[:2], ra[:2], rr[:2], rw[:2])
    for tag, moments in (("fused", jnp.float32), ("bf16m", jnp.bfloat16)):
        st = place_state(
            cast_table_moments(
                init_train_state(jax.random.PRNGKey(4), N_USERS_FULL, N_ANIME, D),
                moments),
            mesh, routing="alltoall",
        )

        def run(st, rep):
            st, losses, *_ = epoch(st, ru, ra, rr, rw, ev,
                                   jax.random.fold_in(key, rep), lr,
                                   plans_u=plans_u, plans_a=plans_a)
            return st, losses

        secs, _ = _epoch_secs(run, st)
        details[f"train350k_sharded_{tag}_epoch_step_ms"] = (
            secs / ROUTED_BATCHES * 1e3)
    return max(epoch_ex_per_s["adam"], epoch_ex_per_s["fused_adam"])


def _overlap(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.mean([len(set(g) & set(w)) / got.shape[1]
                          for g, w in zip(got, want)]))


def bench_retrieval(details: dict, rng) -> None:
    import jax
    import jax.numpy as jnp

    from anime_recommendations_tpu.ops.ivf import build_ivf, ivf_topk
    from anime_recommendations_tpu.ops.quantized import quantize_rows
    from anime_recommendations_tpu.ops.scoring import score_topk
    from anime_recommendations_tpu.ops.topk import cosine_topk
    from anime_recommendations_tpu.utils.profiling import time_per_call

    W = rng.standard_normal((N_USERS_FULL, D), dtype=np.float32)
    W /= np.linalg.norm(W, axis=1, keepdims=True)
    tables = {
        "f32": jax.device_put(jnp.asarray(W)),
        "bf16": jax.device_put(jnp.asarray(W, jnp.bfloat16)),
        "int8": jax.device_put(quantize_rows(jnp.asarray(W))),
    }
    itemsize = {"f32": 4, "bf16": 2, "int8": 1}
    topk10 = lambda t, q: cosine_topk(t, q, k=10)
    for q in (1, 8, 256):
        Q = jnp.asarray(W[rng.choice(N_USERS_FULL, q, replace=False)])
        for tag, table in tables.items():
            qq = Q.astype(jnp.bfloat16) if tag == "bf16" else Q
            ms = time_per_call(topk10, table, qq, iters=ITERS) * 1e3
            key = f"topk_user_{tag}_q{q}"
            details[f"{key}_ms"] = ms
            details[f"{key}_qps"] = q / (ms / 1e3)
            details[f"{key}_floor_ms"] = (
                N_USERS_FULL * D * itemsize[tag] / HBM_BYTES_PER_S * 1e3)

    # Exactness against a numpy oracle (f32 q=256, int8 q=16).
    Q = W[:256]
    oracle = np.argsort(-(Q @ W.T), axis=1)[:, :10]
    details["topk_q256_overlap_vs_oracle"] = _overlap(
        topk10(tables["f32"], jnp.asarray(Q))[1], oracle)
    details["topk_int8_overlap_vs_oracle"] = _overlap(
        topk10(tables["int8"], jnp.asarray(Q[:16]))[1], oracle[:16])

    # Model-recs scoring over the catalog: one user and 256 users per call.
    Wa = jax.device_put(jnp.asarray(W[:N_ANIME]))
    head = jnp.asarray([2.3, -0.8], jnp.float32)
    watched = np.zeros(N_ANIME, bool)
    watched[rng.choice(N_ANIME, 500, replace=False)] = True
    mask = jnp.asarray(~watched)
    score10 = lambda t, q: score_topk(t, q, head, 10, mask=mask)
    for q in (1, 256):
        ms = time_per_call(score10, Wa, jnp.asarray(W[:q]), iters=ITERS) * 1e3
        details[f"score_topk_catalog_q{q}_ms"] = ms
        details[f"score_topk_catalog_q{q}_qps"] = q / (ms / 1e3)
    sc = 1.0 / (1.0 + np.exp(-(2.3 * (W[:64] @ W[:N_ANIME].T) - 0.8)))
    sc[:, watched] = -np.inf
    details["score_topk_overlap_vs_oracle"] = _overlap(
        score10(Wa, jnp.asarray(W[:64]))[1], np.argsort(-sc, axis=1)[:, :10])

    # IVF at beyond-catalog scale: a rank-16-latent 2M x 128 table (the
    # clustered geometry trained tables have).
    lat = jnp.asarray(rng.standard_normal((IVF_ROWS, 16)).astype(np.float32))
    proj = jnp.asarray(rng.standard_normal((16, D)).astype(np.float32) / 4.0)
    big = jax.jit(lambda u, p: (lambda w: w / jnp.linalg.norm(
        w, axis=1, keepdims=True))(u @ p))(lat, proj)
    jax.block_until_ready(big)
    t0 = time.perf_counter()
    ivf = build_ivf(big, n_clusters=2048, iters=8, seed=3)
    jax.block_until_ready(ivf.centroids)
    details["ivf2m_build_secs_incl_compile"] = time.perf_counter() - t0
    Qi = big[jnp.asarray(rng.integers(0, IVF_ROWS, 64))]
    exact = topk10(big, Qi)[1]
    q1 = Qi[:1]
    for p in (8, 32):
        details[f"ivf2m_p{p}_recall_at10"] = _overlap(
            ivf_topk(ivf, Qi, 10, probes=p)[1], exact)
        details[f"ivf2m_q1_p{p}_ms"] = time_per_call(
            lambda t, q, p=p: ivf_topk(t, q, 10, probes=p), ivf, q1,
            iters=ITERS) * 1e3
    details["ivf2m_exact_q1_ms"] = time_per_call(topk10, big, q1,
                                                 iters=ITERS) * 1e3


def bench_serving(details: dict) -> None:
    """Engine request latency with the context on the card: retrieval plus
    the host's enrichment and JSON shaping."""
    import jax

    from anime_recommendations_tpu.config import Config
    from anime_recommendations_tpu.data import synthetic as synth
    from anime_recommendations_tpu.data.catalog import Catalog
    from anime_recommendations_tpu.data.preprocess import preprocess_ratings
    from anime_recommendations_tpu.data.vocab import build_vocab, encode_frame
    from anime_recommendations_tpu.models import two_tower as tt
    from anime_recommendations_tpu.recommend import RecContext
    from anime_recommendations_tpu.serve.api import Engine

    frames = synth.synth_ratings(n_users=2_000, n_anime=500,
                                 n_interactions=200_000, seed=7)
    cat = synth.synth_anime_catalog(n_anime=500, seed=7)
    clean, _ = preprocess_ratings(frames, num_reviews=40)
    vocab = build_vocab(clean)
    catalog = Catalog.from_frames(cat, synth.synth_synopses(cat, seed=7))
    params = tt.init_params(jax.random.PRNGKey(9), vocab.n_users,
                            vocab.n_anime, 64)
    ctx = RecContext.build(params, tt.init_bn_state(), vocab, catalog,
                           encode_frame(clean, vocab))
    engine = Engine(ctx, Config(), cache_size=0)
    uid = int(vocab.user_ids[3])
    name = catalog.anime["Name"].iloc[5]
    for fn_name, call in (
        ("similar_anime", lambda: engine.similar_anime(name, k=10)),
        ("similar_users", lambda: engine.similar_users(uid, k=10)),
        ("user_recs", lambda: engine.user_recs(uid, k=10)),
        ("model_recs", lambda: engine.model_recs(uid, k=10)),
        ("user_prefs", lambda: engine.user_prefs(uid)),
    ):
        call()  # compile
        best = np.inf
        for _ in range(7):
            t0 = time.perf_counter()
            call()
            best = min(best, time.perf_counter() - t0)
        details[f"serve_{fn_name}_ms"] = best * 1e3


def main() -> None:
    import jax

    from anime_recommendations_tpu.utils.compile_cache import enable_compile_cache
    from anime_recommendations_tpu.utils.profiling import (
        gpu_name_and_power, require_gpu,
    )

    enable_compile_cache()
    require_gpu()
    card = gpu_name_and_power()
    print(card, flush=True)
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "nvidia_smi": card}
    rng = np.random.default_rng(0)
    details: dict = {}
    examples_per_sec = bench_training(details, rng)
    bench_retrieval(details, rng)
    bench_serving(details)
    print(json.dumps({
        "metric": "train_examples_per_sec",
        "value": examples_per_sec,
        "unit": "examples/s",
        "device": device,
        "details": details,
    }))


if __name__ == "__main__":
    main()

"""Smoke run of the whole system on one GPU: train, serve, check the ops.

    python chip_smoke.py                 # one card
    python chip_smoke.py --four-cards    # the routed trainer on four cards

One process, five phases, each printing its own ``[phase N]`` line:

1. device   — what JAX sees, the card's name and power limit from
              nvidia-smi, and which optional host packages import;
2. train    — the reference two-tower model at full width (embedding 128,
              batch 10,000, 350,000 users x 17,560 anime) on ~2M synthetic
              interactions, through Trainer with the device-resident epoch
              loop: "adam" for whole epochs, then a few steps each of
              "fused_adam" and "fused_adam_bf16m";
3. serve    — RecContext over the trained tables for f32, bf16 and int8
              retrieval and an IVF index; every recommender and batch
              endpoint through Engine, and one real HTTP request;
4. compare  — each retrieval op and the sparse Adam update against a
              plain numpy / optax reference at 350,000 x 128, with the
              precision and tolerance of each comparison printed, and the
              plain ops timed against their one-read memory floor;
5. the last line, one JSON object naming the device.

``--four-cards`` runs only the routed multi-device trainer and its
single-card reference. Any failed check raises, so the process exits
non-zero and prints no last line. Without a GPU it stops at once.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import threading
import time
import urllib.parse
import urllib.request
from dataclasses import dataclass

import numpy as np

OPTIONAL_PACKAGES = ("pandas", "pyarrow", "yaml", "orbax", "matplotlib")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory, NVIDIA data sheet


@dataclass(frozen=True)
class Sizes:
    n_users: int = 350_000
    n_anime: int = 17_560
    n_rows: int = 2_000_000
    emb: int = 128
    batch: int = 10_000
    epochs: int = 2
    fused_rows: int = 50_000       # 5 steps of each fused optimizer
    holdout: int = 10_000
    compare_queries: tuple = (1, 8, 256)
    k: int = 10
    timing_iters: int = 20
    ivf_probes: int = 16


FULL = Sizes()


class CheckFailed(RuntimeError):
    """A smoke check did not hold."""


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def say(phase: str, text: str) -> None:
    print(f"[{phase}] {text}", flush=True)


# ---- phase 1 ------------------------------------------------------------------


def phase_device() -> dict:
    import jax

    from anime_recommendations_tpu.utils.profiling import gpu_name_and_power

    devs = jax.devices()
    smi = gpu_name_and_power()
    found = {m: importlib.util.find_spec(m) is not None for m in OPTIONAL_PACKAGES}
    print(smi, flush=True)
    say("phase 1", f"device: {devs} kind={devs[0].device_kind!r} "
        f"jax={jax.__version__} nvidia-smi={smi!r} importable={found}")
    return {"smi": smi, "importable": found}


# ---- phase 2 ------------------------------------------------------------------


def full_vocab(clean, n_users: int, n_anime: int):
    """The frame's first-appearance vocab, extended with the synthetic ids
    that drew no interaction, so the tables have the full row counts."""
    from anime_recommendations_tpu.data import synthetic as syn
    from anime_recommendations_tpu.data.vocab import Vocab, build_vocab

    seen = build_vocab(clean)
    all_u = np.arange(n_users) * syn.USER_ID_STRIDE + syn.USER_ID_BASE
    all_a = np.arange(n_anime) * syn.ANIME_ID_STRIDE + syn.ANIME_ID_BASE
    return Vocab(
        user_ids=np.concatenate([seen.user_ids, np.setdiff1d(all_u, seen.user_ids)]),
        anime_ids=np.concatenate([seen.anime_ids, np.setdiff1d(all_a, seen.anime_ids)]),
    )


def epoch_memory(state, n_pad: int, batch: int, l2: float):
    """``compiled.memory_analysis()`` of the adam device epoch."""
    import jax
    import jax.numpy as jnp

    from anime_recommendations_tpu.train import device_loop as dl

    sds = lambda x: jax.ShapeDtypeStruct(np.shape(x), x.dtype)
    data = dl.DeviceData(*(
        jax.ShapeDtypeStruct((n_pad,), dt)
        for dt in (jnp.int32, jnp.int32, jnp.float32, jnp.float32)
    ))
    lowered = dl.train_epoch.lower(
        jax.tree.map(sds, state), data, jax.random.PRNGKey(0),
        jnp.float32(1e-3), batch, l2, shuffle=True, sorted_scatter=True,
        optimizer="adam",
    )
    return lowered.compile().memory_analysis()


def phase_train(sizes: Sizes = FULL, seed: int = 0) -> dict:
    import jax.numpy as jnp

    from anime_recommendations_tpu.data import synthetic as syn
    from anime_recommendations_tpu.data.dataset import RatingsDataset, train_holdout_split
    from anime_recommendations_tpu.data.preprocess import preprocess_ratings
    from anime_recommendations_tpu.data.vocab import encode_frame
    from anime_recommendations_tpu.train.trainer import Trainer

    t0 = time.perf_counter()
    raw = syn.synth_ratings(n_users=sizes.n_users, n_anime=sizes.n_anime,
                            n_interactions=sizes.n_rows, seed=seed)
    clean, _ = preprocess_ratings(raw, num_reviews=1)
    vocab = full_vocab(clean, sizes.n_users, sizes.n_anime)
    encoded = encode_frame(clean, vocab)
    train, holdout = train_holdout_split(
        encoded[["user", "anime", "rating"]], test_size=sizes.holdout,
        shuffle_seed=seed + 42,
    )
    data_secs = time.perf_counter() - t0

    # The reference's own learning-rate schedule (Trainer defaults).
    common = dict(
        embedding_size=sizes.emb, batch_size=sizes.batch, device_loop=True,
        patience=sizes.epochs + 1, seed=seed,
        log_fn=lambda s: say("phase 2", s),
    )
    l2 = Trainer().l2_reg_factor
    t0 = time.perf_counter()
    result = Trainer(epochs=sizes.epochs, optimizer="adam", **common).fit(
        train, holdout, vocab.n_users, vocab.n_anime
    )
    fit_secs = time.perf_counter() - t0
    losses = result.history["loss"].to_numpy()
    check(np.isfinite(losses).all(), f"adam losses not finite: {losses}")
    check(losses[-1] < losses[0], f"adam loss did not fall: {losses}")
    steps = sizes.epochs * -(-len(train) // sizes.batch)
    mem = epoch_memory(result.state, -(-len(train) // sizes.batch) * sizes.batch,
                       sizes.batch, l2)

    sub = RatingsDataset(train.users[:sizes.fused_rows],
                         train.anime[:sizes.fused_rows],
                         train.ratings[:sizes.fused_rows])
    fused = {}
    for opt in ("fused_adam", "fused_adam_bf16m"):
        r = Trainer(epochs=1, optimizer=opt, **common).fit(
            sub, holdout, vocab.n_users, vocab.n_anime
        )
        loss = float(r.history["loss"].iloc[-1])
        check(np.isfinite(loss), f"{opt} loss not finite: {loss}")
        fused[opt] = loss
    check(r.state.opt_state.nu.user_emb.dtype == jnp.bfloat16,
          "fused_adam_bf16m did not keep bf16 moments")

    say("phase 2", (
        f"train: tables {vocab.n_users}x{sizes.emb} users, "
        f"{vocab.n_anime}x{sizes.emb} anime, batch {sizes.batch}, "
        f"{len(train)} train rows; adam loss per epoch "
        f"{[round(float(x), 6) for x in losses]}; {steps} steps in "
        f"{fit_secs:.2f} s incl. compile ({steps / fit_secs:.1f} steps/s, "
        f"information only); fused_adam loss {fused['fused_adam']:.6f}, "
        f"fused_adam_bf16m loss {fused['fused_adam_bf16m']:.6f}; data "
        f"build {data_secs:.1f} s; epoch memory_analysis: {mem}"
    ))
    return {"state": result.state, "vocab": vocab, "ratings": encoded,
            "losses": losses}


# ---- phase 3 ------------------------------------------------------------------


def _http_get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=120) as r:
        return r.status, json.loads(r.read())


def serve_once(ctx, anime_name: str, user_id: int, k: int) -> dict:
    """Every Engine endpoint once cold (compile) and once warm; returns
    {endpoint: (result, cold_ms, warm_ms)}."""
    from anime_recommendations_tpu.config import Config
    from anime_recommendations_tpu.serve.api import Engine

    engine = Engine(ctx, Config(), cache_size=0)
    other_users = [int(u) for u in ctx.vocab.user_ids[:3]]
    names = list(ctx.catalog.anime["Name"].iloc[:3])
    calls = {
        "similar_anime": lambda: engine.similar_anime(anime_name, k=k),
        "similar_users": lambda: engine.similar_users(user_id, k=k),
        "user_recs": lambda: engine.user_recs(user_id, k=k),
        "model_recs": lambda: engine.model_recs(user_id, k=k),
        "similar_anime_batch": lambda: engine.similar_anime_batch(names, k=k),
        "model_recs_batch": lambda: engine.model_recs_batch(other_users, k=k),
        "similar_users_batch": lambda: engine.similar_users_batch(other_users, k=k),
    }
    out = {}
    for name, call in calls.items():
        t0 = time.perf_counter()
        call()
        cold = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        res = call()
        warm = (time.perf_counter() - t0) * 1e3
        out[name] = (res, cold, warm)
    return out


def phase_serve(trained: dict, sizes: Sizes = FULL, seed: int = 0) -> dict:
    from anime_recommendations_tpu.config import Config
    from anime_recommendations_tpu.data import synthetic as syn
    from anime_recommendations_tpu.data.catalog import Catalog
    from anime_recommendations_tpu.recommend import RecContext
    from anime_recommendations_tpu.serve.api import make_server

    state, vocab, ratings = trained["state"], trained["vocab"], trained["ratings"]
    cat = syn.synth_anime_catalog(n_anime=sizes.n_anime, seed=seed)
    catalog = Catalog.from_frames(cat, syn.synth_synopses(cat, seed=seed))
    # The busiest user who has rated at most a tenth of the catalog, so
    # model_recs has unwatched anime to rank.
    counts = ratings["user_id"].value_counts()
    user_id = int(counts[counts <= max(sizes.n_anime // 10, 1)].index[0])
    top_anime = int(ratings["anime_id"].value_counts().idxmax())
    anime_name = str(cat.loc[cat["MAL_ID"] == top_anime, "Name"].iloc[0])
    k = sizes.k

    variants = {
        "f32": dict(retrieval_dtype=None),
        "bf16": dict(retrieval_dtype="bf16"),
        "int8": dict(retrieval_dtype="int8"),
        "ivf": dict(ann="ivf", ann_probes=sizes.ivf_probes),
    }
    results, lat = {}, {}
    for tag, kw in variants.items():
        ctx = RecContext.build(state.params, state.bn_state, vocab, catalog,
                               ratings, **kw)
        if tag == "f32":
            ctx_f32 = ctx
        res = serve_once(ctx, anime_name, user_id, k)
        for name, (payload, cold, warm) in res.items():
            check(len(payload) > 0, f"{tag} {name} returned nothing")
            lat[f"{tag}.{name}"] = (round(cold, 1), round(warm, 2))
        sims = [r["Similarity"] for r in res["similar_anime"][0]]
        check(len(sims) == k and np.isfinite(sims).all(),
              f"{tag} similar_anime: {sims}")
        preds = [r["Prediction"] for r in res["model_recs"][0]]
        check(len(preds) == k and np.isfinite(preds).all(),
              f"{tag} model_recs: {preds}")
        results[tag] = res
    names = {t: [r["Name"] for r in results[t]["similar_anime"][0]] for t in results}
    check(names["int8"] == names["f32"],
          f"int8 similar_anime differs from f32: {names['int8']} vs {names['f32']}")
    overlap_bf16 = len(set(names["bf16"]) & set(names["f32"])) / k

    server = make_server(ctx_f32, Config(), host="127.0.0.1", port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        t0 = time.perf_counter()
        status, body = _http_get(
            port, "/similar_anime?name=" + urllib.parse.quote(anime_name) + f"&k={k}"
        )
        http_ms = (time.perf_counter() - t0) * 1e3
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check(status == 200 and [r["Name"] for r in body] == names["f32"],
          f"HTTP /similar_anime: status {status}, {body}")

    for key, (cold, warm) in lat.items():
        say("phase 3", f"latency {key}: cold {cold} ms, warm {warm} ms")
    say("phase 3", (
        f"serve: f32/bf16/int8/ivf contexts answered similar_anime, "
        f"similar_users, user_recs, model_recs and the three batch "
        f"endpoints; int8 similar_anime == f32; bf16 top-{k} overlap with "
        f"f32 {overlap_bf16:.2f}; HTTP /similar_anime 200 in {http_ms:.1f} ms"
    ))
    return {"latency_ms": lat, "http_ms": http_ms}


# ---- phase 4 ------------------------------------------------------------------


def oracle_top(oracle: np.ndarray, k: int):
    """(indices, values) of each row's k best oracle scores, descending."""
    part = np.argpartition(-oracle, k - 1, axis=1)[:, :k]
    pv = np.take_along_axis(oracle, part, axis=1)
    order = np.argsort(-pv, axis=1, kind="stable")
    return (np.take_along_axis(part, order, axis=1),
            np.take_along_axis(pv, order, axis=1))


def _topk_check(tag, vals, idx, oracle, k, score_tol, tie_tol):
    """Values within ``score_tol`` of the oracle's top-k values; every
    returned index in the oracle's top-k unless its oracle score is within
    ``tie_tol`` of the k-th best. Returns (max score error, overlap)."""
    vals = np.asarray(vals, np.float64)
    idx = np.asarray(idx)
    top, top_vals = oracle_top(oracle, k)
    err = float(np.max(np.abs(vals - top_vals)))
    check(err <= score_tol, f"{tag}: score error {err:.3g} > {score_tol}")
    overlap = []
    for r in range(idx.shape[0]):
        want = set(top[r].tolist())
        got = idx[r].tolist()
        overlap.append(len(want & set(got)) / k)
        for i in got:
            if i not in want:
                gap = abs(oracle[r, i] - top_vals[r, -1])
                check(gap <= tie_tol,
                      f"{tag}: row {r} returned {i}, {gap:.3g} from the k-th score")
    return err, float(np.mean(overlap))


def phase_compare(sizes: Sizes = FULL, seed: int = 0) -> dict:
    import jax
    import jax.numpy as jnp
    import optax

    from anime_recommendations_tpu.models import two_tower as tt
    from anime_recommendations_tpu.ops.fused_adam import sparse_adam_update
    from anime_recommendations_tpu.ops.quantized import quantize_rows
    from anime_recommendations_tpu.ops.scoring import head_affine, score_all_items, score_topk
    from anime_recommendations_tpu.ops.topk import cosine_topk, masked_topk
    from anime_recommendations_tpu.utils.profiling import time_per_call as timed

    n, d, k = sizes.n_users, sizes.emb, sizes.k
    iters = sizes.timing_iters
    rng = np.random.default_rng(seed)
    w64 = rng.standard_normal((n, d))
    w64 /= np.linalg.norm(w64, axis=1, keepdims=True)
    w32 = w64.astype(np.float32)
    W = jnp.asarray(w32)
    Wb = W.astype(jnp.bfloat16)
    wb64 = np.asarray(Wb.astype(jnp.float32), np.float64)
    qt = jax.block_until_ready(quantize_rows(W))
    floor_f32 = n * d * 4 / HBM_BYTES_PER_S * 1e3
    lines = []

    for q in sizes.compare_queries:
        rows = rng.choice(n, size=q, replace=False)
        Q = W[rows]
        oracle = w32[rows].astype(np.float64) @ w64.T
        v, i = cosine_topk(W, Q, k)
        e32, o32 = _topk_check(f"f32 q={q}", v, i, oracle, k, 1e-5, 1e-6)
        f32_idx = np.asarray(i)

        oracle_b = wb64[rows] @ wb64.T
        vb, ib = cosine_topk(Wb, Q.astype(jnp.bfloat16), k)
        eb, ob = _topk_check(f"bf16 q={q} vs bf16 oracle", vb, ib, oracle_b, k,
                             1e-5, 1e-6)
        eb32 = float(np.max(np.abs(np.asarray(vb, np.float64)
                                   - oracle_top(oracle, k)[1])))
        check(eb32 <= 1e-2, f"bf16 q={q} vs f32 oracle: {eb32:.3g} > 1e-2")

        # Rescored int8 results are exact f32 scores: held to the f32
        # bounds, so they equal the f32 result up to ties.
        v8, i8 = cosine_topk(qt, Q, k)
        e8, _ = _topk_check(f"int8 q={q}", v8, i8, oracle, k, 1e-5, 1e-6)
        same = np.array_equal(np.asarray(i8), f32_idx)

        t32 = timed(lambda t, x: masked_topk(t, x, k), W, Q, iters=iters)
        tb = timed(lambda t, x: masked_topk(t, x, k), Wb, Q.astype(jnp.bfloat16),
                   iters=iters)
        t8 = timed(lambda t, x: cosine_topk(t, x, k), qt, Q, iters=iters)
        lines.append(
            f"q={q} k={k} over {n}x{d}: f32 HIGHEST err {e32:.2e} overlap "
            f"{o32:.3f} [tol 1e-5, ties 1e-6] {t32 * 1e3:.3f} ms "
            f"(one-read floor {floor_f32:.4f} ms); bf16 (bf16 products, f32 "
            f"accumulate) err vs bf16 oracle {eb:.2e} overlap {ob:.3f} "
            f"[tol 1e-5], vs f32 oracle {eb32:.2e} [tol 1e-2] "
            f"{tb * 1e3:.3f} ms (floor {floor_f32 / 2:.4f} ms); int8 "
            f"(int8 x int8 -> int32, HIGHEST f32 rescore) err {e8:.2e}, "
            f"indices == f32: {same} {t8 * 1e3:.3f} ms "
            f"(floor {floor_f32 / 4:.4f} ms)"
        )

    # HIGHEST against DEFAULT (TF32 on this card) at the widest query batch.
    qmax = max(sizes.compare_queries)
    Q = W[rng.choice(n, size=qmax, replace=False)]

    def scan(precision):
        @jax.jit
        def f(t, x):
            s = jax.lax.dot_general(x, t, (((1,), (1,)), ((), ())),
                                    precision=precision,
                                    preferred_element_type=jnp.float32)
            return jax.lax.top_k(s, k)
        return f

    t_hi = timed(scan(jax.lax.Precision.HIGHEST), W, Q, iters=iters)
    t_def = timed(scan(jax.lax.Precision.DEFAULT), W, Q, iters=iters)
    flops = 2.0 * qmax * n * d
    lines.append(
        f"q={qmax} f32 scan: HIGHEST {t_hi * 1e3:.3f} ms vs DEFAULT "
        f"{t_def * 1e3:.3f} ms ({flops / 1e9:.1f} GFLOP: >= "
        f"{flops / 67e12 * 1e3:.3f} ms at 67 TFLOP/s f32, one table read "
        f"{floor_f32:.4f} ms)"
    )

    # Model-recs scoring: score_topk against score_all_items + argsort.
    n_anime = sizes.n_anime
    params = tt.init_params(jax.random.PRNGKey(seed), n, n_anime, d)._replace(
        dense_w=jnp.float32(1.7), dense_b=jnp.float32(-0.3),
        bn_gamma=jnp.float32(0.9), bn_beta=jnp.float32(0.2))
    bn = tt.BNState(moving_mean=jnp.float32(0.1), moving_var=jnp.float32(1.4))
    anime_n, user_n = tt.normalized_tables(params)
    head = head_affine(params, bn)
    users = jnp.asarray(rng.choice(n, size=qmax, replace=False), jnp.int32)
    full = np.asarray(jax.vmap(score_all_items, in_axes=(None, None, 0))(
        params, bn, users), np.float64)
    sv, si = score_topk(anime_n, user_n[users], head, k)
    es, os_ = _topk_check(f"score_topk q={qmax}", sv, si, full, k, 1e-5, 1e-6)
    ts = timed(lambda t, u: score_topk(t, u, head, k), anime_n, user_n[users],
               iters=iters)
    lines.append(
        f"score_topk q={qmax} over {n_anime}x{d} (HIGHEST) vs score_all_items "
        f"(HIGHEST) + argsort: err {es:.2e} overlap {os_:.3f} [tol 1e-5, "
        f"ties 1e-6] {ts * 1e3:.3f} ms (one-read floor "
        f"{n_anime * d * 4 / HBM_BYTES_PER_S * 1e3:.4f} ms)"
    )

    # Sparse Adam against optax dense Adam, Zipf batch. (a) The Adam math:
    # the exact dense gradient (f64 sums, rounded once to f32) fed to both
    # sides, rtol 1e-5. (b) The Zipf scatter: f32 sums over duplicate ids
    # round in an order the card chooses (atomics), so the sparse path is
    # held to rtol 1e-5 plus the f32 summation bound k*2^-24*sum|g| of each
    # row, carried through the moment and weight updates.
    b = sizes.batch
    b1, b2, eps, t, lr, l2 = 0.9, 0.999, 1e-7, 3, jnp.float32(1e-3), 1e-4
    zipf = np.minimum(rng.zipf(1.2, b) - 1, n - 1).astype(np.int32)
    w = jnp.asarray(w32 * 0.05)
    mu = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32) * 1e-3)
    nu = jnp.asarray((rng.standard_normal((n, d)).astype(np.float32) * 1e-3) ** 2)
    g = rng.standard_normal((b, d)).astype(np.float32) * 0.1
    exact = np.zeros((n, d))
    np.add.at(exact, zipf, g.astype(np.float64))
    absum = np.zeros((n, d))
    np.add.at(absum, zipf, np.abs(g.astype(np.float64)))
    delta = (np.bincount(zipf, minlength=n)[:, None] * absum
             + np.abs(exact)) * 2.0 ** -24
    scatter32 = jnp.asarray(exact, jnp.float32)
    opt = optax.scale_by_adam(b1=b1, b2=b2, eps=eps)
    upd, new = opt.update(scatter32 + 2.0 * l2 * w, optax.ScaleByAdamState(
        count=jnp.asarray(t - 1, jnp.int32), mu=mu, nu=nu), w)
    ref = [np.asarray(x, np.float64) for x in (w - lr * upd, new.mu, new.nu)]
    no_ids, no_g = jnp.zeros((0,), jnp.int32), jnp.zeros((0, d), jnp.float32)
    math = sparse_adam_update(w, mu, nu, no_ids, no_g, jnp.asarray(t), lr,
                              l2=l2, b1=b1, b2=b2, eps=eps, dense_grad=scatter32)
    zipf_out = sparse_adam_update(w, mu, nu, jnp.asarray(zipf), jnp.asarray(g),
                                  jnp.asarray(t), lr, l2=l2, b1=b1, b2=b2, eps=eps)
    # Tolerances: rtol 1e-5 of the magnitude of the terms summed into each
    # element (an element can cancel to ~0, where a plain relative error
    # means nothing), plus an input uncertainty ``delta`` of the gradient
    # carried through the moment and weight updates.
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    w64, mu64, nu64 = (np.asarray(x, np.float64) for x in (w, mu, nu))
    decay = 2.0 * l2 * w64
    grad = np.abs(exact + decay)
    root = np.sqrt(ref[2] / bc2)
    upd_mag = np.abs(ref[1]) / bc1 / (root + eps)
    scale = (np.abs(w64) + float(lr) * upd_mag,
             b1 * np.abs(mu64) + (1 - b1) * grad,
             b2 * nu64 + (1 - b2) * grad ** 2)

    def bounds(delta):
        tol_mu = (1 - b1) * delta
        tol_nu = (1 - b2) * (2 * grad + delta) * delta
        tol_w = float(lr) * (tol_mu / bc1 / (root + eps) + np.abs(ref[1]) / bc1
                             * (tol_nu / bc2) / (2 * np.maximum(root, 1e-30)
                                                 * (root + eps) ** 2))
        return tol_w, tol_mu, tol_nu

    def held(tag, out, delta):
        errs = []
        for name, a, r, sc, tol in zip(("w", "mu", "nu"), out[:3], ref, scale,
                                       bounds(delta)):
            err = np.abs(np.asarray(a, np.float64) - r)
            bad = err > 1e-5 * sc + tol
            check(not bad.any(), f"sparse_adam_update {tag} {name}: "
                  f"{int(bad.sum())} elements outside their tolerance")
            errs.append(float(np.max(err / np.maximum(sc, 1e-30))))
        return errs

    # f32 rounding of the gradient's own sum (scatter + decay).
    round_g = (np.abs(exact) + np.abs(decay)) * 2.0 ** -23
    math_err = held("math", math, round_g)
    zipf_err = held("Zipf", zipf_out, round_g + delta)
    ta = timed(lambda *a: sparse_adam_update(*a, l2=l2), w, mu, nu,
               jnp.asarray(zipf), jnp.asarray(g), jnp.asarray(t), lr,
               iters=iters)
    lines.append(
        f"sparse_adam_update {n}x{d}, Zipf batch {b} ({len(np.unique(zipf))} "
        f"unique rows) vs optax scale_by_adam: max err / term scale "
        f"w/mu/nu, Adam math {math_err[0]:.1e}/{math_err[1]:.1e}/"
        f"{math_err[2]:.1e}, with the Zipf scatter {zipf_err[0]:.1e}/"
        f"{zipf_err[1]:.1e}/{zipf_err[2]:.1e} [rtol 1e-5 of the summed "
        f"terms + f32 rounding and summation bounds]; f32 throughout, no "
        f"matmul, so no precision setting; "
        f"{ta * 1e3:.3f} ms (6-pass floor {6 * floor_f32:.4f} ms)"
    )

    for line in lines:
        say("phase 4", line)
    say("phase 4", "compare: f32/bf16/int8 top-k, score_topk and "
        "sparse_adam_update hold their tolerances on the card")
    return {"lines": lines}


# ---- --four-cards -------------------------------------------------------------


def phase_four_cards(sizes: Sizes = FULL, seed: int = 0) -> dict:
    """ShardedTrainStep (routing="alltoall", adam and owner-side fused_adam)
    on 1x4 and 4x1 meshes against the single-card step on the same batch,
    plus one planned fused epoch against single-card fused steps."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from anime_recommendations_tpu.parallel.mesh import make_mesh, pad_rows_for_shards
    from anime_recommendations_tpu.parallel.sharded_train import (
        ShardedTrainStep, build_epoch_fn, build_plans_fn, place_state,
        unstripe_state,
    )
    from anime_recommendations_tpu.train.fused import fused_train_step
    from anime_recommendations_tpu.train.trainer import init_train_state, train_step

    devices = jax.devices()[:4]
    check(len(devices) == 4, f"--four-cards needs 4 devices, JAX sees {len(devices)}")
    n_users = pad_rows_for_shards(sizes.n_users, 4)
    n_anime = pad_rows_for_shards(sizes.n_anime, 4)
    b, l2, lr = sizes.batch, 1e-4, jnp.float32(1e-3)
    rng = np.random.default_rng(seed)
    nb = 3
    users = rng.integers(0, n_users, (nb, b)).astype(np.int32)
    anime = rng.integers(0, n_anime, (nb, b)).astype(np.int32)
    ratings = rng.uniform(0, 1, (nb, b)).astype(np.float32)
    weights = np.ones((nb, b), np.float32)
    state0 = jax.device_get(
        init_train_state(jax.random.PRNGKey(seed), n_users, n_anime, sizes.emb))
    on_card = lambda tree: jax.device_put(tree, devices[0])
    lines = []

    with jax.default_matmul_precision("highest"):
        for opt, single in (("adam", lambda s, *a: train_step(*((s,) + a + (l2,)))),
                            ("fused_adam", lambda s, *a: fused_train_step(*((s,) + a + (l2,))))):
            batch = tuple(jnp.asarray(x[0]) for x in (users, anime, ratings, weights))
            ref, r_loss, _ = single(on_card(state0), *batch, lr)
            ref = jax.device_get(ref)
            for shape in ((1, 4), (4, 1)):
                mesh = make_mesh(*shape, devices=devices)
                step = ShardedTrainStep(mesh, l2_reg_factor=l2, routing="alltoall",
                                        optimizer=opt)
                st = place_state(state0, mesh, routing="alltoall")
                st, s_loss, _ = step.train_step(st, *batch, lr)
                host = unstripe_state(st, mesh, "alltoall")
                loss_err = abs(float(s_loss) - float(r_loss)) / abs(float(r_loss))
                check(loss_err <= 1e-5, f"{opt} {shape}: loss rel err {loss_err:.3g}")
                tab_err = max(
                    float(np.max(np.abs(np.asarray(host.params.user_emb)
                                        - np.asarray(ref.params.user_emb)))),
                    float(np.max(np.abs(np.asarray(host.params.anime_emb)
                                        - np.asarray(ref.params.anime_emb)))),
                )
                check(tab_err <= 1e-5, f"{opt} {shape}: table abs err {tab_err:.3g}")
                lines.append(f"{opt} mesh {shape[0]}x{shape[1]}: loss rel err "
                             f"{loss_err:.2e}, unstriped table max abs err "
                             f"{tab_err:.2e} [tol 1e-5, HIGHEST]")

        # One planned fused epoch (shuffle off) against single-card steps.
        mesh = make_mesh(4, 1, devices=devices)
        step = ShardedTrainStep(mesh, l2_reg_factor=l2, routing="alltoall",
                                optimizer="fused_adam")
        sh = NamedSharding(mesh, P(None, ("data", "model")))
        xs = [jax.device_put(jnp.asarray(x), sh)
              for x in (users, anime, ratings, weights)]
        plans_u, plans_a = build_plans_fn(step)(xs[0], xs[1])
        epoch = build_epoch_fn(step, shuffle=False, planned=True)
        st = place_state(state0, mesh, routing="alltoall")
        st, losses, _, _, val_loss, _ = epoch(
            st, *xs, tuple(x[:1] for x in xs), jax.random.PRNGKey(0), lr,
            plans_u=plans_u, plans_a=plans_a,
        )
        ref = on_card(state0)
        ref_losses = []
        for i in range(nb):
            ref, loss, _ = fused_train_step(
                ref, *(jnp.asarray(x[i]) for x in (users, anime, ratings, weights)),
                lr, l2)
            ref_losses.append(float(loss))
        losses = np.asarray(losses, np.float64)
        ep_err = float(np.max(np.abs(losses - ref_losses) / np.abs(ref_losses)))
        check(np.isfinite(float(val_loss)), f"planned epoch val_loss {val_loss}")
        check(ep_err <= 1e-4, f"planned epoch loss rel err {ep_err:.3g}")
        lines.append(f"planned fused epoch 4x1, {nb} batches: per-batch loss max "
                     f"rel err vs single card {ep_err:.2e} [tol 1e-4]")

    for line in lines:
        say("four cards", line)
    return {"lines": lines}


# ---- entry --------------------------------------------------------------------


def device_line() -> str:
    import jax

    devs = jax.devices()
    return json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the routed trainer on four cards")
    args = parser.parse_args(argv)

    import jax

    from anime_recommendations_tpu.utils.compile_cache import enable_compile_cache
    from anime_recommendations_tpu.utils.profiling import require_gpu

    enable_compile_cache()
    if not args.four_cards:
        jax.config.update("jax_cuda_visible_devices", "0")
    require_gpu()
    phase_device()
    if args.four_cards:
        phase_four_cards()
    else:
        trained = phase_train()
        phase_serve(trained)
        phase_compare()
    print(device_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

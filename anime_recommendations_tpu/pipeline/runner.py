"""Pipeline runner: the 8 reference steps as one in-process engine.

Replaces the reference's MLflow orchestration (main.py:22-271 spawns a
conda subprocess per step; every cross-step datum round-trips through W&B
— SURVEY.md §3.1) with direct function calls over a local versioned
ArtifactStore. Step names and artifact names mirror config.yaml so a
reference user finds the same surface:

  ingest          -> full_data_set.pkl, all_anime.csv, synopses.csv
  preprocess      -> preprocessed_stats.pkl
  train           -> anime_nn_model.npz, anime_nn_history.csv,
                     neural_network_loss.png, vocab.json
  similar_anime   -> <cleaned_query>.csv
  similar_users   -> similar_users.csv + ID_used.csv   (the flow join key,
                     similar_users.py:354-367)
  user_prefs      -> user_prefs.csv + genre/source cloud PNGs
  user_recs       -> user_recs.csv + user_recs_preferences.csv + clouds
                     (assert_flow consistency check, user_recs.py:654-705)
  model_recs      -> model_recs.csv

Cross-step invariants: the flow user ID selected in similar_users is
pinned as an artifact; user_prefs/user_recs/model_recs resolve their user
from it when *_from_flow is set; user_recs verifies ID equality across the
ID artifact, the similar-users artifact metadata, and the prefs artifact
metadata, plus the similar-user count — raising when
main.raise_flow_error (config.yaml:17).
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path

import numpy as np
import pandas as pd

from anime_recommendations_tpu.config import Config
from anime_recommendations_tpu.data.catalog import Catalog
from anime_recommendations_tpu.data.dataset import train_holdout_split
from anime_recommendations_tpu.data.ingest import load_raw
from anime_recommendations_tpu.data.preprocess import preprocess_ratings
from anime_recommendations_tpu.data.vocab import Vocab, build_vocab, encode_frame
from anime_recommendations_tpu.pipeline.artifacts import ArtifactStore
from anime_recommendations_tpu.recommend import (
    RecContext,
    model_recs,
    similar_anime,
    similar_users,
    user_recs,
)
from anime_recommendations_tpu.recommend import user_prefs as _user_prefs_fn
from anime_recommendations_tpu.recommend.clouds import genre_cloud, source_cloud
from anime_recommendations_tpu.train.model_io import load_model, save_model

logger = logging.getLogger(__name__)

STEPS = (
    "ingest",
    "preprocess",
    "train",
    "similar_anime",
    "similar_users",
    "user_prefs",
    "user_recs",
    "model_recs",
)


class FlowError(ValueError):
    """Cross-step user-ID inconsistency (assert_flow failure)."""


class PipelineRunner:
    def __init__(self, config: Config, run_dir: str | Path | None = None):
        self.cfg = config
        self.run_dir = Path(run_dir or config.main.run_dir) / config.main.project_name
        self.store = ArtifactStore(self.run_dir / "artifacts")
        self._ctx: RecContext | None = None
        self._rng = np.random.default_rng(config.main.random_seed)

    # ---- orchestration --------------------------------------------------------

    def run(self, steps: list[str] | None = None) -> dict[str, float]:
        steps = list(steps or self.cfg.main.execute_steps)
        timings: dict[str, float] = {}
        for step in steps:
            if step not in STEPS:
                raise ValueError(f"Unknown step {step!r}; choose from {STEPS}")
            fn = getattr(self, f"step_{step}")
            logger.info("=== step %s ===", step)
            t0 = time.perf_counter()
            fn()
            timings[step] = time.perf_counter() - t0
            logger.info("step %s done in %.2fs", step, timings[step])
        (self.run_dir / "timings.json").write_text(json.dumps(timings, indent=2))
        return timings

    # ---- steps ----------------------------------------------------------------

    def step_ingest(self) -> None:
        raw = load_raw(self.cfg.data, cache_dir=self.run_dir / "cache")
        self.store.log_frame(
            "full_data_set.pkl", raw.ratings,
            filename="full_data_set.pkl", type="raw_data",
            metadata={"source": raw.source, "rows": len(raw.ratings)},
        )
        self.store.log_frame(
            "all_anime.csv", raw.anime, filename="all_anime.csv",
            type="raw_data", metadata={"rows": len(raw.anime)},
        )
        self.store.log_frame(
            "synopses.csv", raw.synopses, filename="synopses.csv",
            type="raw_data", metadata={"rows": len(raw.synopses)},
        )

    def step_preprocess(self) -> None:
        raw = pd.read_pickle(self.store.get("full_data_set.pkl:latest").file())
        clean, stats = preprocess_ratings(
            raw,
            num_reviews=self.cfg.data.num_reviews,
            drop_unwatched=self.cfg.data.drop_unwatched,
            drop_plan=self.cfg.data.drop_plan,
            half_watched=self.cfg.data.drop_half_watched,
        )
        self.store.log_frame(
            "preprocessed_stats.pkl", clean,
            filename="preprocessed_stats.pkl", type="preprocessed_data",
            metadata={
                "rows_in": stats.rows_in, "rows_out": stats.rows_out,
                "n_users": stats.n_users, "n_anime": stats.n_anime,
                "min_rating": stats.min_rating, "max_rating": stats.max_rating,
            },
        )

    def step_train(self) -> None:
        import jax

        from anime_recommendations_tpu.parallel.distributed import initialize

        # Multi-host runtime (the reference's cluster-resolver connect,
        # /root/reference/neural_network/neural_network.py:142-144): no-op
        # unless a coordinator is configured via env.
        initialize()

        mc = self.cfg.model
        clean = pd.read_pickle(
            self.store.get("preprocessed_stats.pkl:latest").file()
        )
        vocab = build_vocab(clean)
        encoded = encode_frame(clean, vocab)[["user", "anime", "rating"]]
        train, holdout = train_holdout_split(
            encoded, test_size=min(mc.test_size, max(len(encoded) // 10, 1)),
            shuffle_seed=mc.vocab_shuffle_seed,
        )

        pc = self.cfg.parallel
        n_dev = len(jax.devices())
        use_mesh = n_dev > 1 and (pc.model_axis != 1 or pc.data_axis not in (1,))
        common = dict(
            embedding_size=mc.embedding_size,
            l2_reg_factor=mc.l2_reg_factor,
            batch_size=min(mc.batch_size, max(len(train), 1)),
            epochs=mc.epochs,
            start_lr=mc.start_lr, max_lr=mc.max_lr, min_lr=mc.min_lr,
            rampup_epochs=mc.rampup_epochs, sustain_epochs=mc.sustain_epochs,
            exp_decay=mc.exp_decay, patience=mc.patience,
            seed=self.cfg.main.random_seed,
            checkpoint_dir=str(self.run_dir / "checkpoints"),
            log_fn=logger.info,
        )
        if use_mesh:
            from anime_recommendations_tpu.parallel.trainer import ShardedTrainer

            trainer = ShardedTrainer(
                data_axis=pc.data_axis, model_axis=pc.model_axis,
                shard_anime=pc.shard_anime_table, routing=pc.routing,
                capacity=pc.capacity or None,
                device_loop=mc.device_loop, optimizer=mc.optimizer, **common,
            )
        else:
            from anime_recommendations_tpu.train.trainer import Trainer

            trainer = Trainer(device_loop=mc.device_loop, optimizer=mc.optimizer, **common)
        result = trainer.fit(
            train, holdout, vocab.n_users, vocab.n_anime,
            resume=self.cfg.main.resume_training,
        )

        # Model + vocab + history + loss plot artifacts.
        tmp = self.run_dir / "tmp"
        tmp.mkdir(parents=True, exist_ok=True)
        # Gather (possibly sharded) params to host, trim padded rows.
        params = jax.tree.map(lambda x: np.asarray(x), result.state.params)
        params = params._replace(
            user_emb=params.user_emb[: vocab.n_users],
            anime_emb=params.anime_emb[: vocab.n_anime],
        )
        model_path = save_model(tmp / "anime_nn_model", params, result.state.bn_state)
        vocab_path = tmp / "vocab.json"
        vocab.save(vocab_path)
        self.store.log(
            "anime_nn_model.npz",
            files={"anime_nn_model.npz": model_path, "vocab.json": vocab_path},
            type="model",
            metadata={
                "Loss function": mc.model_loss,
                "Optimizer": mc.optimizer_display,
                "Activation function": mc.activation_function,
                "Start learning rate": mc.start_lr,
                "Min learning rate": mc.min_lr,
                "Max learning rate": mc.max_lr,
                "Batch size": mc.batch_size,
                "L2 regularization factor": mc.l2_reg_factor,
                "best_epoch": result.best_epoch,
                "best_val_loss": result.best_val_loss,
                "epochs_run": result.epochs_run,
                "examples_per_sec": result.examples_per_sec,
                "n_users": vocab.n_users,
                "n_anime": vocab.n_anime,
            },
        )
        # History CSV keeps the golden header (",loss,mse,val_loss,val_mse,lr").
        self.store.log_frame(
            "anime_nn_history.csv", result.history,
            filename="anime_nn_history.csv", type="history_csv", index=True,
            metadata={"best_epoch": result.best_epoch},
        )
        if mc.export_weight_csvs:
            # Normalized weight tables as CSV artifacts (reference
            # wandb_anime_weights.csv / wandb_user_weights.csv,
            # config.yaml:81-84).
            norms = np.linalg.norm(params.anime_emb, axis=1, keepdims=True)
            self.store.log_frame(
                "anime_weights.csv", pd.DataFrame(params.anime_emb / norms),
                filename="anime_weights.csv", type="weights_csv",
                metadata={"rows": vocab.n_anime},
            )
            norms = np.linalg.norm(params.user_emb, axis=1, keepdims=True)
            self.store.log_frame(
                "user_weights.csv", pd.DataFrame(params.user_emb / norms),
                filename="user_weights.csv", type="weights_csv",
                metadata={"rows": vocab.n_users},
            )
        self._log_loss_plot(result.history, tmp)
        self._ctx = None  # force rebuild with the new model

    def _log_loss_plot(self, history: pd.DataFrame, tmp: Path) -> None:
        """Loss curve artifact (neural_network.py:277-288 drops the last 2
        points of each series)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        ax.plot(history["loss"].iloc[:-2] if len(history) > 2 else history["loss"])
        ax.plot(history["val_loss"].iloc[:-2] if len(history) > 2 else history["val_loss"])
        ax.set_title("model loss")
        ax.set_ylabel("loss")
        ax.set_xlabel("epoch")
        ax.legend(["train", "test"], loc="upper left")
        path = tmp / "neural_network_loss.png"
        fig.savefig(path)
        plt.close(fig)
        self.store.log(
            "neural_network_loss.png",
            files={"neural_network_loss.png": path}, type="png",
        )

    # ---- retrieval context ----------------------------------------------------

    def context(self) -> RecContext:
        if self._ctx is None:
            model_art = self.store.get("anime_nn_model.npz:latest")
            params, bn = load_model(model_art.file("anime_nn_model.npz"))
            vocab = Vocab.load(model_art.file("vocab.json"))
            clean = pd.read_pickle(
                self.store.get("preprocessed_stats.pkl:latest").file()
            )
            encoded = encode_frame(clean, vocab)
            catalog = Catalog.from_files(
                self.store.get("all_anime.csv:latest").file(),
                self.store.get("synopses.csv:latest").file(),
            )
            dt = self.cfg.similarity.retrieval_dtype
            self._ctx = RecContext.build(
                params, bn, vocab, catalog, encoded,
                retrieval_dtype=None if dt in ("f32", "float32") else dt,
                ann=self.cfg.similarity.ann,
                ann_probes=self.cfg.similarity.ann_probes,
            )
        return self._ctx

    # ---- retrieval steps ------------------------------------------------------

    def _is_synthetic_run(self) -> bool:
        """True when ingest fell back to the synthetic dataset (its artifact
        records source=synthetic). Configured query names/IDs target the real
        MyAnimeList data and cannot resolve against a synthetic catalog."""
        try:
            art = self.store.get("full_data_set.pkl:latest")
            return art.metadata.get("source") == "synthetic"
        except Exception:
            return False

    def step_similar_anime(self) -> None:
        sc = self.cfg.similarity
        ctx = self.context()
        name = (
            ctx.random_anime_name(self._rng) if sc.random_anime else sc.anime_query
        )
        if not sc.random_anime and self._is_synthetic_run():
            try:
                ctx.catalog.resolve_query(name)
            except KeyError:
                name = ctx.random_anime_name(self._rng)
                logger.warning(
                    "configured anime_query %r not in the synthetic catalog; "
                    "querying random anime %r instead", sc.anime_query, name,
                )
        frame, fn, translated = similar_anime(
            ctx,
            name,
            count=sc.a_query_number,
            types=list(sc.types) if sc.spec_types else None,
            genres=list(sc.anime_rec_genres) if sc.an_spec_genres else None,
        )
        self.store.log_frame(
            fn, frame, filename=fn, type="csv",
            metadata={"Queried anime": name, "Filename": fn},
        )

    def step_similar_users(self) -> None:
        uc = self.cfg.users
        ctx = self.context()
        user_id = (
            ctx.random_user(self._rng)
            if uc.sim_random_user else int(uc.sim_user_query)
        )
        if (
            not uc.sim_random_user
            and ctx.vocab.encode_users(np.asarray([user_id]))[0] < 0
            and self._is_synthetic_run()
        ):
            user_id = ctx.random_user(self._rng)
            logger.warning(
                "configured sim_user_query %s not in the synthetic vocab; "
                "querying random user %s instead", uc.sim_user_query, user_id,
            )
        frame, fn, user_id = similar_users(
            ctx, user_id,
            n_users=uc.id_query_number,
            num_faves=uc.num_faves,
            TV_only=uc.TV_only,
        )
        self.store.log_frame(
            "similar_users.csv", frame, filename=fn, type="csv",
            metadata={
                "Queried user": int(user_id),
                "Filename": fn,
                "num_sim_users": uc.id_query_number,
            },
        )
        id_frame = pd.DataFrame([int(user_id)], columns=["User_ID"])
        self.store.log_frame(
            "ID_used.csv", id_frame, filename=f"{user_id}.csv", type="csv",
            metadata={"Queried user": int(user_id)},
        )

    def _flow_user(self) -> int:
        df = pd.read_csv(self.store.get("ID_used.csv:latest").file())
        return int(df.values[0][0])

    def _select_user(self, from_flow: bool, from_conf: bool, conf_id: int) -> int:
        """Reference precedence: flow artifact > config > random
        (user_prefs.py:295-324, user_recs.py:555-578)."""
        if from_flow:
            return self._flow_user()
        if from_conf:
            return int(conf_id)
        return self.context().random_user(self._rng)

    def step_user_prefs(self) -> None:
        uc = self.cfg.users
        ctx = self.context()
        user = self._select_user(
            uc.prefs_from_flow, uc.prefs_local_user, uc.prefs_user_query
        )
        prefs = _user_prefs_fn(ctx, user, percentile=uc.favorite_percentile)
        fn = f"User_ID_{user}_user_prefs.csv"
        self.store.log_frame(
            "user_prefs.csv", prefs.merged, filename=fn, type="csv",
            index=True, metadata={"ID": int(user), "Filename": fn},
        )
        tmp = self.run_dir / "tmp"
        tmp.mkdir(parents=True, exist_ok=True)
        g_fn = genre_cloud(prefs.genre_frequencies, user, tmp,
                           uc.cloud_width, uc.cloud_height)
        s_fn = source_cloud(prefs.source_frequencies, user, tmp,
                            uc.cloud_width, uc.cloud_height)
        self.store.log(
            "favorite_genres.png", files={Path(g_fn).name: g_fn}, type="png",
            metadata={"ID": int(user)},
        )
        self.store.log(
            "favorite_source_material.png", files={Path(s_fn).name: s_fn},
            type="png", metadata={"ID": int(user)},
        )

    def assert_flow(self, user: int) -> bool:
        """Cross-step ID consistency (user_recs.py:654-705)."""
        id_art = self._flow_user()
        sim_art = self.store.get("similar_users.csv:latest")
        sim_id = int(sim_art.metadata["Queried user"])
        n_sim = int(sim_art.metadata["num_sim_users"])
        prefs_art = self.store.get("user_prefs.csv:latest")
        prefs_id = int(prefs_art.metadata["ID"])
        ok = (user == id_art == sim_id == prefs_id) and (
            n_sim == int(self.cfg.users.recs_n_sim_ID)
        )
        if not ok:
            logger.warning(
                "assert_flow failed: input=%s id_artifact=%s sim=%s prefs=%s "
                "n_sim=%s expected_n_sim=%s",
                user, id_art, sim_id, prefs_id, n_sim, self.cfg.users.recs_n_sim_ID,
            )
        return ok

    def step_user_recs(self) -> None:
        uc = self.cfg.users
        ctx = self.context()
        user = self._select_user(
            uc.ID_recs_from_flow, uc.recs_ID_from_conf, uc.user_recs_query
        )
        if uc.ID_recs_from_flow:
            sim_frame = pd.read_csv(self.store.get("similar_users.csv:latest").file())
            if not self.assert_flow(user):
                if self.cfg.main.raise_flow_error:
                    raise FlowError("MLflow IDs were inconsistent")
                logger.warning("IDs inconsistent; user_recs step skipped")
                return
            prefs_frame = pd.read_csv(
                self.store.get("user_prefs.csv:latest").file(), index_col=0
            )
        else:
            sim_frame, _, _ = similar_users(
                ctx, user, n_users=uc.recs_n_sim_ID,
                num_faves=uc.num_faves, TV_only=uc.TV_only,
            )
            prefs_frame = None

        frame, fn = user_recs(
            ctx, user,
            sim_frame["similar_users"].to_numpy(),
            n=uc.user_num_recs,
            percentile=uc.favorite_percentile,
            genres=list(uc.ID_rec_genres) if uc.ID_spec_genres else None,
            user_pref=prefs_frame,
        )
        self.store.log_frame(
            "user_recs.csv", frame, filename=fn, type="csv",
            metadata={"Queried user": int(user),
                      "Flow ID used": bool(uc.ID_recs_from_flow),
                      "Filename": fn},
        )
        # Favorites csv + clouds (user_recs.py:846-905).
        prefs = _user_prefs_fn(ctx, user, percentile=uc.favorite_percentile)
        fave_fn = f"User_ID_{user}_user_recs_preferences.csv"
        self.store.log_frame(
            "user_recs_preferences.csv", prefs.merged, filename=fave_fn,
            type="csv", metadata={"Queried user": int(user)},
        )
        tmp = self.run_dir / "tmp"
        tmp.mkdir(parents=True, exist_ok=True)
        g_fn = genre_cloud(prefs.genre_frequencies, user, tmp,
                           fn="recs_favorite_genres.png")
        s_fn = source_cloud(prefs.source_frequencies, user, tmp,
                            fn="recs_favorite_sources.png")
        self.store.log("recs_favorite_genres.png",
                       files={Path(g_fn).name: g_fn}, type="png",
                       metadata={"Queried user": int(user)})
        self.store.log("recs_favorite_sources.png",
                       files={Path(s_fn).name: s_fn}, type="png",
                       metadata={"Queried user": int(user)})

    def step_model_recs(self) -> None:
        mrc = self.cfg.model_recs
        ctx = self.context()
        user = self._select_user(
            mrc.model_ID_flow, mrc.model_ID_conf, mrc.model_user_query
        )
        frame, fn = model_recs(
            ctx, user,
            n_recs=mrc.model_num_recs,
            types=list(mrc.anime_types) if mrc.specify_types else None,
            genres=list(mrc.model_genres) if mrc.specify_genres else None,
            min_score=mrc.min_score,
            max_score=mrc.max_score,
        )
        self.store.log_frame(
            "model_recs.csv", frame, filename=fn, type="csv",
            metadata={"Queried user": int(user), "Filename": fn},
        )

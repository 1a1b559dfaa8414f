"""Command-line interface.

Replaces the reference's ``mlflow run .`` + hydra-override surface
(README + main.py:11-15) with subcommands over the same capabilities:

    python -m anime_recommendations_tpu.cli pipeline [--steps ...]
    python -m anime_recommendations_tpu.cli train
    python -m anime_recommendations_tpu.cli similar-anime "Cowboy Bebop" -k 10
    python -m anime_recommendations_tpu.cli similar-users 153695 -k 10
    python -m anime_recommendations_tpu.cli user-prefs 153695
    python -m anime_recommendations_tpu.cli user-recs 153695
    python -m anime_recommendations_tpu.cli model-recs 153695
    python -m anime_recommendations_tpu.cli serve --port 8080
    python -m anime_recommendations_tpu.cli bench

Every subcommand accepts --config <json|yaml> and repeated --set
section.key=value overrides (hydra-style, config.py).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

from anime_recommendations_tpu.config import Config


def _base_parser(sub, name, help_):
    p = sub.add_parser(name, help=help_)
    p.add_argument("--config", default=None, help="JSON or YAML config path")
    p.add_argument(
        "--set", dest="overrides", action="append", default=[],
        metavar="section.key=value", help="config override (repeatable)",
    )
    p.add_argument("--run-dir", default=None, help="artifact/run directory")
    return p


def load_config(args) -> Config:
    if args.config:
        cfg = Config.from_file(args.config, overrides=args.overrides)
    else:
        cfg = Config().with_overrides(args.overrides)
    if args.run_dir:
        cfg.main.run_dir = args.run_dir
    return cfg


def make_runner(args):
    from anime_recommendations_tpu.pipeline.runner import PipelineRunner

    return PipelineRunner(load_config(args))


def main(argv=None) -> int:
    from anime_recommendations_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    parser = argparse.ArgumentParser(prog="anime_recommendations_tpu")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = _base_parser(sub, "pipeline", "run the full step pipeline")
    p.add_argument("--steps", nargs="*", default=None)

    _base_parser(sub, "ingest", "acquire raw data")
    _base_parser(sub, "preprocess", "clean + scale the rating frame")
    _base_parser(sub, "train", "train the two-tower model")

    p = _base_parser(sub, "similar-anime", "query similar anime")
    p.add_argument("name")
    p.add_argument("-k", type=int, default=10)

    p = _base_parser(sub, "similar-users", "query similar users")
    p.add_argument("user_id", type=int)
    p.add_argument("-k", type=int, default=10)

    p = _base_parser(sub, "user-prefs", "profile a user's preferences")
    p.add_argument("user_id", type=int)

    p = _base_parser(sub, "user-recs", "recommendations from similar users")
    p.add_argument("user_id", type=int)
    p.add_argument("-k", type=int, default=10)

    p = _base_parser(sub, "model-recs", "model-scored recommendations")
    p.add_argument("user_id", type=int)
    p.add_argument("-k", type=int, default=10)

    p = _base_parser(sub, "serve", "start the HTTP query API")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)

    _base_parser(sub, "bench", "run the benchmark suite")

    args = parser.parse_args(argv)

    if args.cmd == "bench":
        import bench  # repo-root bench.py

        bench.main()
        return 0

    runner = make_runner(args)

    if args.cmd == "pipeline":
        timings = runner.run(args.steps)
        print(json.dumps(timings, indent=2))
        return 0
    if args.cmd == "ingest":
        runner.step_ingest()
        return 0
    if args.cmd == "preprocess":
        runner.step_preprocess()
        return 0
    if args.cmd == "train":
        runner.step_train()
        return 0

    if args.cmd == "serve":
        from anime_recommendations_tpu.serve.api import serve_http

        serve_http(runner.context(), runner.cfg, host=args.host, port=args.port)
        return 0

    ctx = runner.context()
    if args.cmd == "similar-anime":
        from anime_recommendations_tpu.recommend import similar_anime

        frame, _, _ = similar_anime(ctx, args.name, count=args.k)
        print(frame.to_string())
    elif args.cmd == "similar-users":
        from anime_recommendations_tpu.recommend import similar_users

        frame, _, _ = similar_users(
            ctx, args.user_id, n_users=args.k,
            num_faves=runner.cfg.users.num_faves,
            TV_only=runner.cfg.users.TV_only,
        )
        print(frame.to_string())
    elif args.cmd == "user-prefs":
        from anime_recommendations_tpu.recommend import user_prefs

        prefs = user_prefs(
            ctx, args.user_id, percentile=runner.cfg.users.favorite_percentile
        )
        print(prefs.merged.to_string())
    elif args.cmd == "user-recs":
        from anime_recommendations_tpu.recommend import similar_users, user_recs

        sim, _, _ = similar_users(
            ctx, args.user_id, n_users=runner.cfg.users.recs_n_sim_ID,
            num_faves=runner.cfg.users.num_faves,
            TV_only=runner.cfg.users.TV_only,
        )
        frame, _ = user_recs(
            ctx, args.user_id, sim["similar_users"].to_numpy(), n=args.k,
            percentile=runner.cfg.users.favorite_percentile,
        )
        print(frame.to_string())
    elif args.cmd == "model-recs":
        from anime_recommendations_tpu.recommend import model_recs

        frame, _ = model_recs(ctx, args.user_id, n_recs=args.k)
        print(frame.to_string())
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Typed configuration for the engine.

Replaces the reference's three redundant config tiers (hydra YAML ->
MLproject string params -> per-step argparse with strtobool/literal_eval;
see /root/reference/config/config.yaml and e.g. neural_network.py:292-557)
with one set of dataclasses. Values can be loaded from a JSON or YAML file
and overridden with dotted ``section.key=value`` strings, so the
reference's hydra-style CLI overrides keep working in spirit. Override
values parse as JSON (numbers, booleans, lists, null) and otherwise stay
plain strings; YAML files need PyYAML, which is imported only for them.

Defaults mirror /root/reference/config/config.yaml so that a run with no
arguments reproduces the reference's published configuration.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Sequence


@dataclass
class DataConfig:
    """Ingest + preprocess knobs (config.yaml:19-52)."""

    # Raw input locations. Local paths take priority; URLs are only used when
    # explicitly allowed (the build environment has no egress).
    stats_path: str = "data/user_stats.parquet"
    anime_path: str = "data/all_anime.csv"
    synopses_path: str = "data/synopses.csv"
    stats_url: str = ""
    anime_url: str = ""
    synopses_url: str = ""
    allow_download: bool = False

    # Preprocess semantics (preprocess.py:13-117).
    num_reviews: int = 400          # min ratings per user to keep the user
    drop_half_watched: bool = False  # drop rows with < half the episodes watched
    drop_unwatched: bool = False     # drop rows with watched_episodes == 0
    drop_plan: bool = False          # drop watching_status == 6 ("plan to watch")

    # Synthetic-data fallback for environments without the MyAnimeList blobs
    # (the reference repo ships only stripped placeholders).
    synthetic_users: int = 5000
    synthetic_anime: int = 1200
    synthetic_interactions: int = 400_000
    synthetic_seed: int = 0


@dataclass
class ModelConfig:
    """Two-tower model + training hyperparameters (config.yaml:54-89)."""

    embedding_size: int = 128
    l2_reg_factor: float = 1e-4
    kernel_initializer: str = "he_normal"
    activation_function: str = "sigmoid"
    model_loss: str = "binary_crossentropy"
    model_metrics: tuple[str, ...] = ("mse",)

    test_size: int = 10_000          # holdout rows
    batch_size: int = 10_000
    epochs: int = 20
    start_lr: float = 1e-5
    min_lr: float = 1e-5
    max_lr: float = 5e-5
    rampup_epochs: int = 5
    sustain_epochs: int = 0
    exp_decay: float = 0.8
    patience: int = 3                # early stopping (neural_network.py:198)
    checkpoint_metric: str = "val_loss"
    mode: str = "min"

    # BatchNorm semantics of the Keras head (Keras defaults).
    bn_momentum: float = 0.99
    bn_epsilon: float = 1e-3

    # Numerics: params in float32; matmuls accumulate in float32. The batch
    # compute path may run activations in bfloat16 when True.
    bf16_compute: bool = False

    # Shuffle seeds (neural_network.py:59 uses 42; :160 uses 73).
    vocab_shuffle_seed: int = 42
    split_shuffle_seed: int = 73

    # Export normalized embedding tables as CSV artifacts after training
    # (reference wandb_anime_weights.csv / wandb_user_weights.csv).
    export_weight_csvs: bool = True

    # Run each training epoch as one device program (data resident on
    # device, device-side shuffle) — much lower host overhead. Single-chip
    # trainer only; the sharded trainer ignores it for now.
    device_loop: bool = True
    # "adam" (exact Keras parity), "fused_adam" (same dense-Adam semantics
    # computed from the gathered rows' gradients), "fused_adam_bf16m"
    # (fused_adam with bf16-stored table moments), or
    # "lazy_adam" (row-sparse Adam: only batch-touched embedding rows get
    # moments/decay/updates — faster at scale, standard
    # production-recommender semantics). The reference artifact metadata
    # spells it "Adam" (neural_network.py:263-271); optimizer_display gives
    # that form.
    optimizer: str = "adam"

    @property
    def optimizer_display(self) -> str:
        """Artifact-metadata spelling (reference logs "Adam")."""
        return {
            "adam": "Adam", "fused_adam": "Adam",
            "fused_adam_bf16m": "Adam", "lazy_adam": "LazyAdam",
        }.get(self.optimizer, self.optimizer)


@dataclass
class ParallelConfig:
    """Device mesh layout (replaces the reference's distribution strategy,
    neural_network.py:142-144)."""

    data_axis: int = -1    # -1: infer from available devices
    model_axis: int = 1
    # Row-shard the user table over the 'model' axis when it has >1 shard.
    shard_user_table: bool = True
    # Replicate the anime table when it fits (18K x 128 f32 ~ 9 MB); shard
    # over 'model' otherwise. (Only meaningful for routing="psum"; the
    # all-to-all path always shards both tables over the whole mesh.)
    shard_anime_table: bool = False
    donate_state: bool = True
    # Embedding lookup routing on the mesh: "alltoall" (production — each
    # row crosses the interconnect once, tables sharded over the whole
    # mesh) or "psum" (legacy dense block all-reduce, comparison baseline).
    routing: str = "alltoall"
    # All-to-all per-(sender, owner) slot count; 0 = auto (2x the uniform
    # expectation); -1 = measured per fit (plan_stats over sampled batches,
    # +25%+8 margin — ~2x less exchange row movement on uniform batches,
    # exact under overflow either way). Lower = less wire per round, more
    # overflow rounds under hot-row skew; the trainer logs measured rounds
    # per sampled batch.
    capacity: int = 0


@dataclass
class SimilarityConfig:
    """similar_anime retrieval (config.yaml:101-113)."""

    # Retrieval-table numerics: "f32" (exact), "bf16" (2x less scan
    # traffic, ~1e-3 score error), "int8" (4x less scan traffic; exact
    # f32 rescore of a candidate pool — ops/quantized.py).
    retrieval_dtype: str = "f32"
    # Approximate retrieval: "off" (exact scans — right at reference
    # scale) or "ivf" (cluster-probed sublinear scans, ops/ivf.py — for
    # catalogs beyond ~1M rows; recall set by ann_probes, composes with
    # retrieval_dtype="int8" for a quantized candidate gather).
    ann: str = "off"
    ann_probes: int = 16
    anime_query: str = "YuuYuu☆Hakusho!"
    random_anime: bool = False
    a_query_number: int = 10
    anime_rec_genres: tuple[Any, ...] = (None, "SLiceOF life", "va#mpire")
    an_spec_genres: bool = True
    types: tuple[str, ...] = ("TV", "Movie")
    spec_types: bool = True
    save_sim_anime: bool = True


@dataclass
class UsersConfig:
    """similar_users / user_prefs / user_recs knobs (config.yaml:115-154)."""

    favorite_percentile: float = 80.0
    sim_user_query: int = 153695
    sim_random_user: bool = False
    id_query_number: int = 10
    num_faves: int = 2
    TV_only: bool = True
    prefs_from_flow: bool = True
    prefs_local_user: bool = False
    prefs_user_query: int = 109160
    user_recs_query: int = 109160
    recs_ID_from_conf: bool = True
    ID_recs_from_flow: bool = True
    user_num_recs: int = 10
    recs_n_sim_ID: int = 10
    ID_rec_genres: tuple[Any, ...] = ("Action", "None", None)
    ID_spec_genres: bool = False
    cloud_width: int = 600
    cloud_height: int = 350
    show_clouds: bool = False
    save_faves: bool = True


@dataclass
class ModelRecsConfig:
    """model_recs knobs (config.yaml:156-170)."""

    model_num_recs: int = 10
    specify_types: bool = True
    anime_types: tuple[str, ...] = ("TV", "Movie")
    model_genres: tuple[Any, ...] = ("Action", "Comedy", None)
    specify_genres: bool = False
    min_score: float = 0.0
    max_score: float = 10.0
    model_user_query: int = 109160
    model_ID_flow: bool = True
    model_random_user: bool = False
    model_ID_conf: bool = False


@dataclass
class MainConfig:
    """Pipeline orchestration (config.yaml:1-17)."""

    project_name: str = "anime_recommendations"
    experiment_name: str = "development"
    execute_steps: tuple[str, ...] = (
        "ingest",
        "preprocess",
        "train",
        "similar_anime",
        "similar_users",
        "user_prefs",
        "user_recs",
        "model_recs",
    )
    random_seed: int = 42
    raise_flow_error: bool = True
    run_dir: str = "runs"
    # Resume training from the latest checkpoint in the run dir
    # (epoch-level resume — a capability the reference lacks).
    resume_training: bool = False


@dataclass
class Config:
    main: MainConfig = field(default_factory=MainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    similarity: SimilarityConfig = field(default_factory=SimilarityConfig)
    users: UsersConfig = field(default_factory=UsersConfig)
    model_recs: ModelRecsConfig = field(default_factory=ModelRecsConfig)

    # ---- construction helpers -------------------------------------------------

    @classmethod
    def from_file(cls, path: str | Path, overrides: Sequence[str] = ()) -> "Config":
        """Load a ``.json`` config, or a YAML one (any other suffix)."""
        path = Path(path)
        if path.suffix == ".json":
            raw = json.loads(path.read_text()) or {}
        else:
            import yaml

            raw = yaml.safe_load(path.read_text()) or {}
        return cls.from_dict(raw).with_overrides(overrides)

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "Config":
        cfg = cls()
        for section, values in raw.items():
            if not hasattr(cfg, section):
                raise KeyError(f"Unknown config section: {section!r}")
            sub = getattr(cfg, section)
            if not isinstance(values, dict):
                raise TypeError(f"Section {section!r} must be a mapping")
            for key, value in values.items():
                _set_field(sub, key, value)
        return cfg

    def with_overrides(self, overrides: Sequence[str]) -> "Config":
        """Apply ``section.key=value`` overrides (hydra-style)."""
        cfg = self
        for item in overrides:
            if "=" not in item:
                raise ValueError(f"Override must look like section.key=value: {item!r}")
            dotted, value = item.split("=", 1)
            parts = dotted.strip().split(".")
            if len(parts) != 2:
                raise ValueError(f"Override key must be section.key: {dotted!r}")
            section, key = parts
            sub = getattr(cfg, section)
            _set_field(sub, key, _parse_value(value))
        return cfg

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_yaml(self, path: str | Path) -> None:
        import yaml

        Path(path).write_text(yaml.safe_dump(self.to_dict(), allow_unicode=True))


def _parse_value(text: str) -> Any:
    """An override's value: JSON where it parses, else the plain string."""
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return text.strip()


def _set_field(obj: Any, key: str, value: Any) -> None:
    if not hasattr(obj, key):
        raise KeyError(f"Unknown config key: {type(obj).__name__}.{key}")
    current = getattr(obj, key)
    if isinstance(current, tuple) and isinstance(value, (list, tuple)):
        value = tuple(value)
    elif isinstance(current, bool) and isinstance(value, str):
        value = value.strip().lower() in ("1", "true", "yes", "y", "on")
    elif isinstance(current, int) and not isinstance(current, bool) and isinstance(value, (str, float)):
        value = int(value)
    elif isinstance(current, float) and isinstance(value, (str, int)):
        value = float(value)
    setattr(obj, key, value)

"""Typed config: defaults mirror config.yaml, file round-trips, overrides."""

import pytest

from anime_recommendations_tpu.config import Config


def test_defaults_mirror_reference_config():
    cfg = Config()
    # config.yaml:54-89
    assert cfg.model.embedding_size == 128
    assert cfg.model.batch_size == 10_000
    assert cfg.model.test_size == 10_000
    assert cfg.model.l2_reg_factor == 1e-4
    assert cfg.model.max_lr == 5e-5
    assert cfg.model.rampup_epochs == 5
    assert cfg.model.exp_decay == 0.8
    assert cfg.model.epochs == 20
    # config.yaml:44
    assert cfg.data.num_reviews == 400
    # config.yaml:116
    assert cfg.users.favorite_percentile == 80.0
    assert cfg.main.execute_steps[0] == "ingest"


def test_yaml_roundtrip(tmp_path):
    cfg = Config()
    cfg.model.batch_size = 512
    path = tmp_path / "cfg.yaml"
    cfg.to_yaml(path)
    loaded = Config.from_file(path)
    assert loaded.model.batch_size == 512
    assert loaded.similarity.types == ("TV", "Movie")


def test_overrides():
    cfg = Config().with_overrides(
        ["model.batch_size=2048", "users.TV_only=false", "model.max_lr=1e-4"]
    )
    assert cfg.model.batch_size == 2048
    assert cfg.users.TV_only is False
    assert cfg.model.max_lr == 1e-4


def test_unknown_key_rejected():
    with pytest.raises(KeyError):
        Config().with_overrides(["model.nope=1"])
    with pytest.raises(KeyError):
        Config.from_dict({"nope": {"a": 1}})


def test_json_roundtrip(tmp_path):
    import json

    cfg = Config()
    cfg.similarity.anime_query = "YuuYuu☆Hakusho!"
    cfg.model.batch_size = 256
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg.to_dict()))
    loaded = Config.from_file(path, overrides=["model.epochs=3"])
    assert loaded.model.batch_size == 256 and loaded.model.epochs == 3
    assert loaded.similarity.anime_query == "YuuYuu☆Hakusho!"
    assert loaded.users.ID_rec_genres == ("Action", "None", None)


def test_override_values_parse_as_json_or_plain_strings():
    cfg = Config().with_overrides([
        "similarity.anime_query=Cowboy Bebop",
        "similarity.retrieval_dtype=int8",
        'similarity.types=["TV", "OVA"]',
        "model.epochs=3",
        "model.start_lr=2e-5",
        "users.TV_only=true",
        'users.ID_rec_genres=["Action", null]',
    ])
    assert cfg.similarity.anime_query == "Cowboy Bebop"
    assert cfg.similarity.retrieval_dtype == "int8"
    assert cfg.similarity.types == ("TV", "OVA")
    assert cfg.model.epochs == 3 and cfg.model.start_lr == 2e-5
    assert cfg.users.TV_only is True
    assert cfg.users.ID_rec_genres == ("Action", None)

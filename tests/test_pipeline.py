"""Artifact store + end-to-end pipeline + HTTP serve tests."""

import json
import threading
import urllib.request

import pandas as pd
import pytest

from anime_recommendations_tpu.config import Config
from anime_recommendations_tpu.pipeline.artifacts import ArtifactStore
from anime_recommendations_tpu.pipeline.runner import FlowError, PipelineRunner


# ---------------- artifact store ----------------


def test_artifact_versioning(tmp_path):
    store = ArtifactStore(tmp_path)
    f = tmp_path / "x.txt"
    f.write_text("v0")
    a0 = store.log("thing.txt", files={"thing.txt": f}, metadata={"n": 0})
    f.write_text("v1")
    a1 = store.log("thing.txt", files={"thing.txt": f}, metadata={"n": 1})
    assert (a0.version, a1.version) == (0, 1)
    assert store.get("thing.txt:latest").metadata["n"] == 1
    assert store.get("thing.txt:v0").file().read_text() == "v0"
    assert store.get("thing.txt").version == 1
    assert store.versions("thing.txt") == [0, 1]
    assert store.exists("thing.txt:v1") and not store.exists("thing.txt:v7")


def test_artifact_frame_roundtrip(tmp_path):
    store = ArtifactStore(tmp_path)
    df = pd.DataFrame({"a": [1, 2], "b": ["x", "y"]})
    store.log_frame("t.csv", df, type="csv")
    out = pd.read_csv(store.get("t.csv:latest").file())
    pd.testing.assert_frame_equal(out, df)
    store.log_frame("t.pkl", df, filename="t.pkl")
    out = pd.read_pickle(store.get("t.pkl").file())
    pd.testing.assert_frame_equal(out, df)


def test_artifact_missing(tmp_path):
    store = ArtifactStore(tmp_path)
    with pytest.raises(FileNotFoundError):
        store.get("nope.csv:latest")


# ---------------- end-to-end pipeline ----------------


def small_config(tmp_path) -> Config:
    cfg = Config()
    cfg.main.run_dir = str(tmp_path / "runs")
    cfg.data.synthetic_users = 300
    cfg.data.synthetic_anime = 120
    cfg.data.synthetic_interactions = 30_000
    cfg.data.num_reviews = 50
    cfg.model.embedding_size = 16
    cfg.model.batch_size = 2048
    cfg.model.epochs = 2
    cfg.model.test_size = 1000
    cfg.similarity.anime_query = "Anime 00007"
    cfg.similarity.an_spec_genres = False
    cfg.similarity.spec_types = False
    cfg.similarity.a_query_number = 5
    cfg.users.sim_user_query = 0        # patched after ingest to a real ID
    cfg.users.id_query_number = 5
    cfg.users.recs_n_sim_ID = 5
    cfg.users.user_num_recs = 5
    cfg.model_recs.model_num_recs = 5
    cfg.model_recs.specify_types = False
    return cfg


@pytest.fixture(scope="module")
def finished_run(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("pipe")
    cfg = small_config(tmp_path)
    runner = PipelineRunner(cfg)
    runner.run(["ingest", "preprocess", "train"])
    # Pick a real trained user as the query.
    ctx = runner.context()
    cfg.users.sim_user_query = int(ctx.vocab.user_ids[0])
    runner.run(["similar_anime", "similar_users", "user_prefs",
                "user_recs", "model_recs"])
    return runner


def test_pipeline_artifacts_exist(finished_run):
    store = finished_run.store
    for name in [
        "full_data_set.pkl", "all_anime.csv", "synopses.csv",
        "preprocessed_stats.pkl", "anime_nn_model.npz",
        "anime_nn_history.csv", "neural_network_loss.png",
        "similar_users.csv", "ID_used.csv", "user_prefs.csv",
        "user_recs.csv", "model_recs.csv",
        "favorite_genres.png", "favorite_source_material.png",
    ]:
        assert store.exists(f"{name}:latest"), name


def test_history_has_golden_header(finished_run):
    path = finished_run.store.get("anime_nn_history.csv:latest").file()
    header = path.read_text().splitlines()[0]
    assert header == ",loss,mse,val_loss,val_mse,lr"


def test_flow_id_consistent_across_steps(finished_run):
    store = finished_run.store
    uid = int(pd.read_csv(store.get("ID_used.csv:latest").file()).values[0][0])
    assert int(store.get("similar_users.csv:latest").metadata["Queried user"]) == uid
    assert int(store.get("user_prefs.csv:latest").metadata["ID"]) == uid
    assert int(store.get("user_recs.csv:latest").metadata["Queried user"]) == uid
    assert int(store.get("model_recs.csv:latest").metadata["Queried user"]) == uid
    assert finished_run.assert_flow(uid)


def test_output_schemas_match_goldens(finished_run):
    store = finished_run.store
    sim_users = pd.read_csv(store.get("similar_users.csv:latest").file())
    assert list(sim_users.columns) == ["similar_users", "similarity", "favorite_animes"]
    user_recs = pd.read_csv(store.get("user_recs.csv:latest").file())
    assert list(user_recs.columns) == [
        "anime_id", "Name", "n_user_prefs", "Source", "Genres", "Sypnopsis",
        "Episodes", "Japanese name", "Studios", "Premiered", "Score", "Type",
    ]
    model_recs = pd.read_csv(store.get("model_recs.csv:latest").file())
    assert list(model_recs.columns) == [
        "Name", "Prediction", "Genres", "Source", "anime_id", "Sypnopsis",
        "Episodes", "Japanese name", "Studios", "Premiered", "Score", "Type",
    ]
    prefs = pd.read_csv(store.get("user_prefs.csv:latest").file(), index_col=0)
    assert list(prefs.columns) == ["eng_version", "Source", "Genres"]


def test_assert_flow_detects_mismatch(finished_run):
    # A fresh ID artifact with a different user must trip assert_flow.
    store = finished_run.store
    bad = pd.DataFrame([999999], columns=["User_ID"])
    store.log_frame("ID_used.csv", bad, filename="999999.csv",
                    metadata={"Queried user": 999999})
    uid = int(store.get("similar_users.csv:latest").metadata["Queried user"])
    assert not finished_run.assert_flow(uid)
    finished_run.cfg.main.raise_flow_error = True
    finished_run.cfg.users.ID_recs_from_flow = True
    with pytest.raises(FlowError):
        finished_run.step_user_recs()
    # Restore a consistent ID artifact for later tests.
    good = pd.DataFrame([uid], columns=["User_ID"])
    store.log_frame("ID_used.csv", good, filename=f"{uid}.csv",
                    metadata={"Queried user": uid})


# ---------------- HTTP serve ----------------


def test_http_api(finished_run):
    from anime_recommendations_tpu.serve.api import make_server

    ctx = finished_run.context()
    server = make_server(ctx, finished_run.cfg, host="127.0.0.1", port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        def get(path):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as r:
                return json.loads(r.read()), r.status

        health, status = get("/health")
        assert status == 200 and health["status"] == "ok"

        uid = int(ctx.vocab.user_ids[0])
        recs, _ = get(f"/model_recs?user_id={uid}&k=3")
        assert len(recs) == 3 and "Prediction" in recs[0]

        sim, _ = get("/similar_anime?name=Anime%2000007&k=4")
        assert len(sim) == 4 and "Similarity" in sim[0]

        prefs, _ = get(f"/user_prefs?user_id={uid}")
        assert prefs["user_id"] == uid and "genre_frequencies" in prefs

        sims, _ = get(f"/similar_users?user_id={uid}&k=3")
        assert len(sims) == 3

        urecs, _ = get(f"/user_recs?user_id={uid}&k=3")
        assert isinstance(urecs, list)

        # Error paths.
        try:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope")
            raise AssertionError("expected 404")
        except urllib.error.HTTPError as e:
            assert e.code == 404
    finally:
        server.shutdown()


def test_http_batch_endpoints(finished_run):
    import json as _json
    import threading as _threading
    import urllib.request as _rq

    from anime_recommendations_tpu.serve.api import make_server

    ctx = finished_run.context()
    server = make_server(ctx, finished_run.cfg, host="127.0.0.1", port=0)
    port = server.server_address[1]
    _threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        uids = ",".join(str(int(u)) for u in ctx.vocab.user_ids[:3])
        with _rq.urlopen(
            f"http://127.0.0.1:{port}/model_recs_batch?user_ids={uids}&k=3"
        ) as r:
            out = _json.loads(r.read())
        assert len(out) == 3 and all(len(rec["names"]) <= 3 for rec in out)

        names = "|".join(
            _rq.quote(n) for n in ctx.catalog.anime["Name"].iloc[:2]
        )
        with _rq.urlopen(
            f"http://127.0.0.1:{port}/similar_anime_batch?names={names}&k=2"
        ) as r:
            out = _json.loads(r.read())
        assert len(out) == 2
    finally:
        server.shutdown()

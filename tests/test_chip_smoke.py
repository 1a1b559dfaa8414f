"""chip_smoke.py: it refuses to run without a GPU, and its phases run
end to end at a tiny size on the CPU (the card runs them at full size)."""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke

REPO = Path(__file__).resolve().parents[1]
TINY = chip_smoke.Sizes(
    n_users=300, n_anime=120, n_rows=20_000, emb=16, batch=1000, epochs=2,
    fused_rows=3000, holdout=1000, compare_queries=(1, 8, 16), k=5,
    timing_iters=2, ivf_probes=4,
)


def test_require_gpu_raises_on_cpu():
    from anime_recommendations_tpu.utils.profiling import require_gpu

    with pytest.raises(RuntimeError, match="needs a GPU"):
        require_gpu()


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_script_fails_without_gpu_or_repo(where, tmp_path):
    """Run as the driver does, on the CPU: from the repo, and from a
    directory holding chip_smoke.py alone. Both exit non-zero and print
    no result line."""
    if where == "repo":
        cwd = REPO
    else:
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
           "HOME": str(tmp_path), "JAX_COMPILATION_CACHE_DIR": str(tmp_path)}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_train_and_serve_phases_tiny():
    trained = chip_smoke.phase_train(TINY)
    assert trained["vocab"].n_users == TINY.n_users
    assert trained["vocab"].n_anime == TINY.n_anime
    assert trained["losses"][-1] < trained["losses"][0]
    served = chip_smoke.phase_serve(trained, TINY)
    assert {"f32.similar_anime", "int8.model_recs_batch",
            "ivf.user_recs"} <= set(served["latency_ms"])


def test_compare_phase_tiny():
    out = chip_smoke.phase_compare(TINY)
    assert len(out["lines"]) == len(TINY.compare_queries) + 3


def test_four_cards_phase_on_virtual_devices():
    out = chip_smoke.phase_four_cards(TINY)
    assert len(out["lines"]) == 5


def test_topk_check_accepts_ties_and_rejects_misses():
    oracle = np.asarray([[0.9, 0.5, 0.5 + 5e-7, 0.1]])
    # Index 1 instead of 2: inside the 1e-6 tie window.
    chip_smoke._topk_check("tie", [[0.9, 0.5]], [[0, 1]], oracle, 2, 1e-5, 1e-6)
    with pytest.raises(chip_smoke.CheckFailed):
        chip_smoke._topk_check("miss", [[0.9, 0.5]], [[0, 3]], oracle, 2,
                               1e-5, 1e-6)

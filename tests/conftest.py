"""Test harness: an 8-device virtual CPU mesh by default.

JAX is switched to the CPU with 8 virtual devices before any backend
initializes, so every distributed test exercises real mesh / shard_map
code paths on fake devices. ``ANIMEREC_TEST_GPU=1`` leaves JAX on its
default backend instead: run the GPU-marked tests on a machine with a card
with ``ANIMEREC_TEST_GPU=1 python -m pytest -m gpu``.
"""

import os

if os.environ.get("ANIMEREC_TEST_GPU", "0") != "1":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402

from anime_recommendations_tpu.data import synthetic  # noqa: E402


@pytest.fixture(scope="session")
def ratings_frame() -> pd.DataFrame:
    return synthetic.synth_ratings(
        n_users=300, n_anime=120, n_interactions=30_000, seed=7
    )


@pytest.fixture(scope="session")
def anime_catalog_frame() -> pd.DataFrame:
    return synthetic.synth_anime_catalog(n_anime=120, seed=7)


@pytest.fixture(scope="session")
def synopses_frame(anime_catalog_frame) -> pd.DataFrame:
    return synthetic.synth_synopses(anime_catalog_frame, seed=7)


@pytest.fixture(scope="session")
def rng() -> np.random.Generator:
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless JAX's backend is a GPU (decided here, at run time)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: ANIMEREC_TEST_GPU=1 python -m pytest -m gpu")

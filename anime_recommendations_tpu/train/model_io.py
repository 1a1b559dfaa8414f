"""Model parameter serialization (the engine's .h5-equivalent).

The reference passes trained weights between steps as Keras .h5 artifacts
(neural_network.py:219-275). Here the exported format is a single .npz
holding every TwoTowerParams leaf + BatchNorm state + the vocab sizes —
dependency-free, memory-mappable, and loadable without JAX for inspection.
The async checkpoints (train/checkpoint.py) remain the in-training format.
"""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np

from anime_recommendations_tpu.models.two_tower import BNState, TwoTowerParams


def save_model(path: str | Path, params: TwoTowerParams, bn_state: BNState) -> str:
    path = str(path)
    np.savez(
        path if path.endswith(".npz") else path + ".npz",
        user_emb=np.asarray(params.user_emb),
        anime_emb=np.asarray(params.anime_emb),
        dense_w=np.asarray(params.dense_w),
        dense_b=np.asarray(params.dense_b),
        bn_gamma=np.asarray(params.bn_gamma),
        bn_beta=np.asarray(params.bn_beta),
        moving_mean=np.asarray(bn_state.moving_mean),
        moving_var=np.asarray(bn_state.moving_var),
    )
    return path if path.endswith(".npz") else path + ".npz"


def load_model(path: str | Path) -> tuple[TwoTowerParams, BNState]:
    with np.load(path) as z:
        params = TwoTowerParams(
            user_emb=jnp.asarray(z["user_emb"]),
            anime_emb=jnp.asarray(z["anime_emb"]),
            dense_w=jnp.asarray(z["dense_w"]),
            dense_b=jnp.asarray(z["dense_b"]),
            bn_gamma=jnp.asarray(z["bn_gamma"]),
            bn_beta=jnp.asarray(z["bn_beta"]),
        )
        bn = BNState(
            moving_mean=jnp.asarray(z["moving_mean"]),
            moving_var=jnp.asarray(z["moving_var"]),
        )
    return params, bn

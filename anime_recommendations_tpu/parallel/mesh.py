"""Device mesh construction.

Replacement for the reference's distribution-strategy boilerplate
(neural_network.py:142-144): a two-axis logical mesh

    ('data', 'model')

where 'data' replicates the model and splits the batch (the reference's
only strategy) and 'model' row-shards the user embedding table (the
scaling axis this workload actually has — SURVEY.md §5.7). With several
processes the caller runs jax.distributed.initialize() first. The cards
of one host reach each other all to all at the same rate (NVLink), so
the mesh shape follows the algorithm alone.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.experimental import mesh_utils
from jax.sharding import Mesh

DATA_AXIS = "data"
MODEL_AXIS = "model"


def mesh_shape_for(
    n_devices: int, data_axis: int = -1, model_axis: int = 1
) -> tuple[int, int]:
    """Resolve (data, model) axis sizes; -1 infers from the device count."""
    if data_axis == -1 and model_axis == -1:
        raise ValueError("At most one axis size may be -1")
    if data_axis == -1:
        if n_devices % model_axis:
            raise ValueError(f"{n_devices} devices not divisible by model={model_axis}")
        data_axis = n_devices // model_axis
    elif model_axis == -1:
        if n_devices % data_axis:
            raise ValueError(f"{n_devices} devices not divisible by data={data_axis}")
        model_axis = n_devices // data_axis
    if data_axis * model_axis != n_devices:
        raise ValueError(
            f"mesh {data_axis}x{model_axis} != {n_devices} devices"
        )
    return data_axis, model_axis


def make_mesh(
    data_axis: int = -1,
    model_axis: int = 1,
    devices: list | None = None,
) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    d, m = mesh_shape_for(len(devices), data_axis, model_axis)
    mesh_devices = mesh_utils.create_device_mesh((d, m), devices=devices)
    return Mesh(mesh_devices, (DATA_AXIS, MODEL_AXIS))


def pad_rows_for_shards(n_rows: int, n_shards: int) -> int:
    """Rows after padding so each model shard holds an equal row block."""
    return -(-n_rows // n_shards) * n_shards


def pad_table(table: np.ndarray, n_shards: int) -> np.ndarray:
    """Zero-pad table rows to a shard multiple (zero rows stay zero under
    the L2 term: grad 2*lambda*0 = 0, so padding never drifts)."""
    target = pad_rows_for_shards(table.shape[0], n_shards)
    if target == table.shape[0]:
        return table
    pad = np.zeros((target - table.shape[0], table.shape[1]), table.dtype)
    return np.concatenate([table, pad], axis=0)

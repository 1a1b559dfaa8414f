"""Asynchronous best-only checkpoints as numpy ``.npz`` files.

Equivalent of the reference's best-only, asynchronous Keras checkpointing
(ModelCheckpoint neural_network.py:188-196 +
tf.train.CheckpointOptions(enable_async=True) :178): ``save`` copies the
state to host memory and returns; a background thread writes the file, so
training never waits on disk. Only the newest ``max_to_keep`` checkpoints
are kept (1 by default, matching save_best_only=True).

Layout: ``<dir>/step_<N>.npz`` holding the state's leaves in
``jax.tree.flatten`` order. Each file is written to a temporary name and
renamed into place, so a crash never leaves a partial checkpoint under a
real name. bf16 leaves are stored as their uint16 bit patterns with the
dtype names recorded beside them.

Across several processes (a mesh that spans them), every process gathers
the full state and process 0 alone writes; restore reads the file on
every process and places each leaf under the template's sharding.
"""

from __future__ import annotations

import os
import re
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

_NAME = re.compile(r"^step_(\d+)\.npz$")
_DTYPES_KEY = "__dtypes__"


def _to_host(x) -> np.ndarray:
    if getattr(x, "is_fully_addressable", True):
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def _place(host: np.ndarray, like) -> Any:
    """Put a restored leaf where the template leaf lives."""
    sharding = getattr(like, "sharding", None)
    if sharding is None:
        return jnp.asarray(host)
    if getattr(sharding, "is_fully_addressable", True):
        return jax.device_put(host, sharding)
    return jax.make_array_from_callback(host.shape, sharding, lambda i: host[i])


class AsyncCheckpointer:
    def __init__(self, directory: str | Path, max_to_keep: int = 1):
        self._dir = Path(directory).absolute()
        self._dir.mkdir(parents=True, exist_ok=True)
        self._max_to_keep = max_to_keep
        self._writer = ThreadPoolExecutor(max_workers=1)
        self._pending: list[Future] = []

    def _path(self, step: int) -> Path:
        return self._dir / f"step_{step}.npz"

    def _steps(self) -> list[int]:
        return sorted(
            int(m.group(1)) for p in self._dir.iterdir()
            if (m := _NAME.match(p.name))
        )

    def save(self, step: int, state: Any) -> None:
        """Copy ``state`` to host now; write it in the background."""
        leaves = [_to_host(x) for x in jax.tree.leaves(state)]
        if jax.process_index() != 0:
            return
        self._pending.append(self._writer.submit(self._write, step, leaves))

    def _write(self, step: int, leaves: list[np.ndarray]) -> None:
        arrays = {}
        for i, x in enumerate(leaves):
            arrays[str(i)] = x.view(np.uint16) if x.dtype == jnp.bfloat16 else x
        arrays[_DTYPES_KEY] = np.asarray([str(x.dtype) for x in leaves])
        tmp = self._dir / f".step_{step}.npz.tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path(step))
        for old in self._steps()[:-self._max_to_keep]:
            self._path(old).unlink(missing_ok=True)

    def restore(self, step: int | None = None, *, template: Any) -> Any:
        """Load ``step`` (default: the latest) into the structure and
        shardings of the ``template`` pytree."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoint under {self._dir}")
        with np.load(self._path(step)) as z:
            dtypes = [str(d) for d in z[_DTYPES_KEY]]
            leaves = [
                z[str(i)].view(jnp.bfloat16) if d == "bfloat16" else z[str(i)]
                for i, d in enumerate(dtypes)
            ]
        t_leaves, treedef = jax.tree.flatten(template)
        if len(t_leaves) != len(leaves):
            raise ValueError(
                f"checkpoint step {step} has {len(leaves)} leaves, the "
                f"template {len(t_leaves)}"
            )
        return jax.tree.unflatten(
            treedef, [_place(h, t) for h, t in zip(leaves, t_leaves)]
        )

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Block until every submitted write is on disk; re-raise a failed
        write's error."""
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def close(self) -> None:
        self.wait()
        self._writer.shutdown()

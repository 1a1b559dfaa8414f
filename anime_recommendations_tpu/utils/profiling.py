"""Tracing / profiling hooks.

The reference has no profiling at all (SURVEY.md §5.1 — wall-clock claims
in its README only). This provides:

  * trace(dir): jax.profiler context — produces a TensorBoard-loadable
    trace of XLA execution (op-level timeline, device memory)
  * StepTimer: lightweight wall-clock section timing with summary stats
  * time_per_call(): device time per call of a jitted function
  * device_memory_stats(): live per-device memory usage when the backend
    exposes it
  * require_gpu() / gpu_name_and_power(): what a measurement runs on
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import time
from collections import defaultdict
from pathlib import Path


def require_gpu() -> None:
    """Raise unless JAX's default backend is a GPU: measurements never
    fall back to the CPU."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(f"needs a GPU; JAX's backend is {backend!r}")


def gpu_name_and_power() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi reports them
    (read by a child process that stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_per_call(fn, *args, iters: int = 20) -> float:
    """Seconds per call of ``fn(*args)``: one warm-up call (compiles), then
    ``iters`` calls issued back to back and ended by block_until_ready;
    the best of three such rounds."""
    import jax

    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Profile everything inside the context into ``log_dir``."""
    import jax

    jax.profiler.start_trace(str(log_dir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StepTimer:
    """Accumulates wall-clock timings per named section."""

    def __init__(self):
        self._times: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._times[name].append(time.perf_counter() - t0)

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, xs in self._times.items():
            xs_sorted = sorted(xs)
            out[name] = {
                "count": len(xs),
                "total_s": sum(xs),
                "mean_s": sum(xs) / len(xs),
                "p50_s": xs_sorted[len(xs) // 2],
                "max_s": xs_sorted[-1],
            }
        return out

    def dump(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.summary(), indent=2))


def device_memory_stats() -> list[dict]:
    """Per-device memory stats (bytes) where the backend reports them."""
    import jax

    out = []
    for dev in jax.devices():
        stats = {}
        try:
            stats = dev.memory_stats() or {}
        except (RuntimeError, AttributeError):
            pass
        out.append(
            {
                "device": str(dev),
                "bytes_in_use": stats.get("bytes_in_use"),
                "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
                "bytes_limit": stats.get("bytes_limit"),
            }
        )
    return out

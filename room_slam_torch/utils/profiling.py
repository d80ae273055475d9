"""Profiling helpers (counterpart of the JAX package's
``utils/profiling.py``): a step timer that reports traces per second, and a
context manager that captures a ``torch.profiler`` trace of the host and
the card, viewable in Perfetto or ``chrome://tracing``.

A torch call returns before the card has run it, so on a CUDA device the
timer synchronises before each reading of the clock: a step's time is its
device work, not its launch.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch


class StepTimer:
    """Throughput counter that leaves the first ``skip`` steps out (the
    kernels' first builds and launches).

    >>> timer = StepTimer(batch_size=32, skip=3, device="cuda")
    >>> for batch in batches:
    ...     with timer.step():
    ...         losses = train_step(batch, generator)
    >>> timer.summary()  # {'steps': ..., 'traces_per_sec': ..., ...}
    """

    def __init__(self, batch_size: int, skip: int = 3,
                 device: torch.device | str | None = None):
        self.batch_size = batch_size
        self.skip = skip
        self.count = 0
        self.total = 0.0
        self.device = None if device is None else torch.device(device)

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def step(self) -> Iterator[None]:
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        dt = time.perf_counter() - t0
        self.count += 1
        if self.count > self.skip:
            self.total += dt

    def summary(self) -> Dict[str, float]:
        timed = max(self.count - self.skip, 0)
        if timed == 0 or self.total == 0:
            return {"steps": self.count, "traces_per_sec": 0.0,
                    "ms_per_step": 0.0}
        return {
            "steps": self.count,
            "traces_per_sec": timed * self.batch_size / self.total,
            "ms_per_step": self.total / timed * 1000.0,
        }


@contextlib.contextmanager
def device_trace(log_dir: Optional[str | Path]
                 ) -> Iterator[Optional[torch.profiler.profile]]:
    """Capture a ``torch.profiler`` trace of the body (the host and, where
    a card is present, its CUDA activity) and write it to
    ``<log_dir>/trace.json`` (Chrome / Perfetto format). Yields the
    profiler (``key_averages()``, ``events()``) or, when ``log_dir`` is
    empty, None and records nothing."""
    if not log_dir:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))

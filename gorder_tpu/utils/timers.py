"""Phase timers and XLA profiler hooks.

The reference ships no in-repo tracing (SURVEY §5: benchmarking is external
via hyperfine); the device rebuild adds lightweight wall-clock phase timers —
logged after every run — plus an opt-in ``jax.profiler`` trace so kernel
time on the device can be inspected with TensorBoard/XProf:

* every ``Analysis.run()`` accumulates per-phase wall times (structure,
  topology, trajectory, decode, compute, convert, write) and logs one
  summary line at INFO level;
* ``GORDER_TPU_PROFILE=/path/to/dir`` wraps the run in
  ``jax.profiler.start_trace/stop_trace`` writing an XPlane trace there.

Timers are monotonic (`time.perf_counter`) and additive: entering the same
phase several times accumulates. Decode time is recorded from the prefetch
worker thread; a lock keeps the counters consistent.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional


class PhaseTimers:
    """Accumulating wall-clock phase timers (thread-safe)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._times: Dict[str, float] = {}
        self._order: list = []

    def reset(self) -> None:
        with self._lock:
            self._times.clear()
            self._order.clear()

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            if name not in self._times:
                self._times[name] = 0.0
                self._order.append(name)
            self._times[name] += seconds

    @contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - start)

    def get(self, name: str) -> float:
        with self._lock:
            return self._times.get(name, 0.0)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {k: self._times[k] for k in self._order}

    def summary(self) -> str:
        snap = self.snapshot()
        if not snap:
            return "no phases recorded"
        return " | ".join(f"{k} {v:.3f}s" for k, v in snap.items())


#: process-wide registry used by the analysis pipeline
timers = PhaseTimers()


class _Profiler:
    """Opt-in jax.profiler trace around a run (GORDER_TPU_PROFILE=dir)."""

    def __init__(self) -> None:
        self.dir: Optional[str] = os.environ.get("GORDER_TPU_PROFILE") or None
        self._active = False

    def start(self) -> None:
        if not self.dir:
            return
        import jax

        try:
            os.makedirs(self.dir, exist_ok=True)
            jax.profiler.start_trace(self.dir)
        except OSError as e:
            import logging

            logging.getLogger("gorder_tpu").warning(
                "cannot write profiler trace to '%s' (%s); profiling "
                "disabled for this run", self.dir, e)
            return
        self._active = True

    def stop(self) -> None:
        if not self._active:
            return
        import jax

        jax.profiler.stop_trace()
        self._active = False


@contextmanager
def profiled_run():
    """Reset timers and (optionally) trace the device for one analysis run."""
    timers.reset()
    prof = _Profiler()
    prof.start()
    try:
        with timers.phase("total"):
            yield timers
    finally:
        prof.stop()

"""Named-scope timer registry (rebuild of the reference's ProfilerApp hooks).

The reference instruments ``create_image`` / ``propagate_{ASE,seed}-<method>``
/ ``Sum reduce images`` with PROFILE_START/STOP macros (no-ops in the miniapp,
src/ProfilerApp.h:1-13; regions at src/RayTraceImage.cpp:233,294-298,424,433).
This registry keeps the same region names, records wall time per scope, and
can emit a summary table. ``jax.profiler`` traces can be layered on top via
``trace_annotation``.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import jax

__all__ = ["Profiler", "profiler", "get_time"]

_START = time.perf_counter()


def get_time() -> float:
    """Monotonic seconds since module init (getTime,
    src/CreateImageHelpers.cpp:46-62)."""
    return time.perf_counter() - _START


class Profiler:
    """Accumulating named-scope wall-clock profiler."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._open: dict[str, float] = {}
        self.enabled = True

    def start(self, name: str) -> None:
        if self.enabled:
            self._open[name] = time.perf_counter()

    def stop(self, name: str) -> None:
        if self.enabled and name in self._open:
            self.totals[name] += time.perf_counter() - self._open.pop(name)
            self.counts[name] += 1

    @contextmanager
    def scope(self, name: str, annotate: bool = False):
        """Context-manager scope; optionally emits a jax.profiler annotation
        so the region shows up in profiler traces."""
        self.start(name)
        if annotate:
            with jax.profiler.TraceAnnotation(name):
                yield
        else:
            yield
        self.stop(name)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
        self._open.clear()

    def summary(self) -> str:
        lines = [f"{'region':<32s} {'calls':>6s} {'total(s)':>10s} {'avg(ms)':>10s}"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            tot = self.totals[name]
            cnt = self.counts[name]
            lines.append(f"{name:<32s} {cnt:>6d} {tot:>10.4f} {1e3 * tot / cnt:>10.3f}")
        return "\n".join(lines)


#: process-wide default profiler (the analogue of the global ProfilerApp)
profiler = Profiler()

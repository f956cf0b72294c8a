"""Per-phase wall-clock profiling + on-device trace hooks.

The analog of the reference's timer table printed by Main at the end of
a run (src/Main/Inciter.cpp timers: mesh read, partition, t0ref, time
stepping) and of its Charm++ Projections / ChareStateCollector tracing
(src/Base/ChareStateCollector.hpp): phases accumulate wall-clock over
repeated entries, and `jax_trace` wraps a block in jax.profiler.trace so
the on-device timeline (XLA op breakdown) can be inspected with
TensorBoard / xprof — the replacement for Projections.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Dict, List, Optional, Tuple


class PhaseProfiler:
    """Accumulating named-phase wall-clock breakdown.

        prof = PhaseProfiler()
        with prof.phase("mesh read"):
            ...
        with prof.phase("timestep"):
            ...
        print(prof.table())

    Phases may be entered repeatedly (times and counts accumulate); the
    table lists phases in first-entry order with share-of-total, plus
    the first entry's and the median entry's duration (for "timestep"
    the first entry includes the step's compilation).
    """

    def __init__(self):
        self._t0 = time.perf_counter()
        self._acc: Dict[str, float] = {}
        self._durs: Dict[str, List[float]] = {}
        self._order: List[str] = []

    @contextlib.contextmanager
    def phase(self, name: str):
        if name not in self._acc:
            self._acc[name] = 0.0
            self._durs[name] = []
            self._order.append(name)
        t = time.perf_counter()
        try:
            yield
        finally:
            d = time.perf_counter() - t
            self._acc[name] += d
            self._durs[name].append(d)

    def times(self) -> List[Tuple[str, float, int]]:
        """[(phase, seconds, entries)] in first-entry order."""
        return [(k, self._acc[k], len(self._durs[k])) for k in self._order]

    def total(self) -> float:
        return time.perf_counter() - self._t0

    def table(self) -> str:
        """Formatted breakdown, one line per phase + total (the layout
        of the reference's end-of-run timer printout)."""
        tot = self.total()
        w = max((len(k) for k in self._order), default=5)
        lines = [f"{'phase':<{w}}  {'sec':>9}  {'%':>5}  {'n':>6}  "
                 f"{'first_ms':>10}  {'median_ms':>10}"]
        for k, s, n in self.times():
            d = self._durs[k]
            lines.append(
                f"{k:<{w}}  {s:9.3f}  {100.0 * s / tot:5.1f}  {n:6d}  "
                f"{1e3 * d[0]:10.3f}  {1e3 * statistics.median(d):10.3f}")
        acc = sum(self._acc.values())
        lines.append(
            f"{'(untimed)':<{w}}  {tot - acc:9.3f}  "
            f"{100.0 * (tot - acc) / tot:5.1f}")
        lines.append(f"{'total':<{w}}  {tot:9.3f}  100.0")
        return "\n".join(lines)


@contextlib.contextmanager
def jax_trace(logdir: Optional[str]):
    """Wrap a block in jax.profiler.trace when logdir is set (no-op
    otherwise): captures the on-device XLA timeline for TensorBoard —
    the Charm++ Projections analog."""
    if not logdir:
        yield
        return
    import jax

    with jax.profiler.trace(logdir):
        yield

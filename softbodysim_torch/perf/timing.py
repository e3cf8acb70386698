"""Stage-split timing: the reference's two stat printers, unified.

The reference keeps two hand-rolled profilers of one shape: the C++
perf::StepStats / Accum / ScopedAdd (CProgram/include/PBDServer.h:67-120),
printed at 1 Hz by the sim thread (Sim.cpp:400-418), and Unity's
FrameTimers with a percentage breakdown (SoftBodyManager.cs:10-14,158-197).
Here: named accumulators and a 1 Hz-style ``report()`` with ms and
percentages, on the host's clock (the same class as
``softbodysim_tpu/perf/timing.py``).  A stage timed here measures what
the host waited for; for device time per kernel use torch.profiler.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from contextlib import contextmanager


class StepStats:
    """Accumulating stage timers (seconds in, ms out)."""

    def __init__(self):
        self.sums: "OrderedDict[str, float]" = OrderedDict()
        self.count = 0
        self._last_report = time.perf_counter()

    def add(self, stage: str, seconds: float):
        self.sums[stage] = self.sums.get(stage, 0.0) + seconds
        if stage in ("step", "total"):
            self.count += 1

    @contextmanager
    def scope(self, stage: str):
        """RAII-style stage timer (perf::ScopedAdd, PBDServer.h:111-119)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(stage, time.perf_counter() - t0)

    def averages_ms(self):
        n = max(1, self.count)
        return {k: 1000.0 * v / n for k, v in self.sums.items()}

    def report(self, prefix: str = "[softbodysim]", reset: bool = True) -> str:
        total = sum(self.sums.values()) or 1.0
        parts = [f"{k}={ms:.3f}ms({100.0 * self.sums[k] / total:.1f}%)"
                 for k, ms in self.averages_ms().items()]
        elapsed = time.perf_counter() - self._last_report
        fps = self.count / elapsed if elapsed > 0 else 0.0
        line = (f"{prefix} FPS {fps:.1f} steps {self.count} | "
                + " ".join(parts))
        if reset:
            self.reset()
        return line

    def reset(self):
        self.sums.clear()
        self.count = 0
        self._last_report = time.perf_counter()

"""Per-phase step timing for the worker's loops.

The reference's `PhaseTimers` (`elasticdl_tpu/common/timing.py`):
cumulative wall clock per phase, snapshot-able by the worker summary,
the ReportPhaseStats telemetry and chip_smoke.py.

Phases may nest (the run loop's `task_other` wraps `compute`, which
wraps `report_gradient`); each phase is charged its *exclusive* time —
child durations are subtracted from the parent — so the breakdown sums
to real wall clock. Nesting is tracked per thread, and the totals are
updated under a lock: the pipelined report thread and the sync threads
time their phases while the step loop times its own.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict


class PhaseTimers:
    def __init__(self):
        self._seconds: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        self._local = threading.local()  # .stack: open phases, per thread
        self._lock = threading.Lock()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        stack = self._stack()
        stack.append([name, 0.0])
        try:
            yield
        finally:
            elapsed = time.perf_counter() - t0
            _, child = stack.pop()
            with self._lock:
                self._seconds[name] += elapsed - child
                self._counts[name] += 1
            if stack:
                stack[-1][1] += elapsed

    def add(self, name: str, seconds: float):
        with self._lock:
            self._seconds[name] += seconds
            self._counts[name] += 1

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                k: {"seconds": self._seconds[k], "count": self._counts[k]}
                for k in self._seconds
            }

    def seconds(self) -> Dict[str, float]:
        """{phase: exclusive seconds} (the worker summary's
        `phase_seconds`)."""
        with self._lock:
            return dict(self._seconds)

    def summary(self) -> str:
        with self._lock:
            items = sorted(self._seconds.items(), key=lambda kv: -kv[1])
            total = sum(self._seconds.values()) or 1.0
        return " ".join(
            f"{k}={v:.2f}s({100 * v / total:.0f}%)" for k, v in items
        )

    def reset(self):
        with self._lock:
            self._seconds.clear()
            self._counts.clear()

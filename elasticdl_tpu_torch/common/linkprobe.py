"""Link weather for the adaptive sync plane: the passive tracker.

The reference's `elasticdl_tpu/common/linkprobe.py` `LinkWeather`, kept
as the port's own copy. Every window push knows the wire bytes it sent
and how long its RPC took; their ratio is a bandwidth sample at no
extra traffic. The tracker keeps a short ring of recent samples and
answers their median, which one stalled push does not drag. The
reference's active probe (`probe_link_mbps`, a benchmark's host-to-
device timing) has no caller in the port and is not carried.

`sync_policy.decide()` makes the per-round choice; this module only
measures.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import List, Optional


class LinkWeather:
    """Passive link-bandwidth tracker fed from the sync pushes' timings.

    `observe` is called from the worker's sync threads (one at a time:
    the chain serializes pushes); `mbps` and `history` may be read from
    any thread. A lock of its own covers the ring.
    """

    def __init__(self, window: int = 8):
        self._lock = threading.Lock()
        self._samples: deque = deque(maxlen=max(1, int(window)))
        self._observations = 0

    def observe(self, wire_bytes: int, seconds: float) -> None:
        """One push: `wire_bytes` payload bytes took `seconds`. A push
        of no bytes or under a millisecond measures dispatch, not the
        link, and is discarded."""
        if wire_bytes <= 0 or seconds <= 1e-3:
            return
        mbps = wire_bytes * 8.0 / (seconds * 1e6)
        with self._lock:
            self._samples.append(mbps)
            self._observations += 1

    def mbps(self) -> Optional[float]:
        """The median of the recent samples; None before the first (the
        cold start, which `sync_policy.decide` handles)."""
        with self._lock:
            if not self._samples:
                return None
            ordered = sorted(self._samples)
        mid = len(ordered) // 2
        if len(ordered) % 2:
            return ordered[mid]
        return (ordered[mid - 1] + ordered[mid]) / 2.0

    def history(self) -> List[float]:
        """The recent raw samples, oldest first."""
        with self._lock:
            return list(self._samples)

    @property
    def observations(self) -> int:
        with self._lock:
            return self._observations

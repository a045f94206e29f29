"""Hermetic job harness.

`InProcessMaster` exposes the master's RPC surface to a real Worker
without a network, so a whole training job runs in one process; every
request and response is round-tripped through the wire codec, so
serialization is exercised too. It is thread-safe: window mode calls
it from sync threads beside the worker's main thread.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from typing import Any, Callable, Dict, Optional

from elasticdl_tpu_torch.common import messages


class InProcessMaster:
    """Worker-facing shim over a real MasterServicer. `intercept`
    hooks {method: fn(request) -> request} let tests perturb traffic.
    `handler_seconds` and `codec_seconds` split each method's wall clock
    between the servicer and the wire codec (pack + unpack, both ways)."""

    def __init__(self, servicer, intercept: Optional[Dict[str, Callable]] = None):
        self.servicer = servicer
        self._handlers = servicer.handlers()
        self._intercept = intercept or {}
        self.calls: Dict[str, int] = {}
        self.handler_seconds: Counter = Counter()
        self.codec_seconds: Counter = Counter()
        # window mode calls from its sync threads beside the main thread
        self._lock = threading.Lock()

    def call(self, method: str, request: Any = None) -> Any:
        with self._lock:
            self.calls[method] = self.calls.get(method, 0) + 1
        t0 = time.perf_counter()
        req = messages.unpack(messages.pack(request if request is not None else {}))
        if method in self._intercept:
            req = self._intercept[method](req)
        t1 = time.perf_counter()
        resp = self._handlers[method](req)
        t2 = time.perf_counter()
        out = messages.unpack(messages.pack(resp))
        t3 = time.perf_counter()
        with self._lock:
            self.handler_seconds[method] += t2 - t1
            self.codec_seconds[method] += (t1 - t0) + (t3 - t2)
        return out


def build_job(spec, dispatcher, grads_to_wait: int = 1, init_params=None, init_aux=None):
    """Wire a MasterServicer with the spec's PS optimizer over
    `dispatcher`, as the master's boot does; `init_params` and `init_aux`
    (the non-trainable collections) seed the PS, else the first worker
    does. Returns the servicer. The same servicer takes per-step and
    window-mode workers: window mode's settings are the Worker's
    (`local_updates`, `sync_dtype`, ...)."""
    from elasticdl_tpu_torch.master.ps_optimizer import PSOptimizer
    from elasticdl_tpu_torch.master.servicer import MasterServicer

    return MasterServicer(
        grads_to_wait=grads_to_wait,
        optimizer=PSOptimizer(spec.optimizer()),
        task_dispatcher=dispatcher,
        init_params=init_params,
        init_aux=init_aux,
    )

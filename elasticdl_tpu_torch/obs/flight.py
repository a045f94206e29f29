"""Flight recorder: a bounded ring of structured events, dumped on
crash and on demand, so a job that loses a shard leaves a postmortem.

The reference's `elasticdl_tpu/obs/flight.py`. Recorded event kinds
(the schema is ``{"seq", "ts", "pid", "kind", **fields}``): generation
bumps, shard relaunches, the recovery plane's steps, and the chaos
plane's firings (``chaos_fault``, and ``chaos_crash`` just before an
injected crash exits, `rpc/chaos.py`). Events are
rare (control plane, not data plane), so recording is always on — no
sampling knob — and a single lock suffices;
``EDL_FLIGHT_RECORDER_EVENTS`` bounds the ring (default 4096).

The monotonically increasing ``seq`` is assigned under the ring lock,
so the dump's order IS the causal order of in-process events.

Crash path: :func:`install_crash_dump` hooks ``sys.excepthook`` and
``threading.excepthook``; :func:`dump_on_crash` dumps explicitly where
no hook fires (``os._exit``).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from elasticdl_tpu_torch.common.constants import (
    ENV_FLIGHT_DIR,
    ENV_FLIGHT_RECORDER_EVENTS,
)

_DEFAULT_EVENTS = 4096


def _capacity_from_env() -> int:
    raw = os.environ.get(ENV_FLIGHT_RECORDER_EVENTS, "").strip()
    try:
        return max(16, int(raw)) if raw else _DEFAULT_EVENTS
    except ValueError:
        return _DEFAULT_EVENTS


class FlightRecorder:
    def __init__(self, capacity: Optional[int] = None):
        self._lock = threading.Lock()
        self._events: deque = deque(
            maxlen=capacity if capacity is not None else _capacity_from_env()
        )
        self._seq = 0
        self._dropped = 0

    def record(self, kind: str, **fields: Any) -> None:
        with self._lock:
            self._seq += 1
            if len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._events.append(
                {
                    "seq": self._seq,
                    "ts": time.time(),
                    "pid": os.getpid(),
                    "kind": kind,
                    **fields,
                }
            )

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0
            self._seq = 0

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def dump_json(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "pid": os.getpid(),
                "dumped_at": time.time(),
                "dropped": self._dropped,
                "events": list(self._events),
            }

    def dump(self, path: str) -> str:
        doc = self.dump_json()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path


# Process-wide recorder; module-level record() is the one emit point
# every instrumented site uses.
RECORDER = FlightRecorder()


def record(kind: str, **fields: Any) -> None:
    RECORDER.record(kind, **fields)


_crash_path: Optional[str] = None
_crash_installed = False
_crash_lock = threading.Lock()


def crash_dump_dir() -> str:
    """Directory for crash dumps: EDL_FLIGHT_DIR, else a tmp subdir —
    never the working directory (stray dumps used to litter repo
    checkouts)."""
    d = os.environ.get(ENV_FLIGHT_DIR, "").strip() or os.path.join(
        tempfile.gettempdir(), "edl-flight"
    )
    try:
        os.makedirs(d, exist_ok=True)
    except OSError:
        d = tempfile.gettempdir()
    return d


def crash_dump_path() -> str:
    return _crash_path or os.path.join(
        crash_dump_dir(), f"edl_flight_{os.getpid()}.json"
    )


def dump_on_crash(reason: str = "crash") -> Optional[str]:
    """Best-effort dump to the installed path; safe in dying processes
    (for an exit through os._exit, where excepthooks never fire)."""
    try:
        RECORDER.record("dump", reason=reason)
        return RECORDER.dump(crash_dump_path())
    except Exception:
        return None


def install_crash_dump(path: Optional[str] = None) -> None:
    """Wrap sys.excepthook + threading.excepthook so an uncaught
    exception leaves a flight-recorder artifact. Idempotent; the
    original hooks still run."""
    global _crash_path, _crash_installed
    with _crash_lock:
        if path is not None:
            _crash_path = path
        if _crash_installed:
            return
        _crash_installed = True

        prev_sys = sys.excepthook
        prev_threading = threading.excepthook

        def _sys_hook(exc_type, exc, tb):
            RECORDER.record("uncaught_exception", error=exc_type.__name__)
            dump_on_crash(reason=exc_type.__name__)
            prev_sys(exc_type, exc, tb)

        def _threading_hook(hook_args):
            RECORDER.record(
                "uncaught_thread_exception",
                error=getattr(
                    hook_args.exc_type, "__name__", str(hook_args.exc_type)
                ),
                thread=getattr(hook_args.thread, "name", None),
            )
            dump_on_crash(reason="thread_exception")
            prev_threading(hook_args)

        sys.excepthook = _sys_hook
        threading.excepthook = _threading_hook

"""Cross-process sync tracing: Dapper-style context propagation.

The reference's `elasticdl_tpu/obs/trace.py`. Every RPC carries a
compact ``{"t": trace_id, "s": span_id}`` envelope under
``ENVELOPE_KEY`` inside the request dict; the server's dispatcher pops
it before the handler sees the request, on all four transport tiers
(tcp|uds|shm|inproc). Each hop records a span into a bounded
lock-striped :class:`SpanRecorder` ring: the worker's sync chain, the
client and server sides of every RPC, the PS shards' lock-held apply.

Sampling is controlled by ``EDL_TRACE_SAMPLE`` (a probability in
[0, 1], default 0 = off). The off path is a single module-global float
compare — no allocation, no locking — so the sync hot loop pays nothing
when tracing is disabled. The sampling decision is made once per trace
at the root span; child spans inherit it by construction (a child only
exists when its parent context does).

Export is Chrome trace-event JSON ("X" complete events, wall-clock
microsecond timestamps so spans from different processes align on one
Perfetto timeline) via :func:`dump_trace` / :func:`chrome_trace`, and
cross-process via the ``GetTrace`` RPC (master and shard servicers
return their process recorder's spans; merge with
:func:`chrome_trace_from_spans` or `obs/fetch.fetch_chrome_trace`).
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from elasticdl_tpu_torch.common.constants import ENV_TRACE_SAMPLE

# Request-dict key carrying the trace envelope across process
# boundaries. Popped server-side (rpc/transport.ServerDispatcher)
# before the handler sees the request.
ENVELOPE_KEY = "__edl_trace__"

_STRIPES = 8
_DEFAULT_CAPACITY = 8192

_tls = threading.local()

# Resolved sampling probability; None = not yet read from the env.
# Kept module-global so the disabled fast path is one float compare.
_sample: Optional[float] = None


def _resolve_sample() -> float:
    global _sample
    raw = os.environ.get(ENV_TRACE_SAMPLE, "")
    try:
        val = min(1.0, max(0.0, float(raw))) if raw.strip() else 0.0
    except ValueError:
        val = 0.0
    _sample = val
    return val


def configure(sample: Optional[float]) -> None:
    """Pin the sampling probability (tests); None re-reads the env."""
    global _sample
    _sample = None if sample is None else min(1.0, max(0.0, float(sample)))


def refresh() -> None:
    """Drop the cached EDL_TRACE_SAMPLE (call after mutating the env)."""
    global _sample
    _sample = None


def enabled() -> bool:
    s = _sample
    if s is None:
        s = _resolve_sample()
    return s > 0.0


def _sampled() -> bool:
    s = _sample
    if s is None:
        s = _resolve_sample()
    return s > 0.0 and (s >= 1.0 or random.random() < s)


def _new_id() -> str:
    return os.urandom(8).hex()


@dataclass(frozen=True)
class TraceContext:
    """Identity of one span: which trace, which span, whose child."""

    trace_id: str
    span_id: str
    parent_id: Optional[str] = None

    def envelope(self) -> Dict[str, str]:
        return {"t": self.trace_id, "s": self.span_id}


class SpanRecorder:
    """Bounded lock-striped ring of finished spans.

    Recording threads hash onto one of ``stripes`` (lock, deque)
    pairs by thread id — the same contention-avoidance shape as
    rpc/policy.WireStats. Each deque is bounded; overflow evicts the
    oldest span on that stripe and bumps the dropped counter, so a
    long-running job keeps the most recent window of spans.
    """

    def __init__(
        self, capacity: int = _DEFAULT_CAPACITY, stripes: int = _STRIPES
    ):
        per = max(1, capacity // max(1, stripes))
        self._stripes = [
            (threading.Lock(), deque(maxlen=per), [0])
            for _ in range(max(1, stripes))
        ]

    def _stripe(self):
        return self._stripes[threading.get_ident() % len(self._stripes)]

    def record(self, span: Dict[str, Any]) -> None:
        lock, ring, dropped = self._stripe()
        with lock:
            if len(ring) == ring.maxlen:
                dropped[0] += 1
            ring.append(span)

    def snapshot(self) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for lock, ring, _dropped in self._stripes:
            with lock:
                out.extend(ring)
        out.sort(key=lambda s: s["ts"])
        return out

    def clear(self) -> None:
        for lock, ring, dropped in self._stripes:
            with lock:
                ring.clear()
                dropped[0] = 0

    @property
    def dropped(self) -> int:
        total = 0
        for lock, _ring, dropped in self._stripes:
            with lock:
                total += dropped[0]
        return total

    def __len__(self) -> int:
        return sum(len(ring) for _l, ring, _d in self._stripes)


# Process-wide recorder: every instrumented hop in this process records
# here; GetTrace / dump_trace read it.
RECORDER = SpanRecorder()


def current() -> Optional[TraceContext]:
    return getattr(_tls, "ctx", None)


def bind(ctx: Optional[TraceContext]) -> Optional[TraceContext]:
    """Set the thread's current context; returns the previous one."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    return prev


class Span:
    """A live span; ``end()`` records it. Not thread-safe (one owner)."""

    __slots__ = ("name", "cat", "ctx", "args", "_t0", "_recorder", "_done")

    def __init__(self, name, cat, ctx, args, recorder):
        self.name = name
        self.cat = cat
        self.ctx = ctx
        self.args = args
        self._t0 = time.time()
        self._recorder = recorder
        self._done = False

    def envelope(self) -> Dict[str, str]:
        return self.ctx.envelope()

    def exclude(self, seconds: float) -> None:
        """Leave `seconds` of waiting out of the span's duration by
        moving its start that much later (the port's window sync leaves
        out its wait for the predecessor sync, which the predecessor's
        own span already covers)."""
        self._t0 += max(0.0, float(seconds))

    def end(self, **extra: Any) -> None:
        if self._done:
            return
        self._done = True
        now = time.time()
        args = dict(self.args or {})
        args.update(extra)
        self._recorder.record(
            {
                "name": self.name,
                "cat": self.cat,
                "ts": self._t0,
                "dur": max(0.0, now - self._t0),
                "trace_id": self.ctx.trace_id,
                "span_id": self.ctx.span_id,
                "parent_id": self.ctx.parent_id,
                "pid": os.getpid(),
                "tid": threading.get_ident(),
                "args": args,
            }
        )


def start_span(
    name: str,
    cat: str = "edl",
    parent: Optional[TraceContext] = None,
    args: Optional[Dict[str, Any]] = None,
    root: bool = False,
    recorder: Optional[SpanRecorder] = None,
) -> Optional[Span]:
    """Open a span; returns None when tracing is off or unsampled.

    With no explicit ``parent`` the thread's current context is used;
    when there is no context at all, a new trace starts only if
    ``root=True`` and the sampling coin lands — otherwise the call is
    a no-op. Callers must ``end()`` the returned span.
    """
    s = _sample
    if s is None:
        s = _resolve_sample()
    if s <= 0.0:
        return None
    if parent is None:
        parent = current()
    if parent is None:
        if not root or not _sampled():
            return None
        ctx = TraceContext(_new_id(), _new_id(), None)
    else:
        ctx = TraceContext(parent.trace_id, _new_id(), parent.span_id)
    return Span(name, cat, ctx, args, recorder or RECORDER)


@contextlib.contextmanager
def span(
    name: str,
    cat: str = "edl",
    parent: Optional[TraceContext] = None,
    args: Optional[Dict[str, Any]] = None,
    root: bool = False,
):
    """Context manager: open a span and bind it as the thread's current
    context so nested instrumented calls chain automatically. Records
    on exit, including the error path."""
    sp = start_span(name, cat=cat, parent=parent, args=args, root=root)
    if sp is None:
        yield None
        return
    prev = bind(sp.ctx)
    try:
        yield sp
    except BaseException as e:
        sp.end(error=type(e).__name__)
        raise
    finally:
        bind(prev)
        sp.end()


def record_event(
    name: str,
    begin: float,
    end: float,
    cat: str = "edl",
    parent: Optional[TraceContext] = None,
    args: Optional[Dict[str, Any]] = None,
    recorder: Optional[SpanRecorder] = None,
) -> None:
    """Retro-record a span from explicit wall-clock bounds — used for
    intervals measured before it was known that they end (the master's
    `master.apply`: its lock wait starts before the apply, whose
    duplicate early return records nothing)."""
    if parent is None:
        parent = current()
    if parent is None or not enabled():
        return
    ctx = TraceContext(parent.trace_id, _new_id(), parent.span_id)
    (recorder or RECORDER).record(
        {
            "name": name,
            "cat": cat,
            "ts": begin,
            "dur": max(0.0, end - begin),
            "trace_id": ctx.trace_id,
            "span_id": ctx.span_id,
            "parent_id": ctx.parent_id,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "args": dict(args or {}),
        }
    )


def extract(req: Any) -> Optional[TraceContext]:
    """Pop the envelope from an unpacked request dict (server side).

    Always pops — a disabled server must not leak the envelope key into
    handlers — but only materializes a context when tracing is on."""
    if not isinstance(req, dict):
        return None
    env = req.pop(ENVELOPE_KEY, None)
    if not env or not enabled():
        return None
    try:
        return TraceContext(str(env["t"]), str(env["s"]), None)
    except (KeyError, TypeError):
        return None


def chrome_trace_from_spans(spans: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Chrome trace-event JSON from recorder-shaped span dicts.

    Timestamps are wall-clock microseconds, so spans gathered from
    several processes (GetTrace fan-out) align on one timeline."""
    events = []
    for s in spans:
        args = dict(s.get("args") or {})
        args["trace_id"] = s.get("trace_id")
        args["span_id"] = s.get("span_id")
        args["parent_id"] = s.get("parent_id")
        events.append(
            {
                "name": s["name"],
                "cat": s.get("cat", "edl"),
                "ph": "X",
                "ts": s["ts"] * 1e6,
                "dur": s["dur"] * 1e6,
                "pid": s.get("pid", 0),
                "tid": s.get("tid", 0),
                "args": args,
            }
        )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def chrome_trace(recorder: Optional[SpanRecorder] = None) -> Dict[str, Any]:
    return chrome_trace_from_spans((recorder or RECORDER).snapshot())


def dump_trace(
    path: str, recorder: Optional[SpanRecorder] = None
) -> str:
    """Write the recorder's spans as Perfetto-loadable JSON; returns
    the path."""
    doc = chrome_trace(recorder)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path

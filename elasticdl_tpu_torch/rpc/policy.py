"""Retry, backoff and deadline policy for the RPC plane.

The reference's `elasticdl_tpu/rpc/policy.py` for the ported methods,
without grpc:

- `StatusCode` carries the gRPC code names and values that the port's
  transport raises;
- `PolicyRpcError` is the error every client call raises, with
  `.code()` and `.details()` as a grpc.RpcError has them (`rpc/fencing.py` classifies
  a fenced call and a shard outage on them);
- `RetryPolicy` retries an idempotent call on UNAVAILABLE or
  DEADLINE_EXCEEDED with exponential backoff and deterministic jitter (a
  hash of seed, method and attempt, so a fixed seed reproduces every
  schedule), inside the caller's total deadline; `from_env` applies the
  EDL_RPC_RETRIES, EDL_RPC_BACKOFF and EDL_RPC_SEED overrides;
- `CircuitBreaker` fails an endpoint's calls fast after 5 consecutive
  failures (`CircuitOpenError`, UNAVAILABLE) and half-opens after 5 s
  to let one probe through, so a worker does not spend its whole
  deadline re-dialing a dead shard on every operation;
- `IDEMPOTENT_METHODS` names the calls safe to re-send. GetTask and
  ReportGradient are not: a lost GetTask response would orphan a task,
  and a re-sent gradient would apply twice. They fall through to task
  requeue and worker relaunch;
- `WireStats` counts payload bytes and calls per method and tier, one
  shared by every `RpcClient` of an endpoint (`wire_stats_for`,
  `all_wire_stats`) and one per `RpcServer`; the metrics plane reads
  them (`obs/metrics.py`).

The chaos hooks that inject faults under this policy are in
`rpc/chaos.py`.
"""

from __future__ import annotations

import enum
import hashlib
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, FrozenSet, Optional

from elasticdl_tpu_torch.common.constants import (
    ENV_RPC_BACKOFF,
    ENV_RPC_RETRIES,
    ENV_RPC_SEED,
)


class StatusCode(enum.Enum):
    """gRPC status codes by name and value (the subset the port raises)."""

    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    FAILED_PRECONDITION = 9  # a fenced shard call (rpc/fencing.py): never re-sent
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14


#: Codes worth re-sending an idempotent call for. INTERNAL is absent: a
#: handler exception is deterministic, and a retry would hide it.
RETRYABLE_CODES: FrozenSet[StatusCode] = frozenset(
    {StatusCode.UNAVAILABLE, StatusCode.DEADLINE_EXCEEDED}
)

#: The ported methods that are safe to re-send: reads (EmbeddingLookup
#: among them), the task report that the dispatcher dedups (a stale or
#: repeated report is dropped), and the window sync, which the servicer
#: dedups by its `report_key` (a resend is absorbed and answered with the
#: merged model). EmbeddingUpdate is not, as in the reference. The PS
#: shards' methods are: reads, the SETNX init, the optimizer-state
#: restore (an overwrite) and the pushes, which the shard dedups by their
#: `report_key` (`DEDUP_KEYED_METHODS`); the port's own stats read,
#: PSStats, is not re-sent. ReportWindowMeta is not (a
#: mirror of pushes already applied; a lost one falls through to the task
#: requeue, as in the reference). The recovery plane's are: a worker's
#: restore upload (the plane keeps the highest version offered), the
#: in-place refences (idempotent by target generation; a stale one is
#: fenced, and FAILED_PRECONDITION is never re-sent anyway), and the KV
#: shards' reads, overwrites and mirror traffic, as the reference
#: classifies them. The observability plane's are: phase telemetry is a
#: cumulative last-write-wins snapshot per worker, and GetTrace and
#: GetMetrics are reads of process-local recorders.
IDEMPOTENT_METHODS: FrozenSet[str] = frozenset(
    {"GetModel", "GetAux", "GetPSConfig", "GetSampleBatch", "ReportTaskResult",
     "EmbeddingLookup", "ReportLocalUpdate",
     "PSInit", "PSPull", "PSPushGrad", "PSPushDelta", "PSOptState", "PSOptRestore",
     "PSRefence", "PSRestoreFromWorker",
     "KVLookup", "KVUpdate", "KVSnapshot", "KVRestore", "KVLen",
     "KVMirror", "KVMirrorSnapshot", "KVSetMirror", "KVRefence",
     "ReportPhaseStats", "GetTrace", "GetMetrics"}
)

#: Mutations that are safe to re-send only because the receiver dedups
#: them by the request's `report_key`: every call of one carries a key.
DEDUP_KEYED_METHODS: FrozenSet[str] = frozenset(
    {"PSPushGrad", "PSPushDelta", "ReportLocalUpdate"}
)


class PolicyRpcError(Exception):
    """An RPC failure with its status code."""

    def __init__(self, code: StatusCode, details: str):
        self._code = code
        self._details = details
        super().__init__(f"{code.name}: {details}")

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details


class DeadlineExhausted(PolicyRpcError):
    """The per-call deadline budget ran out across attempts."""


class CircuitOpenError(PolicyRpcError):
    """Fail fast: the endpoint's breaker is open (recent repeated errors)."""

    def __init__(self, endpoint: str):
        super().__init__(StatusCode.UNAVAILABLE, f"circuit open for {endpoint}")


@dataclass(frozen=True)
class RetryPolicy:
    """The retry schedule every RpcClient runs under.

    `max_attempts` counts every try (1: no retry). The backoff before
    retry k (k >= 1) is ``min(initial_backoff * multiplier**(k-1),
    max_backoff)``, shrunk by up to `jitter` of itself by a hash of
    (seed, method, k): deterministic for a fixed seed, different across
    methods and attempts. `sleep_fn` and `clock` are injectable, so a
    test runs a schedule on a virtual clock."""

    max_attempts: int = 4
    initial_backoff: float = 0.05
    multiplier: float = 2.0
    max_backoff: float = 2.0
    jitter: float = 0.5
    seed: int = 0
    retryable_codes: FrozenSet[StatusCode] = RETRYABLE_CODES
    sleep_fn: Callable[[float], None] = field(default=time.sleep, repr=False)
    clock: Callable[[], float] = field(default=time.monotonic, repr=False)

    @classmethod
    def from_env(cls, env=None) -> "RetryPolicy":
        """The default schedule with the EDL_RPC_RETRIES,
        EDL_RPC_BACKOFF and EDL_RPC_SEED overrides that are set."""
        env = os.environ if env is None else env
        kw = {}
        if env.get(ENV_RPC_RETRIES):
            kw["max_attempts"] = max(1, int(env[ENV_RPC_RETRIES]))
        if env.get(ENV_RPC_BACKOFF):
            kw["initial_backoff"] = float(env[ENV_RPC_BACKOFF])
        if env.get(ENV_RPC_SEED):
            kw["seed"] = int(env[ENV_RPC_SEED])
        return cls(**kw)

    def backoff_for(self, method: str, attempt: int) -> float:
        """Backoff before retry number `attempt` (1-based). Deterministic."""
        base = min(self.initial_backoff * self.multiplier ** (attempt - 1), self.max_backoff)
        h = hashlib.sha256(f"{self.seed}:{method}:{attempt}".encode()).digest()
        frac = int.from_bytes(h[:8], "big") / 2**64  # [0, 1)
        return base * (1.0 - self.jitter * frac)

    def call(
        self,
        fn: Callable[[float], object],
        method: str,
        timeout: float,
        idempotent: bool,
        breaker: Optional["CircuitBreaker"] = None,
    ):
        """fn(remaining seconds) under the policy, behind `breaker` when
        one is given. `timeout` bounds the whole call, retries and
        backoff included: a retry is made only when its backoff still
        fits inside the budget. An open circuit raises CircuitOpenError
        before the attempt, and is not retried."""
        deadline = self.clock() + timeout
        attempt = 0
        while True:
            remaining = deadline - self.clock()
            if remaining <= 0:
                raise DeadlineExhausted(
                    StatusCode.DEADLINE_EXCEEDED,
                    f"{method}: deadline budget spent after {attempt} attempts",
                )
            if breaker is not None:
                breaker.before_call()
            try:
                result = fn(remaining)
            except PolicyRpcError as e:
                if breaker is not None:
                    breaker.record_failure()
                attempt += 1
                if (
                    not idempotent
                    or e.code() not in self.retryable_codes
                    or attempt >= self.max_attempts
                ):
                    raise
                pause = self.backoff_for(method, attempt)
                if self.clock() + pause >= deadline:
                    # no room for the backoff and another try: surface
                    # the real failure rather than sleep into the deadline
                    raise
                self.sleep_fn(pause)
                continue
            if breaker is not None:
                breaker.record_success()
            return result


class CircuitBreaker:
    """Per-endpoint breaker: after `failure_threshold` CONSECUTIVE
    failures the circuit opens and calls fail fast with
    `CircuitOpenError` (code UNAVAILABLE). After `reset_interval`
    seconds it half-opens: exactly one probe call goes through; its
    success closes the circuit, its failure opens it again (and re-arms
    the timer). The clock is injectable, so tests never sleep."""

    def __init__(
        self,
        endpoint: str = "",
        failure_threshold: int = 5,
        reset_interval: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.endpoint = endpoint
        self._threshold = max(1, failure_threshold)
        self._reset_interval = reset_interval
        self._clock = clock
        self._lock = threading.Lock()
        self._failures = 0
        self._open = False
        self._opened_at = 0.0
        self._probing = False

    @property
    def is_open(self) -> bool:
        with self._lock:
            return self._open

    def before_call(self):
        with self._lock:
            if not self._open:
                return
            now = self._clock()
            if now - self._opened_at >= self._reset_interval and not self._probing:
                self._probing = True  # half-open: this call is the probe
                return
            raise CircuitOpenError(self.endpoint)

    def record_success(self):
        with self._lock:
            self._failures = 0
            self._open = False
            self._probing = False

    def record_failure(self):
        with self._lock:
            self._failures += 1
            self._probing = False
            if self._failures >= self._threshold:
                self._open = True
                self._opened_at = self._clock()


class WireStats:
    """Per-endpoint wire-byte accounting: bytes_sent / bytes_received /
    calls, broken down by method and by the transport tier that moved
    them ("tcp", "uds", "shm", "inproc"). One instance is shared by
    every `RpcClient` dialing the same endpoint (`wire_stats_for`) and
    one per `RpcServer`. Counters are payload bytes as handed to /
    received from the transport (post-codec, pre-framing); an in-process
    call moves no wire bytes but still counts its call (callers pass
    `calls=1` there, since the default counts a call per non-empty
    send).

    Counters are striped (a lock per stripe, threads pinned round-robin
    to stripes), so concurrent recorders do not convoy on one mutex;
    snapshot() merges the stripes."""

    _NUM_STRIPES = 8

    def __init__(self, endpoint: str = ""):
        self.endpoint = endpoint
        # stripe -> (lock, method -> [sent, recv, calls],
        #           transport tier -> [sent, recv, calls])
        self._stripes = [(threading.Lock(), {}, {}) for _ in range(self._NUM_STRIPES)]

    def record(self, method: str, sent: int = 0, received: int = 0,
               transport: str = "tcp", calls=None):
        n = (1 if sent else 0) if calls is None else int(calls)
        lock, methods, transports = self._stripes[_stripe_index()]
        with lock:
            for table, key in ((methods, method), (transports, transport)):
                row = table.get(key)
                if row is None:
                    row = table[key] = [0, 0, 0]
                row[0] += int(sent)
                row[1] += int(received)
                row[2] += n

    def snapshot(self) -> dict:
        methods: dict = {}
        transports: dict = {}
        for lock, smethods, stransports in self._stripes:
            with lock:
                srows = [(m, list(r)) for m, r in smethods.items()]
                trows = [(t, list(r)) for t, r in stransports.items()]
            for table, rows in ((methods, srows), (transports, trows)):
                for k, r in rows:
                    agg = table.setdefault(
                        k, {"bytes_sent": 0, "bytes_received": 0, "calls": 0})
                    agg["bytes_sent"] += r[0]
                    agg["bytes_received"] += r[1]
                    agg["calls"] += r[2]
        return {
            "endpoint": self.endpoint,
            "bytes_sent": sum(v["bytes_sent"] for v in methods.values()),
            "bytes_received": sum(v["bytes_received"] for v in methods.values()),
            "calls": sum(v["calls"] for v in methods.values()),
            "methods": methods,
            "transports": transports,
        }

    def reset(self):
        for lock, methods, transports in self._stripes:
            with lock:
                methods.clear()
                transports.clear()


# Threads are pinned to stripes round-robin at first record: cheaper
# and better spread than hashing thread ids (CPython idents are
# pointer-aligned, so their low bits collide).
_stripe_tl = threading.local()
_stripe_seq_lock = threading.Lock()
_stripe_seq = 0


def _stripe_index() -> int:
    idx = getattr(_stripe_tl, "idx", None)
    if idx is None:
        global _stripe_seq
        with _stripe_seq_lock:
            idx = _stripe_seq % WireStats._NUM_STRIPES
            _stripe_seq += 1
        _stripe_tl.idx = idx
    return idx


_wire_registry_lock = threading.Lock()
_wire_registry: dict = {}


def wire_stats_for(endpoint: str) -> WireStats:
    """The process-wide WireStats for `endpoint` (created on first
    use), shared by every client of the endpoint."""
    with _wire_registry_lock:
        ws = _wire_registry.get(endpoint)
        if ws is None:
            ws = _wire_registry[endpoint] = WireStats(endpoint)
        return ws


def all_wire_stats() -> dict:
    """{endpoint: snapshot} for every endpoint this process dialed."""
    with _wire_registry_lock:
        entries = list(_wire_registry.items())
    return {ep: ws.snapshot() for ep, ws in entries}


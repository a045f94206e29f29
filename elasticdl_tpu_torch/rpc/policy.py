"""Retry, backoff and deadline policy for the RPC plane.

The reference's `elasticdl_tpu/rpc/policy.py` for the ported methods,
without grpc:

- `StatusCode` carries the gRPC code names and values that the port's
  transport raises;
- `PolicyRpcError` is the error every client call raises, with
  `.code()` and `.details()` as a grpc.RpcError has them;
- `RetryPolicy` retries an idempotent call on UNAVAILABLE or
  DEADLINE_EXCEEDED with exponential backoff and deterministic jitter (a
  hash of seed, method and attempt, so a fixed seed reproduces every
  schedule), inside the caller's total deadline;
- `IDEMPOTENT_METHODS` names the calls safe to re-send. GetTask and
  ReportGradient are not: a lost GetTask response would orphan a task,
  and a re-sent gradient would apply twice. They fall through to task
  requeue and worker relaunch.

Not ported yet: the circuit breaker, wire statistics, chaos hooks and
the environment overrides of the policy.
"""

from __future__ import annotations

import enum
import hashlib
import time
from dataclasses import dataclass, field
from typing import Callable, FrozenSet


class StatusCode(enum.Enum):
    """gRPC status codes by name and value (the subset the port raises)."""

    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    FAILED_PRECONDITION = 9
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14


#: Codes worth re-sending an idempotent call for. INTERNAL is absent: a
#: handler exception is deterministic, and a retry would hide it.
RETRYABLE_CODES: FrozenSet[StatusCode] = frozenset(
    {StatusCode.UNAVAILABLE, StatusCode.DEADLINE_EXCEEDED}
)

#: The ported methods that are safe to re-send: reads, and the task
#: report that the dispatcher dedups (a stale or repeated report is
#: dropped).
IDEMPOTENT_METHODS: FrozenSet[str] = frozenset(
    {"GetModel", "GetPSConfig", "ReportTaskResult"}
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


# The reference's default schedule: `MAX_ATTEMPTS` counts every try; the
# backoff before retry k is min(INITIAL_BACKOFF * MULTIPLIER**(k-1),
# MAX_BACKOFF), shrunk by up to JITTER of itself.
MAX_ATTEMPTS = 4
INITIAL_BACKOFF = 0.05
MULTIPLIER = 2.0
MAX_BACKOFF = 2.0
JITTER = 0.5


@dataclass(frozen=True)
class RetryPolicy:
    """The module's schedule, its jitter drawn from a hash of (seed,
    method, k). `sleep_fn` lets a test record the pauses."""

    seed: int = 0
    sleep_fn: Callable[[float], None] = field(default=time.sleep, repr=False)

    def backoff_for(self, method: str, attempt: int) -> float:
        """Backoff before retry number `attempt` (1-based). Deterministic."""
        base = min(INITIAL_BACKOFF * MULTIPLIER ** (attempt - 1), MAX_BACKOFF)
        h = hashlib.sha256(f"{self.seed}:{method}:{attempt}".encode()).digest()
        frac = int.from_bytes(h[:8], "big") / 2**64  # [0, 1)
        return base * (1.0 - JITTER * frac)

    def call(
        self,
        fn: Callable[[float], object],
        method: str,
        timeout: float,
        idempotent: bool,
    ):
        """fn(remaining seconds) under the policy. `timeout` bounds the
        whole call, retries and backoff included: a retry is made only
        when its backoff still fits inside the budget."""
        deadline = time.monotonic() + timeout
        attempt = 0
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise PolicyRpcError(
                    StatusCode.DEADLINE_EXCEEDED,
                    f"{method}: deadline budget spent after {attempt} attempts",
                )
            try:
                return fn(remaining)
            except PolicyRpcError as e:
                attempt += 1
                if (
                    not idempotent
                    or e.code() not in RETRYABLE_CODES
                    or attempt >= MAX_ATTEMPTS
                ):
                    raise
                pause = self.backoff_for(method, attempt)
                if time.monotonic() + pause >= deadline:
                    raise
                self.sleep_fn(pause)

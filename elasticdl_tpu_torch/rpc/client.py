"""The RPC client: method-name-addressed calls to an `RpcServer`.

The reference's `RpcClient` (`elasticdl_tpu/rpc/client.py`) over the
port's transport tiers: the link takes the tier that
`select_transport(addr)` picks under `EDL_TRANSPORT` when the client is
built, and the TCP tier when it picks none; `tier` names the tier the link runs on ("tcp", "uds", "shm" or
"inproc"). Every call runs under `RetryPolicy` (`RetryPolicy.from_env()`
by default: idempotent methods retry UNAVAILABLE and DEADLINE_EXCEEDED
inside the caller's deadline) behind the endpoint's `CircuitBreaker`,
and raises `PolicyRpcError` when it fails, whichever tier carries it.
The transport runs the client half of chaos (`rpc/chaos.py`) with the
client's `FaultPlan` (`FaultPlan.from_env()` by default, None when
`EDL_CHAOS_SPEC` is unset): one plan for whichever tier serves, so its
counters advance the same way on every tier. It
exposes `call(method, request)` as `testing.InProcessMaster` does, so a
Worker takes either.

`seconds` and `codec_seconds` count each method's wall clock and the
part of it spent in the codec (pack + unpack), so the socket hop is
`seconds - codec_seconds` less the server's time for the method, on
every tier. Calls may come from several threads (window mode's sync
threads): the transport gives each concurrent call its own connection,
and the counters are locked.

Each call opens a root span `rpc.client.<method>` when tracing samples
it (`obs/trace.py`): the span covers the whole policy call, retries
included, and its envelope rides inside a dict request under
`ENVELOPE_KEY`, so the server's span joins the caller's trace. With
tracing off the request's bytes are those of an untraced call. `wire`,
the endpoint's `policy.WireStats`, counts each attempt's payload bytes
and tier.

Not ported yet: `reconnect` (master failover) and the `transport`
argument that pins one link's tier (the aggregation tree's).
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from typing import Any, Optional

from elasticdl_tpu_torch.common import messages
from elasticdl_tpu_torch.obs import trace as obs_trace
from elasticdl_tpu_torch.rpc import chaos
from elasticdl_tpu_torch.rpc.policy import (
    IDEMPOTENT_METHODS,
    CircuitBreaker,
    PolicyRpcError,
    RetryPolicy,
    StatusCode,
    wire_stats_for,
)
from elasticdl_tpu_torch.rpc.transport import TcpTransport, select_transport


class RpcClient:
    def __init__(
        self,
        addr: str,
        policy: Optional[RetryPolicy] = None,
        breaker: Optional[CircuitBreaker] = None,
        fault_plan: Optional[chaos.FaultPlan] = None,
    ):
        host, _, port = addr.rpartition(":")
        self._addr = addr
        plan = fault_plan if fault_plan is not None else chaos.FaultPlan.from_env()
        self._transport = select_transport(addr, fault_plan=plan) or TcpTransport(
            host, int(port), fault_plan=plan
        )
        self.tier = self._transport.name
        self._policy = policy if policy is not None else RetryPolicy.from_env()
        self._breaker = breaker if breaker is not None else CircuitBreaker(addr)
        self.seconds: Counter = Counter()
        self.codec_seconds: Counter = Counter()
        # window mode's sync threads call beside the main thread
        self._stats_lock = threading.Lock()
        # per-endpoint wire-byte accounting, shared by this endpoint's clients
        self.wire = wire_stats_for(addr)

    def wait_ready(self, timeout: float = 30.0):
        """Poll until a listener accepts at the address (a worker may
        boot before its master listens); raises UNAVAILABLE after
        `timeout` seconds."""
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            try:
                self._transport.probe(max(0.001, min(remaining, 1.0)))
                return
            except PolicyRpcError:
                if remaining <= 0.1:
                    break
            time.sleep(0.1)
        raise PolicyRpcError(
            StatusCode.UNAVAILABLE, f"no listener at {self._addr} after {timeout}s"
        )

    def call(
        self,
        method: str,
        request: Any = None,
        timeout: float = 300.0,
        idempotent: Optional[bool] = None,
    ) -> Any:
        if idempotent is None:
            idempotent = method in IDEMPOTENT_METHODS
        t0 = time.perf_counter()
        # the span exists before the request is packed: its envelope
        # rides inside the frame. A call with no surrounding context
        # starts a new sampled trace
        tspan = None
        if request is None or isinstance(request, dict):
            tspan = obs_trace.start_span(f"rpc.client.{method}", cat="rpc", root=True)
            if tspan is not None:
                request = dict(request or {})
                request[obs_trace.ENVELOPE_KEY] = tspan.envelope()
        payload = messages.pack(request if request is not None else {})
        t1 = time.perf_counter()
        transport = self._transport
        inproc = self.tier == "inproc"

        def attempt(remaining):
            self.wire.record(method, sent=0 if inproc else len(payload),
                             transport=self.tier, calls=1 if inproc else None)
            resp_bytes = transport.call(method, payload, remaining)
            self.wire.record(method, received=0 if inproc else len(resp_bytes),
                             transport=self.tier)
            return resp_bytes

        try:
            resp = self._policy.call(attempt, method=method, timeout=timeout,
                                     idempotent=idempotent, breaker=self._breaker)
        finally:
            if tspan is not None:
                tspan.end(transport=self.tier)
        t2 = time.perf_counter()
        out = messages.unpack(resp)
        t3 = time.perf_counter()
        with self._stats_lock:
            self.seconds[method] += t3 - t0
            self.codec_seconds[method] += (t1 - t0) + (t3 - t2)
        return out

    def close(self):
        self._transport.close()

"""The RPC client: method-name-addressed calls to an `RpcServer`.

The reference's `RpcClient` (`elasticdl_tpu/rpc/client.py`) over the
port's TCP transport: every call runs under `RetryPolicy` (idempotent
methods retry UNAVAILABLE and DEADLINE_EXCEEDED inside the caller's
deadline), and raises `PolicyRpcError` when it fails. It exposes
`call(method, request)` as `testing.InProcessMaster` does, so a Worker
takes either.

`seconds` and `codec_seconds` count each method's wall clock and the
part of it spent in the codec (pack + unpack), so the socket hop is
`seconds - codec_seconds` less the server's time for the method.

Not ported yet: the trace envelope, `reconnect` (master failover) and
the circuit breaker.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Any, Optional

from elasticdl_tpu_torch.common import messages
from elasticdl_tpu_torch.rpc.policy import (
    IDEMPOTENT_METHODS,
    PolicyRpcError,
    RetryPolicy,
    StatusCode,
)
from elasticdl_tpu_torch.rpc.transport import TcpTransport


class RpcClient:
    def __init__(self, addr: str, policy: Optional[RetryPolicy] = None):
        host, _, port = addr.rpartition(":")
        self._addr = addr
        self._transport = TcpTransport(host, int(port))
        self._policy = policy if policy is not None else RetryPolicy()
        self.seconds: Counter = Counter()
        self.codec_seconds: Counter = Counter()

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
        payload = messages.pack(request if request is not None else {})
        t1 = time.perf_counter()
        resp = self._policy.call(
            lambda remaining: self._transport.call(method, payload, remaining),
            method=method,
            timeout=timeout,
            idempotent=idempotent,
        )
        t2 = time.perf_counter()
        out = messages.unpack(resp)
        t3 = time.perf_counter()
        self.seconds[method] += t3 - t0
        self.codec_seconds[method] += (t1 - t0) + (t3 - t2)
        return out

    def close(self):
        self._transport.close()

"""The RPC server: `{method: fn(request dict) -> response dict}` over the
port's transport tiers.

The reference's `RpcServer` (`elasticdl_tpu/rpc/server.py`) serves a
handler table over gRPC; the port serves it over the TCP tier of
`rpc/transport.py`, one thread per connection. As in the reference, the
same `ServerDispatcher` also serves the fast paths: the handler table is
registered for in-process calls under the bound port, and, when
`EDL_TRANSPORT` asks for them, a Unix-socket listener (uds, auto) and a
shared-memory listener (shm, auto) open beside TCP. A fast listener that
cannot start is logged, and TCP serves. `shm_scope` and `shm_generation`
name the shm listener's segments: a PS or KV shard slot passes its
job-stable scope and its fencing generation, so that its relaunch sweeps
a SIGKILLed predecessor's segments (`rpc/transport.ShmServer`).

Server-side chaos is on when `EDL_CHAOS_SPEC` is set (a shard process
inherits it, tagged with its role and slot) or a `fault_plan` is passed:
the dispatcher runs the plan's server half on every tier
(`rpc/chaos.py`).

`wire` counts every tier's payload bytes and calls (`policy.WireStats`);
`start` registers it with the process's metrics registry as a pull
collector (`edl_wire_*_total{side="server"}`, dropped again by `stop`)
and starts the `EDL_METRICS_PORT` listener when that is set
(`obs/metrics.py`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from elasticdl_tpu_torch.common.log_util import get_logger
from elasticdl_tpu_torch.rpc import chaos
from elasticdl_tpu_torch.rpc import transport as transport_mod
from elasticdl_tpu_torch.rpc.policy import WireStats

logger = get_logger(__name__)


class RpcServer:
    def __init__(
        self,
        handlers: Dict[str, Callable],
        port: int = 0,
        shm_scope: Optional[str] = None,
        shm_generation: int = 0,
        fault_plan=None,
    ):
        self.wire = WireStats("server")
        plan = fault_plan if fault_plan is not None else chaos.FaultPlan.from_env()
        self._dispatcher = transport_mod.ServerDispatcher(handlers, self.wire, fault_plan=plan)
        self._collector = None  # the metrics collector, from start to stop
        self._tcp = transport_mod.TcpServer(port, self._dispatcher)
        self.port = self._tcp.port
        transport_mod.register_inproc(self.port, self._dispatcher)
        self._uds = None
        if transport_mod.server_fast_paths_enabled():
            try:
                self._uds = transport_mod.UdsServer(self.port, self._dispatcher)
            except OSError as e:
                logger.warning("UDS fast path unavailable for port %s (%s); TCP only",
                               self.port, e)
        self._shm = None
        if transport_mod.server_shm_enabled():
            try:
                self._shm = transport_mod.ShmServer(
                    self.port, self._dispatcher, scope=shm_scope, generation=shm_generation
                )
            except OSError as e:
                logger.warning("shm fast path unavailable for port %s (%s)", self.port, e)

    def start(self):
        self._tcp.start()
        if self._uds is not None:
            self._uds.start()
        if self._shm is not None:
            self._shm.start()
        self._register_metrics()

    def _register_metrics(self):
        """Feed this server's wire counters into the process's
        MetricsRegistry (a pull collector: no cost on the hot path) and
        start the optional EDL_METRICS_PORT scrape listener."""
        from elasticdl_tpu_torch.obs import metrics as obs_metrics

        port = self.port
        wire = self.wire

        def collector(sink):
            snap = wire.snapshot()
            sink.counter("edl_wire_bytes_sent_total", snap.get("bytes_sent", 0),
                         side="server", port=port)
            sink.counter("edl_wire_bytes_received_total", snap.get("bytes_received", 0),
                         side="server", port=port)
            sink.counter("edl_wire_calls_total", snap.get("calls", 0), side="server", port=port)

        obs_metrics.get_registry().register_collector(collector)
        self._collector = collector
        obs_metrics.maybe_serve_from_env()

    def wire_stats(self) -> dict:
        """Per-method and per-tier payload bytes and calls
        (`policy.WireStats`)."""
        return self.wire.snapshot()

    def stats(self) -> dict:
        """Per method: calls, handler seconds and codec seconds."""
        return self._dispatcher.stats()

    def stop(self):
        if self._collector is not None:
            from elasticdl_tpu_torch.obs import metrics as obs_metrics

            obs_metrics.get_registry().unregister_collector(self._collector)
            self._collector = None
        transport_mod.unregister_inproc(self.port)
        if self._uds is not None:
            self._uds.close()
        if self._shm is not None:
            self._shm.close()
        self._tcp.close()

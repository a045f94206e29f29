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
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from elasticdl_tpu_torch.common.log_util import get_logger
from elasticdl_tpu_torch.rpc import transport as transport_mod

logger = get_logger(__name__)


class RpcServer:
    def __init__(
        self,
        handlers: Dict[str, Callable],
        port: int = 0,
        shm_scope: Optional[str] = None,
        shm_generation: int = 0,
    ):
        self._dispatcher = transport_mod.ServerDispatcher(handlers)
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

    def stats(self) -> dict:
        """Per method: calls, handler seconds and codec seconds."""
        return self._dispatcher.stats()

    def stop(self):
        transport_mod.unregister_inproc(self.port)
        if self._uds is not None:
            self._uds.close()
        if self._shm is not None:
            self._shm.close()
        self._tcp.close()

"""The RPC server: `{method: fn(request dict) -> response dict}` over TCP.

The reference's `RpcServer` (`elasticdl_tpu/rpc/server.py`) serves a
handler table over gRPC; the port serves it over the TCP tier of
`rpc/transport.py`, one thread per connection.
"""

from __future__ import annotations

from typing import Callable, Dict

from elasticdl_tpu_torch.rpc.transport import ServerDispatcher, TcpServer


class RpcServer:
    def __init__(self, handlers: Dict[str, Callable], port: int = 0):
        self._dispatcher = ServerDispatcher(handlers)
        self._tcp = TcpServer(port, self._dispatcher)
        self.port = self._tcp.port

    def start(self):
        self._tcp.start()

    def stats(self) -> dict:
        """Per method: calls, handler seconds and codec seconds."""
        return self._dispatcher.stats()

    def stop(self):
        self._tcp.close()

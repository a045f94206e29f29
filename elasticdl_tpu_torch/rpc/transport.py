"""The RPC plane's one transport: length-prefixed codec frames over TCP.

The reference serves every method over gRPC and adds Unix-socket,
shared-memory and in-process fast paths (`elasticdl_tpu/rpc/
transport.py`). The port carries the framing of its Unix-socket tier
over TCP instead (`AF_INET`, `TCP_NODELAY` on both ends): TCP stands in
for the reference's default gRPC tier, because workers address the
master as `host:port`, and the stdlib `socket` module needs no package
that the card's machine may lack.

    request   u16 method length, u32 body length   (struct "<HI")
              method utf-8, body = one codec frame
    ok        u8 status 0, u32 body length         (struct "<BI")
              body = one codec frame
    error     u8 status 1, i32 status-code value,  (struct "<BiH")
              u16 detail length, detail utf-8

The server listens on the loopback interface only: the process backend,
the one backend ported, runs every worker on the master's host. It
authenticates nothing, so a body longer than `MAX_FRAME_BYTES` (the
reference's gRPC message limit) is refused from its header and method
name, before a buffer for it is allocated: the server answers
INVALID_ARGUMENT and closes the connection, whose unread body would
desynchronize the next frame.

A connection carries sequential request/response frames; clients pool
connections. The receiver reads each body into one `bytearray` and hands
it to the codec, which builds its arrays as views over it: a 134 MB
gradient is copied once, by the kernel, into that buffer.

`ServerDispatcher` is the server core: an unknown method answers
UNIMPLEMENTED, a handler's `PolicyRpcError` keeps its code, and any
other exception of the handler, or of decoding its request or encoding
its response, answers INTERNAL with a one-line summary.

Not ported yet: the shared-memory, Unix-socket and in-process tiers, the
event-loop dispatch core, chaos hooks and fencing.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from collections import Counter
from typing import Callable, Dict, Optional

from elasticdl_tpu_torch.common import messages
from elasticdl_tpu_torch.common.log_util import get_logger
from elasticdl_tpu_torch.rpc.policy import PolicyRpcError, StatusCode

logger = get_logger(__name__)

_REQ_HEADER = struct.Struct("<HI")
_RESP_OK = struct.Struct("<BI")
_RESP_ERR = struct.Struct("<BiH")
# the reference's gRPC send and receive limit, about 8x the 134 MB
# gradient of the base transformer
MAX_FRAME_BYTES = 1024 * 1024 * 1024
LISTEN_HOST = "127.0.0.1"

_CODE_BY_VALUE = {c.value: c for c in StatusCode}


def _sanitized_detail(e: BaseException) -> str:
    return f"{type(e).__name__}: {e}".replace("\n", " ")[:256]


def _check_frame(n: int, what: str):
    if n > MAX_FRAME_BYTES:
        raise PolicyRpcError(
            StatusCode.INVALID_ARGUMENT,
            f"{what} frame of {n} bytes exceeds the limit of {MAX_FRAME_BYTES}",
        )


def _error_frame(e: PolicyRpcError) -> bytes:
    detail = e.details().encode("utf-8")[:1024]
    return _RESP_ERR.pack(1, e.code().value, len(detail)) + detail


def _recv_exact(conn: socket.socket, n: int, *, eof_ok: bool = False):
    """Exactly n bytes as a bytearray; None on a clean EOF at a frame
    boundary (eof_ok), ConnectionError on EOF mid-frame."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = conn.recv_into(view[got:], n - got)
        if k == 0:
            if eof_ok and got == 0:
                return None
            raise ConnectionError(f"peer closed mid-frame ({got}/{n} bytes)")
        got += k
    return buf


class ServerDispatcher:
    """Decode, run the handler, encode. `stats()` splits each method's
    server time between the handler and the codec (unpack + pack), as
    `testing.InProcessMaster` does in one process."""

    def __init__(self, handlers: Dict[str, Callable]):
        self._handlers = dict(handlers)
        self._lock = threading.Lock()
        self._calls: Counter = Counter()
        self._handler_seconds: Counter = Counter()
        self._codec_seconds: Counter = Counter()

    def dispatch(self, method: str, request_bytes) -> bytes:
        fn = self._handlers.get(method)
        if fn is None:
            raise PolicyRpcError(StatusCode.UNIMPLEMENTED, f"no handler for {method}")
        t0 = time.perf_counter()
        try:
            req = messages.unpack(request_bytes)
            t1 = time.perf_counter()
            resp = fn(req)
            t2 = time.perf_counter()
            out = messages.pack(resp)
        except PolicyRpcError:
            raise
        except Exception as e:
            logger.exception("RPC handler %s failed", method)
            raise PolicyRpcError(StatusCode.INTERNAL, _sanitized_detail(e))
        t3 = time.perf_counter()
        with self._lock:
            self._calls[method] += 1
            self._handler_seconds[method] += t2 - t1
            self._codec_seconds[method] += (t1 - t0) + (t3 - t2)
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "calls": dict(self._calls),
                "handler_seconds": dict(self._handler_seconds),
                "codec_seconds": dict(self._codec_seconds),
            }


class TcpServer:
    """Threaded TCP listener: one thread per connection, each serving
    sequential frames. Binds in __init__, so `port` is known before
    `start`."""

    def __init__(self, port: int, dispatcher: ServerDispatcher):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._sock.bind((LISTEN_HOST, port))
            self._sock.listen(128)
        except OSError:
            self._sock.close()
            raise
        self.port = self._sock.getsockname()[1]
        self._dispatcher = dispatcher
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        # live connections, severed on close(): a stopped server answers
        # nothing more
        self._conns: set = set()
        self._conns_lock = threading.Lock()

    def start(self):
        self._thread = threading.Thread(
            target=self._accept_loop, name=f"tcp-accept-{self.port}", daemon=True
        )
        self._thread.start()

    def _is_closed(self) -> bool:
        with self._conns_lock:
            return self._closed

    def _accept_loop(self):
        while not self._is_closed():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # closed
            threading.Thread(target=self._serve_conn, args=(conn,), daemon=True).start()

    def _serve_conn(self, conn: socket.socket):
        with self._conns_lock:
            if self._closed:
                conn.close()
                return
            self._conns.add(conn)
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while not self._is_closed():
                header = _recv_exact(conn, _REQ_HEADER.size, eof_ok=True)
                if header is None:
                    return
                mlen, blen = _REQ_HEADER.unpack(header)
                method = _recv_exact(conn, mlen).decode("utf-8")
                try:
                    _check_frame(blen, "request")
                except PolicyRpcError as e:
                    conn.sendall(_error_frame(e))
                    return
                body = _recv_exact(conn, blen)
                try:
                    resp = self._dispatcher.dispatch(method, body)
                    _check_frame(len(resp), "response")
                except PolicyRpcError as e:
                    conn.sendall(_error_frame(e))
                    continue
                conn.sendall(_RESP_OK.pack(0, len(resp)))
                conn.sendall(resp)
        except OSError:
            pass  # the client went away; a connection holds no state
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            conn.close()

    def close(self):
        with self._conns_lock:
            self._closed = True
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        try:
            # wakes the thread blocked in accept(); close() alone does not
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        if self._thread is not None:
            self._thread.join(timeout=5)


class TcpTransport:
    """Client side: a pool of persistent connections, a per-call socket
    timeout from the remaining deadline budget, and PolicyRpcError for
    every failure: a timeout is DEADLINE_EXCEEDED, a connection failure
    UNAVAILABLE (both retryable), and an error frame carries the
    server's code."""

    def __init__(self, host: str, port: int):
        self._host = host
        self._port = port
        self._pool: list = []
        self._pool_lock = threading.Lock()

    def _checkout(self, timeout: float) -> socket.socket:
        with self._pool_lock:
            if self._pool:
                return self._pool.pop()
        conn = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            conn.settimeout(max(0.001, float(timeout)))
            conn.connect((self._host, self._port))
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError as e:
            conn.close()
            raise PolicyRpcError(
                StatusCode.UNAVAILABLE, f"tcp connect {self._host}:{self._port}: {e}"
            )
        return conn

    def _checkin(self, conn: socket.socket):
        with self._pool_lock:
            if len(self._pool) < 8:
                self._pool.append(conn)
                return
        conn.close()

    def probe(self, timeout: float):
        """Open (and pool) one connection; raises UNAVAILABLE when no
        listener answers."""
        self._checkin(self._checkout(timeout))

    def close(self):
        with self._pool_lock:
            while self._pool:
                self._pool.pop().close()

    def call(self, method: str, payload: bytes, timeout: float) -> bytearray:
        _check_frame(len(payload), "request")
        conn = self._checkout(timeout)
        try:
            conn.settimeout(max(0.001, float(timeout)))
            mb = method.encode("utf-8")
            conn.sendall(_REQ_HEADER.pack(len(mb), len(payload)) + mb)
            conn.sendall(payload)
            status = _recv_exact(conn, 1)[0]
            if status == 0:
                (blen,) = struct.unpack("<I", _recv_exact(conn, 4))
                if blen > MAX_FRAME_BYTES:
                    conn.close()
                    conn = None
                    _check_frame(blen, "response")
                body = _recv_exact(conn, blen)
            else:
                code_val, dlen = struct.unpack("<iH", _recv_exact(conn, 6))
                detail = _recv_exact(conn, dlen).decode("utf-8", "replace")
                self._checkin(conn)
                conn = None
                raise PolicyRpcError(
                    _CODE_BY_VALUE.get(code_val, StatusCode.UNKNOWN), detail
                )
        except TimeoutError:
            conn.close()
            conn = None
            raise PolicyRpcError(
                StatusCode.DEADLINE_EXCEEDED,
                f"tcp call {method} timed out after {timeout:.3f}s",
            )
        except (OSError, struct.error) as e:
            conn.close()
            conn = None
            raise PolicyRpcError(
                StatusCode.UNAVAILABLE, f"tcp {self._host}:{self._port}: {e}"
            )
        finally:
            if conn is not None:
                self._checkin(conn)
        return body

"""The RPC plane's transport tiers: tcp / uds / shm / inproc.

The reference serves every method over gRPC and adds Unix-socket,
shared-memory and in-process fast paths (`elasticdl_tpu/rpc/
transport.py`). The port's default tier is TCP in place of gRPC: the
framing of the reference's Unix-socket tier over `AF_INET`
(`TCP_NODELAY` on both ends), because workers address the master as
`host:port` and the stdlib `socket` module needs no package that the
card's machine may lack. **`EDL_TRANSPORT=grpc` (the default) selects
the TCP tier here.** The other tiers are the reference's:

- **uds**: the same frames over an `AF_UNIX` socket;
- **shm**: one shared-memory segment per connection (request region
  `[0, ring)`, response region `[ring, 2*ring)`); a Unix-socket doorbell
  carries only the wakeup, the method and the frame length, and the
  server hands the dispatcher a view over the mapped request region, so
  a request's bytes never cross a socket. A frame larger than the ring
  goes through it in ring-sized chunks, each acknowledged. A port-keyed
  JSON rendezvous file (generation, segment prefix, doorbell, ring,
  pid) next to the doorbell says the tier is up; a server sweeps a dead
  predecessor's segments and files on its port at boot, and unlinks a
  connection's segment when its doorbell reads EOF (a SIGKILLed client
  never closes it);
- **inproc**: a server in the same interpreter is called directly.

Framing of the tcp and uds tiers:

    request   u16 method length, u32 body length   (struct "<HI")
              method utf-8, body = one codec frame
    ok        u8 status 0, u32 body length         (struct "<BI")
              body = one codec frame
    error     u8 status 1, i32 status-code value,  (struct "<BiH")
              u16 detail length, detail utf-8

Every tier refuses a frame longer than `MAX_FRAME_BYTES` (the
reference's gRPC message limit) with INVALID_ARGUMENT: the client before
sending it, a server from its header, before a buffer for it is
allocated (the tcp and uds servers then close the connection, whose
unread body would desynchronize the next frame).

The TCP server listens on the loopback interface only: the process
backend, the one backend ported, runs every worker on the master's
host. Connections carry sequential request/response frames; clients
pool connections, so concurrent callers (window mode's sync threads)
each get their own. The receivers read each body into one `bytearray`
(the shm client copies the response region out into one) and hand it to
the codec, which builds its arrays as views over it.

Selection (`select_transport`) never raises: a fast tier is used only
when the endpoint's host is local and its counterpart is reachable (a
registered in-process dispatcher, a rendezvous file with its doorbell,
a socket file); otherwise the caller uses TCP. `auto` prefers inproc >
shm > uds > tcp. The port's socket, rendezvous and segment names start
with "edlt" (`edlt-uds-<port>.sock`, `edlt-shm-<port>.{sock,json}`,
`edltshm.<scope>.g<generation>.<pid>.`), so that they never collide
with the reference's on one host. A server's scope is `p<port>` unless
its owner names one: a PS or KV shard slot's scope stays the same
across its relaunches, and the relaunch, at the next fencing
generation and on a new port, sweeps its SIGKILLed predecessor's
segments and files (any of its scope at an older generation).

`ServerDispatcher` is the core every tier's server runs: an unknown
method answers UNIMPLEMENTED, a handler's `PolicyRpcError` keeps its
code, an `EpochFencedError` (`rpc/fencing.py`) answers
FAILED_PRECONDITION with the exception's name in its details (never
re-sent), and any other exception of the handler, or of decoding its
request or encoding its response, answers INTERNAL with a one-line
summary. A
handler must not keep a view of its request past its return: over shm
the next request on the connection overwrites it.

The dispatcher pops the trace envelope from every request on every
tier, runs the handler under the sender's trace when both ends trace,
and counts each call's payload bytes in its server's `WireStats`
(`ServerDispatcher`).

Chaos (`rpc/chaos.py`) runs on every tier and on both sides, with one
`FaultPlan` per client or server: every client transport runs the
client half around its call, and `ServerDispatcher` runs the server
half around the handler, whichever tier delivered the frame. The port
has no gRPC interceptors, so its TCP tier takes the same two halves as
the reference's non-gRPC tiers. A drop runs the call to completion (the
server applies it) before the response is withheld.

Not ported yet: the shm tier's broadcast segments (`ShmBroadcaster`,
the sharded PS's pull), `AsyncUdsServer` and the event-loop dispatch
core (`EDL_DISPATCH=loop`).
"""

from __future__ import annotations

import json
import os
import socket
import struct
import tempfile
import threading
import time
from collections import Counter
from multiprocessing import shared_memory as _shm_mod
from typing import Callable, Dict, Optional

from elasticdl_tpu_torch.common import messages
from elasticdl_tpu_torch.common.constants import (
    ENV_TRANSPORT,
    ENV_TRANSPORT_SHM_DOORBELL_TIMEOUT,
    ENV_TRANSPORT_SHM_RING,
    ENV_UDS_DIR,
)
from elasticdl_tpu_torch.common.log_util import get_logger
from elasticdl_tpu_torch.obs import trace as obs_trace
from elasticdl_tpu_torch.rpc.chaos import transport_faults_after, transport_faults_before
from elasticdl_tpu_torch.rpc.fencing import EpochFencedError
from elasticdl_tpu_torch.rpc.policy import PolicyRpcError, StatusCode, WireStats

logger = get_logger(__name__)

# the reference's tier names; "grpc" is the TCP tier here
TRANSPORT_GRPC = "grpc"
TRANSPORT_UDS = "uds"
TRANSPORT_SHM = "shm"
TRANSPORT_INPROC = "inproc"
TRANSPORT_TIERS = (TRANSPORT_GRPC, TRANSPORT_UDS, TRANSPORT_SHM, TRANSPORT_INPROC)

_LOCAL_HOSTS = frozenset({"localhost", "127.0.0.1", "[::1]", "::1", "0.0.0.0", "[::]", ""})

# the port's file and segment name prefixes (never the reference's
# "edl-uds-", "edl-shm-" and "edlshm.")
UDS_PREFIX = "edlt-uds-"
SHM_FILE_PREFIX = "edlt-shm-"
SHM_SEGMENT_PREFIX = "edltshm."

_REQ_HEADER = struct.Struct("<HI")
_RESP_OK = struct.Struct("<BI")
_RESP_ERR = struct.Struct("<BiH")
# shm hello (server -> client on accept): u32 generation, u32 segment-name
# length, u64 ring bytes a direction; then the segment name utf-8
_SHM_HELLO = struct.Struct("<IIQ")
# shm request doorbell: kind (1: the whole frame is in the request
# region, 2: chunks follow), u16 method length, u32 frame length (the
# total for kind 2); then the method utf-8
_SHM_REQ = struct.Struct("<BHI")
# shm response doorbell: status (0: the frame is in the response region,
# 1: error, 2: chunks follow), u32 length
_SHM_RESP = struct.Struct("<BI")
# chunk header (either direction): u32 chunk length; the receiver acks
# each chunk with one byte before the region is written again
_SHM_CHUNK = struct.Struct("<I")
# after a status-1 doorbell: i32 status-code value, u16 detail length;
# then the detail utf-8
_SHM_ERR = struct.Struct("<iH")
_SHM_ACK = b"\x06"
# the reference's gRPC send and receive limit, about 8x the 134 MB
# gradient of the base transformer
MAX_FRAME_BYTES = 1024 * 1024 * 1024
LISTEN_HOST = "127.0.0.1"

_CODE_BY_VALUE = {c.value: c for c in StatusCode}


# -- selection and rendezvous (the reference's, never raising) --------------


def transport_mode(env=None) -> str:
    """The configured tier ("grpc" = tcp, "uds", "shm", "inproc" or
    "auto"); an unknown value logs and means grpc."""
    env = os.environ if env is None else env
    mode = (env.get(ENV_TRANSPORT, "") or TRANSPORT_GRPC).strip().lower()
    if mode not in TRANSPORT_TIERS and mode != "auto":
        logger.warning("unknown %s=%r; using grpc (tcp)", ENV_TRANSPORT, mode)
        return TRANSPORT_GRPC
    return mode


def server_fast_paths_enabled() -> bool:
    """Whether RpcServer opens the uds listener (the inproc registry is
    always filled: a dict entry, not a socket)."""
    return transport_mode() in (TRANSPORT_UDS, "auto")


def server_shm_enabled() -> bool:
    """Whether RpcServer opens the shared-memory listener."""
    return transport_mode() in (TRANSPORT_SHM, "auto")


def uds_dir(env=None) -> str:
    env = os.environ if env is None else env
    return env.get(ENV_UDS_DIR) or tempfile.gettempdir()


def uds_path_for(port: int) -> str:
    """The socket a server on TCP `port` also serves: the port number is
    the rendezvous, so a client derives the path from its endpoint."""
    return os.path.join(uds_dir(), f"{UDS_PREFIX}{int(port)}.sock")


_SHM_DEFAULT_RING = 1 << 22  # 4 MiB a direction


def shm_ring_bytes(env=None) -> int:
    """Ring bytes a direction for each shm connection, at least 4096 and
    rounded up to the codec's 64-byte segment alignment."""
    env = os.environ if env is None else env
    try:
        n = int(env.get(ENV_TRANSPORT_SHM_RING, "") or _SHM_DEFAULT_RING)
    except ValueError:
        n = _SHM_DEFAULT_RING
    n = max(n, 4096)
    return (n + 63) // 64 * 64


def shm_doorbell_timeout(env=None) -> float:
    """Socket timeout of the shm hello and chunk acks (a call's deadline
    still comes from the caller's budget)."""
    env = os.environ if env is None else env
    try:
        t = float(env.get(ENV_TRANSPORT_SHM_DOORBELL_TIMEOUT, "") or 5.0)
    except ValueError:
        t = 5.0
    return max(t, 0.001)


def shm_doorbell_path(port: int) -> str:
    return os.path.join(uds_dir(), f"{SHM_FILE_PREFIX}{int(port)}.sock")


def shm_rendezvous_path(port: int) -> str:
    """Rendezvous JSON of a server on TCP `port`, written atomically
    after its doorbell listens: its existence says the tier is up."""
    return os.path.join(uds_dir(), f"{SHM_FILE_PREFIX}{int(port)}.json")


def read_shm_rendezvous(port: int) -> Optional[dict]:
    try:
        with open(shm_rendezvous_path(port), "r", encoding="utf-8") as f:
            info = json.load(f)
    except (OSError, ValueError):
        return None
    return info if isinstance(info, dict) else None


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
    `testing.InProcessMaster` does in one process.

    Every tier's server hands its frames here with its tier's name
    (`transport`), so the observability plane sees every request once:
    the trace envelope (`obs/trace.ENVELOPE_KEY`) is popped from every
    dict request before the handler sees it, whether or not this
    process traces; when the sender sampled the request and this
    process traces, the handler runs under an `rpc.server.<method>`
    span, the child of the sender's, bound as the thread's context so
    the handler's own spans chain under it. `wire`, a
    `policy.WireStats`, counts the payload bytes of each request and
    response (none for inproc, which moves no bytes) and each call.

    `fault_plan` (`rpc/chaos.FaultPlan`) runs the server half of chaos
    around the handler on every tier: an error answers before the
    handler runs, a drop or crash after fires with the handler's state
    applied."""

    def __init__(self, handlers: Dict[str, Callable], wire: Optional[WireStats] = None,
                 fault_plan=None):
        self._handlers = dict(handlers)
        self._wire = wire
        self._plan = fault_plan
        self._lock = threading.Lock()
        self._calls: Counter = Counter()
        self._handler_seconds: Counter = Counter()
        self._codec_seconds: Counter = Counter()

    def dispatch(self, method: str, request_bytes, transport: str = "tcp") -> bytes:
        after = transport_faults_before(self._plan, method, "server")
        resp = self._invoke(method, request_bytes, transport)
        # a drop or crash after fires with the handler APPLIED: state
        # changed, response withheld
        transport_faults_after(after, method)
        return resp

    def _invoke(self, method: str, request_bytes, transport: str) -> bytes:
        fn = self._handlers.get(method)
        if fn is None:
            raise PolicyRpcError(StatusCode.UNIMPLEMENTED, f"no handler for {method}")
        inproc = transport == TRANSPORT_INPROC
        t0 = time.perf_counter()
        failure = None
        sp = None
        try:
            req = messages.unpack(request_bytes)
            # always popped: a handler never sees the envelope; a context
            # exists only when the sender sampled the request and this
            # process traces
            tctx = obs_trace.extract(req)
            if tctx is not None:
                sp = obs_trace.start_span(f"rpc.server.{method}", cat="rpc", parent=tctx,
                                          args={"transport": transport})
            prev_ctx = obs_trace.bind(sp.ctx) if sp is not None else None
            t1 = time.perf_counter()
            try:
                resp = fn(req)
            finally:
                if sp is not None:
                    obs_trace.bind(prev_ctx)
                    sp.end()
            t2 = time.perf_counter()
            out = messages.pack(resp)
        except PolicyRpcError:
            raise
        except EpochFencedError as e:
            # a protocol answer, not a bug: FAILED_PRECONDITION is never
            # re-sent, so the client re-resolves (rpc/fencing.py)
            logger.warning("RPC %s fenced: %s", method, e)
            failure = (StatusCode.FAILED_PRECONDITION, _sanitized_detail(e))
        except Exception as e:
            logger.exception("RPC handler %s failed", method)
            failure = (StatusCode.INTERNAL, _sanitized_detail(e))
        if failure is not None:
            # raised outside the except block: this frame (and the request
            # views it holds) is not kept alive by a traceback cycle
            raise PolicyRpcError(*failure)
        t3 = time.perf_counter()
        with self._lock:
            self._calls[method] += 1
            self._handler_seconds[method] += t2 - t1
            self._codec_seconds[method] += (t1 - t0) + (t3 - t2)
        if self._wire is not None:
            self._wire.record(method, sent=0 if inproc else len(out),
                              received=0 if inproc else len(request_bytes),
                              transport=transport, calls=1)
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "calls": dict(self._calls),
                "handler_seconds": dict(self._handler_seconds),
                "codec_seconds": dict(self._codec_seconds),
            }


class _FrameServer:
    """Threaded stream listener over a bound, listening socket: one
    thread per connection, each serving sequential frames. The tcp and
    uds tiers differ only in the socket (and `_tier`, the name the
    dispatcher records)."""

    _tier = "tcp"

    def __init__(self, sock: socket.socket, dispatcher: ServerDispatcher, name: str):
        self._sock = sock
        self._dispatcher = dispatcher
        self._name = name
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        # live connections, severed on close(): a stopped server answers
        # nothing more
        self._conns: set = set()
        self._conns_lock = threading.Lock()

    def start(self):
        self._thread = threading.Thread(
            target=self._accept_loop, name=f"{self._name}-accept", daemon=True
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

    def _setup_conn(self, conn: socket.socket):
        pass

    def _serve_conn(self, conn: socket.socket):
        with self._conns_lock:
            if self._closed:
                conn.close()
                return
            self._conns.add(conn)
        try:
            self._setup_conn(conn)
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
                    resp = self._dispatcher.dispatch(method, body, self._tier)
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
        _wake_accept(self._sock)
        try:
            # wakes the thread blocked in accept(); close() alone does not
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        if self._thread is not None:
            self._thread.join(timeout=5)


def _wake_accept(sock: socket.socket):
    """Connect to a listener once, so that a thread blocked in its
    accept() returns and sees the server closed: on some kernels (the
    card machine's) shutdown() of a listening AF_UNIX socket does not wake
    it, and the accept thread's join would wait out its timeout."""
    try:
        address = sock.getsockname()
        with socket.socket(sock.family, socket.SOCK_STREAM) as s:
            s.settimeout(1.0)
            s.connect(address)
    except OSError:
        pass


def _listening(family: int, address, reuse: bool = False) -> socket.socket:
    sock = socket.socket(family, socket.SOCK_STREAM)
    try:
        if reuse:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind(address)
        sock.listen(128)
    except OSError:
        # a half-built listener has no owner to close it
        sock.close()
        raise
    return sock


class TcpServer(_FrameServer):
    """The default tier's listener on the loopback interface. Binds in
    __init__, so `port` is known before `start`."""

    def __init__(self, port: int, dispatcher: ServerDispatcher):
        sock = _listening(socket.AF_INET, (LISTEN_HOST, port), reuse=True)
        self.port = sock.getsockname()[1]
        super().__init__(sock, dispatcher, f"tcp-{self.port}")

    def _setup_conn(self, conn: socket.socket):
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


class UdsServer(_FrameServer):
    """The uds tier's listener at `uds_path_for(port)`, sharing an
    RpcServer's dispatcher. Raises OSError from __init__ when the path
    is unusable (the caller logs and serves TCP only)."""

    _tier = TRANSPORT_UDS

    def __init__(self, port: int, dispatcher: ServerDispatcher):
        self.path = uds_path_for(port)
        _unlink(self.path)
        super().__init__(_listening(socket.AF_UNIX, self.path), dispatcher, f"uds-{port}")

    def close(self):
        super().close()
        _unlink(self.path)


def _unlink(path: str):
    try:
        os.unlink(path)
    except OSError:
        pass


def _raise_error_reply(conn: socket.socket):
    """After a status-1 byte: read the error tail and raise its code."""
    code_val, dlen = struct.unpack("<iH", _recv_exact(conn, 6))
    detail = _recv_exact(conn, dlen).decode("utf-8", "replace")
    raise PolicyRpcError(_CODE_BY_VALUE.get(code_val, StatusCode.UNKNOWN), detail)


class _FrameTransport:
    """Client side of the tcp and uds tiers: a pool of persistent
    connections, a per-call socket timeout from the remaining deadline
    budget, and PolicyRpcError for every failure: a timeout is
    DEADLINE_EXCEEDED, a connection failure UNAVAILABLE (both
    retryable), and an error frame carries the server's code.
    `fault_plan` runs the client half of chaos around each call."""

    name = ""

    def __init__(self, where: str, fault_plan=None):
        self._where = where
        self._plan = fault_plan
        self._pool: list = []
        self._pool_lock = threading.Lock()

    def _connect(self, timeout: float) -> socket.socket:
        raise NotImplementedError

    def _checkout(self, timeout: float) -> socket.socket:
        with self._pool_lock:
            if self._pool:
                return self._pool.pop()
        try:
            return self._connect(max(0.001, float(timeout)))
        except OSError as e:
            raise PolicyRpcError(
                StatusCode.UNAVAILABLE, f"{self.name} connect {self._where}: {e}"
            )

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
        after = transport_faults_before(self._plan, method, "client")
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
                try:
                    _raise_error_reply(conn)
                except PolicyRpcError:
                    self._checkin(conn)
                    conn = None
                    raise
        except TimeoutError:
            conn.close()
            conn = None
            raise PolicyRpcError(
                StatusCode.DEADLINE_EXCEEDED,
                f"{self.name} call {method} timed out after {timeout:.3f}s",
            )
        except (OSError, struct.error) as e:
            conn.close()
            conn = None
            raise PolicyRpcError(StatusCode.UNAVAILABLE, f"{self.name} {self._where}: {e}")
        finally:
            if conn is not None:
                self._checkin(conn)
        transport_faults_after(after, method)
        return body


class TcpTransport(_FrameTransport):
    """The default tier's client."""

    name = "tcp"

    def __init__(self, host: str, port: int, fault_plan=None):
        super().__init__(f"{host}:{port}", fault_plan)
        self._addr = (host, port)

    def _connect(self, timeout: float) -> socket.socket:
        conn = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            conn.settimeout(timeout)
            conn.connect(self._addr)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            conn.close()
            raise
        return conn


class UdsTransport(_FrameTransport):
    """The uds tier's client."""

    name = TRANSPORT_UDS

    def __init__(self, path: str, fault_plan=None):
        super().__init__(path, fault_plan)
        self._path = path

    def _connect(self, timeout: float) -> socket.socket:
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            conn.settimeout(timeout)
            conn.connect(self._path)
        except OSError:
            conn.close()
            raise
        return conn


# -- inproc: the same interpreter's servers, keyed by their TCP port -------

_inproc_lock = threading.Lock()
_inproc_registry: Dict[int, ServerDispatcher] = {}


def register_inproc(port: int, dispatcher: ServerDispatcher) -> None:
    with _inproc_lock:
        _inproc_registry[int(port)] = dispatcher


def unregister_inproc(port: int) -> None:
    with _inproc_lock:
        _inproc_registry.pop(int(port), None)


def inproc_dispatcher(port: int) -> Optional[ServerDispatcher]:
    with _inproc_lock:
        return _inproc_registry.get(int(port))


class InprocTransport:
    """Direct dispatch into a same-interpreter RpcServer: the packed
    frame crosses by reference. The dispatcher is looked up on each
    call, so a stopped server answers UNAVAILABLE. `fault_plan` runs the
    client half of chaos around each call."""

    name = TRANSPORT_INPROC

    def __init__(self, port: int, fault_plan=None):
        self._port = int(port)
        self._plan = fault_plan

    def _dispatcher(self) -> ServerDispatcher:
        dispatcher = inproc_dispatcher(self._port)
        if dispatcher is None:
            raise PolicyRpcError(
                StatusCode.UNAVAILABLE, f"inproc server for port {self._port} is gone"
            )
        return dispatcher

    def probe(self, timeout: float):
        self._dispatcher()

    def close(self):
        pass

    def call(self, method: str, payload: bytes, timeout: float) -> bytes:
        _check_frame(len(payload), "request")
        after = transport_faults_before(self._plan, method, "client")
        resp = self._dispatcher().dispatch(method, payload, TRANSPORT_INPROC)
        _check_frame(len(resp), "response")
        transport_faults_after(after, method)
        return resp


# -- shm: codec frames through per-connection shared-memory rings ----------


class _QuietSharedMemory(_shm_mod.SharedMemory):
    """SharedMemory whose destructor tolerates views still exported at
    interpreter exit (the kernel drops the mapping either way)."""

    def __del__(self):
        try:
            super().__del__()
        except BufferError:
            pass


_attach_lock = threading.Lock()


def _attach_shm_segment(name: str) -> _shm_mod.SharedMemory:
    """Attach (never create) a server's segment. CPython before 3.13
    registers an attachment with the resource tracker too, which would
    unlink the server's segment when this process exits: the
    registration is suppressed for the attach. The suppression patches
    the module for the whole process, so every create holds the same
    lock (`_create_shm_segment`)."""
    from multiprocessing import resource_tracker

    with _attach_lock:
        orig = resource_tracker.register
        resource_tracker.register = lambda *a, **k: None
        try:
            return _QuietSharedMemory(name=name)
        finally:
            resource_tracker.register = orig


def _create_shm_segment(name: str, size: int) -> _shm_mod.SharedMemory:
    """Create a segment under `_attach_lock`, so a concurrent attach's
    suppression window cannot swallow its tracker registration."""
    with _attach_lock:
        return _QuietSharedMemory(name=name, create=True, size=size)


def _unlink_segments(prefix: str) -> None:
    """Unlink every segment whose name starts with `prefix` (Linux backs
    POSIX shared memory with /dev/shm)."""
    if not prefix:
        return
    try:
        names = os.listdir("/dev/shm")
    except OSError:
        return
    for name in names:
        if name.startswith(prefix):
            _unlink(os.path.join("/dev/shm", name))


def _sanitize_scope(scope: str) -> str:
    return "".join(c if c.isalnum() or c in "._-" else "-" for c in scope)


def _shm_error_frame(e: PolicyRpcError) -> bytes:
    detail = e.details().encode("utf-8")[:1024]
    return _SHM_RESP.pack(1, 0) + _SHM_ERR.pack(e.code().value, len(detail)) + detail


class ShmServer:
    """Threaded shared-memory listener sharing an RpcServer's
    dispatcher. Each accepted doorbell connection gets its own segment
    (request region [0, ring), response region [ring, 2*ring)); a
    request frame that fits the ring reaches the dispatcher as a view
    over the mapping, a larger one is assembled from chunks.

    Boot order: sweep a dead predecessor's segments and files (on this
    port, or of this scope at an older generation), bind the doorbell,
    then publish the rendezvous file, which names this scope and
    generation, atomically. Raises OSError from __init__ when the
    doorbell path is unusable (the caller logs and serves TCP only)."""

    def __init__(self, port: int, dispatcher: ServerDispatcher,
                 scope: Optional[str] = None, generation: int = 0):
        self.port = int(port)
        self._dispatcher = dispatcher
        self.generation = int(generation)
        self._scope = _sanitize_scope(scope) if scope else f"p{self.port}"
        self._ring = shm_ring_bytes()
        # the pid keeps two live servers' names apart on one host
        self._prefix = (
            f"{SHM_SEGMENT_PREFIX}{self._scope}.g{self.generation}.{os.getpid()}."
        )
        self._reclaim_stale()
        self.doorbell = shm_doorbell_path(self.port)
        self.path = shm_rendezvous_path(self.port)
        _unlink(self.doorbell)
        self._sock = _listening(socket.AF_UNIX, self.doorbell)
        self._conn_seq = 0
        self._thread: Optional[threading.Thread] = None
        # live connections, severed on close()
        self._conns: set = set()
        self._conn_threads: list = []
        self._conns_lock = threading.Lock()
        self._closed = False
        try:
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"scope": self._scope, "generation": self.generation,
                           "prefix": self._prefix,
                           "doorbell": self.doorbell, "ring": self._ring,
                           "pid": os.getpid()}, f)
            os.replace(tmp, self.path)
        except Exception:
            # a half-built server has no owner to close it
            self._sock.close()
            for leftover in (self.doorbell, self.path + ".tmp"):
                _unlink(leftover)
            raise

    def _reclaim_stale(self) -> None:
        """Sweep a dead predecessor's rings: the rendezvous file keyed by
        this port is stale by construction (the TCP bind proved the port
        free), and so is any segment named for this port or scope (one
        live server a scope). A rendezvous file of this scope on another
        port at an older generation belongs to a SIGKILLed incarnation
        whose relaunch (this server) got a fresh port."""
        mine = read_shm_rendezvous(self.port)
        if mine is not None:
            _unlink_segments(str(mine.get("prefix", "")))
            _unlink(str(mine.get("doorbell", "")))
            _unlink(shm_rendezvous_path(self.port))
        _unlink_segments(f"{SHM_SEGMENT_PREFIX}p{self.port}.")
        _unlink_segments(f"{SHM_SEGMENT_PREFIX}{self._scope}.")
        try:
            names = os.listdir(uds_dir())
        except OSError:
            return
        for name in names:
            if not (name.startswith(SHM_FILE_PREFIX) and name.endswith(".json")):
                continue
            path = os.path.join(uds_dir(), name)
            try:
                with open(path, encoding="utf-8") as f:
                    other = json.load(f)
                other_gen = int(other.get("generation", -1))
            except (OSError, ValueError, TypeError, AttributeError):
                continue
            if other.get("scope") == self._scope and other_gen < self.generation:
                _unlink_segments(str(other.get("prefix", "")))
                _unlink(str(other.get("doorbell", "")))
                _unlink(path)

    def start(self):
        self._thread = threading.Thread(
            target=self._accept_loop, name=f"shm-accept-{self.port}", daemon=True
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
            t = threading.Thread(target=self._serve_conn, args=(conn,), daemon=True)
            with self._conns_lock:
                self._conn_threads = [x for x in self._conn_threads if x.is_alive()]
                self._conn_threads.append(t)
            t.start()

    def _serve_conn(self, conn: socket.socket):
        with self._conns_lock:
            if self._closed:
                conn.close()
                return
            self._conns.add(conn)
            self._conn_seq += 1
            name = f"{self._prefix}c{self._conn_seq}"
        seg = req_region = resp_region = None
        try:
            seg = _create_shm_segment(name, 2 * self._ring)
            mb = name.encode("utf-8")
            conn.sendall(_SHM_HELLO.pack(self.generation, len(mb), self._ring) + mb)
            req_region = memoryview(seg.buf)[: self._ring]
            resp_region = memoryview(seg.buf)[self._ring : 2 * self._ring]
            while not self._is_closed():
                header = _recv_exact(conn, _SHM_REQ.size, eof_ok=True)
                if header is None:
                    return  # the client closed its doorbell, or died
                kind, mlen, length = _SHM_REQ.unpack(header)
                method = _recv_exact(conn, mlen).decode("utf-8")
                try:
                    _check_frame(length, "request")
                except PolicyRpcError as e:
                    # the client would go on with its chunks: answer, close
                    conn.sendall(_shm_error_frame(e))
                    return
                if kind == 1:
                    if length > self._ring:
                        raise ConnectionError(f"shm frame length {length} exceeds the ring")
                    # the dispatcher reads the mapped region itself, which
                    # stays untouched until the response doorbell
                    body = req_region[:length]
                else:
                    body = self._recv_chunked(conn, req_region, length)
                try:
                    resp = self._dispatcher.dispatch(method, body, TRANSPORT_SHM)
                    _check_frame(len(resp), "response")
                except PolicyRpcError as e:
                    conn.sendall(_shm_error_frame(e))
                    continue
                finally:
                    # the region's views must be gone before the segment
                    # closes: the handler's have been, the request's here
                    body = None
                if len(resp) <= self._ring:
                    resp_region[: len(resp)] = resp
                    conn.sendall(_SHM_RESP.pack(0, len(resp)))
                else:
                    self._send_chunked(conn, resp_region, resp)
        except (OSError, struct.error):
            pass  # the client went away; its state is the segment
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            conn.close()
            for region in (req_region, resp_region):
                if region is not None:
                    region.release()
            if seg is not None:
                try:
                    seg.close()
                except BufferError:  # pragma: no cover - a view not yet collected
                    pass
                try:
                    seg.unlink()
                except OSError:
                    pass

    def _recv_chunked(self, conn, region, total: int) -> bytearray:
        """A request larger than the ring, assembled from ring-sized
        chunks (one copy)."""
        out = bytearray(total)
        got = 0
        conn.settimeout(shm_doorbell_timeout())
        try:
            while got < total:
                (clen,) = _SHM_CHUNK.unpack(_recv_exact(conn, _SHM_CHUNK.size))
                if clen > len(region) or got + clen > total:
                    raise ConnectionError(f"shm chunk overrun ({clen} bytes)")
                out[got : got + clen] = region[:clen]
                got += clen
                conn.sendall(_SHM_ACK)  # the client may write the region again
        finally:
            conn.settimeout(None)
        return out

    def _send_chunked(self, conn, region, resp: bytes) -> None:
        total = len(resp)
        conn.sendall(_SHM_RESP.pack(2, total))
        rv = memoryview(resp)
        sent = 0
        conn.settimeout(shm_doorbell_timeout())
        try:
            while sent < total:
                clen = min(self._ring, total - sent)
                region[:clen] = rv[sent : sent + clen]
                conn.sendall(_SHM_CHUNK.pack(clen))
                _recv_exact(conn, 1)  # the client copied the chunk out
                sent += clen
        finally:
            conn.settimeout(None)

    def close(self):
        with self._conns_lock:
            self._closed = True
            conns = list(self._conns)
            threads = list(self._conn_threads)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        _wake_accept(self._sock)
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        # each connection thread unlinks its segment; close() returning
        # means /dev/shm is clean (the prefix sweep backs up a thread that
        # outlives its join)
        for t in threads:
            t.join(timeout=5)
        if self._thread is not None:
            self._thread.join(timeout=5)
        _unlink_segments(self._prefix)
        _unlink(self.doorbell)
        _unlink(self.path)


class _ShmConn:
    """One client connection: the doorbell socket and the mapped regions
    of its segment. Destroyed, never pooled, after any protocol error."""

    __slots__ = ("sock", "seg", "ring", "generation", "req", "resp")

    def __init__(self, doorbell: str):
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            sock.settimeout(shm_doorbell_timeout())
            sock.connect(doorbell)
            gen, nlen, ring = _SHM_HELLO.unpack(_recv_exact(sock, _SHM_HELLO.size))
            seg = _attach_shm_segment(_recv_exact(sock, nlen).decode("utf-8"))
        except (OSError, struct.error) as e:
            sock.close()
            raise PolicyRpcError(StatusCode.UNAVAILABLE, f"shm connect {doorbell}: {e}")
        self.sock = sock
        self.seg = seg
        self.ring = int(ring)
        self.generation = int(gen)
        self.req = memoryview(seg.buf)[: self.ring]
        self.resp = memoryview(seg.buf)[self.ring : 2 * self.ring]

    def destroy(self):
        self.sock.close()
        self.req.release()
        self.resp.release()
        try:
            self.seg.close()
        except BufferError:  # pragma: no cover - a caller kept a view
            pass


class ShmTransport:
    """Client side of the shm tier: a pool of persistent connections,
    per-call socket timeouts from the deadline budget, and the other
    tiers' PolicyRpcError codes. A response is copied out of the
    response region into a private buffer before the connection goes
    back to the pool (the next call on it overwrites the region).
    `fault_plan` runs the client half of chaos around each call."""

    name = TRANSPORT_SHM

    def __init__(self, port: int, fault_plan=None):
        self._port = int(port)
        self._plan = fault_plan
        self._doorbell = shm_doorbell_path(port)
        self._pool: list = []
        self._pool_lock = threading.Lock()

    def _checkout(self) -> _ShmConn:
        with self._pool_lock:
            if self._pool:
                return self._pool.pop()
        return _ShmConn(self._doorbell)

    def _checkin(self, conn: _ShmConn):
        with self._pool_lock:
            if len(self._pool) < 8:
                self._pool.append(conn)
                return
        conn.destroy()

    def probe(self, timeout: float):
        self._checkin(self._checkout())

    def close(self):
        with self._pool_lock:
            pool, self._pool = self._pool, []
        for conn in pool:
            conn.destroy()

    def call(self, method: str, payload: bytes, timeout: float) -> bytearray:
        n = len(payload)
        _check_frame(n, "request")
        after = transport_faults_before(self._plan, method, "client")
        conn = self._checkout()
        try:
            conn.sock.settimeout(max(0.001, float(timeout)))
            mb = method.encode("utf-8")
            early = b""  # a server's answer instead of a chunk ack
            if n <= conn.ring:
                conn.req[:n] = payload
                conn.sock.sendall(_SHM_REQ.pack(1, len(mb), n) + mb)
            else:
                conn.sock.sendall(_SHM_REQ.pack(2, len(mb), n) + mb)
                pv = memoryview(payload)
                sent = 0
                while sent < n:
                    clen = min(conn.ring, n - sent)
                    conn.req[:clen] = pv[sent : sent + clen]
                    conn.sock.sendall(_SHM_CHUNK.pack(clen))
                    ack = _recv_exact(conn.sock, 1)
                    if ack != _SHM_ACK:
                        early = bytes(ack)
                        break
                    sent += clen
            head = early + _recv_exact(conn.sock, _SHM_RESP.size - len(early))
            status, length = _SHM_RESP.unpack(head)
            if status in (0, 2) and length > MAX_FRAME_BYTES:
                raise _FrameTooLarge(length)
            if status == 0:
                body = bytearray(conn.resp[:length])
            elif status == 2:
                body = bytearray(length)
                got = 0
                while got < length:
                    (clen,) = _SHM_CHUNK.unpack(_recv_exact(conn.sock, _SHM_CHUNK.size))
                    if clen > conn.ring or got + clen > length:
                        raise ConnectionError(f"shm chunk overrun ({clen} bytes)")
                    body[got : got + clen] = conn.resp[:clen]
                    got += clen
                    conn.sock.sendall(_SHM_ACK)
            else:
                code_val, dlen = _SHM_ERR.unpack(_recv_exact(conn.sock, _SHM_ERR.size))
                detail = _recv_exact(conn.sock, dlen).decode("utf-8", "replace")
                if early:
                    # the server refused the frame mid-transfer and closed
                    conn.destroy()
                else:
                    self._checkin(conn)
                conn = None
                raise PolicyRpcError(_CODE_BY_VALUE.get(code_val, StatusCode.UNKNOWN), detail)
        except _FrameTooLarge as e:
            conn.destroy()
            conn = None
            _check_frame(e.length, "response")
        except TimeoutError:
            conn.destroy()
            conn = None
            raise PolicyRpcError(
                StatusCode.DEADLINE_EXCEEDED, f"shm call {method} timed out after {timeout:.3f}s"
            )
        except (OSError, struct.error) as e:
            conn.destroy()
            conn = None
            raise PolicyRpcError(StatusCode.UNAVAILABLE, f"shm {self._doorbell}: {e}")
        finally:
            if conn is not None:
                self._checkin(conn)
        transport_faults_after(after, method)
        return body


class _FrameTooLarge(Exception):
    def __init__(self, length: int):
        super().__init__(length)
        self.length = length


# -- selection ---------------------------------------------------------------


def _endpoint_port(addr: str) -> Optional[int]:
    try:
        return int(addr.rpartition(":")[2])
    except ValueError:
        return None


def endpoint_is_local(addr: str) -> bool:
    """Whether the endpoint's host is this one."""
    host = addr.rpartition(":")[0].strip().lower()
    if host in _LOCAL_HOSTS:
        return True
    try:
        return host == socket.gethostname().lower()
    except OSError:  # pragma: no cover
        return False


def select_transport(addr: str, tier: Optional[str] = None, fault_plan=None):
    """The fast-path transport for `addr` under the configured mode, or
    None for the TCP tier. Never raises: any doubt (a remote host, no
    socket file, an unparseable endpoint) means TCP. `tier` overrides
    EDL_TRANSPORT for this one link; an unknown value is ignored. The
    transport runs `fault_plan`'s client half of chaos."""
    mode = transport_mode()
    if tier is not None:
        tier = tier.strip().lower()
        if tier in TRANSPORT_TIERS or tier == "auto":
            mode = tier
    if mode == TRANSPORT_GRPC:
        return None
    port = _endpoint_port(addr)
    if port is None or not endpoint_is_local(addr):
        return None
    if mode in (TRANSPORT_INPROC, "auto") and inproc_dispatcher(port) is not None:
        return InprocTransport(port, fault_plan)
    if mode in (TRANSPORT_SHM, "auto"):
        info = read_shm_rendezvous(port)
        if info is not None and os.path.exists(str(info.get("doorbell", ""))):
            return ShmTransport(port, fault_plan)
    if mode in (TRANSPORT_UDS, "auto"):
        path = uds_path_for(port)
        if os.path.exists(path):
            return UdsTransport(path, fault_plan)
    return None

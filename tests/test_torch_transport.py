"""The port's transport tiers (tcp, uds, shm, inproc) against the
reference's `elasticdl_tpu/rpc/transport.py`.

- For the same environment, endpoint and counterpart state (rendezvous
  file with or without its doorbell, socket file, an in-process server,
  a remote host, an unparseable endpoint, unknown modes and per-link
  pins), `select_transport` picks the reference's tier ("grpc" is the
  port's TCP tier, None on both sides).
- One handler table served on every tier gives the same decoded
  responses as the handlers called directly: frames larger than the
  shm ring (the chunked path) both ways, and concurrent callers whose
  frames stay paired.
- A handler's error, its own status code, an unknown method, a deadline,
  a frame over the limit and a server that is gone give the same status
  codes on every tier, and the reference's on its grpc, uds and inproc
  tiers (its shm tier would make segments under the prefix that the
  reference's own tests sweep for, so it is not started here).
- A server started on the port of a SIGKILLed predecessor (a
  subprocess) reclaims its segments and files; a SIGKILLed client's segment is unlinked when its doorbell
  reads EOF.
- No test leaves a socket, rendezvous file or segment behind
  (`_torch_tiers.tier_dir`), and no name the port makes starts with the
  reference's prefixes.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from elasticdl_tpu.rpc import transport as jtransport
from elasticdl_tpu.rpc.client import RpcClient as JRpcClient
from elasticdl_tpu.rpc.policy import PolicyRpcError as JPolicyRpcError
from elasticdl_tpu.rpc.policy import RetryPolicy as JRetryPolicy
from elasticdl_tpu.rpc.server import RpcServer as JRpcServer
from elasticdl_tpu_torch.common.codec import BF16Bits
from elasticdl_tpu_torch.rpc import transport
from elasticdl_tpu_torch.rpc.client import RpcClient
from elasticdl_tpu_torch.rpc.policy import PolicyRpcError, StatusCode
from elasticdl_tpu_torch.rpc.server import RpcServer
from _torch_tiers import own_segments, port_files, tier_dir  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIERS = ("grpc", "uds", "shm", "inproc")  # "grpc": the port's TCP tier
TIER_NAME = {"grpc": "tcp", "uds": "uds", "shm": "shm", "inproc": "inproc"}
RING = 16384  # small, so that a 100 KB frame takes the chunked path


def _touch(path):
    open(path, "w").close()


# -- selection -----------------------------------------------------------------

PORT = 40123
STATES = {
    "nothing": (),
    "rendezvous+doorbell": ("json", "doorbell"),
    "rendezvous alone": ("json",),
    "socket file": ("sock",),
    "inproc": ("inproc",),
    "everything": ("json", "doorbell", "sock", "inproc"),
    "socket+rendezvous": ("json", "doorbell", "sock"),
}
ADDRS = (f"localhost:{PORT}", f"127.0.0.1:{PORT}", f"[::1]:{PORT}", f"10.9.8.7:{PORT}",
         "localhost:http", "no-port-here", f":{PORT}")


def _make_state(mod, d, parts, json_name, sock_name):
    """The counterpart state in `mod`'s own file names."""
    doorbell = os.path.join(d, json_name.replace(".json", ".sock"))
    if "json" in parts:
        with open(os.path.join(d, json_name), "w") as f:
            json.dump({"doorbell": doorbell, "prefix": "x", "generation": 0}, f)
    if "doorbell" in parts:
        _touch(doorbell)
    if "sock" in parts:
        _touch(os.path.join(d, sock_name))
    if "inproc" in parts:
        mod.register_inproc(PORT, object())


@pytest.mark.parametrize("mode", ["", "grpc", "uds", "shm", "inproc", "auto", "AUTO ", "tcp",
                                  "bogus"])
def test_select_transport_picks_the_references_tier(mode, tier_dir, monkeypatch):
    monkeypatch.setenv("EDL_TRANSPORT", mode)
    checked = 0
    for state, parts in STATES.items():
        _make_state(jtransport, tier_dir, parts, f"edl-shm-{PORT}.json", f"edl-uds-{PORT}.sock")
        _make_state(transport, tier_dir, parts, f"edlt-shm-{PORT}.json",
                    f"edlt-uds-{PORT}.sock")
        try:
            for addr in ADDRS:
                for pin in (None, "shm", "uds", "grpc", "nonsense"):
                    want = jtransport.select_transport(addr, tier=pin)
                    got = transport.select_transport(addr, tier=pin)
                    assert getattr(got, "name", None) == getattr(want, "name", None), (
                        state, addr, pin)
                    checked += 1
        finally:
            jtransport.unregister_inproc(PORT)
            transport.unregister_inproc(PORT)
            for name in os.listdir(tier_dir):
                os.unlink(os.path.join(tier_dir, name))
    assert checked == len(STATES) * len(ADDRS) * 5


def test_mode_ring_and_timeout_parsing_equal_the_references():
    for env in ({}, {"EDL_TRANSPORT": " SHM"}, {"EDL_TRANSPORT": "x"},
                {"EDL_TRANSPORT_SHM_RING_BYTES": "100"},
                {"EDL_TRANSPORT_SHM_RING_BYTES": "5000001"},
                {"EDL_TRANSPORT_SHM_RING_BYTES": "lots"},
                {"EDL_TRANSPORT_SHM_DOORBELL_TIMEOUT": "0"},
                {"EDL_TRANSPORT_SHM_DOORBELL_TIMEOUT": "2.5"},
                {"EDL_TRANSPORT_SHM_DOORBELL_TIMEOUT": "soon"}):
        assert transport.transport_mode(env) == jtransport.transport_mode(env)
        assert transport.shm_ring_bytes(env) == jtransport.shm_ring_bytes(env)
        assert transport.shm_doorbell_timeout(env) == jtransport.shm_doorbell_timeout(env)


def test_port_names_never_take_the_references_prefixes(tier_dir, monkeypatch):
    monkeypatch.setenv("EDL_TRANSPORT", "shm")
    reference = ("edlshm.", "edl-uds-", "edl-shm-")
    names = [os.path.basename(p) for p in (
        transport.uds_path_for(PORT), transport.shm_doorbell_path(PORT),
        transport.shm_rendezvous_path(PORT))]
    srv = RpcServer({"Echo": _echo}, port=0)
    srv.start()
    try:
        client = RpcClient(f"localhost:{srv.port}")
        client.call("Echo", {"x": np.zeros(3, np.float32)})
        names += port_files(tier_dir) + sorted(own_segments())
        client.close()
    finally:
        srv.stop()
    assert len(names) >= 6
    for n in names:
        assert n.startswith("edlt") and not n.startswith(reference), n


# -- one handler table on every tier -----------------------------------------


def _echo(req):
    x = np.asarray(req["x"])
    return {"y": x * 2, "bits": BF16Bits.from_f32(x[:7]), "pair": (int(x.size), "ok"),
            "nested": {"n": [x[:2].copy(), None]}}


def _big(req):
    return {"z": np.arange(int(req["n"]), dtype=np.float32)}


def _slow(req):
    time.sleep(float(req["s"]))
    return {}


def _raise_value(req):
    raise ValueError("bad input")


def _raise_code(req):
    raise PolicyRpcError(StatusCode.FAILED_PRECONDITION, "fenced")


HANDLERS = {"Echo": _echo, "Big": _big, "Slow": _slow, "Boom": _raise_value,
            "Fenced": _raise_code}


def _same(got, want, where="resp"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            _same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
    elif isinstance(want, BF16Bits):
        _same(got.bits, want.bits, where)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), where
    else:
        assert got == want, where


@pytest.fixture
def auto_server(monkeypatch):
    """A server with every tier open (auto), the shm ring at RING."""
    monkeypatch.setenv("EDL_TRANSPORT", "auto")
    monkeypatch.setenv("EDL_TRANSPORT_SHM_RING_BYTES", str(RING))
    srv = RpcServer(HANDLERS, port=0)
    srv.start()
    yield srv
    srv.stop()


def _client(srv, tier):
    """A client on `tier`: EDL_TRANSPORT names it while the client is
    built (the handlers' methods are not idempotent: no call is retried)."""
    saved = os.environ.get("EDL_TRANSPORT")
    os.environ["EDL_TRANSPORT"] = tier
    try:
        return RpcClient(f"localhost:{srv.port}")
    finally:
        if saved is None:
            del os.environ["EDL_TRANSPORT"]
        else:
            os.environ["EDL_TRANSPORT"] = saved


@pytest.mark.parametrize("tier", TIERS)
def test_every_tier_returns_the_handlers_responses(auto_server, tier):
    client = _client(auto_server, tier)
    assert client.tier == TIER_NAME[tier]
    rng = np.random.default_rng(3)
    try:
        # one frame under the ring, one over it (chunked both ways)
        for n in (5, 60_000):
            req = {"x": rng.standard_normal(n).astype(np.float32)}
            _same(client.call("Echo", req), _echo(req))
        _same(client.call("Big", {"n": 3 * RING}), _big({"n": 3 * RING}))
        assert client.seconds["Echo"] >= client.codec_seconds["Echo"] > 0
    finally:
        client.close()


@pytest.mark.parametrize("tier", TIERS)
def test_concurrent_callers_keep_their_frames_paired(auto_server, tier):
    client = _client(auto_server, tier)
    errors = []

    def caller(i):
        try:
            for j in range(12):
                n = (i * 977 + j * 131) % 9000 + (RING if j % 4 == 0 else 1)
                x = np.full(n, float(i * 100 + j), dtype=np.float32)
                resp = client.call("Echo", {"x": x})
                assert resp["pair"] == (n, "ok") and (resp["y"] == 2 * x).all()
        except Exception as e:  # reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=caller, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    client.close()
    assert not any(t.is_alive() for t in threads)
    assert errors == []


# -- status codes ---------------------------------------------------------------


def _codes(make_client, stop, errors, slow_ok=True):
    """{case: status-code name} for one tier."""
    client = make_client()
    out = {}
    cases = [("handler error", "Boom", {}), ("own code", "Fenced", {}),
             ("unknown method", "NoSuchMethod", {})]
    if slow_ok:
        cases.append(("deadline", "Slow", {"s": 0.6}))
    for case, method, req in cases:
        try:
            client.call(method, req, timeout=0.2 if case == "deadline" else 10)
            out[case] = "OK"
        except errors as e:
            out[case] = e.code().name
    stop()
    try:
        client.call("Echo", {"x": np.zeros(2, np.float32)}, timeout=2)
        out["server gone"] = "OK"
    except errors as e:
        out["server gone"] = e.code().name
    client.close()
    return out


def test_status_codes_equal_the_references_on_every_tier(monkeypatch):
    import grpc

    def jfenced(req):
        raise JPolicyRpcError(grpc.StatusCode.FAILED_PRECONDITION, "fenced")

    jhandlers = dict(HANDLERS, Fenced=jfenced)
    # the reference's grpc, uds and inproc tiers (uds opens no segment)
    monkeypatch.setenv("EDL_TRANSPORT", "uds")
    reference = {}
    for tier in ("grpc", "uds", "inproc"):
        srv = JRpcServer(jhandlers, port=0)
        srv.start()
        reference[tier] = _codes(
            lambda: JRpcClient(f"localhost:{srv.port}", policy=JRetryPolicy(max_attempts=1),
                               transport=tier),
            # a call racing grpc's shutdown is CANCELLED: wait it out
            lambda: (srv.stop(0), srv._server.wait_for_termination(5)), grpc.RpcError,
            slow_ok=tier != "inproc")
    want = reference["grpc"]
    assert want == {"handler error": "INTERNAL", "own code": "FAILED_PRECONDITION",
                    "unknown method": "UNIMPLEMENTED", "deadline": "DEADLINE_EXCEEDED",
                    "server gone": "UNAVAILABLE"}
    assert reference["uds"] == want
    monkeypatch.setenv("EDL_TRANSPORT", "auto")
    for tier in TIERS:
        srv = RpcServer(HANDLERS, port=0)
        srv.start()
        got = _codes(lambda: _client(srv, tier), srv.stop, PolicyRpcError,
                     slow_ok=tier != "inproc")
        assert got == reference["inproc" if tier == "inproc" else "grpc"], tier


@pytest.mark.parametrize("tier", TIERS)
def test_frame_over_the_limit_is_invalid_argument_on_every_tier(auto_server, tier,
                                                                monkeypatch):
    monkeypatch.setattr(transport, "MAX_FRAME_BYTES", 4 * RING)
    client = _client(auto_server, tier)
    try:
        for method, req in (("Echo", {"x": np.zeros(5 * RING // 4, np.float32)}),
                            ("Big", {"n": 2 * RING})):
            with pytest.raises(PolicyRpcError) as e:
                client.call(method, req)
            assert e.value.code() == StatusCode.INVALID_ARGUMENT, method
        # the link still works
        assert client.call("Big", {"n": 4})["z"].tolist() == [0, 1, 2, 3]
    finally:
        client.close()


# -- crash recovery -------------------------------------------------------------

PREDECESSOR = r"""
import os, time
from multiprocessing import resource_tracker
# a predecessor whose segments outlive it: no tracker unlinks them
resource_tracker.register = lambda *a, **k: None
os.environ["EDL_TRANSPORT"] = "shm"
from elasticdl_tpu_torch.rpc.server import RpcServer
from elasticdl_tpu_torch.rpc.client import RpcClient
srv = RpcServer({"Ping": lambda req: {"ok": True}}, port=0)
srv.start()
client = RpcClient(f"localhost:{srv.port}")
assert client.tier == "shm" and client.call("Ping", {})["ok"]
print(srv.port, flush=True)
time.sleep(600)
"""


def _predecessor(tier_dir):
    env = dict(os.environ, EDL_UDS_DIR=tier_dir, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-c", PREDECESSOR],
        env=env, stdout=subprocess.PIPE, text=True,
    )
    try:
        port = int(proc.stdout.readline())
    except ValueError:
        proc.kill()
        raise
    return proc, port


def _segments(prefix):
    return sorted(n for n in os.listdir("/dev/shm") if n.startswith(prefix))


def test_successor_reclaims_a_sigkilled_predecessors_rings(tier_dir, monkeypatch):
    proc, port = _predecessor(tier_dir)
    try:
        info = transport.read_shm_rendezvous(port)
        prefix = info["prefix"]
        assert prefix.startswith(f"edltshm.p{port}.g0.{proc.pid}.")
        left = _segments(prefix)
        assert left, "the predecessor's connection has a segment"
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)
    assert _segments(prefix) == left  # nothing cleaned up after the kill
    monkeypatch.setenv("EDL_TRANSPORT", "shm")
    srv = RpcServer({"Ping": lambda req: {"ok": 1}}, port=port)
    srv.start()
    try:
        assert _segments(prefix) == []
        mine = transport.read_shm_rendezvous(srv.port)
        assert mine["pid"] == os.getpid() and mine["generation"] == 0
        client = RpcClient(f"localhost:{srv.port}")
        assert client.tier == "shm" and client.call("Ping", {})["ok"] == 1
        client.close()
    finally:
        srv.stop()
    assert port_files(tier_dir) == []


KILLED_CLIENT = r"""
import os, sys, time
from elasticdl_tpu_torch.rpc.client import RpcClient
client = RpcClient(sys.argv[1])
assert client.tier == "shm" and client.call("Ping", {})["ok"]
print("called", flush=True)
time.sleep(600)
"""


def test_a_sigkilled_clients_segment_is_unlinked(tier_dir, monkeypatch):
    monkeypatch.setenv("EDL_TRANSPORT", "shm")
    srv = RpcServer({"Ping": lambda req: {"ok": True}}, port=0)
    srv.start()
    try:
        before = own_segments()
        env = dict(os.environ, PYTHONPATH=REPO)
        proc = subprocess.Popen([sys.executable, "-c", KILLED_CLIENT, f"localhost:{srv.port}"],
                                env=env, stdout=subprocess.PIPE, text=True)
        try:
            assert proc.stdout.readline().strip() == "called"
            assert len(own_segments() - before) == 1
        finally:
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=10)
        deadline = time.monotonic() + 5
        while own_segments() - before and time.monotonic() < deadline:
            time.sleep(0.02)
        assert own_segments() - before == set()
    finally:
        srv.stop()


# -- handlers keep no view of a request over shm ---------------------------------


def test_servicer_keeps_no_view_of_a_shm_request(monkeypatch):
    """Over shm a request's arrays are views over the connection's ring,
    which the next request overwrites: the aux trees that the servicer
    keeps must be its own copies."""
    from elasticdl_tpu_torch.master.ps_optimizer import PSOptimizer, Sgd
    from elasticdl_tpu_torch.master.servicer import MasterServicer

    monkeypatch.setenv("EDL_TRANSPORT", "shm")
    servicer = MasterServicer(1, PSOptimizer(Sgd(0.1, momentum=0.9)), use_async=True)
    srv = RpcServer(servicer.handlers(), port=0)
    srv.start()
    client = RpcClient(f"localhost:{srv.port}")
    assert client.tier == "shm"
    rng = np.random.default_rng(0)

    def aux():
        return {"bn": {"mean": rng.standard_normal(64).astype(np.float32),
                       "var": BF16Bits.from_f32(rng.standard_normal(64).astype(np.float32))}}

    def overwrite():
        # the same frame layout with other values, over the same ring
        client.call("ReportVariable", {"params": params, "aux": aux()})

    def held():
        got = servicer.get_params_copy()[1]
        return got["bn"]["mean"].tobytes() + got["bn"]["var"].bits.tobytes()

    def sent(a):
        return a["bn"]["mean"].tobytes() + a["bn"]["var"].bits.tobytes()

    try:
        params = {"w": rng.standard_normal(32).astype(np.float32)}
        first = aux()
        client.call("ReportVariable", {"params": params, "aux": first})
        overwrite()
        assert held() == sent(first)
        for method, extra in (
                ("ReportGradient", {"gradient_flat": np.ones(32, np.float32), "version": 0}),
                ("ReportLocalUpdate", {"delta_flat": np.ones(32, np.float32), "steps": 1,
                                       "base_version": 1, "report_key": "k"})):
            state = aux()
            client.call(method, dict(extra, aux_state=state))
            overwrite()
            assert held() == sent(state), method
    finally:
        client.close()
        srv.stop()

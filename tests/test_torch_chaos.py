"""The port's fault-injection plane (`rpc/chaos.py`), circuit breaker and
retry overrides (`rpc/policy.py`) against the reference's.

- Firing: for specs that use every selector (nth, every, prob under two
  seeds, max_fires, roles, targets, side "both", methods, once_file and
  an armed_file latch first absent and then present), the port's and
  the reference's `FaultPlan.actions_for` fire the same (call index,
  kind) list on the same 200-call sequence.
- `CircuitBreaker` under a virtual clock makes the reference's open,
  probe and close decisions; `RetryPolicy.from_env` gives its backoff
  schedule, and the default schedule is the one the port always had.
- `chaos_env_for` and `FaultPlan.from_env` (inline, @file, malformed,
  absent) match.
- On each tier (tcp, uds, shm, inproc): an injected error retried to
  success, the error surfacing on ReportGradient (not idempotent), a
  drop applied on a `PSShardServicer` and absorbed by its dedup ring, a
  server-side error retried, and latency. A crash exits 117 in a
  subprocess with the call applied and leaves a flight dump.
- Exit 117 is relaunch-eligible and exit 2 is not; an open circuit is
  a shard outage.
- A CPU job (2 worker processes, 2 inproc PS shards, per-step) under the
  reference's spec ends at the same versions as its fault-free twin,
  with a dedup hit, a relaunch and every fault in the worker logs; the
  flight recorder orders a fault before the recovery it precedes.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from elasticdl_tpu.common import constants as jconstants
from elasticdl_tpu.rpc import chaos as jchaos
from elasticdl_tpu.rpc import policy as jpolicy
from elasticdl_tpu_torch.common import constants
from elasticdl_tpu_torch.common.constants import (
    ENV_CHAOS_ROLE,
    ENV_CHAOS_SPEC,
    ENV_CHAOS_TARGET_ID,
    ENV_WORKER_LOG_DIR,
    EXIT_CODE_JOB_FAILED,
)
from elasticdl_tpu_torch.master import main as master_main
from elasticdl_tpu_torch.master.ps_shard import PSShardServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.master.worker_manager import WorkerManager
from elasticdl_tpu_torch.models.record_codec import write_learnable_token_records
from elasticdl_tpu_torch.obs import flight, metrics
from elasticdl_tpu_torch.rpc import chaos
from elasticdl_tpu_torch.rpc.chaos import CHAOS_CRASH_EXIT_CODE, FaultPlan, InjectedRpcError
from elasticdl_tpu_torch.rpc.client import RpcClient
from elasticdl_tpu_torch.rpc.fencing import is_shard_outage
from elasticdl_tpu_torch.rpc.policy import (
    CircuitBreaker,
    CircuitOpenError,
    PolicyRpcError,
    RetryPolicy,
    StatusCode,
)
from elasticdl_tpu_torch.rpc.server import RpcServer
from _torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)
from _torch_tiers import tier_dir  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = os.path.join(REPO, "elasticdl_tpu_torch", "models")
TIERS = ("grpc", "uds", "shm", "inproc")  # "grpc": the port's TCP tier
TIER_NAME = {"grpc": "tcp", "uds": "uds", "shm": "shm", "inproc": "inproc"}


def fast_policy(**kw):
    kw.setdefault("initial_backoff", 0.01)
    kw.setdefault("max_backoff", 0.05)
    return RetryPolicy(**kw)


# -- firing parity -------------------------------------------------------------------

METHODS = ("PSPull", "PSPushGrad", "GetTask", "ReportGradient")
SIDES = ("client", "server")


def _calls(n=200):
    """The call sequence: methods and sides interleaved with two
    different periods, so every (method, side) pair recurs."""
    return [(METHODS[i % 4], SIDES[(i // 3) % 2]) for i in range(n)]


SPECS = {
    "nth": {"faults": [{"kind": "drop", "nth": 3}, {"kind": "error", "nth": 17,
                                                     "methods": ["GetTask"]}]},
    "every and max_fires": {"faults": [
        {"kind": "latency", "every": 2, "max_fires": 5},
        {"kind": "error", "code": "DEADLINE_EXCEEDED", "every": 7, "methods": ["PSPull"]}]},
    "prob seed 5": {"seed": 5, "faults": [{"kind": "drop", "prob": 0.4},
                                          {"kind": "latency", "prob": 0.1, "side": "both"}]},
    "prob seed 6": {"seed": 6, "faults": [{"kind": "drop", "prob": 0.4},
                                          {"kind": "latency", "prob": 0.1, "side": "both"}]},
    "roles": {"faults": [{"kind": "drop", "roles": ["worker"], "every": 3},
                         {"kind": "error", "roles": ["ps"], "every": 2}]},
    "targets": {"faults": [{"kind": "drop", "targets": ["0"], "every": 5},
                           {"kind": "error", "targets": [1, "2"], "every": 3}]},
    "side both": {"faults": [{"kind": "error", "side": "both", "every": 4},
                             {"kind": "drop", "side": "server", "nth": 5}]},
    "methods": {"faults": [{"kind": "latency", "methods": ["PSPull", "GetTask"], "every": 3,
                            "max_fires": 9},
                           {"kind": "crash", "methods": ["ReportGradient"], "nth": 40,
                            "when": "after"}]},
}


def _firing(plan, calls, at=None):
    """[(call index, kind)] of `plan` over `calls`; `at(i)` runs first."""
    out = []
    for i, (method, side) in enumerate(calls):
        if at is not None:
            at(i)
        out += [(i, f.kind) for f in plan.actions_for(method, side)]
    return out


@pytest.mark.parametrize("role,target", [("worker", "0"), ("ps", "1"), ("", "")])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_plans_fire_as_the_references(name, role, target):
    spec = SPECS[name]
    calls = _calls()
    port = _firing(FaultPlan.from_spec(spec, role=role, target_id=target), calls)
    ref = _firing(jchaos.FaultPlan.from_spec(spec, role=role, target_id=target), calls)
    assert port == ref
    if name.startswith("prob") and not role:
        assert 0 < len(port) < 2 * len(calls)


def test_two_seeds_fire_differently_on_both_sides():
    calls = _calls()
    a = _firing(FaultPlan.from_spec(SPECS["prob seed 5"]), calls)
    b = _firing(FaultPlan.from_spec(SPECS["prob seed 6"]), calls)
    assert a != b


def test_det_unit_is_the_references_hash():
    for seed in (0, 7, 123):
        p = FaultPlan([], seed=seed)
        r = jchaos.FaultPlan([], seed=seed)
        for idx, method, count in ((0, "M", 1), (3, "PSPull", 77), (1, "GetTask", 200)):
            assert p._det_unit(idx, method, count) == r._det_unit(idx, method, count)


def test_armed_file_and_once_file_latches_fire_as_the_references(tmp_path):
    """The armed entry is scoped out (its counter frozen) until its latch
    appears at call 100; the once_file entry fires for one plan only."""
    calls = _calls()
    out = {}
    for side, mod in (("port", chaos), ("ref", jchaos)):
        armed = tmp_path / f"{side}.armed"
        once = str(tmp_path / f"{side}.once")
        spec = {"faults": [{"kind": "drop", "every": 3, "armed_file": str(armed)},
                           {"kind": "error", "every": 5, "once_file": once}]}
        first = mod.FaultPlan.from_spec(spec)
        second = mod.FaultPlan.from_spec(spec)

        def arm(i, armed=armed):
            if i == 100:
                armed.touch()

        out[side] = (_firing(first, calls, arm), _firing(second, calls))
    assert out["port"] == out["ref"]
    first, second = out["port"]
    drops = [i for i, k in first if k == "drop"]
    # the counter starts at the arming: calls 102-104 are the first
    # client-side calls after it (sides alternate every 3 calls)
    assert drops and min(drops) == 104
    assert [k for _i, k in first].count("error") == 1 and not [k for _i, k in second
                                                                  if k == "error"]


def test_firing_records_flight_events_and_the_chaos_counter():
    flight.RECORDER.clear()
    reg = metrics.get_registry()

    def counted(kind):
        rows = reg.snapshot().get("edl_chaos_injected_total", [])
        return sum(r["value"] for r in rows if r["labels"] == {"kind": kind})

    before = counted("drop")
    plan = FaultPlan.from_spec({"faults": [{"kind": "drop", "nth": 2}]}, role="worker",
                               target_id="3")
    for _ in range(3):
        plan.actions_for("PSPull", "client")
    assert counted("drop") == before + 1
    (ev,) = [e for e in flight.RECORDER.snapshot() if e["kind"] == "chaos_fault"]
    assert {k: ev[k] for k in ("fault", "method", "side", "role", "target")} == {
        "fault": "drop", "method": "PSPull", "side": "client", "role": "worker", "target": "3"}
    assert metrics.METRIC_REGISTRY["edl_chaos_injected_total"] == (
        "Chaos faults injected, per kind.")
    flight.RECORDER.clear()


# -- construction parity -------------------------------------------------------------


def test_env_names_and_help_equal_the_references():
    for name in ("ENV_CHAOS_SPEC", "ENV_CHAOS_ROLE", "ENV_CHAOS_TARGET_ID", "ENV_RPC_RETRIES",
                 "ENV_RPC_BACKOFF", "ENV_RPC_SEED"):
        env = getattr(constants, name)
        assert env == getattr(jconstants, name)
        assert constants.ENV_REGISTRY[env] == jconstants.ENV_REGISTRY[env]


@pytest.mark.parametrize("role,target", [("worker", 4), ("ps", 0), ("kv", None), ("ps", "1")])
def test_chaos_env_for_equals_the_references(role, target):
    assert chaos.chaos_env_for(role, target) == jchaos.chaos_env_for(role, target)


def _plan_view(plan):
    if plan is None:
        return None
    return (plan.seed, plan.role, plan.target_id,
            [(f.kind, f.methods, f.roles, f.targets, f.side, f.prob, f.every, f.nth,
              f.max_fires, f.latency_ms, f.code, f.when, f.once_file, f.armed_file)
             for f in plan.faults])


SPEC_FILE = {"seed": 9, "faults": [
    {"kind": "latency", "latency_ms": 5, "methods": ["PSPull"], "roles": ["worker"]},
    {"kind": "error", "code": "DEADLINE_EXCEEDED", "targets": [0, "1"], "side": "both"},
    {"kind": "crash", "nth": 2, "when": "after", "once_file": "/nowhere/once"}]}


@pytest.mark.parametrize("raw", ["inline", "@file", "{not json", "@/nonexistent/spec.json",
                                 json.dumps({"faults": [{"kind": "explode"}]}),
                                 json.dumps({"faults": [{"kind": "error", "code": "INTERNAL"}]}),
                                 "", "   "])
def test_from_env_equals_the_references(raw, tmp_path):
    if raw == "inline":
        raw = json.dumps(SPEC_FILE)
    elif raw == "@file":
        path = tmp_path / "spec.json"
        path.write_text(json.dumps(SPEC_FILE))
        raw = f"@{path}"
    env = {ENV_CHAOS_SPEC: raw, ENV_CHAOS_ROLE: "worker", ENV_CHAOS_TARGET_ID: "3"}
    port, ref = FaultPlan.from_env(env), jchaos.FaultPlan.from_env(env)
    assert _plan_view(port) == _plan_view(ref)
    assert (port is not None) == (raw == json.dumps(SPEC_FILE) or raw.startswith(f"@{tmp_path}"))
    assert FaultPlan.from_env({}) is None


# -- the breaker and the retry overrides -----------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


BREAKER_SCRIPT = (
    # (advance seconds, op): op is "call" (before_call), "fail" or "ok"
    [(0, "call"), (0, "fail")] * 4 + [(0, "call"), (0, "ok")]  # 4 failures, then reset
    + [(0.1, "call"), (0, "fail")] * 5  # the 5th opens it
    + [(1, "call"), (2, "call"), (1.9, "call")]  # open: fail fast
    + [(0.2, "call"), (0, "call")]  # 5.2 s: one probe, a second call refused
    + [(0, "fail"), (0, "call"), (4.9, "call"), (0.2, "call")]  # probe failed: open again
    + [(0, "ok"), (0, "call"), (0, "fail"), (0, "call")]  # probe ok: closed; 1 failure
)


def _breaker_trace(breaker_cls, clock, threshold=5, interval=5.0):
    b = breaker_cls("localhost:1", failure_threshold=threshold, reset_interval=interval,
                    clock=clock)
    out = []
    for dt, op in BREAKER_SCRIPT:
        clock.t += dt
        if op == "call":
            try:
                b.before_call()
                out.append("pass")
            except Exception as e:  # noqa: BLE001 - both packages' CircuitOpenError
                out.append(f"open:{e.code().name}")
        elif op == "fail":
            b.record_failure()
            out.append(f"failed:{b.is_open}")
        else:
            b.record_success()
            out.append(f"ok:{b.is_open}")
    return out


@pytest.mark.parametrize("threshold,interval", [(5, 5.0), (2, 1.0), (1, 0.5)])
def test_breaker_decisions_equal_the_references(threshold, interval):
    port = _breaker_trace(CircuitBreaker, _Clock(), threshold, interval)
    ref = _breaker_trace(jpolicy.CircuitBreaker, _Clock(), threshold, interval)
    assert port == ref
    if threshold == 5:
        assert "open:UNAVAILABLE" in port and port.count("pass") >= 3


def test_policy_call_behind_an_open_breaker_fails_fast_and_is_an_outage():
    clock = _Clock()
    breaker = CircuitBreaker("localhost:1", clock=clock)
    tries = []

    def dead(remaining):
        tries.append(remaining)
        raise PolicyRpcError(StatusCode.UNAVAILABLE, "connection refused")

    policy = RetryPolicy(sleep_fn=lambda s: None, clock=clock)
    for _ in range(2):  # 4 attempts each: the 5th failure opens the circuit
        with pytest.raises(PolicyRpcError):
            policy.call(dead, "PSPull", 30.0, True, breaker=breaker)
    assert len(tries) == 5 and breaker.is_open
    with pytest.raises(CircuitOpenError) as ei:
        policy.call(dead, "PSPull", 30.0, True, breaker=breaker)
    assert len(tries) == 5, "an open circuit sends nothing"
    assert ei.value.code() is StatusCode.UNAVAILABLE and is_shard_outage(ei.value)
    clock.t += 5.0  # half-open: the probe goes out and closes it
    assert policy.call(lambda r: "up", "PSPull", 30.0, True, breaker=breaker) == "up"
    assert not breaker.is_open


ENVS = [
    {},
    {constants.ENV_RPC_RETRIES: "7"},
    {constants.ENV_RPC_RETRIES: "0"},
    {constants.ENV_RPC_BACKOFF: "0.2", constants.ENV_RPC_SEED: "42"},
    {constants.ENV_RPC_RETRIES: "2", constants.ENV_RPC_BACKOFF: "0.001",
     constants.ENV_RPC_SEED: "3"},
    {constants.ENV_RPC_RETRIES: "", constants.ENV_RPC_SEED: "9"},
]


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
def test_from_env_schedules_equal_the_references(env):
    port, ref = RetryPolicy.from_env(env), jpolicy.RetryPolicy.from_env(env)
    assert (port.max_attempts, port.initial_backoff, port.seed) == (
        ref.max_attempts, ref.initial_backoff, ref.seed)
    for method in ("GetModel", "PSPushGrad", "KVLookup"):
        for k in range(1, 12):
            assert port.backoff_for(method, k) == ref.backoff_for(method, k)


def test_the_default_schedule_is_unchanged():
    """The schedule the port kept as module constants (4 attempts, 0.05 s
    doubling to 2 s, half jitter), bit for bit."""
    import hashlib

    def old(seed, method, k):
        base = min(0.05 * 2.0 ** (k - 1), 2.0)
        h = hashlib.sha256(f"{seed}:{method}:{k}".encode()).digest()
        return base * (1.0 - 0.5 * (int.from_bytes(h[:8], "big") / 2**64))

    for seed in (0, 5):
        policy = RetryPolicy(seed=seed)
        assert policy.max_attempts == 4
        for k in range(1, 10):
            assert policy.backoff_for("GetModel", k) == old(seed, "GetModel", k)
    assert RetryPolicy.from_env({}) == RetryPolicy()


def test_client_defaults_read_the_environment(monkeypatch):
    monkeypatch.setenv(constants.ENV_RPC_RETRIES, "2")
    monkeypatch.setenv(ENV_CHAOS_SPEC, json.dumps({"faults": [{"kind": "drop", "nth": 1}]}))
    monkeypatch.setenv(ENV_CHAOS_ROLE, "worker")
    client = RpcClient("localhost:1")
    try:
        assert client._policy.max_attempts == 2
        assert client._breaker.endpoint == "localhost:1"
        assert client._transport._plan.role == "worker"
    finally:
        client.close()


# -- every fault kind on every tier ----------------------------------------------------


def _serve(handlers, monkeypatch, plan=None):
    monkeypatch.setenv("EDL_TRANSPORT", "auto")
    srv = RpcServer(handlers, port=0, fault_plan=plan)
    srv.start()
    return srv


def _client(srv, tier, monkeypatch, plan=None, **kw):
    monkeypatch.setenv("EDL_TRANSPORT", tier)
    try:
        client = RpcClient(f"localhost:{srv.port}", fault_plan=plan, **kw)
    finally:
        monkeypatch.setenv("EDL_TRANSPORT", "auto")
    assert client.tier == TIER_NAME[tier]
    return client


def _echo_handlers(hits):
    def echo(req):
        hits.append(req.get("x"))
        return {"x": req.get("x")}

    return {"Echo": echo, "ReportGradient": echo}


def _plan(**fault):
    return FaultPlan.from_spec({"faults": [fault]})


@pytest.mark.parametrize("tier", TIERS)
def test_client_error_is_retried_to_success(tier, monkeypatch):
    hits = []
    srv = _serve(_echo_handlers(hits), monkeypatch)
    client = _client(srv, tier, monkeypatch, _plan(kind="error", methods=["Echo"], nth=1),
                     policy=fast_policy())
    try:
        assert client.call("Echo", {"x": 1}, timeout=10, idempotent=True) == {"x": 1}
        assert hits == [1], "the first attempt never reached the server"
    finally:
        client.close()
        srv.stop()


@pytest.mark.parametrize("tier", TIERS)
def test_client_error_surfaces_on_report_gradient(tier, monkeypatch):
    hits = []
    srv = _serve(_echo_handlers(hits), monkeypatch)
    client = _client(srv, tier, monkeypatch,
                     _plan(kind="error", methods=["ReportGradient"], nth=1),
                     policy=fast_policy())
    try:
        with pytest.raises(InjectedRpcError) as ei:
            client.call("ReportGradient", {"x": 1}, timeout=10)
        assert ei.value.code() is StatusCode.UNAVAILABLE
        assert ei.value.details() == "chaos: ReportGradient"
        assert hits == [], "a gradient report is never re-sent"
        assert client.call("ReportGradient", {"x": 2}, timeout=10) == {"x": 2}
    finally:
        client.close()
        srv.stop()


@pytest.mark.parametrize("tier", TIERS)
def test_dropped_push_is_applied_once_and_deduped(tier, monkeypatch):
    """The push APPLIES on the shard, its response is lost, the retry
    carries the same report_key: the shard's version moves by one and
    its dedup ring counts the resend."""
    shard = PSShardServicer(0, 1)
    srv = _serve(shard.handlers(), monkeypatch)
    client = _client(srv, tier, monkeypatch, _plan(kind="drop", methods=["PSPushGrad"], nth=1),
                     policy=fast_policy())
    try:
        client.call("PSInit", {"vec": np.zeros(8, np.float32), "version": 0}, timeout=10)
        resp = client.call("PSPushGrad", {"grad": np.ones(8, np.float32), "version": 0,
                                          "report_key": "w0:t0:s0"}, timeout=10)
        st = shard.stats()
        assert resp["version"] == 1 and resp.get("duplicate") is True
        assert (st["version"], st["applied_pushes"], st["duplicate_pushes"]) == (1, 1, 1)
    finally:
        client.close()
        srv.stop()


@pytest.mark.parametrize("tier", TIERS)
def test_server_side_error_is_retried(tier, monkeypatch):
    hits = []
    plan = _plan(kind="error", methods=["Echo"], side="server", nth=1, code="UNAVAILABLE")
    srv = _serve(_echo_handlers(hits), monkeypatch, plan)
    client = _client(srv, tier, monkeypatch, policy=fast_policy())
    try:
        assert client.call("Echo", {"x": 2}, timeout=10, idempotent=True) == {"x": 2}
        assert hits == [2], "the error answered before the handler ran"
        assert srv.stats()["calls"] == {"Echo": 1}
    finally:
        client.close()
        srv.stop()


@pytest.mark.parametrize("tier", TIERS)
def test_server_side_drop_runs_the_handler(tier, monkeypatch):
    hits = []
    plan = _plan(kind="drop", methods=["Echo"], side="server", nth=1)
    srv = _serve(_echo_handlers(hits), monkeypatch, plan)
    client = _client(srv, tier, monkeypatch, policy=fast_policy())
    try:
        with pytest.raises(PolicyRpcError) as ei:
            client.call("Echo", {"x": 5}, timeout=10, idempotent=False)
        assert ei.value.code() is StatusCode.UNAVAILABLE
        assert ei.value.details() == "chaos drop: Echo"
        assert hits == [5], "the handler ran; its response was withheld"
    finally:
        client.close()
        srv.stop()


@pytest.mark.parametrize("tier", TIERS)
def test_latency_delays_the_call(tier, monkeypatch):
    hits = []
    srv = _serve(_echo_handlers(hits), monkeypatch)
    client = _client(srv, tier, monkeypatch,
                     _plan(kind="latency", methods=["Echo"], latency_ms=80, nth=1))
    try:
        t0 = time.monotonic()
        client.call("Echo", {"x": 3}, timeout=10)
        slow = time.monotonic() - t0
        t0 = time.monotonic()
        client.call("Echo", {"x": 4}, timeout=10)
        assert slow >= 0.08 and hits == [3, 4]
    finally:
        client.close()
        srv.stop()


CHILD = (
    "import sys\n"
    "from elasticdl_tpu_torch.rpc.client import RpcClient\n"
    "c = RpcClient(sys.argv[1])\n"
    "c.wait_ready(10)\n"
    "c.call('Echo', {'x': 9}, timeout=10)\n"
    "print('survived')\n"
)


def test_crash_exits_117_with_the_call_applied_and_a_flight_dump(tmp_path, monkeypatch):
    """The production activation path: the child's RpcClient reads the
    spec from its environment, and `crash when=after` exits 117 once the
    server applied the call, leaving its flight recorder on disk."""
    hits = []
    srv = _serve(_echo_handlers(hits), monkeypatch)
    try:
        env = dict(os.environ, PYTHONPATH=REPO, EDL_FLIGHT_DIR=str(tmp_path),
                   EDL_TRANSPORT="grpc")
        env[ENV_CHAOS_SPEC] = json.dumps({"faults": [
            {"kind": "crash", "methods": ["Echo"], "roles": ["worker"], "nth": 1,
             "when": "after"}]})
        env.update(chaos.chaos_env_for("worker", 0))
        proc = subprocess.run([sys.executable, "-c", CHILD, f"localhost:{srv.port}"], env=env,
                              capture_output=True, text=True, timeout=120)
    finally:
        srv.stop()
    assert proc.returncode == CHAOS_CRASH_EXIT_CODE == 117, proc.stderr
    assert "survived" not in proc.stdout and "chaos: crashing process" in proc.stderr
    assert hits == [9], "a crash after fires with the call applied"
    (dump,) = [p for p in tmp_path.iterdir() if p.name.startswith("edl_flight_")]
    events = json.loads(dump.read_text())["events"]
    assert [e["kind"] for e in events] == ["chaos_fault", "chaos_crash", "dump"]
    assert events[1]["when"] == "after" and events[2]["reason"] == "chaos_crash"


# -- the recovery ladder's answers -----------------------------------------------------


class _FakeBackend:
    def __init__(self):
        self.started = []
        self._cb = None

    def set_event_callback(self, cb):
        self._cb = cb

    def start_worker(self, worker_id, argv, envs):
        self.started.append(worker_id)

    def delete_worker(self, worker_id):
        pass

    def stop(self):
        pass

    def fire(self, worker_id, exit_code):
        from elasticdl_tpu_torch.cluster.pod_backend import PodEvent, PodPhase

        self._cb(PodEvent(worker_id, PodPhase.FAILED, exit_code=exit_code))


def test_chaos_crash_is_relaunch_eligible_and_job_failed_is_not():
    """A worker killed by an injected crash (117) gets its task requeued
    and a replacement; one that exits EXIT_CODE_JOB_FAILED (2) does not."""
    dispatcher = TaskDispatcher({"f": 64}, {}, {}, 16, 1)
    backend = _FakeBackend()
    manager = WorkerManager(backend, dispatcher, num_workers=2, worker_argv_fn=lambda w: [],
                            max_relaunches=4)
    manager.start_workers()
    assert dispatcher.get(0) is not None
    before = dispatcher.pending_count()
    backend.fire(0, CHAOS_CRASH_EXIT_CODE)
    assert dispatcher.pending_count() == before + 1, "the task was not requeued"
    assert backend.started == [0, 1, 2] and manager.relaunches() == 1
    backend.fire(1, EXIT_CODE_JOB_FAILED)
    assert backend.started == [0, 1, 2] and manager.relaunches() == 1


def test_an_open_circuit_is_a_shard_outage_as_in_the_reference():
    from elasticdl_tpu.rpc import fencing as jfencing

    port, ref = CircuitOpenError("localhost:1"), jpolicy.CircuitOpenError("localhost:1")
    assert is_shard_outage(port) and jfencing.is_shard_outage(ref)
    assert (port.code().name, port.details()) == (ref.code().name, ref.details())


def test_a_dead_endpoints_circuit_opens_and_reads_as_an_outage(monkeypatch):
    """Five failed attempts on a dead endpoint open its circuit; the next
    call fails fast with an outage the worker re-resolves on."""
    monkeypatch.setenv("EDL_TRANSPORT", "grpc")
    srv = RpcServer({"Echo": lambda r: r}, port=0)
    srv.start()
    addr = f"localhost:{srv.port}"
    srv.stop()
    client = RpcClient(addr, policy=fast_policy(max_attempts=5))
    try:
        with pytest.raises(PolicyRpcError) as first:
            client.call("PSPull", {}, timeout=10)
        assert not isinstance(first.value, CircuitOpenError) and client._breaker.is_open
        t0 = time.monotonic()
        with pytest.raises(CircuitOpenError) as ei:
            client.call("PSPull", {}, timeout=10)
        assert time.monotonic() - t0 < 0.5 and is_shard_outage(ei.value)
    finally:
        client.close()


# -- the flight recorder's postmortem order --------------------------------------------


def _wait_until(predicate, timeout=20.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def test_flight_recorder_orders_fault_fence_and_recovery():
    """A fault injected on a call, then a PS shard failover: the master
    process's ring holds chaos_fault, recovery_begin, generation_bump and
    recovery_done in seq order."""
    from elasticdl_tpu_torch.master.ps_group import PSShardGroup
    from elasticdl_tpu_torch.master.recovery import RecoveryPlane
    from elasticdl_tpu_torch.models import transformer_lm_zoo as tzoo

    class _Stub:
        def shard_version_floor(self, shard_id):
            return 1 if int(shard_id) == 1 else -1

    flight.RECORDER.clear()
    group = PSShardGroup(2, mode="inproc", use_async=True, optimizer_factory=tzoo.optimizer)
    group.start()
    try:
        n = 10
        group.ensure_init(np.arange(n, dtype=np.float32), version=0)
        client = group.client()
        versions, vec = client.push_grad(np.full(n, 0.5, np.float32), [0, 0],
                                         return_model=True)
        assert versions == [1, 1]
        plan = FaultPlan.from_spec({"seed": 3, "faults": [
            {"kind": "error", "code": "UNAVAILABLE", "methods": ["GetTrace"], "nth": 1}]},
            role="test")
        chaotic = RpcClient(group.endpoints[1], policy=fast_policy(), fault_plan=plan)
        try:
            assert chaotic.call("GetTrace", {}, timeout=10) is not None
        finally:
            chaotic.close()
        plane = RecoveryPlane(_Stub(), ps_group=group, restore_deadline=20.0,
                              opt_mirror_interval=0.05)
        plane.start()
        try:
            _wait_until(lambda: plane.opt_ring_depth(1) >= 1, what="opt mirror ring fill")
            plane.on_shard_failure("ps", 1)
            _wait_until(lambda: 1 in plane.status()["ps"], what="shard 1 fenced")
            s, e = client.bounds[1]
            assert plane.offer_upload(7, 1, vec[s:e], 1) is True
            _wait_until(lambda: ("ps", 1, 1) in plane.recoveries(), what="shard 1 recovery")
        finally:
            plane.stop()
            client.close()
        events = flight.RECORDER.snapshot()
        seqs = [e["seq"] for e in events]
        assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
        first = {}
        for ev in events:
            first.setdefault(ev["kind"], ev["seq"])
        story = ["chaos_fault", "recovery_begin", "generation_bump", "recovery_done"]
        assert all(k in first for k in story), sorted(first)
        assert [first[k] for k in story] == sorted(first[k] for k in story)
        fault = next(e for e in events if e["kind"] == "chaos_fault")
        assert (fault["fault"], fault["method"], fault["role"]) == ("error", "GetTrace", "test")
        bump = next(e for e in events if e["kind"] == "generation_bump")
        assert (bump["shard_kind"], bump["shard"], bump["generation"]) == ("ps", 1, 1)
    finally:
        group.stop()
        flight.RECORDER.clear()


# -- the chaos job ---------------------------------------------------------------------

VOCAB, SEQ, BATCH, FILE_RECORDS = 64, 32, 16, 64


def _chaos_spec(tmp):
    """The reference's spec (`tests/test_chaos.py:560-585`): all on the
    workers' clients."""
    return {"seed": 11, "faults": [
        {"kind": "latency", "methods": ["PSPull"], "roles": ["worker"], "latency_ms": 20,
         "every": 1, "max_fires": 4},
        {"kind": "error", "code": "UNAVAILABLE", "methods": ["PSPushGrad"],
         "roles": ["worker"], "every": 4, "max_fires": 3},
        {"kind": "drop", "methods": ["PSPushGrad"], "roles": ["worker"], "nth": 3},
        {"kind": "crash", "methods": ["GetTask"], "roles": ["worker"], "targets": ["0"],
         "nth": 2, "when": "after", "once_file": os.path.join(tmp, "crash.once")},
    ]}


def _grep_logs(log_dir, needle):
    count = 0
    for name in os.listdir(log_dir):
        with open(os.path.join(log_dir, name), errors="replace") as f:
            count += f.read().count(needle)
    return count


def _both_workers_first(box):
    """master.main's `on_start`: keep the servicer in `box`, and hand out
    no task until workers 0 and 1 have both asked for one (120 s at
    most). A worker that boots late would otherwise find the other one
    done with the job, and worker 0, whose second GetTask the spec
    crashes, might never ask twice."""
    def on_start(servicer):
        box["servicer"] = servicer
        dispatcher = servicer._task_d
        get, asked, cv = dispatcher.get, set(), threading.Condition()

        def gated(worker_id):
            with cv:
                asked.add(worker_id)
                cv.notify_all()
                cv.wait_for(lambda: {0, 1} <= asked, timeout=120)
            return get(worker_id)

        dispatcher.get = gated

    return on_start


def _job(tmp, data, tag, spec, monkeypatch):
    """2 worker processes (device cpu), 2 inproc PS shards, per-step,
    grads_to_wait 1, staleness window 1, 2 epochs of 2 x 64 records in
    tasks of 32: 16 pushes a shard. Returns the accounting."""
    if spec is None:
        monkeypatch.delenv(ENV_CHAOS_SPEC, raising=False)
    else:
        monkeypatch.setenv(ENV_CHAOS_SPEC, json.dumps(spec))
    log_dir = os.path.join(tmp, f"logs-{tag}")
    monkeypatch.setenv(ENV_WORKER_LOG_DIR, log_dir)
    argv = ["--model_zoo", ZOO, "--model_def", "transformer_lm_zoo.custom_model",
            "--model_params", f"vocab={VOCAB}", "--minibatch_size", str(BATCH),
            "--training_data_dir", data, "--records_per_task", "32", "--num_epochs", "2",
            "--grads_to_wait", "1", "--staleness_window", "1", "--num_workers", "2",
            "--worker_backend", "process", "--num_ps", "2", "--ps_mode", "inproc",
            "--max_worker_relaunches", "4", "--device", "cpu", "--envs", "OMP_NUM_THREADS=1"]
    box = {}
    rc, summary = master_main.run(argv, on_start=_both_workers_first(box))
    monkeypatch.delenv(ENV_CHAOS_SPEC, raising=False)
    assert rc == 0 and summary is not None, f"job[{tag}] exited {rc}"
    shards = summary["ps_shards"]
    return {
        "completed_records": box["servicer"]._task_d.completed_records(),
        "versions": [s["version"] for s in shards],
        "applied": sum(s["applied_pushes"] for s in shards),
        "duplicates": sum(s["duplicate_pushes"] for s in shards),
        "relaunches": summary["relaunches"],
        "log_dir": log_dir,
    }


@pytest.mark.parametrize("tier", ["grpc", "shm"])
def test_chaos_job_ends_at_the_fault_free_versions(tier, tmp_path, monkeypatch):
    """Latency, UNAVAILABLE errors, a dropped push response and a worker
    crash injected into a process job: every record completed once, the
    drop's resend absorbed by dedup, and the shards at the fault-free
    twin's versions, [16, 16] with 32 pushes applied."""
    monkeypatch.setenv("EDL_TRANSPORT", tier)
    tmp = str(tmp_path)
    data = os.path.join(tmp, "data")
    os.makedirs(data)
    for i in range(2):
        write_learnable_token_records(os.path.join(data, f"shard-{i}.rio"), FILE_RECORDS, SEQ,
                                      VOCAB, seed=i)
    under = _job(tmp, data, "chaos", _chaos_spec(tmp), monkeypatch)
    twin = _job(tmp, data, "clean", None, monkeypatch)
    assert under["completed_records"] == twin["completed_records"] == 256
    assert under["versions"] == twin["versions"] == [16, 16]
    assert under["applied"] == twin["applied"] == 32
    assert under["duplicates"] >= 1 and twin["duplicates"] == 0
    assert under["relaunches"] >= 1 and twin["relaunches"] == 0
    assert os.path.exists(os.path.join(tmp, "crash.once"))
    logs = under["log_dir"]
    assert _grep_logs(logs, "chaos: +20ms latency") >= 1
    assert _grep_logs(logs, "chaos: injecting UNAVAILABLE") >= 1
    assert _grep_logs(logs, "chaos: dropping response") >= 1
    assert _grep_logs(logs, "chaos: crashing process") == 1
    assert _grep_logs(twin["log_dir"], "chaos:") == 0

"""The port's observability plane (elasticdl_tpu_torch/obs/) against the
reference's (elasticdl_tpu/obs/).

Bit for bit (host code, the same inputs through both packages): the
Chrome trace of a span list, the sync critical path and the exposed sync
fraction derived from it, the flight recorder's dump under a fixed
clock, and the span ring's eviction. Behaviour: a traced call on every
transport tier records `rpc.client.M` and its child `rpc.server.M` under
one trace id and the handler never sees the envelope; with sampling off
nothing is recorded and the request's bytes are the untraced ones; a
crashing process leaves its flight dump; GetTrace and GetMetrics answer
from the master, from inproc shards and from shard processes, a fenced
one included; ReportPhaseStats reaches the master's aggregator; a traced
window job gives the reference's sync-chain span names and a critical
path that re-composes its sync wall; a worker process writes its
torch.profiler trace; and the self-check CLI writes its artifacts.
Tolerances are stated where a test is not exact.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from elasticdl_tpu.api.model_spec_helpers import spec_from_module as jspec_from_module
from elasticdl_tpu.master.ps_optimizer import PSOptimizer as JPSOptimizer
from elasticdl_tpu.master.servicer import MasterServicer as JServicer
from elasticdl_tpu.master.task_dispatcher import TaskDispatcher as JDispatcher
from elasticdl_tpu.models import transformer_lm as jtlm
from elasticdl_tpu.models import transformer_lm_zoo as jzoo
from elasticdl_tpu.obs import critical_path as jcp
from elasticdl_tpu.obs import flight as jflight
from elasticdl_tpu.obs import trace as jtrace
from elasticdl_tpu.rpc.client import RpcClient as JRpcClient
from elasticdl_tpu.rpc.server import RpcServer as JRpcServer
from elasticdl_tpu.worker.worker import Worker as JWorker
from elasticdl_tpu_torch.api.model_spec_helpers import spec_from_module
from elasticdl_tpu_torch.common import messages
from elasticdl_tpu_torch.master import main as master_main
from elasticdl_tpu_torch.master.kv_group import KVShardGroup
from elasticdl_tpu_torch.master.ps_group import PSShardGroup
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.models import transformer_lm_zoo as tzoo
from elasticdl_tpu_torch.models.record_codec import write_learnable_token_records
from elasticdl_tpu_torch.obs import critical_path as tcp
from elasticdl_tpu_torch.obs import fetch, flight, metrics, trace
from elasticdl_tpu_torch.rpc import fencing
from elasticdl_tpu_torch.rpc.client import RpcClient
from elasticdl_tpu_torch.rpc.policy import PolicyRpcError
from elasticdl_tpu_torch.rpc.server import RpcServer
from elasticdl_tpu_torch.testing import build_job
from elasticdl_tpu_torch.worker import main as worker_main
from elasticdl_tpu_torch.worker.worker import Worker
from _torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)
from _torch_tiers import tier_dir  # noqa: F401 (autouse: a socket dir of the test's own)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = os.path.join(REPO, "elasticdl_tpu_torch", "models")
VOCAB, SEQ, BATCH = 64, 128, 16
# the port's traced window job's model: wide enough that a sync's encode,
# push and apply outweigh the chain's fixed costs (a thread's start, the
# bookkeeping), which no span names
WIDE = dict(vocab=VOCAB, d_model=512, d_ff=2048)


@pytest.fixture
def traced():
    """Tracing on for the test in both packages, the recorders empty
    before and after."""
    for mod in (trace, jtrace):
        mod.configure(1.0)
        mod.RECORDER.clear()
    yield
    for mod in (trace, jtrace):
        mod.configure(None)
        mod.RECORDER.clear()


# -- span-derived views, bit for bit ------------------------------------------------


def _span(name, ts, dur, tid, sid, parent=None, **args):
    return {"name": name, "cat": "edl", "ts": ts, "dur": dur, "trace_id": tid,
            "span_id": sid, "parent_id": parent, "pid": 7, "tid": 1, "args": args}


def _spans():
    """Two window syncs (one over a fan-in park, for the combine
    component), a worker pull outside the chain, and exposed stalls."""
    return [
        _span("worker.window_sync", 100.0, 0.5, "t1", "a", steps=4),
        _span("worker.quantize", 100.0, 0.01, "t1", "b", "a"),
        _span("worker.encode", 100.02, 0.04, "t1", "c", "a"),
        _span("rpc.client.ReportLocalUpdate", 100.07, 0.4, "t1", "d", "a", transport="tcp"),
        _span("rpc.server.ReportLocalUpdate", 100.1, 0.3, "t1", "e", "d", transport="tcp"),
        _span("master.apply", 100.12, 0.2, "t1", "f", "e", kind="local_update"),
        _span("worker.window_sync", 101.0, 0.75, "t2", "g", steps=4),
        _span("worker.encode", 101.0, 0.05, "t2", "h", "g"),
        _span("rpc.client.PSPushDelta", 101.05, 0.6, "t2", "i", "g"),
        _span("rpc.server.PSPushDelta", 101.1, 0.5, "t2", "j", "i"),
        _span("fanin.park", 101.1, 0.45, "t2", "k", "j"),
        _span("ps.apply", 101.2, 0.25, "t2", "l", "k", shard=0, kind="delta"),
        _span("rpc.admission_wait", 101.1, 0.02, "t2", "m", "j"),
        _span("worker.pull", 102.0, 0.3, "t3", "n"),
        _span("rpc.client.GetModel", 102.0, 0.3, "t3", "o", "n"),
        _span("worker.sync_exposed", 103.0, 0.125, "t4", "p", reason="join"),
        _span("worker.sync_exposed", 104.0, 0.0625, "t5", "q", reason="backpressure"),
        _span("worker.sync_exposed", 105.0, 0.25, "t6", "r"),
    ]


def test_span_views_match_the_reference_bit_for_bit():
    spans = _spans()
    assert trace.chrome_trace_from_spans(spans) == jtrace.chrome_trace_from_spans(spans)
    for method in ("ReportLocalUpdate", "PSPushDelta"):
        got = tcp.sync_critical_path_from_spans(spans, sync_method=method)
        assert got == jcp.sync_critical_path_from_spans(spans, sync_method=method)
    assert got["rounds"] == 2 and got["combine_s"] is not None
    # without a fan-in park the combine component is None, for the reason given
    plain = [s for s in spans if s["name"] != "fanin.park"]
    got = tcp.sync_critical_path_from_spans(plain)
    assert got == jcp.sync_critical_path_from_spans(plain)
    assert got["combine_s"] is None and "combine_s_skipped_reason" in got
    for wall in (10.0, 0.0):
        got = tcp.sync_exposed_fraction_from_spans(spans, wall)
        assert got == jcp.sync_exposed_fraction_from_spans(spans, wall)
    assert got["by_reason"] == {"backpressure": 0.0625, "join": 0.125, "unknown": 0.25}
    for empty in ([], spans[13:15]):
        assert tcp.sync_critical_path_from_spans(empty) is None
        assert tcp.sync_exposed_fraction_from_spans(empty, 1.0) is None
        assert jcp.sync_exposed_fraction_from_spans(empty, 1.0) is None


def test_flight_dump_matches_the_reference_under_a_fixed_clock(monkeypatch):
    import time as time_mod

    monkeypatch.setattr(time_mod, "time", lambda: 1234.5)
    monkeypatch.setattr(os, "getpid", lambda: 4242)
    dumps = []
    for cls in (flight.FlightRecorder, jflight.FlightRecorder):
        rec = cls(capacity=3)
        rec.record("generation_bump", shard_kind="ps", shard=1, generation=1)
        rec.record("recovery_begin", shard_kind="ps", shard=1, why="process exit rc=-9")
        rec.record("generation_bump", shard_kind="kv", shard=0, generation=2, refence=True)
        rec.record("recovery_done", shard_kind="ps", shard=1, generation=1)
        dumps.append((rec.dump_json(), rec.dropped, len(rec), rec.snapshot()))
    assert dumps[0] == dumps[1]
    doc = dumps[0][0]
    assert doc["dropped"] == 1 and [e["seq"] for e in doc["events"]] == [2, 3, 4]


def test_span_ring_drops_its_oldest_spans_as_the_reference():
    """A ring of 4 on one stripe takes 6 spans: the last 4 stay, in
    order, and 2 are counted as dropped; clear() empties both."""
    out = []
    for mod in (trace, jtrace):
        ring = mod.SpanRecorder(capacity=4, stripes=1)
        for i in range(6):
            ring.record({"name": f"s{i}", "ts": float(i)})
        out.append(([s["name"] for s in ring.snapshot()], ring.dropped, len(ring)))
        ring.clear()
        assert ring.dropped == 0 and len(ring) == 0
    assert out[0] == out[1] == (["s2", "s3", "s4", "s5"], 2, 4)


def test_sampling_is_read_from_the_environment(monkeypatch):
    monkeypatch.setenv("EDL_TRACE_SAMPLE", "0")
    trace.refresh()
    try:
        assert not trace.enabled() and trace.start_span("x", root=True) is None
        monkeypatch.setenv("EDL_TRACE_SAMPLE", "1")
        trace.refresh()
        assert trace.enabled()
        sp = trace.start_span("x", root=True)
        assert sp is not None and sp.ctx.parent_id is None
        # no context and not a root: a no-op
        assert trace.start_span("y") is None
        for bad in ("nan-ish", "-3"):
            monkeypatch.setenv("EDL_TRACE_SAMPLE", bad)
            trace.refresh()
            assert not trace.enabled()
    finally:
        trace.refresh()


# -- the envelope on every tier ---------------------------------------------------------


class _Echo:
    """A handler table that keeps every request it is handed."""

    def __init__(self):
        self.seen = []

    def handlers(self):
        return {"Echo": self.echo}

    def echo(self, req):
        self.seen.append(sorted(req))
        return {"n": len(self.seen), "x": req.get("x")}


@pytest.mark.parametrize("tier", ["grpc", "uds", "shm", "inproc"])
def test_traced_call_on_every_tier_chains_client_and_server(tier, monkeypatch, traced):
    monkeypatch.setenv("EDL_TRANSPORT", tier)
    echo = _Echo()
    server = RpcServer(echo.handlers(), port=0)
    server.start()
    client = RpcClient(f"localhost:{server.port}")
    try:
        assert client.tier == ("tcp" if tier == "grpc" else tier)
        assert client.call("Echo", {"x": 3})["x"] == 3
        with trace.span("outer", root=True) as outer:
            client.call("Echo", {"x": 4})
    finally:
        client.close()
        server.stop()
    assert echo.seen == [["x"], ["x"]]  # the envelope never reached the handler
    spans = trace.RECORDER.snapshot()
    by_name = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(s)
    clients, servers = by_name["rpc.client.Echo"], by_name["rpc.server.Echo"]
    assert len(clients) == len(servers) == 2
    for c, srv in zip(sorted(clients, key=lambda s: s["ts"]),
                      sorted(servers, key=lambda s: s["ts"])):
        assert srv["trace_id"] == c["trace_id"] and srv["parent_id"] == c["span_id"]
        assert srv["args"]["transport"] == client.tier == c["args"]["transport"]
    # the first call was a root; the second the child of "outer"
    assert sorted(c["parent_id"] is None for c in clients) == [False, True]
    assert any(c["parent_id"] == outer.ctx.span_id for c in clients)
    # the server's wire counters saw both calls on this tier
    snap = server.wire_stats()
    assert snap["methods"]["Echo"]["calls"] == 2 and set(snap["transports"]) == {client.tier}


def test_untraced_requests_carry_their_untraced_bytes(monkeypatch):
    """Sampling at 0: no span is recorded, the envelope is absent, and the
    bytes on the wire are messages.pack(request) exactly; the server
    pops a stray envelope all the same."""
    trace.configure(0.0)
    trace.RECORDER.clear()
    echo = _Echo()
    server = RpcServer(echo.handlers(), port=0)
    server.start()
    client = RpcClient(f"localhost:{server.port}")
    sent = []
    real = client._transport.call

    def spy(method, payload, timeout):
        sent.append(bytes(payload))
        return real(method, payload, timeout)

    client._transport.call = spy
    try:
        req = {"x": np.arange(5, dtype=np.float32), "k": "v"}
        client.call("Echo", req)
        client.call("Echo", {"x": 1, trace.ENVELOPE_KEY: {"t": "a", "s": "b"}})
    finally:
        client.close()
        server.stop()
        trace.configure(None)
    assert sent[0] == bytes(messages.pack(req))
    assert echo.seen == [["k", "x"], ["x"]]
    assert len(trace.RECORDER) == 0


# -- the flight recorder's crash dump -------------------------------------------------


def test_a_crashing_process_leaves_its_flight_dump(tmp_path):
    code = (
        "from elasticdl_tpu_torch.obs import flight\n"
        "flight.install_crash_dump()\n"
        "flight.record('generation_bump', shard_kind='ps', shard=0, generation=1)\n"
        "raise RuntimeError('boom')\n"
    )
    env = {**os.environ, "EDL_FLIGHT_DIR": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1 and "boom" in out.stderr
    (dump,) = [p for p in os.listdir(tmp_path) if p.startswith("edl_flight_")]
    doc = json.loads((tmp_path / dump).read_text())
    kinds = [e["kind"] for e in doc["events"]]
    assert kinds == ["generation_bump", "uncaught_exception", "dump"]
    assert doc["events"][1]["error"] == "RuntimeError"


# -- GetTrace and GetMetrics from the master and the shards -----------------------------


def _ps_argv():
    return ["--model_zoo", ZOO, "--model_def", "transformer_lm_zoo.custom_model",
            "--model_params", f"vocab={VOCAB}", "--minibatch_size", str(BATCH)]


@pytest.mark.parametrize("mode", ["inproc", "process"])
def test_get_trace_and_metrics_answer_from_master_and_shards(mode, tmp_path, monkeypatch,
                                                             traced):
    """Two PS shards and two KV shards: the master's GetMetrics carries the
    inproc shards' counters in its own registry and the shard processes'
    under `shards`; each shard answers GetTrace and GetMetrics even
    while a client holds a fenced (stale) epoch; the master's GetTrace
    holds the server spans of a traced push's fan-out, one trace id
    across the shard clients."""
    monkeypatch.setenv("EDL_TRACE_SAMPLE", "1")  # the shard processes trace too
    kw = dict(shard_argv=_ps_argv()) if mode == "process" else dict(
        optimizer_factory=tzoo.optimizer)
    group = PSShardGroup(2, mode=mode, use_async=True, **kw)
    kvg = KVShardGroup(2, mode=mode)
    group.start()
    kvg.start()
    try:
        spec = spec_from_module(tzoo, model=tzoo.custom_model(vocab=VOCAB))
        servicer, _e, _c = build_job(spec, None, ps_group=group, embedding_store=kvg.store())
        servicer.kv_group = kvg  # as master.main's sparse plane wires it
        ps = group.client(8)
        ps.init_model(np.zeros(8, np.float32))
        with trace.span("step", root=True) as step:
            ps.push_grad(np.ones(8, np.float32), [0, 0])
        group.refence()  # the shards move to generation 1: epoch 0 is fenced
        stale = RpcClient(group.endpoints[0])
        try:
            with pytest.raises(PolicyRpcError) as e:
                stale.call("PSPull", {"epoch": 0})
            assert fencing.is_fenced_error(e.value)
            got = stale.call("GetTrace", {"epoch": 0})
            assert set(got) == {"spans", "dropped"}
            assert "edl_ps_version" in stale.call("GetMetrics", {"epoch": 0})["metrics"]
        finally:
            stale.close()
        kv = RpcClient(kvg.endpoints[1])
        try:
            assert "edl_kv_rows" in kv.call("GetMetrics", {"epoch": 0})["metrics"]
        finally:
            kv.close()
        answer = servicer.get_metrics({})
        own = answer["metrics"]
        if mode == "inproc":
            assert answer["shards"] == {}
            shards = {r["labels"]["shard"] for r in own["edl_ps_generation"]}
            assert shards >= {"0", "1"}
        else:
            assert sorted(answer["shards"]) == ["kv0", "kv1", "ps0", "ps1"]
            for i in range(2):
                gen = answer["shards"][f"ps{i}"]["edl_ps_generation"]
                assert gen == [{"labels": {"shard": str(i)}, "value": 1.0}]
                pushed = answer["shards"][f"ps{i}"]["edl_ps_applied_pushes_total"]
                assert pushed[0]["value"] == 1.0
        merged = fetch.fetch_chrome_trace([RpcClient(ep) for ep in group.endpoints],
                                          path=str(tmp_path / "merged.json"))
        events = [e for e in merged["traceEvents"] if e["args"]["trace_id"] == step.ctx.trace_id]
        names = sorted(e["name"] for e in events)
        assert names.count("rpc.client.PSPushGrad") == 2
        assert names.count("rpc.server.PSPushGrad") == 2 and names.count("ps.apply") == 2
        pids = {e["pid"] for e in events}
        assert len(pids) == (1 if mode == "inproc" else 3)
        assert json.loads((tmp_path / "merged.json").read_text()) == merged
    finally:
        kvg.stop()
        group.stop()


def test_report_phase_stats_reaches_the_master_aggregator():
    """master.main's observability wiring: ReportPhaseStats over the socket
    lands in the PhaseStatsAggregator, and GetMetrics shows the worker's
    cumulative phase seconds and counts."""
    spec = spec_from_module(tzoo, model=tzoo.custom_model(vocab=VOCAB))
    servicer, _e, _c = build_job(spec, None)
    collector = master_main.observe_master(servicer)
    server = RpcServer(servicer.handlers(), port=0)
    server.start()
    client = RpcClient(f"localhost:{server.port}")
    try:
        phases = {"compute": {"seconds": 1.5, "count": 3}, "get_task": {"seconds": 0.25,
                                                                        "count": 4}}
        assert client.call("ReportPhaseStats", {"worker_id": 7, "phases": phases}) == {}
        got = client.call("GetMetrics", {})["metrics"]
    finally:
        client.close()
        server.stop()
        metrics.get_registry().unregister_collector(collector)
    rows = {(r["labels"]["worker"], r["labels"]["phase"]): r["value"]
            for r in got["edl_phase_seconds_total"]}
    assert rows[("7", "compute")] == 1.5 and rows[("7", "get_task")] == 0.25
    counts = {r["labels"]["phase"]: r["value"] for r in got["edl_phase_count_total"]
              if r["labels"]["worker"] == "7"}
    assert counts == {"compute": 3.0, "get_task": 4.0}


# -- a traced window job in both packages ------------------------------------------------


@pytest.fixture
def records(tmp_path):
    path = str(tmp_path / "tokens.rio")
    write_learnable_token_records(path, 128, SEQ, VOCAB, seed=2)
    return path


def _chain_names(spans):
    roots = {s["trace_id"] for s in spans if s["name"] == "worker.window_sync"}
    return {s["name"] for s in spans if s["trace_id"] in roots}


def test_traced_window_job_has_the_references_sync_chain(records, traced):
    """One worker, W = 4, bf16 EF sync, over a real server and client in
    each package: the sync chains hold the same span names (the port adds
    `worker.sync_queue`, the wait for the predecessor sync), each client
    push span is the child of its window's root, and the port's
    critical path re-composes its sync wall within 10% (the reference's
    own gate)."""
    init = jtlm.init_params(np.random.default_rng(11), jzoo.custom_model(vocab=VOCAB).cfg)
    jdispatcher = JDispatcher({records: 128}, {}, {}, 64, 1, shuffle_seed=3)
    jspec = jspec_from_module(jzoo, model=jzoo.custom_model(vocab=VOCAB))
    jservicer = JServicer(1, JPSOptimizer(jzoo.optimizer()), task_dispatcher=jdispatcher,
                          init_params=init)
    jserver = JRpcServer(jservicer.handlers(), port=0)
    jserver.start()
    jclient = JRpcClient(f"localhost:{jserver.port}")
    try:
        jworker = JWorker(0, jclient, jspec, minibatch_size=BATCH, local_updates=4,
                          sync_dtype="bfloat16")
        assert jworker.run()
        jworker.close()
    finally:
        jclient.close()
        jserver.stop()
    jspans = jtrace.RECORDER.snapshot()

    dispatcher = TaskDispatcher({records: 128}, {}, {}, 64, 1, shuffle_seed=3)
    spec = spec_from_module(tzoo, model=tzoo.custom_model(**WIDE))
    servicer, _e, _c = build_job(spec, dispatcher)  # the worker's init seeds the PS
    server = RpcServer(servicer.handlers(), port=0)
    server.start()
    client = RpcClient(f"localhost:{server.port}")
    try:
        worker = Worker(0, client, spec, minibatch_size=BATCH, device="cpu", local_updates=4,
                        sync_dtype="bfloat16")
        assert worker.run()
        worker.close()
    finally:
        client.close()
        server.stop()
    spans = trace.RECORDER.snapshot()
    # the port's one addition: the wait for the chain's predecessor, a
    # child of the window's root, outside the root's own interval
    assert _chain_names(spans) - {"worker.sync_queue"} == _chain_names(jspans)
    assert {"worker.quantize", "worker.encode", "rpc.client.ReportLocalUpdate",
            "rpc.server.ReportLocalUpdate", "master.apply"} <= _chain_names(spans)
    roots = {s["span_id"]: s for s in spans if s["name"] == "worker.window_sync"}
    pushes = [s for s in spans if s["name"] == "rpc.client.ReportLocalUpdate"]
    assert len(roots) == len(pushes) == 2
    assert all(p["parent_id"] in roots for p in pushes)
    cp = tcp.sync_critical_path_from_spans(spans, sync_method="ReportLocalUpdate")
    assert cp["rounds"] == 2 and 0.9 <= cp["sum_fraction"] <= 1.1, cp
    # every span the worker recorded belongs to a trace that started in a root
    names = {s["name"] for s in spans}
    assert {"worker.pull", "rpc.client.GetTask", "rpc.server.GetTask"} <= names


# -- the per-process profiler trace and the CLI --------------------------------------------


def test_worker_process_writes_its_profiler_trace(tmp_path, monkeypatch):
    data = tmp_path / "data"
    data.mkdir()
    write_learnable_token_records(str(data / "tokens.rio"), 32, SEQ, VOCAB, seed=1)
    monkeypatch.setenv("EDL_WORKER_LOG_DIR", str(tmp_path / "logs"))
    profile = tmp_path / "profile"
    rc, summary = master_main.run([
        "--model_zoo", ZOO, "--model_def", "transformer_lm_zoo.custom_model",
        "--model_params", f"vocab={VOCAB}", "--minibatch_size", str(BATCH),
        "--training_data_dir", str(data), "--records_per_task", "32", "--num_epochs", "1",
        "--num_workers", "1", "--device", "cpu", "--envs", "OMP_NUM_THREADS=1",
        "--profile_dir", str(profile),
    ])
    assert rc == 0
    (s,) = worker_main.read_summaries(str(tmp_path / "logs")).values()
    path = s["profile_trace"]
    assert path is not None and os.path.dirname(path) == str(profile / "worker-0")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_obs_cli_writes_its_three_artifacts(tmp_path):
    out = subprocess.run([sys.executable, "-m", "elasticdl_tpu_torch.obs", "--out-dir",
                          str(tmp_path), "--rounds", "3"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert sorted(os.listdir(tmp_path)) == ["flight.json", "metrics.txt", "trace.json"]
    doc = json.loads((tmp_path / "trace.json").read_text())
    assert {e["ph"] for e in doc["traceEvents"]} == {"X"}
    assert "# TYPE edl_ps_applied_pushes_total counter" in (tmp_path / "metrics.txt").read_text()
    kinds = [e["kind"] for e in json.loads((tmp_path / "flight.json").read_text())["events"]]
    assert kinds[:2] == ["obs_selfcheck_begin", "obs_selfcheck_probe_done"]


def test_fan_out_threads_carry_the_callers_context(traced):
    """ShardedPS pool threads bind the caller's context: the shard calls of
    a pull made under a span are its children, one per shard."""
    group = PSShardGroup(2, mode="inproc", optimizer_factory=tzoo.optimizer, use_async=True)
    group.start()
    try:
        ps = group.client(6)
        ps.init_model(np.arange(6, dtype=np.float32))
        with trace.span("outer", root=True) as outer:
            versions, vec = ps.pull()
            fut = ps.pull_async()
            fut.result()
        threads = {threading.get_ident()}
    finally:
        group.stop()
    np.testing.assert_array_equal(vec, np.arange(6, dtype=np.float32))
    pulls = [s for s in trace.RECORDER.snapshot() if s["name"] == "rpc.client.PSPull"]
    assert len(pulls) == 4 and all(s["parent_id"] == outer.ctx.span_id for s in pulls)
    assert {s["tid"] for s in pulls}.isdisjoint(threads)

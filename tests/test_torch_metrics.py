"""The port's metrics surface (elasticdl_tpu_torch/obs/metrics.py) against
the reference's (elasticdl_tpu/obs/metrics.py): the declared names are a
subset of the reference's with its help strings, the snapshot and the
Prometheus text of the same samples are equal bit for bit, and the
scrape surfaces work: the HTTP listener, the process registry's default
collectors, each server's wire collector (dropped on stop), the shards'
collectors, and the recovery plane's flight records and event counter."""

import time
import urllib.request

import numpy as np
import pytest

from elasticdl_tpu.obs import metrics as jmetrics
from elasticdl_tpu_torch.master.kv_group import KVShardGroup
from elasticdl_tpu_torch.master.recovery import RecoveryPlane
from elasticdl_tpu_torch.obs import flight, metrics
from elasticdl_tpu_torch.rpc.client import RpcClient
from elasticdl_tpu_torch.rpc.server import RpcServer
from _torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)


def test_declared_names_are_the_references_with_its_help():
    assert set(metrics.METRIC_REGISTRY) <= set(jmetrics.METRIC_REGISTRY)
    for name, help_text in metrics.METRIC_REGISTRY.items():
        assert jmetrics.METRIC_REGISTRY[name] == help_text, name
    # the names the port's code emits
    assert {"edl_ps_applied_pushes_total", "edl_kv_rows", "edl_phase_seconds_total",
            "edl_recovery_events_total", "edl_wire_calls_total"} <= set(metrics.METRIC_REGISTRY)


def _fill(reg):
    reg.inc("edl_recovery_events_total", event="begin", kind="ps")
    reg.inc("edl_recovery_events_total", 2, event="done", kind="kv")
    reg.set_gauge("edl_trace_spans", 12)
    reg.inc("edl_wire_calls_total", 3, endpoint='a"b\\c\nd', side="client")

    def collector(sink):
        sink.counter("edl_ps_applied_pushes_total", 7, shard="1")
        sink.counter("edl_ps_applied_pushes_total", 5, shard="0")
        sink.gauge("edl_ps_version", 0.5, shard="0")
        sink.gauge("edl_kv_rows", 1e20, shard="0")

    def broken(sink):
        raise RuntimeError("a collector that fails is skipped")

    reg.register_collector(collector)
    reg.register_collector(broken)
    return reg


def test_snapshot_and_prometheus_text_match_the_reference():
    port = _fill(metrics.MetricsRegistry())
    ref = _fill(jmetrics.MetricsRegistry(declared=dict(metrics.METRIC_REGISTRY)))
    assert port.snapshot() == ref.snapshot()
    assert port.prometheus_text() == ref.prometheus_text()
    text = port.prometheus_text()
    assert "# TYPE edl_ps_version gauge" in text
    assert 'edl_ps_applied_pushes_total{shard="0"} 5\n' in text
    assert 'endpoint="a\\"b\\\\c\\nd"' in text


def test_undeclared_names_raise_in_both():
    for reg in (metrics.MetricsRegistry(), jmetrics.MetricsRegistry()):
        with pytest.raises(ValueError):
            reg.inc("edl_not_declared_total")
        with pytest.raises(ValueError):
            reg.set_gauge("edl_not_declared", 1.0)


def test_unregistered_collectors_stop_reporting():
    reg = metrics.MetricsRegistry()

    def collector(sink):
        sink.gauge("edl_kv_rows", 3, shard="0")

    reg.register_collector(collector)
    assert "edl_kv_rows" in reg.snapshot()
    reg.unregister_collector(collector)
    reg.unregister_collector(collector)  # unknown: ignored
    assert reg.snapshot() == {}


def test_http_listener_serves_the_process_registry(monkeypatch):
    monkeypatch.setenv("EDL_METRICS_PORT", "0")
    server = metrics.maybe_serve_from_env()
    try:
        assert server is not None and metrics.maybe_serve_from_env() is server
        port = server.server_address[1]
        body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10).read()
        assert b"# TYPE edl_trace_spans gauge" in body
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/other", timeout=10)
    finally:
        metrics.stop_serving_for_tests()
    monkeypatch.setenv("EDL_METRICS_PORT", "not-a-port")
    assert metrics.maybe_serve_from_env() is None


def test_server_and_client_wire_counters_reach_the_registry():
    """An RpcServer's collector reports its side's bytes and calls under
    its port, the client's endpoint row its own (the reference's client
    collector iterates the endpoint names and is skipped); stop() drops
    the server's collector."""
    server = RpcServer({"Echo": lambda req: {"x": req.get("x")}}, port=0)
    server.start()
    client = RpcClient(f"localhost:{server.port}")
    try:
        for i in range(3):
            client.call("Echo", {"x": np.arange(i + 1, dtype=np.float32)})
        snap = metrics.get_registry().snapshot()
    finally:
        client.close()
        server.stop()
    calls = {(r["labels"].get("side"), r["labels"].get("port", r["labels"].get("endpoint"))):
             r["value"] for r in snap["edl_wire_calls_total"]}
    assert calls[("server", str(server.port))] == 3
    assert calls[("client", f"localhost:{server.port}")] == 3
    sent = {r["labels"]["side"]: r["value"] for r in snap["edl_wire_bytes_sent_total"]
            if r["labels"].get("port", r["labels"].get("endpoint"))
            in (str(server.port), f"localhost:{server.port}")}
    assert sent["client"] > 0 and sent["server"] > 0
    after = metrics.get_registry().snapshot().get("edl_wire_calls_total", [])
    assert not any(r["labels"].get("port") == str(server.port) for r in after)


class _Floors:
    def shard_version_floor(self, shard_id):
        return -1


def test_kv_recovery_leaves_flight_records_and_counts_its_events():
    """A KV shard's recovery from its pair: the flight ring holds its
    begin, the generation bump and its end, in causal order, and
    edl_recovery_events_total counts begin and done for kind kv; the
    relaunched shard's collector reports generation 1."""
    reg = metrics.get_registry()

    def count(event):
        rows = reg.snapshot().get("edl_recovery_events_total", [])
        return sum(r["value"] for r in rows
                   if r["labels"] == {"event": event, "kind": "kv"})

    before = (count("begin"), count("done"))
    flight.RECORDER.clear()
    kvg = KVShardGroup(2, mode="inproc")
    kvg.start()
    try:
        plane = RecoveryPlane(_Floors(), kv_group=kvg)
        plane.start()
        try:
            kvg.servicers[0].kv_update({"layer": "emb", "ids": np.array([0, 2], np.int64),
                                        "values": np.ones((2, 2), np.float32)})
            assert kvg.servicers[0].mirror_flush(timeout=10.0)
            plane.on_shard_failure("kv", 0)
            deadline = time.monotonic() + 30.0
            while ("kv", 0, 1) not in plane.recoveries():
                assert time.monotonic() < deadline, "kv shard 0 not recovered in 30 s"
                time.sleep(0.02)
        finally:
            plane.stop()
        gens = {r["labels"]["shard"]: r["value"] for r in reg.snapshot()["edl_kv_generation"]}
        assert gens["0"] == 1.0
    finally:
        kvg.stop()
    events = [e for e in flight.RECORDER.snapshot() if e.get("shard_kind") == "kv"]
    kinds = [e["kind"] for e in events]
    assert kinds == ["recovery_begin", "generation_bump", "recovery_done"]
    assert [e["seq"] for e in events] == sorted(e["seq"] for e in events)
    assert events[2]["generation"] == 1
    assert (count("begin"), count("done")) == (before[0] + 1, before[1] + 1)

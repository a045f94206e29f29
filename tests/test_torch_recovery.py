"""The port's shard recovery plane and fencing against the reference's.

The same inputs go through `elasticdl_tpu` (rpc/fencing.py,
master/recovery.py and the shard groups) and `elasticdl_tpu_torch`:
the epoch check, the fenced handler sets, a fenced call on every tier
(terminal, never re-sent), the clients' epochs, the dedup ring after a
failed apply, a torn push healed by its replay, the PS failover from a
worker's upload (restored slice and versions), the unrecoverable PS
shard, the KV mirror and the KV failover from the ring pair (restored
rows), a single KV shard's empty relaunch, the version floor and
GetPSConfig, PSRestoreFromWorker without a plane, and the sparse apply's
ride through a KV recovery. Where the contract is host numpy (slices,
versions, rows) both sides are held bit for bit.

Then jobs: a torn-push job over 2 inproc shards whose shard 1 "dies"
before applying its 5th push (a test double that dies between a push's
fan-out and its apply) ends at the fault-free versions, [16, 16], as its fault-free
twin and the reference's fault-free run; a process-mode job over 2 PS
shard processes rides out a SIGKILLed shard at exact versions; an
unrecoverable shard makes the master exit 2; and the shm tier's
relaunch sweeps a SIGKILLed predecessor's segments by scope.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from elasticdl_tpu.api.model_spec_helpers import spec_from_module as jspec_from_module
from elasticdl_tpu.common import codec as jcodec
from elasticdl_tpu.master.kv_group import KVShardGroup as JKVShardGroup
from elasticdl_tpu.master.kv_shard import KVShardServicer as JKVShardServicer
from elasticdl_tpu.master.ps_group import PSShardGroup as JPSShardGroup
from elasticdl_tpu.master.ps_optimizer import PSOptimizer as JPSOptimizer
from elasticdl_tpu.master.ps_shard import PSShardServicer as JPSShardServicer
from elasticdl_tpu.master.recovery import RecoveryPlane as JRecoveryPlane
from elasticdl_tpu.master.servicer import MasterServicer as JServicer
from elasticdl_tpu.master.task_dispatcher import TaskDispatcher as JDispatcher
from elasticdl_tpu.models import transformer_lm as jtlm
from elasticdl_tpu.models import transformer_lm_zoo as jzoo
from elasticdl_tpu.rpc import fencing as jfencing
from elasticdl_tpu.rpc.ps_client import ShardedPS as JShardedPS
from elasticdl_tpu.testing import InProcessMaster as JInProcessMaster
from elasticdl_tpu.worker.worker import Worker as JWorker
from elasticdl_tpu_torch.api.model_spec_helpers import spec_from_module
from elasticdl_tpu_torch.common.constants import ENV_OPT_MIRROR_SECS, ENV_REGISTRY
from elasticdl_tpu_torch.master import main as master_main
from elasticdl_tpu_torch.master import ps_shard as ps_shard_mod
from elasticdl_tpu_torch.master.kv_group import KVShardGroup
from elasticdl_tpu_torch.master.kv_shard import KVShardServicer
from elasticdl_tpu_torch.master.ps_group import PSShardGroup
from elasticdl_tpu_torch.master.ps_shard import PSShardServicer
from elasticdl_tpu_torch.master.recovery import RecoveryPlane
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.models import transformer_lm_zoo as tzoo
from elasticdl_tpu_torch.models.record_codec import write_learnable_token_records
from elasticdl_tpu_torch.rpc import fencing, transport
from elasticdl_tpu_torch.rpc.client import RpcClient
from elasticdl_tpu_torch.rpc.kv_client import ShardedEmbeddingStore
from elasticdl_tpu_torch.rpc.policy import PolicyRpcError, RetryPolicy, StatusCode
from elasticdl_tpu_torch.rpc.ps_client import ShardedPS
from elasticdl_tpu_torch.rpc.server import RpcServer
from elasticdl_tpu_torch.testing import InProcessMaster, build_job
from elasticdl_tpu_torch.worker import main as worker_main
from elasticdl_tpu_torch.worker.worker import Worker
from _torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = os.path.join(REPO, "elasticdl_tpu_torch", "models")
VOCAB, SEQ, BATCH = 64, 64, 16


def _wait_until(predicate, timeout=20.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


class _Floors:
    """A master stand-in for driving a plane directly."""

    def __init__(self, floors=None):
        self.floors = dict(floors or {})

    def shard_version_floor(self, shard_id):
        return self.floors.get(int(shard_id), -1)


def _bits(a):
    return np.asarray(a, dtype=np.float32).tobytes()


# -- fencing epochs ---------------------------------------------------------------------


@pytest.mark.parametrize("req, generation", [
    ({}, 3), ({"epoch": -1}, 3), ({"epoch": None}, 3), ({"epoch": 3}, 3),
    ({"epoch": 2}, 3), ({"epoch": 4}, 3), ({"epoch": 0}, 0), ({"epoch": 1}, 0),
])
def test_check_epoch_semantics(req, generation):
    """Pass or raise as the reference does, with its message; the raised
    error is fenced and an outage on both sides."""
    outcomes = []
    for mod in (fencing, jfencing):
        try:
            mod.check_epoch(dict(req), generation, "kv", 1)
            outcomes.append(None)
        except mod.EpochFencedError as e:
            assert (e.kind, e.shard_id, e.generation) == ("kv", 1, generation)
            assert mod.is_fenced_error(e) and mod.is_shard_outage(e)
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert fencing.UNFENCED == jfencing.UNFENCED


def _stale_requests(n=4):
    zeros = np.zeros(n, np.float32)
    ids = np.array([0, 2], np.int64)
    return {
        "PSInit": {"vec": zeros, "version": 0}, "PSPull": {},
        "PSPushGrad": {"grad": zeros, "version": 0},
        "PSPushDelta": {"delta": zeros, "steps": 1, "base_version": 0},
        "PSOptState": {}, "PSOptRestore": {"leaves": None},
        "KVLookup": {"layer": "emb", "ids": ids},
        "KVUpdate": {"layer": "emb", "ids": ids, "values": np.ones((2, 2), np.float32)},
        "KVSnapshot": {}, "KVRestore": {"layers": {}}, "KVLen": {},
    }


@pytest.mark.parametrize("kind", ["ps", "kv"])
def test_every_ps_and_kv_shard_rpc_is_fenced_except_the_declared_set(kind):
    """The fenced handlers are the reference's over the ported methods;
    each rejects a stale epoch and serves the current one."""
    if kind == "ps":
        port, ref = PSShardServicer(0, 1, generation=2), JPSShardServicer(0, 1, generation=2)
        port.init_slice({"vec": np.zeros(4, np.float32), "version": 0, "epoch": 2})
    else:
        port, ref = KVShardServicer(0, 1, generation=2), JKVShardServicer(0, 1, generation=2)
    fenced = set(port.handlers()) - port.UNFENCED_HANDLERS
    ref_fenced = set(ref.handlers()) - ref.UNFENCED_HANDLERS
    assert fenced == ref_fenced & set(port.handlers())
    assert port.UNFENCED_HANDLERS - set(port.handlers()) == set()
    reqs = _stale_requests()
    for method in sorted(fenced):
        with pytest.raises(fencing.EpochFencedError):
            port.handlers()[method](dict(reqs[method], epoch=1))
        port.handlers()[method](dict(reqs[method], epoch=2))
    if kind == "kv":
        port.close()
        ref.close()


@pytest.mark.parametrize("tier", ["grpc", "uds", "shm", "inproc"])
def test_fenced_rpc_is_terminal_outage_not_retried(tier, monkeypatch, tmp_path):
    """Over every tier: a stale epoch answers FAILED_PRECONDITION naming
    the exception, the retry policy never re-sends it, the shard applied
    nothing, and the client classifies it as a fenced shard outage."""
    import tempfile

    uds = tempfile.mkdtemp(prefix="edlt")
    monkeypatch.setenv("EDL_UDS_DIR", uds)
    monkeypatch.setenv("EDL_TRANSPORT", "auto")
    group = PSShardGroup(1, mode="inproc", use_async=True)
    group.start()
    try:
        group.ensure_init(np.zeros(4, np.float32))
        group.relaunch_shard(0)  # generation 0 -> 1
        monkeypatch.setenv("EDL_TRANSPORT", tier)
        sleeps = []
        client = RpcClient(group.endpoints[0], policy=RetryPolicy(sleep_fn=sleeps.append))
        assert client.tier == {"grpc": "tcp"}.get(tier, tier)
        try:
            with pytest.raises(PolicyRpcError) as ei:
                client.call("PSPushGrad", {"grad": np.ones(4, np.float32), "version": 0,
                                           "report_key": "k", "epoch": 0}, timeout=10)
            assert ei.value.code() is StatusCode.FAILED_PRECONDITION
            assert "EpochFencedError" in ei.value.details()
            assert fencing.is_fenced_error(ei.value) and fencing.is_shard_outage(ei.value)
            assert sleeps == []  # never re-sent
            assert group.servicers[0].stats()["applied_pushes"] == 0
        finally:
            client.close()
    finally:
        group.stop()
        import shutil

        shutil.rmtree(uds, ignore_errors=True)


def test_sharded_ps_client_stamps_and_updates_epochs():
    """A client at stale generations bounces off the relaunched shard as
    an outage; updated, it reads the reference's versions ([0, -1]: the
    relaunched shard boots empty)."""
    out = []
    for group_cls, client_cls, fmod in ((PSShardGroup, ShardedPS, fencing),
                                        (JPSShardGroup, JShardedPS, jfencing)):
        group = group_cls(2, mode="inproc", use_async=True)
        group.start()
        try:
            group.ensure_init(np.zeros(8, np.float32))
            ps = client_cls(group.endpoints, 8, generations=[0, 0])
            group.relaunch_shard(1)
            assert group.generations == [0, 1]
            with pytest.raises(Exception) as ei:
                ps.pull()
            assert fmod.is_shard_outage(ei.value)
            ps.update_endpoints(group.endpoints, group.generations)
            out.append(ps.pull()[0])
            ps.close()
        finally:
            group.stop()
    assert out[0] == out[1] == [0, -1]


def _refence(group_cls, client_cls, kind):
    """Bump every slot in place: state survives, the group's client
    follows, a client at the old generations bounces as fenced, a stale
    bump is refused, and the current one is idempotent."""
    from elasticdl_tpu.rpc.client import RpcClient as JRpcClient

    group = group_cls(2, mode="inproc", use_async=True) if kind == "ps" else group_cls(
        2, mode="inproc")
    group.start()
    try:
        if kind == "ps":
            group.ensure_init(np.arange(8, dtype=np.float32), version=3)
            stale = client_cls(group.endpoints, 8, generations=[0, 0])
            read = lambda c: c.pull()[0]  # noqa: E731
        else:
            store = group.store()
            store.update("emb", np.array([0, 1], np.int64), np.ones((2, 2), np.float32))
            stale = client_cls(group.endpoints, generations=[0, 0])
            read = lambda c: c.lookup("emb", np.array([0, 1], np.int64))[1].tolist()  # noqa: E731
        before = read(stale)
        gens = group.refence()
        fenced = False
        try:
            read(stale)
        except Exception as e:
            fenced = (fencing if client_cls in (ShardedPS, ShardedEmbeddingStore)
                      else jfencing).is_fenced_error(e)
        own = read(group.client() if kind == "ps" else group.store())
        method = "PSRefence" if kind == "ps" else "KVRefence"
        rpc_cls = RpcClient if client_cls in (ShardedPS, ShardedEmbeddingStore) else JRpcClient
        c = rpc_cls(group.endpoints[0])
        try:
            again = c.call(method, {"generation": 1}, timeout=10)["generation"]
            try:
                c.call(method, {"generation": 0}, timeout=10)
                refused = False
            except Exception:
                refused = True
        finally:
            c.close()
        stale.close()
        return gens, before, fenced, own, again, refused
    finally:
        group.stop()


@pytest.mark.parametrize("kind", ["ps", "kv"])
def test_refence_moves_the_generations_in_place(kind):
    from elasticdl_tpu.rpc.kv_client import ShardedEmbeddingStore as JStore

    if kind == "ps":
        port = _refence(PSShardGroup, ShardedPS, kind)
        ref = _refence(JPSShardGroup, JShardedPS, kind)
    else:
        port = _refence(KVShardGroup, ShardedEmbeddingStore, kind)
        ref = _refence(JKVShardGroup, JStore, kind)
    assert port == ref
    gens, before, fenced, own, again, refused = port
    assert gens == [1, 1] and own == before and fenced and again == 1 and refused


# -- the dedup ring and the replay --------------------------------------------------------


def test_failed_apply_is_not_registered_as_duplicate():
    """A push that fails mid-apply leaves its key unregistered: the
    resend applies, the next one dedups; responses and stats as the
    reference's."""
    runs = []
    for cls in (PSShardServicer, JPSShardServicer):
        shard = cls(0, 1, use_async=True)
        shard.init_slice({"vec": np.zeros(4, np.float32), "version": 0})
        with pytest.raises(ValueError, match="grad slice shape"):
            shard.push_grad({"grad": np.ones(2, np.float32), "version": 0, "report_key": "k1"})
        good = {"grad": np.ones(4, np.float32), "version": 0, "report_key": "k1"}
        first, second = shard.push_grad(dict(good)), shard.push_grad(dict(good))
        st = shard.stats()
        runs.append((first["version"], "duplicate" in first, second.get("duplicate"),
                     st["applied_pushes"], st["duplicate_pushes"],
                     _bits(shard.pull({})["vec"])))
    assert runs[0] == runs[1]
    assert runs[0][:5] == (1, False, True, 1, 1)


def _torn_replay(group_cls, client_cls):
    group = group_cls(2, mode="inproc", use_async=True)
    group.start()
    try:
        n = 10
        vec0 = np.arange(n, dtype=np.float32)
        group.ensure_init(vec0, version=0)
        ps = client_cls(group.endpoints, n, generations=list(group.generations))
        grad = np.full(n, 0.5, np.float32)
        versions, vec_after = ps.push_grad(grad, [0, 0], return_model=True, report_key="torn")
        # the torn push: shard 1 rolled back to the pre-push state, as
        # the plane rebuilds it from a worker's snapshot
        s, e = ps.bounds[1]
        group.relaunch_shard(1)
        ps.update_endpoints(group.endpoints, group.generations)
        ps._clients[1].call("PSInit", {"vec": vec0[s:e], "version": 0,
                                       "epoch": group.generations[1]})
        assert group.servicers[1].version == 0
        replayed, vec_replayed = ps.push_grad(grad, [0, 0], return_model=True,
                                              report_key="torn")
        st = [sv.stats() for sv in group.servicers]
        ps.close()
        return (list(versions), list(replayed), _bits(vec_after), _bits(vec_replayed),
                st[0]["duplicate_pushes"], st[1]["applied_pushes"], st[1]["duplicate_pushes"])
    finally:
        group.stop()


def test_push_replay_same_key_heals_torn_report():
    """The replay under the torn push's key: shard 0 dedups, the
    restored shard 1 applies; versions and the model bit for bit the
    untorn push's and the reference's."""
    port = _torn_replay(PSShardGroup, ShardedPS)
    ref = _torn_replay(JPSShardGroup, JShardedPS)
    assert port == ref
    assert port[0] == port[1] == [1, 1] and port[2] == port[3]
    assert port[4:] == (1, 1, 0)


# -- PS failover through the plane ---------------------------------------------------------


def _ps_failover(group_cls, plane_cls, opt_factory, upload):
    group = group_cls(2, mode="inproc", use_async=True, optimizer_factory=opt_factory)
    group.start()
    try:
        n = 10
        group.ensure_init(np.arange(n, dtype=np.float32), version=0)
        client = group.client()
        client.push_grad(np.full(n, 0.5, np.float32), [0, 0], return_model=True)
        plane = plane_cls(_Floors({1: 1}), ps_group=group, restore_deadline=20.0,
                          opt_mirror_interval=0.05)
        plane.start()
        try:
            _wait_until(lambda: plane.opt_ring_depth(1) >= 1, what="opt mirror ring")
            s, e = client.bounds[1]
            refused = plane.offer_upload(0, 1, upload[s:e], 1)  # a healthy shard
            plane.on_shard_failure("ps", 1)
            _wait_until(lambda: 1 in plane.status()["ps"], what="shard 1 fenced")
            accepted = plane.offer_upload(7, 1, upload[s:e], 1)
            _wait_until(lambda: ("ps", 1, 1) in plane.recoveries(), what="shard 1 recovery")
            versions, vec = group.assemble()
            opt_ready = group.servicers[1]._opt.initialized
            gens = list(group.generations)
            assert plane.states()[("ps", 1)] == "ACTIVE"
            # another event adds no recovery (with no upload, this one
            # gives up)
            plane.on_shard_failure("ps", 1)
            time.sleep(0.2)
            return (refused, accepted, gens, versions, _bits(vec[s:e]),
                    [r for r in plane.recoveries() if r[0] == "ps"], opt_ready)
        finally:
            plane.stop()
    finally:
        group.stop()


def test_ps_failover_restores_from_worker_upload():
    """The same upload through both planes: the relaunched shard holds
    it bit for bit at the reference's versions and generations, its
    optimizer state from the mirror ring."""
    upload = (np.arange(10, dtype=np.float32) * 0.75 - 1.0).astype(np.float32)
    port = _ps_failover(PSShardGroup, RecoveryPlane, tzoo.optimizer, upload)
    ref = _ps_failover(JPSShardGroup, JRecoveryPlane, jzoo.optimizer, upload)
    assert port == ref
    refused, accepted, gens, versions, restored, recoveries, opt_ready = port
    assert (refused, accepted, gens, versions) == (False, True, [0, 1], [1, 1])
    assert restored == _bits(upload[5:10]) and recoveries == [("ps", 1, 1)] and opt_ready


@pytest.mark.parametrize("which", ["port", "reference"])
def _unreported_ack(group_cls, plane_cls, opt_factory):
    """Shard 1 acknowledged two pushes (v2) but the master saw only the
    first (its floor for the shard at 1) when the shard died: an upload
    at v1 meets the fence, and the shard is restored a push short."""
    group = group_cls(2, mode="inproc", use_async=True, optimizer_factory=opt_factory)
    group.start()
    try:
        n = 10
        group.ensure_init(np.arange(n, dtype=np.float32), version=0)
        client = group.client()
        _v, snapshot = client.push_grad(np.full(n, 0.5, np.float32), [0, 0], return_model=True)
        acked, _vec = client.push_grad(np.full(n, 0.25, np.float32), [1, 1], return_model=True)
        plane = plane_cls(_Floors({1: 1}), ps_group=group, restore_deadline=20.0)
        plane.start()
        try:
            plane.on_shard_failure("ps", 1)
            _wait_until(lambda: 1 in plane.status()["ps"], what="shard 1 fenced")
            s, e = client.bounds[1]
            accepted = plane.offer_upload(7, 1, snapshot[s:e], 1)
            _wait_until(lambda: ("ps", 1, 1) in plane.recoveries(), what="shard 1 recovery")
            versions, vec = group.assemble()
            return acked, accepted, versions, _bits(vec[s:e]) == _bits(snapshot[s:e])
        finally:
            plane.stop()
    finally:
        group.stop()


def test_the_restore_fence_is_the_reported_version_as_the_reference():
    """Both planes take the fence from the versions the master saw
    reported, when the recovery begins: a push the dead shard had
    acknowledged whose report was still on its way is below it, so both
    restore the shard from an older upload, one version short of its
    partner, and call the restore exact. A reference quirk, kept; the
    torn-push job test gates each report with its fan-out
    (`_one_report_at_a_time`)."""
    port = _unreported_ack(PSShardGroup, RecoveryPlane, tzoo.optimizer)
    ref = _unreported_ack(JPSShardGroup, JRecoveryPlane, jzoo.optimizer)
    assert port == ref == ([2, 2], True, [2, 1], True)


@pytest.mark.parametrize("which", ["port", "reference"])
def test_ps_failover_unrecoverable_without_upload(which):
    group_cls, plane_cls = ((PSShardGroup, RecoveryPlane) if which == "port"
                            else (JPSShardGroup, JRecoveryPlane))
    group = group_cls(2, mode="inproc", use_async=True)
    group.start()
    try:
        group.ensure_init(np.zeros(6, np.float32))
        failed = []
        plane = plane_cls(_Floors(), ps_group=group, restore_deadline=0.3,
                          on_unrecoverable=lambda kind, sid: failed.append((kind, sid)))
        plane.start()
        try:
            plane.on_shard_failure("ps", 0)
            _wait_until(lambda: failed, what="the unrecoverable callback")
            assert failed == [("ps", 0)]
            status = plane.status()
            assert (status["ps"], status["kv"]) == ([], [])
        finally:
            plane.stop()
    finally:
        group.stop()


# -- KV mirroring and failover -----------------------------------------------------------


def _kv_rows():
    return "emb", np.array([0, 2, 4], np.int64), np.arange(6, dtype=np.float32).reshape(3, 2)


def _rows(layers, layer):
    entry = layers[layer]
    order = np.argsort(np.asarray(entry["ids"]))
    return np.asarray(entry["ids"])[order].tolist(), _bits(np.asarray(entry["values"])[order])


def test_kv_mirror_forwards_and_snapshots():
    out = []
    for cls in (KVShardGroup, JKVShardGroup):
        kvg = cls(2, mode="inproc")
        kvg.start()
        try:
            kvg.wire_mirrors()
            layer, ids, values = _kv_rows()
            kvg.servicers[0].kv_update({"layer": layer, "ids": ids, "values": values})
            assert kvg.servicers[0].mirror_flush(timeout=10.0)
            # the reference's flush returns once its queue is empty, before
            # the write it took off the queue has reached the pair (the
            # port's waits for the delivery): wait for the sent count
            _wait_until(lambda: kvg.servicers[0].stats()["mirrored_writes"] == 1,
                        what="the mirror write delivered")
            snap = kvg.servicers[1].kv_mirror_snapshot({"source_shard": 0})
            out.append((_rows(snap["layers"], layer), kvg.servicers[1].stats()["n"],
                        kvg.servicers[0].kv_mirror_snapshot({"source_shard": 1})["layers"]))
        finally:
            kvg.stop()
    assert out[0] == out[1]
    assert out[0][0][0] == [0, 2, 4] and out[0][1] == 0 and out[0][2] == {}


def _kv_failover(group_cls, plane_cls):
    kvg = group_cls(2, mode="inproc")
    kvg.start()
    try:
        plane = plane_cls(_Floors(), kv_group=kvg)
        plane.start()  # wires the ring
        try:
            layer, ids, values = _kv_rows()
            kvg.servicers[0].kv_update({"layer": layer, "ids": ids, "values": values})
            assert kvg.servicers[0].mirror_flush(timeout=10.0)
            old = kvg.servicers[0]
            plane.on_shard_failure("kv", 0)
            _wait_until(lambda: ("kv", 0, 1) in plane.recoveries(), what="kv shard 0 recovery")
            assert kvg.servicers[0] is not old
            got, unknown = kvg.servicers[0]._store.lookup(layer, ids)
            # the ring points at the relaunched shard: the pair's writes
            # mirror back to it
            kvg.servicers[1].kv_update({"layer": layer, "ids": np.array([1], np.int64),
                                        "values": np.ones((1, 2), np.float32)})
            assert kvg.servicers[1].mirror_flush(timeout=10.0)
            _wait_until(lambda: kvg.servicers[0].kv_mirror_snapshot(
                {"source_shard": 1})["layers"], what="re-pointed mirror delivery")
            return list(kvg.generations), np.asarray(unknown).tolist(), _bits(got)
        finally:
            plane.stop()
    finally:
        kvg.stop()


def test_kv_failover_restores_rows_from_ring_pair():
    port = _kv_failover(KVShardGroup, RecoveryPlane)
    ref = _kv_failover(JKVShardGroup, JRecoveryPlane)
    assert port == ref == ([1, 0], [], _bits(_kv_rows()[2]))


@pytest.mark.parametrize("which", ["port", "reference"])
def test_kv_single_shard_relaunches_empty(which):
    group_cls, plane_cls = ((KVShardGroup, RecoveryPlane) if which == "port"
                            else (JKVShardGroup, JRecoveryPlane))
    kvg = group_cls(1, mode="inproc")
    kvg.start()
    try:
        plane = plane_cls(_Floors(), kv_group=kvg)
        plane.start()
        try:
            layer, ids, values = _kv_rows()
            kvg.servicers[0].kv_update({"layer": layer, "ids": ids, "values": values})
            plane.on_shard_failure("kv", 0)
            _wait_until(lambda: ("kv", 0, 1) in plane.recoveries(), what="kv relaunch")
            assert kvg.servicers[0].stats()["n"] == 0 and kvg.servicers[0].generation == 1
        finally:
            plane.stop()
    finally:
        kvg.stop()


# -- the master servicer ----------------------------------------------------------------


def _floor_run(servicer):
    servicer.report_window_meta({"versions": [3, 5], "loss": 0.1})
    servicer.report_window_meta({"versions": [2, 6], "loss": 0.1})
    return [servicer.shard_version_floor(i) for i in range(3)], servicer.version


def test_crossed_fan_outs_leave_the_mirror_behind_as_the_reference():
    """Two workers' pushes cross between the shards: one reports shard
    versions [16, 15], the other [15, 16]. Both packages advance the
    mirror to the maximum of each report's minimum, so it stays at 15
    while every shard is at 16; each shard's maximum (the restore floor)
    is 16. A reference quirk, kept: an undercount of one version until
    the next report."""
    group = PSShardGroup(2, mode="inproc", use_async=True)
    jgroup = JPSShardGroup(2, mode="inproc", use_async=True)
    group.start()
    jgroup.start()
    try:
        spec = spec_from_module(tzoo, model=tzoo.custom_model(vocab=VOCAB))
        servicer, _e, _c = build_job(spec, None, ps_group=group)
        jservicer = JServicer(1, JPSOptimizer(jzoo.optimizer()))
        jservicer._ps_group = jservicer.ps_group = jgroup
        out = []
        for sv in (servicer, jservicer):
            sv.report_window_meta({"versions": [14, 14], "loss": 0.1})
            sv.report_window_meta({"versions": [16, 15], "loss": 0.1})
            sv.report_window_meta({"versions": [15, 16], "loss": 0.1})
            out.append((sv.version, [sv.shard_version_floor(i) for i in range(2)]))
        assert out[0] == out[1] == (15, [16, 16])
    finally:
        group.stop()
        jgroup.stop()


def test_shard_version_floor_mirror_and_ps_config():
    """Each shard's maximum reported version, as the reference's; the
    mirror advances to the minimum and counts as applied steps;
    GetPSConfig advertises the generations and the plane's lists, and a
    restore upload reaches the plane."""
    group = PSShardGroup(2, mode="inproc", use_async=True)
    jgroup = JPSShardGroup(2, mode="inproc", use_async=True)
    group.start()
    jgroup.start()
    try:
        spec = spec_from_module(tzoo, model=tzoo.custom_model(vocab=VOCAB))
        servicer, _e, _c = build_job(spec, None, ps_group=group)
        jservicer = JServicer(1, JPSOptimizer(jzoo.optimizer()))
        jservicer._ps_group = jservicer.ps_group = jgroup
        assert servicer.shard_version_floor(0) == jservicer.shard_version_floor(0) == -1
        assert _floor_run(servicer) == _floor_run(jservicer) == ([3, 6, -1], 3)
        assert servicer.exactness() == {"version": 3, "init_version": 0,
                                        "applied_update_steps": 3}
        cfg = servicer.get_ps_config({})
        assert cfg["endpoints"] == group.endpoints and cfg["ps_generations"] == [0, 0]
        assert cfg["recovering"] == {"ps": [], "kv": []} and cfg["kv_generations"] == []

        class _Plane:
            def status(self):
                return {"ps": [1], "kv": []}

            def offer_upload(self, worker_id, shard_id, vec, version):
                self.seen = (worker_id, shard_id, version, _bits(vec))
                return True

        plane = _Plane()
        servicer.set_recovery_plane(plane)
        assert servicer.get_ps_config({})["recovering"] == {"ps": [1], "kv": []}
        vec = np.arange(4, dtype=np.float32)
        resp = servicer.ps_restore_from_worker(
            {"worker_id": 3, "shard_id": 1, "vec": vec, "version": 7})
        assert resp == {"accepted": True} and plane.seen == (3, 1, 7, _bits(vec))
    finally:
        group.stop()
        jgroup.stop()


def test_ps_restore_from_worker_without_plane_is_rejected():
    spec = spec_from_module(tzoo, model=tzoo.custom_model(vocab=VOCAB))
    servicer, _e, _c = build_job(spec, None)
    jservicer = JServicer(1, JPSOptimizer(jzoo.optimizer()))
    req = {"worker_id": 0, "shard_id": 0, "vec": np.zeros(2, np.float32), "version": 0}
    assert servicer.ps_restore_from_worker(dict(req)) == jservicer.ps_restore_from_worker(
        dict(req)) == {"accepted": False}


class _SparseOpt:
    def __init__(self, error):
        self.calls = 0
        self._error = error

    def apply_gradients(self, grads):
        self.calls += 1
        if self.calls == 1:
            raise self._error


class _KVPlane:
    def __init__(self):
        self.polls = 0

    def status(self):
        self.polls += 1
        return {"ps": [], "kv": [0] if self.polls < 2 else []}


def _sparse_servicer(cls, error, plane):
    sv = cls.__new__(cls)
    sv._sparse_lock = threading.Lock()
    sv._sparse_opt = _SparseOpt(error)
    sv._recovery_plane = plane
    sv.sparse_apply_seconds = 0.0
    return sv


def test_sparse_apply_rides_through_kv_recovery():
    """A KV shard's outage mid sparse-apply waits out the recovery and
    applies again (twice in all, as the reference); without a plane the
    outage propagates, and an error that is no outage always does."""
    import grpc

    class _JErr(grpc.RpcError):
        def code(self):
            return grpc.StatusCode.UNAVAILABLE

    outage = PolicyRpcError(StatusCode.UNAVAILABLE, "kv shard gone")
    sv = _sparse_servicer(MasterServicer, outage, _KVPlane())
    jsv = _sparse_servicer(JServicer, _JErr(), _KVPlane())
    sv._apply_sparse({"emb": object()})
    jsv._apply_sparse({"emb": object()})
    assert sv._sparse_opt.calls == jsv._sparse_opt.calls == 2
    assert sv.sparse_apply_seconds > 0
    with pytest.raises(PolicyRpcError):
        _sparse_servicer(MasterServicer, outage, None)._apply_sparse({"emb": object()})
    with pytest.raises(ValueError):
        _sparse_servicer(MasterServicer, ValueError("bad rows"), _KVPlane())._apply_sparse(
            {"emb": object()})


def test_opt_mirror_env_is_registered():
    assert ENV_OPT_MIRROR_SECS == "EDL_OPT_MIRROR_SECS" and ENV_OPT_MIRROR_SECS in ENV_REGISTRY


# -- lock discipline of the counters the recovery plane's code touches -----------------


class _OwnedLock:
    """A lock that knows which thread holds it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._owner = None

    def __enter__(self):
        self._lock.acquire()
        self._owner = threading.get_ident()
        return self

    def __exit__(self, *exc):
        self._owner = None
        self._lock.release()

    def held(self) -> bool:
        return self._owner == threading.get_ident()


class _AuditedWorker(Worker):
    """Records every write of `edl_gradient_bytes` made without
    `_stats_lock` (window mode's sync threads add to it too)."""

    def __setattr__(self, name, value):
        lock = self.__dict__.get("_stats_lock")
        if name == "edl_gradient_bytes" and isinstance(lock, _OwnedLock) and not lock.held():
            self.__dict__.setdefault("unlocked", []).append(sys._getframe(1).f_code.co_name)
        object.__setattr__(self, name, value)


class _AuditedServicer(MasterServicer):
    """Records every read of `sparse_apply_seconds` made without
    `_sparse_lock` (the sparse apply adds to it under that lock)."""

    def __getattribute__(self, name):
        if name == "sparse_apply_seconds":
            lock = object.__getattribute__(self, "__dict__").get("_sparse_lock")
            if isinstance(lock, _OwnedLock) and not lock.held():
                object.__getattribute__(self, "unlocked").append(sys._getframe(1).f_code.co_name)
        return object.__getattribute__(self, name)


def test_sparse_counters_are_read_and_written_under_their_locks(tmp_path):
    """A deepfm per-step job in-process: the worker adds every report's
    `edl_gradient` bytes under `_stats_lock`, and the servicer's
    `sparse_summary` reads the sparse apply's seconds under
    `_sparse_lock`."""
    from elasticdl_tpu_torch.master.embedding_store import EmbeddingStore
    from elasticdl_tpu_torch.models import deepfm_edl_embedding as tdeepfm
    from elasticdl_tpu_torch.models.record_codec import write_synthetic_tabular_records

    path = str(tmp_path / "t.rio")
    write_synthetic_tabular_records(path, 64, tdeepfm.NUM_FIELDS, 500, seed=0)
    spec = spec_from_module(tdeepfm)
    servicer, _e, _c = build_job(spec, TaskDispatcher({path: 64}, {}, {}, 32, 1, shuffle_seed=1),
                                 embedding_store=EmbeddingStore())
    servicer.__class__ = _AuditedServicer
    servicer.unlocked = []
    servicer._sparse_lock = _OwnedLock()
    worker = _AuditedWorker(0, InProcessMaster(servicer), spec, minibatch_size=16, device="cpu")
    worker._stats_lock = _OwnedLock()
    assert worker.run()
    worker.close()
    assert worker.edl_gradient_bytes > 0 and worker.__dict__.get("unlocked", []) == []
    summary = servicer.sparse_summary()
    assert summary["apply_seconds"] > 0 and servicer.unlocked == []


# -- jobs --------------------------------------------------------------------------------


@pytest.fixture
def records(tmp_path):
    path = str(tmp_path / "tokens.rio")
    write_learnable_token_records(path, 128, SEQ, VOCAB, seed=4)
    return path


def _init():
    return jtlm.init_params(np.random.default_rng(5), jzoo.custom_model(vocab=VOCAB).cfg)


def _ref_fault_free(path, init):
    """The reference's job: 2 workers in threads, per-step under a
    staleness window of 1, over 2 inproc shards; the shard versions."""
    group = JPSShardGroup(2, mode="inproc", optimizer_factory=jzoo.optimizer,
                          staleness_window=1, fanin_combine=False)
    group.start()
    try:
        dispatcher = JDispatcher({path: 128}, {}, {}, 16, 2, shuffle_seed=3)
        jspec = jspec_from_module(jzoo, model=jzoo.custom_model(vocab=VOCAB))
        servicer = JServicer(1, JPSOptimizer(jzoo.optimizer()), task_dispatcher=dispatcher,
                             init_params=init, staleness_window=1, ps_group=group)
        group.ensure_init(jcodec.ravel_np(init), 0)
        master = JInProcessMaster(servicer)
        workers = [JWorker(i, master, jspec, minibatch_size=BATCH,
                           ps_endpoints=group.endpoints) for i in range(2)]
        _run_threads(workers)
        assert dispatcher.finished()
        return group.assemble()[0]
    finally:
        group.stop()


def _run_threads(workers):
    results = [None] * len(workers)

    def run(i):
        results[i] = workers[i].run()
        workers[i].close()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(workers))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert results == [True] * len(workers)


class _CrashingShard(PSShardServicer):
    """A test double of a shard process that dies before applying its
    n-th PSPushGrad: from then on every call fails as a dead endpoint
    does (UNAVAILABLE), and the death is reported to the plane, as its
    monitor reports a process's."""

    def __init__(self, *a, nth=5, on_death=None, **kw):
        super().__init__(*a, **kw)
        self._nth, self._on_death = nth, on_death
        self._grads, self.dead = 0, False

    def handlers(self):
        def guard(fn):
            def call(req):
                if self.dead:
                    raise PolicyRpcError(StatusCode.UNAVAILABLE, "shard process gone")
                return fn(req)
            return call

        return {m: guard(fn) for m, fn in super().handlers().items()}

    def push_grad(self, req):
        self._grads += 1
        if self._grads == self._nth:
            self.dead = True
            threading.Thread(target=self._on_death, daemon=True).start()
            raise PolicyRpcError(StatusCode.UNAVAILABLE, "shard process gone")
        return super().push_grad(req)


def _one_report_at_a_time(monkeypatch):
    """Each worker's whole per-step report under one lock: the lock is
    taken before its fan-out to the shards (ShardedPS.push_grad) and
    given back once the master has its ReportWindowMeta, or at once
    when the fan-out fails (the worker then waits out the shard's
    recovery without it, and takes it again for the replay). So:
    - two workers' fan-outs cannot cross between the shards. Crossed,
      each worker gets shard versions one behind on a different shard
      ([16, 15] and [15, 16]), and the master's mirror, the maximum of
      each report's minimum as in the reference, stays at 15 (pinned by
      `test_crossed_fan_outs_leave_the_mirror_behind_as_the_reference`);
    - no push a shard acknowledged is still unreported when a shard
      dies. The recovery plane's fence is the highest version the master
      saw the shard acknowledge, read when the recovery begins; a push
      acknowledged but not yet reported is under it, an upload from
      before that push meets it, and the restored shard ends one push
      short ([16, 15], the mirror at 15), as the reference's would
      (pinned by `test_the_restore_fence_is_the_reported_version_as_the_reference`)."""
    lock = threading.Lock()
    push_grad, call = ShardedPS.push_grad, InProcessMaster.call

    def gated_push(self, *args, **kwargs):
        lock.acquire()
        try:
            return push_grad(self, *args, **kwargs)
        except BaseException:
            lock.release()
            raise

    def gated_call(self, method, request=None):
        try:
            return call(self, method, request)
        finally:
            if method == "ReportWindowMeta":
                lock.release()

    monkeypatch.setattr(ShardedPS, "push_grad", gated_push)
    monkeypatch.setattr(InProcessMaster, "call", gated_call)


def _port_job(path, init, crash: bool, monkeypatch):
    """The port's job as the reference's; with `crash`, shard 1 (at
    generation 0) is a `_CrashingShard`. The caller gates the workers'
    reports one at a time (`_one_report_at_a_time`), so the master's
    mirror and the restore fence keep up with the shards' versions.
    Returns (shard versions, recoveries, generations, workers)."""
    plane_box = []
    if crash:
        def make(shard_id, num_shards, generation=0, **kw):
            if shard_id == 1 and generation == 0:
                return _CrashingShard(shard_id, num_shards, generation=generation, nth=5,
                                      on_death=lambda: plane_box[0].on_shard_failure("ps", 1),
                                      **kw)
            return PSShardServicer(shard_id, num_shards, generation=generation, **kw)

        monkeypatch.setattr(ps_shard_mod, "PSShardServicer", make)
    group = PSShardGroup(2, mode="inproc", optimizer_factory=tzoo.optimizer,
                         staleness_window=1, num_workers=2)
    group.start()
    monkeypatch.setattr(ps_shard_mod, "PSShardServicer", PSShardServicer)
    try:
        dispatcher = TaskDispatcher({path: 128}, {}, {}, 16, 2, shuffle_seed=3)
        spec = spec_from_module(tzoo, model=tzoo.custom_model(vocab=VOCAB))
        servicer, _e, _c = build_job(spec, dispatcher, init_params=init, staleness_window=1,
                                     ps_group=group)
        plane = RecoveryPlane(servicer, ps_group=group, opt_mirror_interval=0.25)
        plane_box.append(plane)
        servicer.set_recovery_plane(plane)
        plane.start()
        try:
            master = InProcessMaster(servicer)
            workers = [Worker(i, master, spec, minibatch_size=BATCH, device="cpu",
                              ps_endpoints=group.endpoints) for i in range(2)]
            _run_threads(workers)
            assert dispatcher.finished() and not dispatcher.has_failed_tasks()
            assert servicer.exactness()["version"] == 16
            workers.append(group.servicers[0].stats()["duplicate_pushes"])
            return group.assemble()[0], plane.recoveries(), list(group.generations), workers
        finally:
            plane.stop()
    finally:
        group.stop()


def test_torn_push_job_ends_at_the_fault_free_versions(records, monkeypatch):
    """256 records in minibatches of 16 on 2 workers: shard 1 dies before
    its 5th push, tearing it across the fan-out. The plane relaunches it
    at generation 1 from a worker's upload, the torn push is replayed
    under its key, and both shards end at 16, as the fault-free twin and
    the reference's fault-free run."""
    _one_report_at_a_time(monkeypatch)
    init = _init()
    torn, recoveries, gens, workers = _port_job(records, init, True, monkeypatch)
    twin, twin_recoveries, _g, twin_workers = _port_job(records, init, False, monkeypatch)
    ref = _ref_fault_free(records, init)
    assert torn == twin == ref == [16, 16]
    assert recoveries == [("ps", 1, 1)] and gens == [0, 1] and twin_recoveries == []
    # shard 0 had applied the torn push: it absorbed the replay
    dups = workers.pop()
    assert dups >= 1 and twin_workers.pop() == 0
    assert sum(w.shard_recoveries_observed for w in workers) >= 1
    assert sum(w.restore_uploads for w in workers) >= 1
    assert all(np.isfinite(w.task_losses).all() for w in workers)


def _process_argv(data, tmp_path, extra):
    return ["--model_zoo", ZOO, "--model_def", "transformer_lm_zoo.custom_model",
            "--model_params", f"vocab={VOCAB}", "--minibatch_size", str(BATCH),
            "--training_data_dir", str(data), "--records_per_task", "32",
            "--num_epochs", "2", "--num_workers", "2", "--device", "cpu",
            "--local_updates", "2",
            "--num_ps", "2", "--ps_mode", "process", "--envs", "OMP_NUM_THREADS=1",
            "--output", str(tmp_path / "m.ckpt")] + extra


def _process_job(records, tmp_path, monkeypatch, on_start, extra=()):
    import tempfile

    uds = tempfile.mkdtemp(prefix="edlt")
    monkeypatch.setenv("EDL_UDS_DIR", uds)
    monkeypatch.setenv("EDL_TRANSPORT", "shm")
    monkeypatch.setenv("EDL_WORKER_LOG_DIR", str(tmp_path / "logs"))
    data = tmp_path / "data"
    data.mkdir()
    os.rename(records, data / "tokens.rio")
    try:
        return master_main.run(_process_argv(data, tmp_path, list(extra)), on_start=on_start)
    finally:
        import shutil

        shutil.rmtree(uds, ignore_errors=True)


def _killer(shard_id, after_pushes, box):
    """on_start: SIGKILL PS shard `shard_id`'s process once its stats
    show `after_pushes` applied pushes."""
    def on_start(servicer):
        group = servicer.ps_group

        def watch():
            client = RpcClient(group.endpoints[shard_id])
            try:
                while client.call("PSStats", {})["applied_pushes"] < after_pushes:
                    time.sleep(0.02)
                box["pid"] = group.procs[shard_id].pid
                os.kill(box["pid"], signal.SIGKILL)
            finally:
                client.close()

        threading.Thread(target=watch, daemon=True).start()

    return on_start


def test_process_job_rides_out_a_sigkilled_ps_shard(records, tmp_path, monkeypatch):
    """master.main with 2 workers over 2 PS shard processes on shm, W 2:
    shard 1's process is SIGKILLed after its 3rd applied push. The job
    completes every record with exit 0, shard 1 relaunched at generation
    1 (a new process), and both shards and the master at the job's 16
    steps: 2 epochs of 128 records, 8 tasks of one 2-step window."""
    box = {}
    rc, summary = _process_job(records, tmp_path, monkeypatch, _killer(1, 3, box))
    assert rc == 0
    assert summary["recoveries"] == [["ps", 1, 1]] and summary["unrecoverable"] == []
    assert summary["generations"] == {"ps": [0, 1], "kv": []}
    assert [s["version"] for s in summary["ps_shards"]] == [16, 16]
    assert summary["version"] == 16 and summary["applied_update_steps"] == 16
    assert summary["ps_shards"][1]["pid"] != box["pid"]
    assert summary["ps_shards"][1]["generation"] == 1
    tl = summary["recovery_timelines"][0]
    assert tl["detected"] <= tl["relaunched"] <= tl["active"] and tl["exact"]
    workers = worker_main.read_summaries(str(tmp_path / "logs"))
    assert sum(w["shard_recoveries_observed"] for w in workers.values()) >= 1
    assert sum(w["restore_uploads"] for w in workers.values()) >= 1
    assert all(np.isfinite(w["losses"] + [x[2] for x in w["windows"]]).all()
               for w in workers.values())


def test_unrecoverable_shard_makes_the_master_exit_2(records, tmp_path, monkeypatch):
    """A relaunch that fails leaves the shard unrecoverable: the plane
    gives it up, the master aborts the job with exit 2, and chip_smoke.py's
    check of a failover phase fails on the summary."""
    def failing_relaunch(self, shard_id):
        raise RuntimeError("relaunch failed")

    monkeypatch.setattr(PSShardGroup, "relaunch_shard", failing_relaunch)
    box = {}
    killer = _killer(1, 1, box)

    def on_start(servicer):
        box["scope"] = f"{transport.SHM_SEGMENT_PREFIX}{servicer.ps_group._shm_ns}."
        killer(servicer)

    try:
        rc, summary = _process_job(records, tmp_path, monkeypatch, on_start)
    finally:
        # no relaunch swept the killed shard's segments
        transport._unlink_segments(box.get("scope", ""))
    assert rc == 2
    assert summary["unrecoverable"] == [["ps", 1]] and summary["recoveries"] == []
    assert "unrecoverable" in summary["recovery_timelines"][0]
    # chip_smoke.py's failover phases fail (and the script exits non-zero)
    # on such a summary, and pass on a recovered one
    import chip_smoke

    killed = dict(box, kill=time.time())
    assert chip_smoke.check_failover(summary, "ps", 1, killed)
    assert chip_smoke.check_failover(None, "ps", 1, killed)
    recovered = dict(summary, recoveries=[["ps", 1, 1]], unrecoverable=[],
                     generations={"ps": [0, 1], "kv": []})
    assert chip_smoke.check_failover(recovered, "ps", 1, killed) == []
    assert chip_smoke.check_failover(recovered, "ps", 1, {})  # never killed


def test_deepfm_process_job_rides_out_a_sigkilled_kv_shard(tmp_path, monkeypatch):
    """deepfm_edl_embedding over 2 KV shard processes, 2 workers, W 2, with
    an evaluation: KV shard 1's process is SIGKILLed mid-job. The plane
    restores its rows from its ring pair at generation 1; the job
    completes every record at its exact version with exit 0, the master
    served no row, the evaluation ran, and no row is duplicated: at most
    the rows still in the dead shard's mirror queue are missing."""
    from elasticdl_tpu_torch.models import deepfm_edl_embedding as tdeepfm
    from elasticdl_tpu_torch.models.record_codec import write_synthetic_tabular_records

    train, evals = tmp_path / "train", tmp_path / "eval"
    train.mkdir()
    evals.mkdir()
    for i in range(2):
        write_synthetic_tabular_records(str(train / f"s{i}.rio"), 128, tdeepfm.NUM_FIELDS,
                                        5000, seed=i)
    write_synthetic_tabular_records(str(evals / "e.rio"), 32, tdeepfm.NUM_FIELDS, 5000, seed=9)
    monkeypatch.setenv("EDL_WORKER_LOG_DIR", str(tmp_path / "logs"))
    box = {}

    def on_start(servicer):
        def watch():
            while servicer.exactness()["applied_update_steps"] < 4:
                time.sleep(0.01)
            box["pid"] = servicer.kv_group.procs[1].pid
            os.kill(box["pid"], signal.SIGKILL)

        threading.Thread(target=watch, daemon=True).start()

    rc, summary = master_main.run([
        "--model_zoo", ZOO, "--model_def", "deepfm_edl_embedding.custom_model",
        "--minibatch_size", "16", "--records_per_task", "32", "--device", "cpu",
        "--envs", "OMP_NUM_THREADS=1", "--training_data_dir", str(train),
        "--evaluation_data_dir", str(evals), "--eval_steps", "16", "--num_workers", "2",
        "--local_updates", "2", "--num_kv_shards", "2", "--kv_mode", "process",
        "--grads_to_wait", "1",
    ], on_start=on_start)
    assert rc == 0 and "pid" in box
    assert summary["recoveries"] == [["kv", 1, 1]] and summary["unrecoverable"] == []
    assert summary["generations"] == {"ps": [], "kv": [0, 1]}
    assert {k: summary[k] for k in ("version", "init_version", "applied_update_steps")} == {
        "version": 16, "init_version": 0, "applied_update_steps": 16}
    calls = summary["server"]["calls"]
    assert calls.get("EmbeddingLookup", 0) == 0 and calls.get("EmbeddingUpdate", 0) == 0
    (_version, metrics), = summary["evaluations"]
    assert 0.0 <= metrics["auc"] <= 1.0
    tl = summary["recovery_timelines"][0]
    assert tl["kind"] == "kv" and tl["rows_restored"] > 0
    workers = worker_main.read_summaries(str(tmp_path / "logs"))
    assert sum(w["shard_recoveries_observed"] for w in workers.values()) >= 1


SCOPED = r"""
import os, sys, time
from multiprocessing import resource_tracker
resource_tracker.register = lambda *a, **k: None
os.environ["EDL_TRANSPORT"] = "shm"
from elasticdl_tpu_torch.rpc.server import RpcServer
from elasticdl_tpu_torch.rpc.client import RpcClient
srv = RpcServer({"Ping": lambda req: {"ok": True}}, port=0, shm_scope=sys.argv[1],
                shm_generation=0)
srv.start()
client = RpcClient(f"localhost:{srv.port}")
assert client.tier == "shm" and client.call("Ping", {})["ok"]
print(srv.port, flush=True)
time.sleep(600)
"""


def test_relaunch_sweeps_a_sigkilled_predecessors_segments_by_scope(monkeypatch, tmp_path):
    """A shard slot's relaunch binds a new port; its shm server, at the
    next generation in the same scope, sweeps the SIGKILLed
    predecessor's segments and rendezvous files."""
    import tempfile

    uds = tempfile.mkdtemp(prefix="edlt")
    monkeypatch.setenv("EDL_UDS_DIR", uds)
    scope = f"t{os.getpid()}.ps1"
    proc = subprocess.Popen([sys.executable, "-c", SCOPED, scope],
                            env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE,
                            text=True)
    try:
        old_port = int(proc.stdout.readline())
        info = transport.read_shm_rendezvous(old_port)
        assert info["scope"] == scope and info["generation"] == 0
        prefix = info["prefix"]
        assert prefix.startswith(f"edltshm.{scope}.g0.{proc.pid}.")
        assert [n for n in os.listdir("/dev/shm") if n.startswith(prefix)]
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)
    monkeypatch.setenv("EDL_TRANSPORT", "shm")
    srv = RpcServer({"Ping": lambda req: {"ok": 1}}, port=0, shm_scope=scope,
                    shm_generation=1)
    srv.start()
    try:
        assert srv.port != old_port
        assert [n for n in os.listdir("/dev/shm") if n.startswith(prefix)] == []
        assert transport.read_shm_rendezvous(old_port) is None
        assert transport.read_shm_rendezvous(srv.port)["generation"] == 1
    finally:
        srv.stop()
        import shutil

        shutil.rmtree(uds, ignore_errors=True)

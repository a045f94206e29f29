"""The shard recovery plane: PS and KV shard failover with an exact resume.

The reference's `elasticdl_tpu/master/recovery.py` (rung 6 of its fault
model) without the aggregation-tree arm. A dead PS or KV shard is
detected, fenced, relaunched at the next generation, restored from state
the plane kept while the shard was healthy, and the job goes on with no
master restart.

Each shard's states::

    ACTIVE --(death seen)--> FENCED --(relaunch)--> RELAUNCHING --> RESTORING
      ^                                                                 |
      +----------------------------(state restored)--------------------+

Detection: the monitor thread polls the groups' `poll_dead()` (a shard
process has no pod-event stream), and `on_shard_failure` takes a pod
event. Both dedup per (kind, shard, generation), so a death is recovered
once.

Fencing: `relaunch_shard` bumps the slot's generation before the new
servicer exists, and every client stamps its requests with the
generation it knows (`rpc/fencing.py`). A push in flight against the
dead generation fails fast (UNAVAILABLE, the endpoint is gone, or
FAILED_PRECONDITION from a zombie or the new servicer), and the worker's
outage handler replays it or requeues its task: nothing applies twice.

Restore sources:

- **PS params** (exact): each worker keeps a restore snapshot, each
  shard's slice at the version it stands at, from its pulls, its pushes'
  responses and (window mode) its landed windows
  (`worker.Worker._restore_snap`). While a PS shard recovers, GetPSConfig lists it
  under `recovering`, and each polling worker uploads its slice of the
  snapshot (PSRestoreFromWorker, `offer_upload`: only a recovering shard
  takes one, and the highest version wins). The plane waits for an
  upload at or above the shard's version floor, the highest version the
  master saw the shard acknowledge (ReportWindowMeta's per-shard
  maximum, `servicer.shard_version_floor`): every acknowledged push is
  in some worker's snapshot at that version or above. It seeds the
  relaunched shard with the highest upload through PSInit, so the
  shard's version is exactly init plus the applied steps; a push that
  was not acknowledged failed to its worker, which replays or retrains
  it. Past `restore_deadline` it takes the best upload below the floor
  (the resume is then not version-exact, and it warns); with no upload
  at all the shard is unrecoverable.
- **PS optimizer state** (bounded staleness): a mirror thread reads
  each shard's optimizer-state leaves (PSOptState) every
  `EDL_OPT_MIRROR_SECS` into a small ring a shard; the newest goes into
  the relaunched shard through PSOptRestore. The moments lag by at most
  the mirror's period: they shape values, never versions.
- **KV rows** (bounded staleness): each KV shard mirrors its applied
  writes to its ring pair ((i + 1) % N, `kv_group.wire_mirrors`); the
  plane reads `KVMirrorSnapshot(source_shard=i)` from the pair and
  `KVRestore`s it into the relaunched shard, then re-points the ring.
  Rows still queued at the death come back cold (lazy re-init). With
  one KV shard there is no pair, and the shard relaunches empty.

An unrecoverable shard fires `on_unrecoverable(kind, shard)`, which the
master wires to its abort (exit 2): the ladder falls back to the rung
below instead of hanging.

Each recovery keeps a timeline of wall-clock stamps (`timelines()`):
detected, fenced, the relaunch's start and end, the first accepted
upload, restored, active; and the KV rows restored from the pair.

Each recovery's begin, end and give-up is a flight record
(`recovery_begin`, `recovery_done`, `recovery_give_up`, beside the
group's `generation_bump`; `obs/flight.py`) and a count of
`edl_recovery_events_total{event, kind}` in the process's metrics
registry, at the reference's sites.

Not ported yet: the aggregation-tree arm (`_recover_agg` and the
`agg_group` argument: the port has no aggregators).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from elasticdl_tpu_torch.common.constants import ENV_OPT_MIRROR_SECS
from elasticdl_tpu_torch.common.log_util import get_logger
from elasticdl_tpu_torch.obs import flight as obs_flight
from elasticdl_tpu_torch.obs import metrics as obs_metrics

logger = get_logger(__name__)

# each shard's states (status() and tests read these)
ACTIVE = "ACTIVE"
FENCED = "FENCED"
RELAUNCHING = "RELAUNCHING"
RESTORING = "RESTORING"


def restore_ps_shard(
    endpoint: str,
    generation: int,
    vec: Any,
    version: int,
    fence_version: int = -1,
    opt_leaves: Any = None,
    timeout: float = 60.0,
) -> bool:
    """Seed a (re)launched PS shard from a restore candidate: PSInit the
    slice at its version, then PSOptRestore the mirrored optimizer leaves
    when there are. A plain function of (endpoint, generation,
    candidate), so that master migration's adoption can share it.
    Returns True when the restore is version-exact (the candidate reached
    the fence)."""
    from elasticdl_tpu_torch.rpc.client import RpcClient

    exact = version >= fence_version
    if not exact:
        logger.warning("PS shard at %s: restore candidate v%d < fence v%d, seeding from it "
                       "anyway (the resume is not version-exact)", endpoint, version,
                       fence_version)
    client = RpcClient(endpoint)
    try:
        client.call("PSInit", {"vec": vec, "version": version, "epoch": generation},
                    timeout=timeout)
        if opt_leaves is not None:
            client.call("PSOptRestore", {"leaves": opt_leaves, "epoch": generation},
                        timeout=timeout)
        else:
            logger.warning("PS shard at %s: no mirrored optimizer state, the moments "
                           "restart cold", endpoint)
    finally:
        client.close()
    return exact


class RecoveryPlane:
    """The master's controller of PS and KV shard failover."""

    def __init__(
        self,
        servicer,
        ps_group=None,
        kv_group=None,
        poll_interval: float = 0.25,
        opt_mirror_interval: Optional[float] = None,
        opt_mirror_ring: int = 4,
        restore_deadline: float = 60.0,
        on_unrecoverable: Optional[Callable[[str, int], None]] = None,
    ):
        self._servicer = servicer
        self._ps_group = ps_group
        self._kv_group = kv_group
        self._poll_interval = poll_interval
        if opt_mirror_interval is None:
            try:
                opt_mirror_interval = float(os.environ.get(ENV_OPT_MIRROR_SECS, "2.0").strip())
            except ValueError:
                opt_mirror_interval = 2.0
        self._opt_mirror_interval = opt_mirror_interval
        self._opt_mirror_ring = max(1, int(opt_mirror_ring))
        self._restore_deadline = restore_deadline
        self._on_unrecoverable = on_unrecoverable

        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._states: Dict[tuple, str] = {}  # (kind, shard) -> state
        self._recovering: Dict[str, set] = {"ps": set(), "kv": set()}
        self._uploads: Dict[int, tuple] = {}  # shard -> (version, vec): the best so far
        self._opt_rings: Dict[int, deque] = {}  # shard -> optimizer leaves, newest last
        self._handled: set = set()  # (kind, shard, generation)
        self._recoveries: List[tuple] = []  # (kind, shard, new generation)
        self._unrecoverable: List[tuple] = []
        self._timelines: List[dict] = []
        self._current: Dict[tuple, dict] = {}  # (kind, shard) -> its open timeline
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._workers: List[threading.Thread] = []  # one thread a recovery
        self._started = False

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        """Arm the plane: wire the KV mirrors, start the death monitor
        and the PS optimizer-state mirror."""
        if self._started:
            return
        self._started = True
        if self._kv_group is not None:
            try:
                self._kv_group.wire_mirrors()
            except Exception:
                logger.exception("KV mirror wiring failed: a KV restore relaunches empty")
        self._spawn(self._monitor_loop, "recovery-monitor")
        if self._ps_group is not None:
            self._spawn(self._opt_mirror_loop, "recovery-opt-mirror")

    def _spawn(self, target, name):
        t = threading.Thread(target=target, name=name, daemon=True)
        t.start()
        self._threads.append(t)

    def stop(self):
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5.0)
        # the monitor appends recovery threads: snapshot under the lock,
        # join outside it (a recovery thread may need the lock to finish)
        with self._lock:
            workers = list(self._workers)
        for t in workers:
            t.join(timeout=5.0)
        self._threads = []
        with self._lock:
            self._workers = []

    # -- status and the servicer's hooks ---------------------------------------

    def status(self) -> Dict[str, List[int]]:
        """The fenced shards, advertised through GetPSConfig: a worker
        that sees a PS shard listed uploads its restore snapshot, and
        waits to re-resolve until the lists clear."""
        with self._lock:
            return {"ps": sorted(self._recovering["ps"]), "kv": sorted(self._recovering["kv"])}

    def states(self) -> Dict[tuple, str]:
        with self._lock:
            return dict(self._states)

    def recoveries(self) -> List[tuple]:
        """The completed recoveries: (kind, shard, new generation)."""
        with self._lock:
            return list(self._recoveries)

    def unrecoverable(self) -> List[tuple]:
        """The shards given up on: (kind, shard)."""
        with self._lock:
            return list(self._unrecoverable)

    def timelines(self) -> List[dict]:
        """Each recovery's wall-clock stamps (time.time()), in order."""
        with self._lock:
            return [dict(t) for t in self._timelines]

    def offer_upload(self, worker_id: int, shard_id: int, vec: Any, version: int) -> bool:  # edl-lint: disable=lock-discipline -- self._cv wraps self._lock
        """A worker's restore candidate for a recovering PS shard; only
        the highest version is kept (a re-sent one changes nothing).
        Refused when the shard is not recovering: a late upload must not
        overwrite a live shard's lineage."""
        shard_id, version = int(shard_id), int(version)
        with self._cv:
            if shard_id not in self._recovering["ps"]:
                return False
            cur = self._uploads.get(shard_id)
            if cur is None or version > cur[0]:
                self._uploads[shard_id] = (version, np.array(vec, dtype=np.float32))
                tl = self._current.get(("ps", shard_id))
                if tl is not None:
                    tl.setdefault("upload_accepted", time.time())
                    tl["upload_version"] = version
                logger.info("recovery: worker %s offered PS shard %d's restore at v%d",
                            worker_id, shard_id, version)
                self._cv.notify_all()
            return True

    def on_shard_failure(self, kind: str, shard_id: int):
        """A pod event's entry point."""
        self._begin(kind, int(shard_id), "pod event")

    # -- detection -----------------------------------------------------------

    def _monitor_loop(self):
        while not self._stop.wait(self._poll_interval):
            try:
                for kind, group in (("ps", self._ps_group), ("kv", self._kv_group)):
                    if group is not None:
                        for i, rc in group.poll_dead():
                            self._begin(kind, i, f"process exit rc={rc}")
            except Exception:
                logger.exception("recovery monitor poll failed")

    def _begin(self, kind: str, shard_id: int, why: str):
        group = {"ps": self._ps_group, "kv": self._kv_group}.get(kind)
        if group is None:
            return
        now = time.time()
        with self._lock:
            if shard_id in self._recovering[kind]:
                # a recovery of this slot is in flight: a repeated event
                # (or a poll racing the relaunch) must not stack another
                return
            key = (kind, shard_id, group.generations[shard_id])
            if key in self._handled:
                return  # an event and a poll raced: recover once
            self._handled.add(key)
            self._states[(kind, shard_id)] = FENCED
            self._recovering[kind].add(shard_id)
            if kind == "ps":
                self._uploads.pop(shard_id, None)
            tl = {"kind": kind, "shard": shard_id, "why": why, "detected": now,
                  "fenced": time.time()}
            self._current[(kind, shard_id)] = tl
            self._timelines.append(tl)
        logger.error("%s shard %d died (%s): starting recovery", kind.upper(), shard_id, why)
        obs_flight.record("recovery_begin", shard_kind=kind, shard=shard_id, why=why)
        obs_metrics.get_registry().inc("edl_recovery_events_total", event="begin", kind=kind)
        t = threading.Thread(target=self._recover, args=(kind, shard_id),
                             name=f"recover-{kind}{shard_id}", daemon=True)
        t.start()
        with self._lock:
            self._workers.append(t)

    # -- recovery ------------------------------------------------------------

    def _recover(self, kind: str, shard_id: int):
        try:
            if kind == "ps":
                self._recover_ps(shard_id)
            else:
                self._recover_kv(shard_id)
        except Exception:
            logger.exception("%s shard %d recovery failed", kind.upper(), shard_id)
            self._give_up(kind, shard_id)

    def _stamp(self, kind: str, shard_id: int, **fields):
        with self._lock:
            tl = self._current.get((kind, shard_id))
            if tl is not None:
                tl.update(fields)

    def _relaunch(self, kind: str, shard_id: int, group) -> tuple:
        with self._lock:
            self._states[(kind, shard_id)] = RELAUNCHING
        self._stamp(kind, shard_id, relaunch_start=time.time())
        endpoint = group.relaunch_shard(shard_id)
        generation = group.generations[shard_id]
        with self._lock:
            self._states[(kind, shard_id)] = RESTORING
        self._stamp(kind, shard_id, relaunched=time.time(), generation=generation)
        return endpoint, generation

    def _finish(self, kind: str, shard_id: int, generation: int):  # edl-lint: disable=lock-discipline -- self._cv wraps self._lock
        with self._cv:
            self._states[(kind, shard_id)] = ACTIVE
            self._recovering[kind].discard(shard_id)
            if kind == "ps":
                self._uploads.pop(shard_id, None)
            self._recoveries.append((kind, shard_id, generation))
            tl = self._current.pop((kind, shard_id), None)
            if tl is not None:
                tl["active"] = time.time()
            self._cv.notify_all()
        logger.info("%s shard %d recovered at generation %d", kind.upper(), shard_id,
                    generation)
        obs_flight.record("recovery_done", shard_kind=kind, shard=shard_id, generation=generation)
        obs_metrics.get_registry().inc("edl_recovery_events_total", event="done", kind=kind)

    def _give_up(self, kind: str, shard_id: int):  # edl-lint: disable=lock-discipline -- self._cv wraps self._lock
        with self._cv:
            self._recovering[kind].discard(shard_id)
            self._unrecoverable.append((kind, shard_id))
            tl = self._current.pop((kind, shard_id), None)
            if tl is not None:
                tl["unrecoverable"] = time.time()
            self._cv.notify_all()
        logger.error("%s shard %d is UNRECOVERABLE: falling back to fail-fast",
                     kind.upper(), shard_id)
        obs_flight.record("recovery_give_up", shard_kind=kind, shard=shard_id)
        obs_metrics.get_registry().inc("edl_recovery_events_total", event="give_up", kind=kind)
        if self._on_unrecoverable is not None:
            self._on_unrecoverable(kind, shard_id)

    def _recover_ps(self, shard_id: int):  # edl-lint: disable=lock-discipline -- self._cv wraps self._lock
        group = self._ps_group
        # the fence: the highest version the master saw this shard
        # acknowledge; an upload at or above it restores exact accounting
        fence_version = -1
        floor_fn = getattr(self._servicer, "shard_version_floor", None)
        if floor_fn is not None:
            fence_version = floor_fn(shard_id)
        endpoint, generation = self._relaunch("ps", shard_id, group)
        self._stamp("ps", shard_id, fence_version=fence_version)
        # wait for an upload that reaches the fence; past the deadline
        # take the best one (not version-exact), and with none give up
        deadline = time.monotonic() + self._restore_deadline
        with self._cv:
            while not self._stop.is_set():
                best = self._uploads.get(shard_id)
                if best is not None and best[0] >= fence_version:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(min(0.25, remaining))
            best = self._uploads.get(shard_id)
            ring = self._opt_rings.get(shard_id)
            leaves = ring[-1] if ring else None
        if best is None:
            self._give_up("ps", shard_id)
            return
        version, vec = best
        exact = restore_ps_shard(endpoint, generation, vec, version,
                                 fence_version=fence_version, opt_leaves=leaves)
        self._stamp("ps", shard_id, restored=time.time(), restored_version=version,
                    exact=exact, opt_restored=leaves is not None)
        self._finish("ps", shard_id, generation)

    def _recover_kv(self, shard_id: int):
        from elasticdl_tpu_torch.rpc.client import RpcClient

        group = self._kv_group
        layers = {}
        if group.num_shards > 1:
            pair = group.mirror_pair_of(shard_id)
            # an inproc pair's servicer: drain its outbound queue, so that
            # its view is current (the dead shard's own queue is lost)
            if group.servicers:
                try:
                    group.servicers[pair].mirror_flush(timeout=5.0)
                except Exception:
                    pass
            pair_client = RpcClient(group.endpoints[pair])
            try:
                layers = pair_client.call("KVMirrorSnapshot", {"source_shard": shard_id},
                                          timeout=60.0).get("layers") or {}
            finally:
                pair_client.close()
        else:
            logger.warning("KV shard %d has no ring pair (one shard): relaunching it empty, "
                           "its rows come back cold", shard_id)
        endpoint, generation = self._relaunch("kv", shard_id, group)
        rows = sum(len(entry["ids"]) for entry in layers.values())
        if layers:
            client = RpcClient(endpoint)
            try:
                client.call("KVRestore", {"layers": layers, "epoch": generation}, timeout=60.0)
            finally:
                client.close()
        # point the ring at the relaunched endpoint (idempotent)
        if group.num_shards > 1:
            group.wire_mirrors()
        self._stamp("kv", shard_id, restored=time.time(), rows_restored=rows)
        self._finish("kv", shard_id, generation)

    # -- the PS optimizer-state mirror -----------------------------------------

    def _opt_mirror_loop(self):
        """Each PS shard's optimizer leaves into its ring, every mirror
        period. Best effort: a failed read (a shard mid-relaunch, a slow
        apply) skips a beat, and the ring keeps its newest entry."""
        group = self._ps_group
        while not self._stop.wait(self._opt_mirror_interval):
            if not group.initialized:
                continue
            try:
                client = group.client()
            except Exception:
                continue
            for i in range(group.num_shards):
                with self._lock:
                    if i in self._recovering["ps"]:
                        continue
                try:
                    leaves = client.export_opt_shard(i)
                except Exception:
                    continue
                if leaves is None:
                    continue
                with self._lock:
                    ring = self._opt_rings.get(i)
                    if ring is None:
                        ring = self._opt_rings[i] = deque(maxlen=self._opt_mirror_ring)
                    ring.append(leaves)

    def opt_ring_depth(self, shard_id: int) -> int:
        """The mirror ring's occupancy for one shard."""
        with self._lock:
            ring = self._opt_rings.get(int(shard_id))
            return len(ring) if ring else 0

"""KV shard: one slice of the scale-out embedding service.

The reference's `elasticdl_tpu/master/kv_shard.py`: N shard endpoints,
each an embedding store (`master/embedding_store.py`: the C++ arena when
it builds, else the Python store) behind the RPC server, so table memory
and lookup bandwidth scale apart from the master, and workers look rows
up straight from the shards, not through the master.

Rows are placed by id, `id % num_shards`, on the client side
(`rpc/kv_client.ShardedEmbeddingStore`); slot rows (`<layer>/slot/m`)
key by the same ids, so a row and its optimizer slots share a shard.
Snapshots cross the wire as `{layer: {"ids": [n], "values": [n, dim]}}`
(`snapshot_to_arrays`): the `{id: row}` form has integer keys, which the
port's JSON frame header does not take.

Fencing (`rpc/fencing.py`): the servicer carries its slot's
`generation`; every handler but `UNFENCED_HANDLERS` rejects a request
whose `epoch` names another one. `KVRefence` moves it in place.

Replica mirroring, the recovery plane's KV restore source
(`master/recovery.py`): once `KVSetMirror` names its pair (the ring,
shard i to (i + 1) % N, wired by the group), a shard forwards each
applied KVUpdate to the pair on a background thread (`KVMirror`). The
pair keeps the mirrored rows in a store of their own per source shard,
apart from its primary rows; when shard i dies, the plane reads
`KVMirrorSnapshot(source_shard=i)` from the pair and `KVRestore`s it
into the relaunched shard. Mirroring is bounded staleness by design: a
write still queued at the death is lost, and its rows come back cold
(lazy re-init); step accounting never depends on it. The mirror traffic
carries no epoch: the group addresses it to the generation it just
launched.

GetTrace and GetMetrics answer for the hosting process, unfenced, as
the PS shard's do; `register_metrics` feeds `stats()` to the process's
metrics registry (`edl_kv_*`).

Not ported yet: the admission and wire statistics in `stats()`.
"""

from __future__ import annotations

import queue
import threading
import time
import weakref
from typing import Any, Dict, Optional

import numpy as np

from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.common.log_util import get_logger
from elasticdl_tpu_torch.master.embedding_store import EmbeddingStore
from elasticdl_tpu_torch.obs import metrics as obs_metrics
from elasticdl_tpu_torch.rpc.fencing import EpochFencedError, check_epoch

logger = get_logger(__name__)

#: the mirror thread's shutdown sentinel
_STOP = object()


def snapshot_to_arrays(snap: Dict[str, Dict[int, np.ndarray]]) -> Dict[str, Any]:
    """{layer: {id: row}} -> {layer: {"ids": [n], "values": [n, dim]}}."""
    out = {}
    for layer, rows in snap.items():
        if not rows:
            continue
        ids = np.fromiter(rows.keys(), dtype=np.int64, count=len(rows))
        values = np.stack([rows[i] for i in ids])
        out[layer] = {"ids": ids, "values": values}
    return out


def arrays_to_snapshot(wire: Dict[str, Any]) -> Dict[str, Dict[int, np.ndarray]]:
    """The inverse of `snapshot_to_arrays` (rows as views of `wire`)."""
    return {
        layer: {int(i): np.asarray(v) for i, v in zip(entry["ids"], entry["values"])}
        for layer, entry in wire.items()
    }


class KVShardServicer:
    """One shard's RPC surface over a local embedding store. Both stores
    copy what they keep, so a request's arrays (views of the transport's
    buffer) are never held past the handler; the mirror queue keeps
    copies."""

    #: Handlers that skip the epoch check: the mirror plane (shard to
    #: shard, and group to shard), KVRefence, the fence mover, whose own
    #: monotonicity check is its fence, and the trace and metrics reads,
    #: which answer for the process (what a postmortem wants from a
    #: fenced shard).
    UNFENCED_HANDLERS = frozenset(
        {"KVMirror", "KVMirrorSnapshot", "KVSetMirror", "KVRefence", "GetTrace", "GetMetrics"}
    )

    def __init__(self, shard_id: int, num_shards: int, generation: int = 0):
        self.shard_id = int(shard_id)
        self.num_shards = int(num_shards)
        # the slot's fencing epoch: written under _mirror_lock (KVRefence),
        # read bare by _check_epoch (one int)
        self.generation = int(generation)
        self._store = EmbeddingStore()
        # outbound mirroring (this shard as a primary)
        self._mirror_lock = threading.Lock()
        self._mirror_endpoint: Optional[str] = None
        self._mirror_q: "queue.Queue" = queue.Queue()
        self._mirror_thread: Optional[threading.Thread] = None
        self._mirrored_writes = 0
        self._mirror_drops = 0
        # inbound mirrored rows (this shard as a pair), by source shard,
        # never mixed into the primary store
        self._mirror_stores: Dict[int, EmbeddingStore] = {}
        # best-effort tallies: handlers run concurrently without a lock
        self._lookups = 0
        self._updates = 0

    @property
    def store(self):
        return self._store

    def handlers(self) -> Dict[str, Any]:
        return {
            "KVLookup": self.kv_lookup,
            "KVUpdate": self.kv_update,
            "KVSnapshot": self.kv_snapshot,
            "KVRestore": self.kv_restore,
            "KVLen": self.kv_len,
            "KVMirror": self.kv_mirror,
            "KVMirrorSnapshot": self.kv_mirror_snapshot,
            "KVSetMirror": self.kv_set_mirror,
            "KVRefence": self.refence,
            "GetTrace": obs.get_trace,
            "GetMetrics": obs.get_metrics,
        }

    def register_metrics(self, registry=None) -> None:
        """Feed this shard's counters into the process's
        MetricsRegistry as a pull collector (weakly referenced, as
        `PSShardServicer.register_metrics`)."""
        reg = registry if registry is not None else obs_metrics.get_registry()
        ref = weakref.ref(self)
        shard = str(self.shard_id)

        def collector(sink):
            s = ref()
            if s is None:
                return
            st = s.stats()
            sink.gauge("edl_kv_rows", st["n"], shard=shard)
            sink.gauge("edl_kv_generation", st["generation"], shard=shard)
            sink.counter("edl_kv_lookups_total", st["lookups"], shard=shard)
            sink.counter("edl_kv_updates_total", st["updates"], shard=shard)

        reg.register_collector(collector)

    def _check_epoch(self, req: dict):  # edl-lint: disable=lock-discipline -- bare read of the one int epoch word: a request racing the refence is rejected either way
        check_epoch(req, self.generation, "kv", self.shard_id)

    def refence(self, req: dict) -> dict:
        """Move the generation in place (the KV leg of the
        master-migration cutover): the store and the mirror wiring
        survive. Monotonic: the current generation answers ok, an older
        one is fenced."""
        target = int(req.get("generation", -1))
        with self._mirror_lock:
            if target < self.generation:
                raise EpochFencedError("kv", self.shard_id, self.generation, target)
            if target > self.generation:
                logger.info("KV shard %d refenced: generation %d -> %d",
                            self.shard_id, self.generation, target)
                self.generation = target
            return {"generation": self.generation}

    def kv_lookup(self, req: dict) -> dict:
        self._check_epoch(req)
        self._lookups += 1
        values, unknown = self._store.lookup(req["layer"], req["ids"])
        return {"values": values, "unknown_index": unknown}

    def kv_update(self, req: dict) -> dict:
        self._check_epoch(req)
        self._updates += 1
        self._store.update(
            req["layer"], req["ids"], req["values"],
            set_if_not_exist=req.get("set_if_not_exist", False),
        )
        self._enqueue_mirror(req)
        return {}

    def kv_snapshot(self, req: dict) -> dict:
        self._check_epoch(req)
        return {"layers": snapshot_to_arrays(self._store.snapshot())}

    def kv_restore(self, req: dict) -> dict:
        self._check_epoch(req)
        self._store.restore(arrays_to_snapshot(req.get("layers") or {}))
        return {}

    def kv_len(self, req: dict) -> dict:
        self._check_epoch(req)
        return {"n": len(self._store), "store": type(self._store).__name__}

    # -- replica mirroring ---------------------------------------------------

    def kv_set_mirror(self, req: dict) -> dict:
        """Point this shard at its pair ('' turns mirroring off)."""
        endpoint = req.get("endpoint") or ""
        with self._mirror_lock:
            self._mirror_endpoint = endpoint or None
            if endpoint and self._mirror_thread is None:
                self._mirror_thread = threading.Thread(
                    target=self._mirror_loop, name=f"kv{self.shard_id}-mirror", daemon=True
                )
                self._mirror_thread.start()
        return {}

    def kv_mirror(self, req: dict) -> dict:
        """A primary's forwarded write, into its source's mirror store
        (last writer wins, as KVUpdate)."""
        source = int(req.get("source_shard", -1))
        with self._mirror_lock:
            store = self._mirror_stores.get(source)
            if store is None:
                store = self._mirror_stores[source] = EmbeddingStore()
        store.update(
            req["layer"], req["ids"], req["values"],
            set_if_not_exist=req.get("set_if_not_exist", False),
        )
        return {}

    def kv_mirror_snapshot(self, req: dict) -> dict:
        """Every row this shard holds for `source_shard`: the recovery
        plane's restore payload for that shard."""
        source = int(req.get("source_shard", -1))
        with self._mirror_lock:
            store = self._mirror_stores.get(source)
        return {"layers": snapshot_to_arrays(store.snapshot()) if store is not None else {}}

    def _enqueue_mirror(self, req: dict):
        with self._mirror_lock:
            if self._mirror_endpoint is None:
                return
        # copies: the request's arrays are views of the transport's buffer
        self._mirror_q.put({
            "source_shard": self.shard_id,
            "layer": req["layer"],
            "ids": np.array(req["ids"], dtype=np.int64),
            "values": np.array(req["values"], dtype=np.float32),
            "set_if_not_exist": req.get("set_if_not_exist", False),
        })

    def _mirror_loop(self):
        """Drain the outbound queue to the pair. Best effort: a write that
        fails is dropped (bounded staleness), so a slow or dead pair never
        stalls the primary's writes."""
        from elasticdl_tpu_torch.rpc.client import RpcClient

        client, client_endpoint = None, None
        while True:
            item = self._mirror_q.get()
            if item is _STOP:
                break
            with self._mirror_lock:
                endpoint = self._mirror_endpoint
            if endpoint is not None:
                try:
                    if client is None or client_endpoint != endpoint:
                        if client is not None:
                            client.close()
                        client, client_endpoint = RpcClient(endpoint), endpoint
                    client.call("KVMirror", item, timeout=10.0)
                    with self._mirror_lock:
                        self._mirrored_writes += 1
                except Exception as e:  # noqa: BLE001 - the mirror is best effort
                    with self._mirror_lock:
                        self._mirror_drops += 1
                    logger.warning("kv shard %d: mirror write to %s dropped: %s",
                                   self.shard_id, endpoint, e)
            self._mirror_q.task_done()
        self._mirror_q.task_done()
        if client is not None:
            client.close()

    def mirror_flush(self, timeout: float = 10.0) -> bool:
        """Wait until every queued mirror write was sent (or dropped):
        the recovery plane's barrier before it reads a pair's mirror."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._mirror_q.unfinished_tasks == 0:
                return True
            time.sleep(0.01)
        return False

    def close(self):
        """Stop the mirror thread (after it drained the queue)."""
        with self._mirror_lock:
            thread, self._mirror_thread = self._mirror_thread, None
        if thread is not None:
            self._mirror_q.put(_STOP)
            thread.join(timeout=5.0)

    def stats(self) -> Dict[str, Any]:  # edl-lint: disable=lock-discipline -- generation and the tallies are single words read for a diagnostic snapshot
        with self._mirror_lock:
            mirror_sources = len(self._mirror_stores)
            mirrored_writes = self._mirrored_writes
            mirror_drops = self._mirror_drops
        return {
            "n": len(self._store),
            "generation": self.generation,
            "lookups": self._lookups,
            "updates": self._updates,
            "mirrored_writes": mirrored_writes,
            "mirror_drops": mirror_drops,
            "mirror_sources": mirror_sources,
        }

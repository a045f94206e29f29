"""KV shard: one slice of the scale-out embedding service.

The reference's `elasticdl_tpu/master/kv_shard.py` (its core): N shard
endpoints, each an embedding store (`master/embedding_store.py`: the C++
arena when it builds, else the Python store) behind the RPC server, so
table memory and lookup bandwidth scale apart from the master, and
workers look rows up straight from the shards, not through the master.

Rows are placed by id, `id % num_shards`, on the client side
(`rpc/kv_client.ShardedEmbeddingStore`); slot rows (`<layer>/slot/m`)
key by the same ids, so a row and its optimizer slots share a shard.
Snapshots cross the wire as `{layer: {"ids": [n], "values": [n, dim]}}`
(`snapshot_to_arrays`): the `{id: row}` form has integer keys, which the
port's JSON frame header does not take.

Not ported yet: replica mirroring, fencing generations and the refence,
the relaunch of a dead shard (the recovery plane), and the shards'
GetTrace and GetMetrics.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from elasticdl_tpu_torch.master.embedding_store import EmbeddingStore


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
    buffer) are never held past the handler."""

    def __init__(self, shard_id: int, num_shards: int):
        self.shard_id = int(shard_id)
        self.num_shards = int(num_shards)
        self._store = EmbeddingStore()
        # best-effort tallies: handlers run concurrently without a lock
        self.lookups = 0
        self.updates = 0

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
        }

    def kv_lookup(self, req: dict) -> dict:
        self.lookups += 1
        values, unknown = self._store.lookup(req["layer"], req["ids"])
        return {"values": values, "unknown_index": unknown}

    def kv_update(self, req: dict) -> dict:
        self.updates += 1
        self._store.update(
            req["layer"], req["ids"], req["values"],
            set_if_not_exist=req.get("set_if_not_exist", False),
        )
        return {}

    def kv_snapshot(self, req: dict) -> dict:
        return {"layers": snapshot_to_arrays(self._store.snapshot())}

    def kv_restore(self, req: dict) -> dict:
        self._store.restore(arrays_to_snapshot(req.get("layers") or {}))
        return {}

    def kv_len(self, req: dict) -> dict:
        return {"n": len(self._store), "store": type(self._store).__name__}

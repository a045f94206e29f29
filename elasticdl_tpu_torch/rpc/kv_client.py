"""Client for the sharded embedding KV service.

The reference's `elasticdl_tpu/rpc/kv_client.py` over the port's own
`RpcClient` (no grpc). `ShardedEmbeddingStore` has the embedding
store's surface (lookup / update / snapshot / restore / len) over N
shard endpoints, so both of its users work unchanged: the master's
sparse optimizer and checkpoints, and the workers, which build one from
the endpoints GetPSConfig advertises and look rows up without the master
on the path.

Row placement: id -> shard `id % num_shards`. Every operation splits its
ids by shard and fans out on a thread pool, one connection a shard.
Lookups, snapshots and lengths are reads, and updates and restores
overwrite rows (or SETNX them), so every KV method is re-sent on a
transient failure, as the reference classifies them.

Fencing (`rpc/fencing.py`): with `generations`, every request carries
its shard's as its `epoch`, so a relaunched or zombie shard refuses a
client that holds another (FAILED_PRECONDITION, never re-sent).
`update_endpoints` swaps in the endpoints and generations that the
master advertises after a KV shard's recovery; the shard count is fixed
for the job (ids never re-hash).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np

from elasticdl_tpu_torch.master.kv_shard import arrays_to_snapshot, snapshot_to_arrays
from elasticdl_tpu_torch.rpc.client import RpcClient
from elasticdl_tpu_torch.rpc.policy import PolicyRpcError, StatusCode


class ShardedEmbeddingStore:
    def __init__(self, endpoints, generations=None):
        if not endpoints:
            raise ValueError("ShardedEmbeddingStore needs >= 1 endpoint")
        self.endpoints = list(endpoints)
        # each shard's fencing epoch, stamped on its requests (None: unfenced)
        self.generations = list(generations) if generations else None
        self._clients = [RpcClient(ep) for ep in self.endpoints]
        # the links of earlier endpoints, closed with this client: a
        # fan-out or prefetch thread may still be in a call on one
        self._retired: list = []
        self._pool = ThreadPoolExecutor(
            max_workers=len(self.endpoints), thread_name_prefix="kv-shard"
        )

    @property
    def num_shards(self) -> int:
        return len(self._clients)

    @property
    def tiers(self) -> List[str]:
        """The transport tier of each shard's link."""
        return [c.tier for c in self._clients]

    def _call(self, s: int, method: str, req: dict) -> dict:
        if self.generations is not None:
            req["epoch"] = self.generations[s]
        return self._clients[s].call(method, req, idempotent=True)

    def update_endpoints(self, endpoints, generations=None):
        """Re-resolution after a shard's relaunch: the new endpoints and
        generations (the same shard count)."""
        if len(endpoints) != len(self.endpoints):
            raise ValueError(
                f"re-resolution changed the shard count {len(self.endpoints)} -> {len(endpoints)}"
            )
        self._retired.extend(self._clients)
        self._clients = [RpcClient(ep) for ep in endpoints]
        self.endpoints = list(endpoints)
        self.generations = list(generations) if generations else None

    def wait_ready(self, timeout: float = 30.0):
        """One deadline shared by every shard; the waits run at once."""
        deadline = time.monotonic() + timeout

        def wait(c):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise PolicyRpcError(StatusCode.DEADLINE_EXCEEDED, "KV shards not ready")
            c.wait_ready(remaining)

        for f in [self._pool.submit(wait, c) for c in self._clients]:
            f.result()

    def _shard_of(self, ids: np.ndarray) -> np.ndarray:
        return ids % self.num_shards

    def lookup(self, layer: str, ids) -> Tuple[np.ndarray, np.ndarray]:
        """(values [n, dim], unknown_index into the caller's order)."""
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        shard = self._shard_of(ids)
        futs, pos = {}, {}
        for s in range(self.num_shards):
            (where,) = np.nonzero(shard == s)
            if not len(where):
                continue
            pos[s] = where
            futs[s] = self._pool.submit(self._call, s, "KVLookup", {"layer": layer, "ids": ids[where]})
        resps = {s: f.result() for s, f in futs.items()}
        dim = 0
        for r in resps.values():
            v = np.asarray(r["values"])
            if v.ndim == 2 and v.shape[1] > 0:
                dim = v.shape[1]
                break
        values = np.zeros((len(ids), dim), dtype=np.float32)
        unknown_parts = []
        for s, r in resps.items():
            v = np.asarray(r["values"])
            if dim and v.ndim == 2 and v.shape[1] == dim:
                values[pos[s]] = v
                unk = np.asarray(r["unknown_index"], dtype=np.int64)
            else:
                # the shard has no such layer yet: every id there is unknown
                unk = np.arange(len(pos[s]))
            if len(unk):
                unknown_parts.append(pos[s][unk])
        unknown = np.sort(np.concatenate(unknown_parts)) if unknown_parts else np.empty(0, np.int64)
        return values, unknown

    def update(self, layer: str, ids, values, set_if_not_exist: bool = False):
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        values = np.asarray(values, dtype=np.float32)
        shard = self._shard_of(ids)
        futs = []
        for s in range(self.num_shards):
            (where,) = np.nonzero(shard == s)
            if not len(where):
                continue
            futs.append(self._pool.submit(self._call, s, "KVUpdate", {
                "layer": layer, "ids": ids[where], "values": values[where],
                "set_if_not_exist": set_if_not_exist,
            }))
        for f in futs:
            f.result()

    def snapshot(self) -> Dict[str, Dict[int, np.ndarray]]:
        futs = [self._pool.submit(self._call, s, "KVSnapshot", {}) for s in range(self.num_shards)]
        merged: Dict[str, Dict[int, np.ndarray]] = {}
        for f in futs:
            for layer, rows in arrays_to_snapshot(f.result().get("layers") or {}).items():
                merged.setdefault(layer, {}).update(rows)
        return merged

    def restore(self, snap: Dict[str, Dict[int, np.ndarray]]):
        parts: list = [dict() for _ in range(self.num_shards)]
        for layer, rows in (snap or {}).items():
            for i, row in rows.items():
                parts[int(i) % self.num_shards].setdefault(layer, {})[int(i)] = row
        futs = [
            self._pool.submit(self._call, s, "KVRestore", {"layers": snapshot_to_arrays(part)})
            for s, part in enumerate(parts) if part
        ]
        for f in futs:
            f.result()

    def shard_lens(self) -> List[dict]:
        """Each shard's {"n": rows, "store": its store's class name}."""
        futs = [self._pool.submit(self._call, s, "KVLen", {}) for s in range(self.num_shards)]
        return [f.result() for f in futs]

    def __len__(self) -> int:
        return sum(r["n"] for r in self.shard_lens())

    def close(self):
        # drain in-flight calls before the connections close
        self._pool.shutdown(wait=True)
        for c in self._retired + self._clients:
            c.close()
        self._retired = []

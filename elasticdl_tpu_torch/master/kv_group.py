"""The master's lifecycle manager for the embedding KV shard endpoints.

The reference's `elasticdl_tpu/master/kv_group.py`, for the job's
lifetime:

- ``inproc``: each shard a `KVShardServicer` behind an `RpcServer` in
  the master's process (tests, one host);
- ``process``: each shard a `python -m
  elasticdl_tpu_torch.master.kv_shard_main` subprocess, booted and
  stopped by `shard_host` (ephemeral ports published through port
  files; the environment, the transport tier included, passes on with
  the socket directory pinned).

`start()` -> the endpoints; `store()` -> the master's
`ShardedEmbeddingStore` over them (the sparse optimizer's and the
checkpoints'); `stop()` closes the store, stops the servers and
terminates the processes (SIGKILL after a grace period).

The recovery plane's hooks (`master/recovery.py`): `generations` holds
each slot's fencing epoch, which the clients stamp on their requests;
`wire_mirrors` points each shard at its ring pair ((i + 1) % N), whose
mirror of its rows is its restore source; `poll_dead` reports each dead
shard process once; `relaunch_shard` boots a slot again, empty, at the
next generation, and moves the master's store client to it; `refence`
moves every slot's generation in place. Each slot's shm segments are
scoped by a job nonce and the slot, so that a relaunch sweeps its
SIGKILLed predecessor's.

Observability, as `PSShardGroup`'s: inproc shards register their
counters, `collect_shard_metrics` polls the shard processes, and every
generation bump is a flight record.

Not ported yet: the k8s mode and `refence`'s caller (master migration).
"""

from __future__ import annotations

import subprocess
import uuid
from typing import List, Optional

from elasticdl_tpu_torch.common.log_util import get_logger
from elasticdl_tpu_torch.obs import flight as obs_flight
from elasticdl_tpu_torch.master.shard_host import (
    collect_metrics,
    spawn_shard_processes,
    stop_shard_processes,
)
from elasticdl_tpu_torch.rpc.kv_client import ShardedEmbeddingStore

logger = get_logger(__name__)

ENTRY_MODULE = "elasticdl_tpu_torch.master.kv_shard_main"


class KVShardGroup:
    """Owns N embedding KV shard endpoints for one job."""

    def __init__(self, num_shards: int, mode: str = "inproc", boot_timeout: float = 60.0):
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        if mode not in ("inproc", "process"):
            raise ValueError(f"unknown kv group mode {mode!r} (inproc|process)")
        self._n = num_shards
        self._mode = mode
        self._boot_timeout = boot_timeout
        self.endpoints: List[str] = []
        # each slot's fencing generation, bumped on every relaunch
        self.generations: List[int] = [0] * num_shards
        # the shm segments' namespace: one nonce a job, stable a slot
        self._shm_ns = uuid.uuid4().hex[:8]
        self.servicers: list = []  # inproc only
        self._servers: list = []
        self.procs: List[subprocess.Popen] = []
        self._store: Optional[ShardedEmbeddingStore] = None
        self._reported_dead: set = set()  # poll_dead: dead Popen objects

    @property
    def num_shards(self) -> int:
        return self._n

    @property
    def mode(self) -> str:
        return self._mode

    def start(self) -> List[str]:
        if self.endpoints:
            return self.endpoints
        if self._mode == "inproc":
            for i in range(self._n):
                servicer, server = self._build_inproc_shard(i)
                self.servicers.append(servicer)
                self._servers.append(server)
                self.endpoints.append(f"localhost:{server.port}")
        else:
            self.procs, self.endpoints = spawn_shard_processes(
                self._n, ENTRY_MODULE, self._shard_cli_flags, "edlt_kv_", self._boot_timeout
            )
        logger.info("KV shard group up (%s): %s", self._mode, ", ".join(self.endpoints))
        return self.endpoints

    def _build_inproc_shard(self, i: int):
        from elasticdl_tpu_torch.master.kv_shard import KVShardServicer
        from elasticdl_tpu_torch.rpc.server import RpcServer

        servicer = KVShardServicer(i, self._n, generation=self.generations[i])
        server = RpcServer(servicer.handlers(), port=0, shm_scope=f"{self._shm_ns}.kv{i}",
                           shm_generation=self.generations[i])
        server.start()
        servicer.register_metrics()
        return servicer, server

    def _shard_cli_flags(self, i: int) -> List[str]:
        return [
            "--shard_id", str(i),
            "--num_shards", str(self._n),
            "--generation", str(self.generations[i]),
            "--shm_scope", f"{self._shm_ns}.kv{i}",
        ]

    # -- replica mirroring and the recovery hooks ------------------------------

    def wire_mirrors(self):
        """Ring mirroring: shard i forwards its writes to (i + 1) % N, so
        each shard's rows live on one pair (nothing to do with one
        shard). Idempotent: after a relaunch it points the ring at the
        new endpoint."""
        if self._n < 2:
            return
        from elasticdl_tpu_torch.rpc.client import RpcClient

        for i in range(self._n):
            c = RpcClient(self.endpoints[i])
            try:
                c.call("KVSetMirror", {"endpoint": self.endpoints[self.mirror_pair_of(i)]},
                       timeout=30.0)
            finally:
                c.close()

    def mirror_pair_of(self, shard_id: int) -> int:
        return (int(shard_id) + 1) % self._n

    def poll_dead(self) -> List[tuple]:
        """[(shard_id, exit code)] of shard processes that died, each dead
        process reported once: keyed by its Popen object, not by (shard,
        generation), for the reasons `PSShardGroup.poll_dead` gives."""
        out = []
        for i, p in enumerate(self.procs):
            if p is None or p.poll() is None or p in self._reported_dead:
                continue
            self._reported_dead.add(p)
            out.append((i, p.returncode))
        return out

    def relaunch_shard(self, shard_id: int) -> str:
        """Boot slot `shard_id` again at the next generation; it boots
        empty (the recovery plane restores its rows from the pair, then
        `wire_mirrors` re-points the ring). Returns the new endpoint."""
        i = int(shard_id)
        self.generations[i] += 1
        obs_flight.record("generation_bump", shard_kind="kv", shard=i,
                          generation=self.generations[i])
        if self._mode == "inproc":
            self._servers[i].stop()
            self.servicers[i].close()
            servicer, server = self._build_inproc_shard(i)
            self.servicers[i] = servicer
            self._servers[i] = server
            self.endpoints[i] = f"localhost:{server.port}"
        else:
            if self.procs[i].poll() is None:
                stop_shard_processes([self.procs[i]])  # fence a zombie
            procs, endpoints = spawn_shard_processes(
                1, ENTRY_MODULE, self._shard_cli_flags, "edlt_kv_", self._boot_timeout,
                shard_ids=[i],
            )
            self.procs[i] = procs[0]
            self.endpoints[i] = endpoints[0]
        if self._store is not None:
            self._store.update_endpoints(self.endpoints, self.generations)
        logger.info("KV shard %d relaunched at generation %d on %s", i,
                    self.generations[i], self.endpoints[i])
        return self.endpoints[i]

    def refence(self) -> List[int]:
        """Bump every slot's generation in place (KVRefence): the rows
        and the mirror wiring survive, and every client still stamping
        the old generation bounces. Idempotent by target."""
        from elasticdl_tpu_torch.rpc.client import RpcClient

        for i, endpoint in enumerate(self.endpoints):
            target = self.generations[i] + 1
            c = RpcClient(endpoint)
            try:
                c.call("KVRefence", {"generation": target}, timeout=10.0)
            finally:
                c.close()
            self.generations[i] = target
            obs_flight.record("generation_bump", shard_kind="kv", shard=i,
                              generation=target, refence=True)
        if self._store is not None:
            self._store.update_endpoints(self.endpoints, self.generations)
        logger.info("KV shard group refenced: generations=%s", self.generations)
        return list(self.generations)

    def collect_shard_metrics(self) -> dict:
        """Each shard process's metrics snapshot, keyed kv<i>, for the
        master's GetMetrics (`shard_host.collect_metrics`). Inproc shards
        feed the master's own registry, so they are not polled."""
        if self._mode == "inproc":
            return {}
        return collect_metrics(self.endpoints, "kv")

    def store(self) -> ShardedEmbeddingStore:
        """The master's store client over the shards, once they listen."""
        if self._store is None:
            self._store = ShardedEmbeddingStore(self.endpoints, generations=self.generations)
            self._store.wait_ready(self._boot_timeout)
        return self._store

    def stop(self):
        if self._store is not None:
            self._store.close()
            self._store = None
        for sv in self.servicers:
            sv.close()
        self.servicers = []
        for s in self._servers:
            s.stop()
        self._servers = []
        stop_shard_processes(self.procs)
        self.procs = []
        self.endpoints = []

"""The master's lifecycle manager for the embedding KV shard endpoints.

The reference's `elasticdl_tpu/master/kv_group.py` (its core), for the
job's lifetime:

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

Not ported yet: the k8s mode, replica mirroring, fencing generations,
the refence and `relaunch_shard` (the recovery plane), and the shards'
metrics scrape.
"""

from __future__ import annotations

import subprocess
from typing import List, Optional

from elasticdl_tpu_torch.common.log_util import get_logger
from elasticdl_tpu_torch.master.shard_host import stop_shard_processes
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
        self.servicers: list = []  # inproc only
        self._servers: list = []
        self.procs: List[subprocess.Popen] = []
        self._store: Optional[ShardedEmbeddingStore] = None

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
            from elasticdl_tpu_torch.master.kv_shard import KVShardServicer
            from elasticdl_tpu_torch.rpc.server import RpcServer

            for i in range(self._n):
                servicer = KVShardServicer(i, self._n)
                server = RpcServer(servicer.handlers(), port=0)
                server.start()
                self.servicers.append(servicer)
                self._servers.append(server)
                self.endpoints.append(f"localhost:{server.port}")
        else:
            self._start_processes()
        logger.info("KV shard group up (%s): %s", self._mode, ", ".join(self.endpoints))
        return self.endpoints

    def _start_processes(self):
        from elasticdl_tpu_torch.master.shard_host import spawn_shard_processes

        self.procs, self.endpoints = spawn_shard_processes(
            self._n, ENTRY_MODULE,
            lambda i: ["--shard_id", str(i), "--num_shards", str(self._n)],
            "edlt_kv_", self._boot_timeout,
        )

    def store(self) -> ShardedEmbeddingStore:
        """The master's store client over the shards, once they listen."""
        if self._store is None:
            self._store = ShardedEmbeddingStore(self.endpoints)
            self._store.wait_ready(self._boot_timeout)
        return self._store

    def stop(self):
        if self._store is not None:
            self._store.close()
            self._store = None
        for s in self._servers:
            s.stop()
        self._servers = []
        self.servicers = []
        stop_shard_processes(self.procs)
        self.procs = []
        self.endpoints = []

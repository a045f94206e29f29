"""The master's lifecycle manager for the embedding KV shard endpoints.

The reference's `elasticdl_tpu/master/kv_group.py` (its core), for the
job's lifetime:

- ``inproc``: each shard a `KVShardServicer` behind an `RpcServer` in
  the master's process (tests, one host);
- ``process``: each shard a `python -m
  elasticdl_tpu_torch.master.kv_shard_main` subprocess that binds an
  ephemeral port and publishes it through a port file (no bind races).
  The environment passes on, the transport tier included, with the
  socket directory pinned, so master, shards and workers meet in one
  place.

`start()` -> the endpoints; `store()` -> the master's
`ShardedEmbeddingStore` over them (the sparse optimizer's and the
checkpoints'); `stop()` closes the store, stops the servers, terminates
the processes (SIGKILL after a grace period) and removes the port
files' directory.

Not ported yet: the k8s mode, replica mirroring, fencing generations,
the refence and `relaunch_shard` (the recovery plane), and the shards'
metrics scrape.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

from elasticdl_tpu_torch.common.constants import ENV_UDS_DIR
from elasticdl_tpu_torch.common.log_util import get_logger
from elasticdl_tpu_torch.rpc.kv_client import ShardedEmbeddingStore

logger = get_logger(__name__)

ENTRY_MODULE = "elasticdl_tpu_torch.master.kv_shard_main"
# seconds a terminated shard process gets before it is killed
STOP_GRACE_SECONDS = 5.0


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
        self._port_dir: Optional[str] = None
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
        from elasticdl_tpu_torch.rpc import transport

        self._port_dir = tempfile.mkdtemp(prefix="edlt_kv_")
        env = dict(os.environ)
        # the fast tiers' sockets must be where the master's clients
        # and the workers look for them
        env.setdefault(ENV_UDS_DIR, transport.uds_dir())
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        port_files = []
        for i in range(self._n):
            pf = os.path.join(self._port_dir, f"shard-{i}.port")
            port_files.append(pf)
            argv = [sys.executable, "-m", ENTRY_MODULE, "--shard_id", str(i),
                    "--num_shards", str(self._n), "--port", "0", "--port_file", pf]
            self.procs.append(subprocess.Popen(argv, env=env))
        deadline = time.monotonic() + self._boot_timeout
        try:
            for i, pf in enumerate(port_files):
                while not os.path.exists(pf):
                    if self.procs[i].poll() is not None:
                        raise RuntimeError(
                            f"KV shard {i} exited rc={self.procs[i].returncode} "
                            "before publishing its port"
                        )
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"KV shard {i} did not publish a port")
                    time.sleep(0.05)
                with open(pf) as f:
                    self.endpoints.append(f"localhost:{int(f.read().strip())}")
        except Exception:
            self._stop_processes()
            raise

    def store(self) -> ShardedEmbeddingStore:
        """The master's store client over the shards, once they listen."""
        if self._store is None:
            self._store = ShardedEmbeddingStore(self.endpoints)
            self._store.wait_ready(self._boot_timeout)
        return self._store

    def _stop_processes(self):
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        for p in self.procs:
            try:
                p.wait(timeout=STOP_GRACE_SECONDS)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        if self._port_dir is not None:
            shutil.rmtree(self._port_dir, ignore_errors=True)
            self._port_dir = None

    def stop(self):
        if self._store is not None:
            self._store.close()
            self._store = None
        for s in self._servers:
            s.stop()
        self._servers = []
        self.servicers = []
        self._stop_processes()
        self.endpoints = []

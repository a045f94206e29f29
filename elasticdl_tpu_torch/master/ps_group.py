"""The master's lifecycle manager for the sharded PS endpoints.

The reference's `elasticdl_tpu/master/ps_group.py` (its core). Two
hosting modes, for the job's lifetime:

- ``inproc``: each shard a `PSShardServicer` behind an `RpcServer` on
  threads of the master's process (tests, one host: still N sockets and
  N locks);
- ``process``: each shard a `python -m
  elasticdl_tpu_torch.master.ps_shard_main` subprocess with its own
  interpreter, booted and stopped by `shard_host` (the environment, the
  transport tier included, passes on with the socket directory pinned,
  so master, shards and workers meet on one tier).

Each shard gets the zoo's optimizer (inproc: `optimizer_factory()`;
process: the model-spec flags, from which the shard resolves it), the
job's sync settings and a dedup ring sized by `dedup_cap_for`.

The model plane: `client(n_params)` is the master's `ShardedPS` over
the shards; `ensure_init` seeds them (SETNX), `export_opt` /
`restore_opt` carry the per-shard optimizer state of a checkpoint (the
same shard count only: slices do not re-split), `assemble` pulls the
whole model (a relaxed snapshot: the slices may straddle a step), and
`stats` reads each shard's counters for the master's summary. `stop()`
closes the client, stops the servers and terminates the processes.

A dead shard is not a job failure: the recovery plane
(`master/recovery.py`) relaunches its slot. `generations` holds each
slot's fencing epoch, which every client stamps on its requests;
`poll_dead` reports each dead shard process once; `relaunch_shard` boots
a slot again, empty, at the next generation, and moves the master's
client to it (the plane then seeds it); `refence` moves every slot's
generation in place (PSRefence). Each slot's shm segments are scoped by
a job nonce and the slot, so that a relaunch sweeps its SIGKILLed
predecessor's.

Observability: inproc shards register their counters with the master's
metrics registry; `collect_shard_metrics` polls each shard process's
GetMetrics for the master's; every generation bump is a flight record
(`generation_bump`, `obs/flight.py`).

Not ported yet: the k8s pods and `refence`'s caller (master migration).
"""

from __future__ import annotations

import subprocess
import uuid
from typing import List, Optional

import numpy as np

from elasticdl_tpu_torch.common.log_util import get_logger
from elasticdl_tpu_torch.obs import flight as obs_flight
from elasticdl_tpu_torch.master.shard_host import (
    collect_metrics,
    spawn_shard_processes,
    stop_shard_processes,
)
from elasticdl_tpu_torch.rpc.ps_client import ShardedPS

logger = get_logger(__name__)

ENTRY_MODULE = "elasticdl_tpu_torch.master.ps_shard_main"
# seconds the shards get to publish their ports and to listen
BOOT_TIMEOUT_SECONDS = 60.0


class PSShardGroup:
    """Owns N PS shard endpoints for one job."""

    def __init__(
        self,
        num_shards: int,
        mode: str = "inproc",
        optimizer_factory=None,  # () -> the zoo's optimizer (inproc)
        shard_argv: Optional[List[str]] = None,  # model-spec flags (process)
        grads_to_wait: int = 1,
        use_async: bool = False,
        lr_staleness_modulation: bool = False,
        staleness_window: int = 0,
        num_workers: int = 1,
    ):
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        if mode not in ("inproc", "process"):
            raise ValueError(f"unknown ps group mode {mode!r} (inproc|process)")
        if mode == "process" and shard_argv is None:
            raise ValueError("process mode needs the model-spec argv")
        self._n = num_shards
        self._mode = mode
        self._opt_factory = optimizer_factory
        self._shard_argv = list(shard_argv or [])
        self._sync_flags = dict(
            grads_to_wait=grads_to_wait,
            use_async=use_async,
            lr_staleness_modulation=lr_staleness_modulation,
            staleness_window=staleness_window,
        )
        self._dedup_cap = self.dedup_cap_for(num_workers)
        self.endpoints: List[str] = []
        # each slot's fencing generation, bumped on every relaunch
        self.generations: List[int] = [0] * num_shards
        # the shm segments' namespace: one nonce a job, stable a slot
        self._shm_ns = uuid.uuid4().hex[:8]
        self._servers: list = []  # inproc only
        self.servicers: list = []  # inproc only
        self.procs: List[subprocess.Popen] = []
        self._client: Optional[ShardedPS] = None
        self._reported_dead: set = set()  # poll_dead: dead Popen objects

    @staticmethod
    def dedup_cap_for(num_workers: int, max_inflight_syncs: int = 8) -> int:
        """Dedup ring capacity: only a key whose sync is still in flight
        can be re-sent, so the ring must hold num_workers x syncs in
        flight a worker; x4 headroom, and the 512 floor of a servicer
        built alone."""
        return max(512, int(num_workers) * int(max_inflight_syncs) * 4)

    @property
    def num_shards(self) -> int:
        return self._n

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> List[str]:
        if self.endpoints:
            return self.endpoints
        if self._mode == "inproc":
            self._start_inproc()
        else:
            self.procs, self.endpoints = spawn_shard_processes(
                self._n, ENTRY_MODULE, self._shard_cli_flags, "edlt_ps_", BOOT_TIMEOUT_SECONDS
            )
        logger.info("PS shard group up (%s): %s", self._mode, ", ".join(self.endpoints))
        return self.endpoints

    def _shard_cli_flags(self, shard_id: int) -> List[str]:
        flags = [
            "--shard_id", str(shard_id),
            "--num_shards", str(self._n),
            "--generation", str(self.generations[shard_id]),
            "--shm_scope", f"{self._shm_ns}.ps{shard_id}",
            "--dedup_cap", str(self._dedup_cap),
            "--grads_to_wait", str(self._sync_flags["grads_to_wait"]),
            "--staleness_window", str(self._sync_flags["staleness_window"]),
        ] + self._shard_argv
        if self._sync_flags["use_async"]:
            flags.append("--use_async")
        if self._sync_flags["lr_staleness_modulation"]:
            flags.append("--lr_staleness_modulation")
        return flags

    def _start_inproc(self):
        try:
            for i in range(self._n):
                servicer, server = self._build_inproc_shard(i)
                self.servicers.append(servicer)
                self._servers.append(server)
                self.endpoints.append(f"localhost:{server.port}")
        except BaseException:
            self.stop()
            raise

    def _build_inproc_shard(self, i: int):
        from elasticdl_tpu_torch.master.ps_optimizer import PSOptimizer
        from elasticdl_tpu_torch.master.ps_shard import PSShardServicer
        from elasticdl_tpu_torch.rpc.server import RpcServer

        opt = PSOptimizer(self._opt_factory()) if self._opt_factory is not None else None
        servicer = PSShardServicer(i, self._n, optimizer=opt, generation=self.generations[i],
                                   dedup_cap=self._dedup_cap, **self._sync_flags)
        server = RpcServer(servicer.handlers(), port=0, shm_scope=f"{self._shm_ns}.ps{i}",
                           shm_generation=self.generations[i])
        server.start()
        servicer.register_metrics()
        return servicer, server

    # -- the recovery plane's hooks --------------------------------------------

    def poll_dead(self) -> List[tuple]:
        """[(shard_id, exit code)] of shard processes that died, each dead
        process reported once. The key is the Popen object, not (shard,
        generation): the relaunch bumps the generation before the new
        process takes the slot, so a generation key would report the old
        corpse again under the new generation, and then miss a real
        second death."""
        out = []
        for i, p in enumerate(self.procs):
            if p is None or p.poll() is None or p in self._reported_dead:
                continue
            self._reported_dead.add(p)
            out.append((i, p.returncode))
        return out

    def relaunch_shard(self, shard_id: int) -> str:
        """Boot slot `shard_id` again at the next generation; it boots
        empty, and the caller (the recovery plane) seeds it before the
        endpoint is advertised to the workers. The master's client moves
        to it. Returns the new endpoint."""
        i = int(shard_id)
        self.generations[i] += 1
        obs_flight.record("generation_bump", shard_kind="ps", shard=i,
                          generation=self.generations[i])
        if self._mode == "inproc":
            self._servers[i].stop()
            servicer, server = self._build_inproc_shard(i)
            self.servicers[i] = servicer
            self._servers[i] = server
            self.endpoints[i] = f"localhost:{server.port}"
        else:
            if self.procs[i].poll() is None:
                stop_shard_processes([self.procs[i]])  # fence a zombie
            procs, endpoints = spawn_shard_processes(
                1, ENTRY_MODULE, self._shard_cli_flags, "edlt_ps_", BOOT_TIMEOUT_SECONDS,
                shard_ids=[i],
            )
            self.procs[i] = procs[0]
            self.endpoints[i] = endpoints[0]
        if self._client is not None:
            self._client.update_endpoints(self.endpoints, self.generations)
        logger.info("PS shard %d relaunched at generation %d on %s", i,
                    self.generations[i], self.endpoints[i])
        return self.endpoints[i]

    def refence(self) -> List[int]:
        """Bump every slot's generation in place (PSRefence): the slices
        survive, and every client still stamping the old generation
        bounces with FAILED_PRECONDITION. Idempotent by target: a re-sent
        cutover re-sends the current generation, which the shard takes
        as a no-op."""
        from elasticdl_tpu_torch.rpc.client import RpcClient

        for i, endpoint in enumerate(self.endpoints):
            target = self.generations[i] + 1
            c = RpcClient(endpoint)
            try:
                c.call("PSRefence", {"generation": target}, timeout=10.0)
            finally:
                c.close()
            self.generations[i] = target
            obs_flight.record("generation_bump", shard_kind="ps", shard=i,
                              generation=target, refence=True)
        if self._client is not None:
            self._client.update_endpoints(self.endpoints, self.generations)
        logger.info("PS shard group refenced: generations=%s", self.generations)
        return list(self.generations)

    def stop(self):
        if self._client is not None:
            self._client.close()
            self._client = None
        for s in self._servers:
            s.stop()
        self._servers = []
        self.servicers = []
        stop_shard_processes(self.procs)
        self.procs = []
        self.endpoints = []

    def collect_shard_metrics(self) -> dict:
        """Each shard process's metrics snapshot, keyed ps<i>, for the
        master's GetMetrics (`shard_host.collect_metrics`). Inproc shards
        feed the master's own registry, so they are not polled."""
        if self._mode == "inproc":
            return {}
        return collect_metrics(self.endpoints, "ps")

    # -- the model plane -----------------------------------------------------

    def client(self, n_params: Optional[int] = None) -> ShardedPS:
        """The master's fan-out client; the first call names the model's
        size and waits for every shard to listen."""
        if self._client is None:
            if n_params is None:
                raise RuntimeError("the PS group's client needs n_params once")
            client = ShardedPS(self.endpoints, int(n_params), generations=self.generations)
            try:
                client.wait_ready(BOOT_TIMEOUT_SECONDS)
            except BaseException:
                client.close()
                raise
            self._client = client
        return self._client

    @property
    def initialized(self) -> bool:
        return self._client is not None

    def ensure_init(self, vec: np.ndarray, version: int = 0) -> List[int]:
        """Seed every shard with its slice (SETNX: idempotent)."""
        vec = np.asarray(vec, dtype=np.float32)
        return self.client(vec.size).init_model(vec, version)

    def export_opt(self) -> Optional[List[Optional[list]]]:
        """Each shard's optimizer-state leaves, for a checkpoint."""
        if self._client is None:
            return None
        return self._client.export_opt()

    def restore_opt(self, shards):
        """Adopt a checkpoint's per-shard optimizer state (after
        ensure_init); raises ValueError on another shard count."""
        self.client().restore_opt(shards)

    def assemble(self, model_dtype: Optional[str] = None):
        """(shard versions, the whole flat model)."""
        if self._client is None:
            raise RuntimeError("PS group not initialized")
        return self._client.pull(model_dtype=model_dtype)

    def stats(self) -> List[dict]:
        """Each shard's counters ([] before the model is seeded)."""
        if self._client is None:
            return []
        return self._client.stats()

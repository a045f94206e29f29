"""Worker lifecycle backends.

The elasticity signal path is: backend watch -> PodEvent ->
WorkerManager callback -> TaskDispatcher.recover_tasks + relaunch, as in
the reference (`elasticdl_tpu/cluster/pod_backend.py`).

`ProcessBackend` realizes "pods" as local worker subprocesses
(`python -m elasticdl_tpu_torch.worker.main`): a monitor thread polls
for exits and synthesizes SUCCEEDED, FAILED and DELETED events, so a
SIGKILL on a worker process looks to the WorkerManager exactly like a
pod preemption. Deleting a worker, and stopping the backend, send
SIGTERM first: the worker drains (finishes its task, lands its window
syncs and reports) and exits; only one still alive after
DRAIN_GRACE_SECONDS is SIGKILLed.

Not ported yet: the k8s backend, victim ordering for policy stops, and
PS / KV shard replicas.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import elasticdl_tpu_torch
from elasticdl_tpu_torch.common.log_util import get_logger
from elasticdl_tpu_torch.rpc.chaos import chaos_env_for

logger = get_logger(__name__)

# the directory holding the package, put on each worker's PYTHONPATH so
# that the child imports it whatever its working directory
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(elasticdl_tpu_torch.__file__)))
WORKER_MODULE = "elasticdl_tpu_torch.worker.main"
# how often the monitor thread polls the worker processes for exits
POLL_SECONDS = 0.1
# how long a worker sent SIGTERM may take to drain (finish its task, land
# its window syncs and task reports) before it is SIGKILLed
DRAIN_GRACE_SECONDS = 30.0


class PodPhase:
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    DELETED = "Deleted"


@dataclass
class PodEvent:
    """One lifecycle transition of a worker process."""

    worker_id: int
    phase: str
    exit_code: Optional[int] = None


@dataclass
class _ProcEntry:
    proc: subprocess.Popen
    reported: bool = False
    deleted: bool = False


class ProcessBackend:
    """Workers as local subprocesses of `WORKER_MODULE`. The monitor
    thread fires the event callback with SUCCEEDED (exit 0), FAILED
    (nonzero) or DELETED (killed by a signal, or after delete_worker).
    With `log_dir`, each worker's stdout and stderr go to
    `log_dir/worker-<id>.log`."""

    def __init__(self, log_dir: str = ""):
        self._log_dir = log_dir
        self._procs: Dict[int, _ProcEntry] = {}
        self._lock = threading.Lock()
        self._cb: Optional[Callable[[PodEvent], None]] = None
        self._stop = threading.Event()
        self._monitor = threading.Thread(target=self._watch, daemon=True)
        self._monitor.start()

    def set_event_callback(self, cb: Callable[[PodEvent], None]):
        # the monitor thread reads the callback per event
        with self._lock:
            self._cb = cb

    def start_worker(self, worker_id: int, argv: List[str], envs: Dict[str, str]):
        env = dict(os.environ)
        env.update(envs)
        env["PYTHONPATH"] = (
            _PKG_ROOT + os.pathsep + env["PYTHONPATH"]
            if env.get("PYTHONPATH")
            else _PKG_ROOT
        )
        # chaos scoping: an inherited EDL_CHAOS_SPEC applies with role and
        # target filters (inert when chaos is off), and a spec aimed at
        # workers never fires inside the master
        env.update(chaos_env_for("worker", worker_id))
        cmd = [sys.executable, "-m", WORKER_MODULE] + list(argv)
        logf = None
        if self._log_dir:
            os.makedirs(self._log_dir, exist_ok=True)
            logf = open(os.path.join(self._log_dir, f"worker-{worker_id}.log"), "ab")
        try:
            proc = subprocess.Popen(cmd, env=env, stdout=logf, stderr=logf)
        finally:
            if logf is not None:
                logf.close()  # the child holds its own descriptor
        with self._lock:
            self._procs[worker_id] = _ProcEntry(proc=proc)
            cb = self._cb
        logger.info("Started worker %d (pid %d)", worker_id, proc.pid)
        if cb:
            cb(PodEvent(worker_id, PodPhase.RUNNING))

    def delete_worker(self, worker_id: int):
        with self._lock:
            entry = self._procs.get(worker_id)
            if entry is None or entry.proc.poll() is not None:
                return
            entry.deleted = True
        try:
            entry.proc.send_signal(signal.SIGTERM)
            try:
                entry.proc.wait(timeout=DRAIN_GRACE_SECONDS)
            except subprocess.TimeoutExpired:
                entry.proc.kill()
        except ProcessLookupError:  # already gone
            pass

    def pid_of(self, worker_id: int) -> Optional[int]:
        with self._lock:
            entry = self._procs.get(worker_id)
        if entry is None or entry.proc.poll() is not None:
            return None
        return entry.proc.pid

    def _watch(self):
        while not self._stop.is_set():
            events = []
            with self._lock:
                for wid, entry in self._procs.items():
                    if entry.reported:
                        continue
                    rc = entry.proc.poll()
                    if rc is None:
                        continue
                    entry.reported = True
                    if entry.deleted or rc < 0:
                        # deleted or killed by a signal: the preemption
                        # shape, whose tasks must be recovered
                        phase = PodPhase.DELETED
                    elif rc == 0:
                        phase = PodPhase.SUCCEEDED
                    else:
                        phase = PodPhase.FAILED
                    events.append(PodEvent(wid, phase, exit_code=rc))
                cb = self._cb
            for ev in events:
                logger.info(
                    "Worker %d exited: %s (rc=%s)", ev.worker_id, ev.phase, ev.exit_code
                )
                if cb:
                    try:
                        cb(ev)
                    except Exception:
                        logger.exception("pod event callback failed")
            self._stop.wait(POLL_SECONDS)

    def stop(self):
        self._stop.set()
        with self._lock:
            entries = list(self._procs.values())
            live = [e for e in entries if e.proc.poll() is None]
            for entry in live:
                entry.deleted = True
        for entry in live:
            entry.proc.terminate()
        deadline = time.monotonic() + DRAIN_GRACE_SECONDS
        for entry in entries:
            try:
                entry.proc.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                entry.proc.kill()
                entry.proc.wait()
        self._monitor.join(timeout=5)

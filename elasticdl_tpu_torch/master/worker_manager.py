"""WorkerManager: the elasticity controller.

The reference's `WorkerManager` (`elasticdl_tpu/master/
worker_manager.py`) over a backend with `ProcessBackend`'s methods:

- `start_workers()` launches N workers with incrementing ids;
- on a FAILED or DELETED event the dead worker's in-flight tasks are
  requeued (`task_dispatcher.recover_tasks`) and a replacement is
  launched with a FRESH id, so the dispatcher's doing-map stays
  unambiguous across generations;
- SUCCEEDED workers, and workers that exit EXIT_CODE_JOB_FAILED (the job
  finished with dropped tasks), are not relaunched; a worker that exits
  EXIT_CODE_MASTER_UNREACHABLE is, and so is one that an injected chaos
  crash ended (`rpc/chaos.CHAOS_CRASH_EXIT_CODE`, 117): any other exit is;
- `max_relaunches` bounds crash loops;
- a terminal event for a worker already terminal is ignored;
- `stop_relaunch_and_remove_workers()` for teardown.

Warm standby workers (`num_standby`), as the reference has them: a
standby is a booted worker process that the servicer refuses tasks to
(`is_standby`); it pulls the model and pre-warms on a sample batch, then
waits. When an active worker dies, the lowest-id standby is PROMOTED in
the event callback (it launches nothing, so the relaunch budget does not
gate it), and a replacement standby is launched to refill the pool. A
dead standby is refilled without a task recovery. Ids are marked standby
before their process starts, so a standby's first GetTask already sees
it.

Not ported yet: policy stops (autoscaler, QoS preemption), the PS / KV
shard hooks and the migration state.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from elasticdl_tpu_torch.cluster.pod_backend import PodEvent, PodPhase
from elasticdl_tpu_torch.common.constants import (
    EXIT_CODE_JOB_FAILED,
    EXIT_CODE_MASTER_UNREACHABLE,
)
from elasticdl_tpu_torch.common.log_util import get_logger

logger = get_logger(__name__)

_TERMINAL = (PodPhase.SUCCEEDED, PodPhase.FAILED, PodPhase.DELETED)


class WorkerManager:
    def __init__(
        self,
        backend,
        task_dispatcher,
        num_workers: int,
        worker_argv_fn: Callable[[int], List[str]],
        envs: Optional[Dict[str, str]] = None,
        max_relaunches: int = 10,
        num_standby: int = 0,
    ):
        self._backend = backend
        self._task_d = task_dispatcher
        self._num_workers = num_workers
        self._num_standby = num_standby
        self._argv_fn = worker_argv_fn
        self._envs = envs or {}
        self._max_relaunches = max_relaunches
        self._lock = threading.Lock()
        self._next_id = 0
        self._relaunches = 0
        self._promotions = 0
        self._relaunch = True
        self._phases: Dict[int, str] = {}
        self._standby: set = set()  # worker ids held in reserve
        self._live = 0
        backend.set_event_callback(self._event_cb)

    # -- lifecycle ----------------------------------------------------------

    def start_workers(self):
        for _ in range(self._num_workers):
            self._start_one()
        for _ in range(self._num_standby):
            self._start_one(standby=True)

    def _start_one(self, live_reserved: bool = False, standby: bool = False):
        with self._lock:
            worker_id = self._next_id
            self._next_id += 1
            self._phases[worker_id] = PodPhase.PENDING
            if standby:
                self._standby.add(worker_id)
            if not live_reserved:
                self._live += 1
        self._backend.start_worker(worker_id, self._argv_fn(worker_id), self._envs)

    def is_standby(self, worker_id: int) -> bool:
        """The servicer's hook: a standby gets WAIT instead of tasks."""
        with self._lock:
            return worker_id in self._standby

    def stop_relaunch_and_remove_workers(self):
        with self._lock:
            self._relaunch = False
            ids = [
                wid
                for wid, phase in self._phases.items()
                if phase in (PodPhase.PENDING, PodPhase.RUNNING)
            ]
        for wid in ids:
            self._backend.delete_worker(wid)

    # -- elasticity ---------------------------------------------------------

    def _event_cb(self, event: PodEvent):
        """Phase bookkeeping, task recovery and relaunch."""
        done = event.phase in _TERMINAL
        # "completed with dropped poison tasks" is a deliberate terminal
        # state: a relaunch would only exit 2 again
        completed = event.phase == PodPhase.SUCCEEDED or (
            event.exit_code == EXIT_CODE_JOB_FAILED
        )
        if done and event.exit_code == EXIT_CODE_MASTER_UNREACHABLE:
            logger.warning(
                "Worker %d exited %d (RPC peer unreachable); "
                "treating as relaunch-eligible",
                event.worker_id,
                event.exit_code,
            )
        with self._lock:
            # a worker already terminal must not re-decrement the live
            # count, trigger another relaunch or be resurrected
            if self._phases.get(event.worker_id) in _TERMINAL:
                return
            self._phases[event.worker_id] = event.phase
            dead_standby = False
            promoted = None
            if done:
                self._live = max(0, self._live - 1)
                dead_standby = event.worker_id in self._standby
                self._standby.discard(event.worker_id)
            recoverable = done and not completed and self._relaunch
            if recoverable and not dead_standby and self._standby:
                # a warm standby takes over at once; the promotion launches
                # nothing, so only the refill below spends the budget
                promoted = min(self._standby)
                self._standby.discard(promoted)
                self._promotions += 1
            should_relaunch = recoverable and self._relaunches < self._max_relaunches
            if should_relaunch:
                self._relaunches += 1
                # reserve the replacement's live slot here, so that
                # all_exited() never reads 0 while it is being launched
                self._live += 1
        if not done:
            return
        if event.phase != PodPhase.SUCCEEDED and not dead_standby:
            logger.info(
                "Worker %d %s: recovering tasks%s%s",
                event.worker_id,
                event.phase,
                f", promoting standby {promoted}" if promoted is not None else "",
                ", relaunching" if should_relaunch else "",
            )
            self._task_d.recover_tasks(event.worker_id)
        if should_relaunch:
            # the replacement joins as a standby when one was promoted (the
            # promotion restored the active count) or when a standby died
            self._start_one(live_reserved=True, standby=promoted is not None or dead_standby)

    # -- introspection ------------------------------------------------------

    def phases(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._phases)

    def relaunches(self) -> int:
        with self._lock:
            return self._relaunches

    def promotions(self) -> int:
        with self._lock:
            return self._promotions

    def all_exited(self) -> bool:
        with self._lock:
            return self._live == 0 and bool(self._phases)

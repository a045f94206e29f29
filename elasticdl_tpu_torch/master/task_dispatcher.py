"""Dynamic data sharder: the task queue that makes training elastic.

The reference's `TaskDispatcher`, carried over for the slice's path
(no speculation, goodput counters or migration export):

- shards `{file: num_records}` into Tasks of `records_per_task` records;
- shuffles training tasks per epoch and lazily rolls epochs;
- `get(worker_id)` moves a task todo -> doing;
- `report(task_id, success)` requeues failures, dropping a task after
  `max_task_retries` failures;
- `recover_tasks(worker_id)` requeues every in-flight task of a dead
  worker.

With the same `shuffle_seed` it hands out tasks in the reference's order.
"""

from __future__ import annotations

import random
import threading
from typing import Dict, List, Optional, Tuple

from elasticdl_tpu_torch.common.log_util import get_logger
from elasticdl_tpu_torch.common.messages import Task, TaskType

logger = get_logger(__name__)


class TaskDispatcher:
    def __init__(
        self,
        training_shards: Dict[str, int],
        evaluation_shards: Dict[str, int],
        prediction_shards: Dict[str, int],
        records_per_task: int,
        num_epochs: int,
        max_task_retries: int = 10,
        shuffle_seed: Optional[int] = None,
    ):
        if evaluation_shards or prediction_shards:
            raise NotImplementedError(
                "evaluation and prediction tasks are not ported yet"
            )
        self._lock = threading.Lock()
        # a seed pins the epoch shuffle order; None uses the
        # process-global stream, as the reference does
        self._shuffle_rng = (
            random.Random(shuffle_seed) if shuffle_seed is not None else random
        )
        self._max_task_retries = max_task_retries
        self._retry_count: Dict[int, int] = {}
        self.failed_tasks: List[Task] = []
        self._training_shards = training_shards
        self._records_per_task = records_per_task
        self._num_epochs = num_epochs
        self._epoch = 0
        self._task_id = 0
        self._attempt_seq = 0
        self._todo: List[Task] = []
        self._doing: Dict[int, Tuple[int, Task]] = {}  # id -> (worker, task)
        self._completed_records = 0
        if self._training_shards:
            logger.info("Starting epoch %d", self._epoch)
            self._create_training_tasks()

    def _create_training_tasks(self):
        tasks = []
        for name, num_records in self._training_shards.items():
            for start in range(0, num_records, self._records_per_task):
                tasks.append(
                    Task(
                        shard_file_name=name,
                        start=start,
                        end=min(start + self._records_per_task, num_records),
                        type=TaskType.TRAINING,
                    )
                )
        self._shuffle_rng.shuffle(tasks)
        for t in tasks:
            self._task_id += 1
            t.task_id = self._task_id
            self._todo.append(t)

    def get(self, worker_id: int) -> Optional[Task]:
        """Pop the next task (todo -> doing); lazily roll the next epoch.
        Returns None when nothing is available."""
        with self._lock:
            if not self._todo and self._epoch < self._num_epochs - 1:
                self._epoch += 1
                logger.info("Starting epoch %d", self._epoch)
                self._create_training_tasks()
            if not self._todo:
                return None
            task = self._todo.pop(0)
            if not task.spec_key:
                self._attempt_seq += 1
                task.spec_key = f"t{task.task_id}.a{self._attempt_seq}"
            self._doing[task.task_id] = (worker_id, task)
            return task

    def report(
        self, task_id: int, success: bool, worker_id: Optional[int] = None
    ) -> bool:
        """Worker reports task done/failed; failures are requeued.
        Returns False for unknown ids and for a report from a worker
        that no longer owns the task."""
        with self._lock:
            worker_and_task = self._doing.get(task_id)
            if worker_and_task is None:
                logger.warning("Unknown task completion report: %d", task_id)
                return False
            owner, task = worker_and_task
            if worker_id is not None and owner != worker_id:
                logger.warning(
                    "Stale report for task %d from worker %d (owned by %d)",
                    task_id, worker_id, owner,
                )
                return False
            del self._doing[task_id]
            if success:
                self._completed_records += task.end - task.start
                return True
            n = self._retry_count.get(task_id, 0) + 1
            self._retry_count[task_id] = n
            if n >= self._max_task_retries:
                logger.error(
                    "Task %d failed %d times, dropping (poison task)", task_id, n
                )
                self.failed_tasks.append(task)
            else:
                logger.warning("Task %d failed, requeueing", task_id)
                self._todo.append(task)
            return True

    def recover_tasks(self, worker_id: int):
        """Requeue every in-flight task of a dead worker."""
        with self._lock:
            for tid in [
                tid for tid, (wid, _) in self._doing.items() if wid == worker_id
            ]:
                _, task = self._doing.pop(tid)
                logger.info("Recovering task %d from dead worker %d", tid, worker_id)
                self._todo.append(task)

    def completed_records(self) -> int:
        with self._lock:
            return self._completed_records

    def finished(self) -> bool:
        """All epochs exhausted and nothing in flight (True even when
        tasks were dropped; check `has_failed_tasks()`)."""
        with self._lock:
            if self._training_shards and self._epoch < self._num_epochs - 1:
                return False
            return not self._todo and not self._doing

    def has_failed_tasks(self) -> bool:
        with self._lock:
            return bool(self.failed_tasks)

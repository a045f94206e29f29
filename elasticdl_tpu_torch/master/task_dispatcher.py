"""Dynamic data sharder: the task queue that makes training elastic.

The reference's `TaskDispatcher` (no speculation, goodput counters or
migration export):

- shards `{file: num_records}` into Tasks of `records_per_task` records;
- shuffles training tasks per epoch and lazily rolls epochs;
- evaluation tasks are pinned to a model version: a standalone
  evaluation job's to `eval_model_version` (the checkpoint the master
  booted from), a training job's to the version its evaluation service
  snapshots (`create_evaluation_tasks`); a prediction job's tasks are
  made up front;
- `get(worker_id)` moves a task todo -> doing;
- `report(task_id, success)` requeues failures, dropping a task after
  `max_task_retries` failures; a completed EVALUATION task, or a
  dropped one, is counted toward its evaluation job (else the job
  would never finish and every worker would wait on it);
- `recover_tasks(worker_id)` requeues every in-flight task of a dead
  worker.

With the same `shuffle_seed` it hands out tasks in the reference's order,
with the reference's ids and ranges.
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
        eval_model_version: int = -1,
        shuffle_seed: Optional[int] = None,
    ):
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
        self._evaluation_shards = evaluation_shards
        self._prediction_shards = prediction_shards
        self._evaluation_service = None
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
        elif self._evaluation_shards:
            self._extend_todo(
                self._shard_to_tasks(
                    self._evaluation_shards, TaskType.EVALUATION, eval_model_version
                )
            )
        elif self._prediction_shards:
            self._extend_todo(self._shard_to_tasks(self._prediction_shards, TaskType.PREDICTION))

    def _shard_to_tasks(self, shards: Dict[str, int], task_type: str, model_version: int = -1):
        tasks = []
        for name, num_records in shards.items():
            for start in range(0, num_records, self._records_per_task):
                tasks.append(
                    Task(
                        shard_file_name=name,
                        start=start,
                        end=min(start + self._records_per_task, num_records),
                        type=task_type,
                        model_version=model_version,
                    )
                )
        return tasks

    def _create_training_tasks(self):
        tasks = self._shard_to_tasks(self._training_shards, TaskType.TRAINING)
        self._shuffle_rng.shuffle(tasks)
        self._extend_todo(tasks)

    def _extend_todo(self, tasks):  # caller holds self._lock, or is __init__
        for t in tasks:
            self._task_id += 1
            t.task_id = self._task_id
            self._todo.append(t)

    def create_evaluation_tasks(self, model_version: int) -> int:
        """Queue EVALUATION tasks pinned to `model_version`; returns how
        many."""
        with self._lock:
            tasks = self._shard_to_tasks(
                self._evaluation_shards, TaskType.EVALUATION, model_version
            )
            self._extend_todo(tasks)
            return len(tasks)

    def set_evaluation_service(self, evaluation_service):
        self._evaluation_service = evaluation_service

    def get(self, worker_id: int) -> Optional[Task]:
        """Pop the next task (todo -> doing); lazily roll the next epoch.
        Returns None when nothing is available."""
        with self._lock:
            if (
                not self._todo
                and self._training_shards
                and self._epoch < self._num_epochs - 1
            ):
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
        evaluation_task_completed = False
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
            is_eval = task.type == TaskType.EVALUATION
            if success:
                if task.type == TaskType.TRAINING:
                    self._completed_records += task.end - task.start
                evaluation_task_completed = is_eval
            else:
                n = self._retry_count.get(task_id, 0) + 1
                self._retry_count[task_id] = n
                if n >= self._max_task_retries:
                    logger.error(
                        "Task %d failed %d times, dropping (poison task)", task_id, n
                    )
                    self.failed_tasks.append(task)
                    evaluation_task_completed = is_eval
                else:
                    logger.warning("Task %d failed, requeueing", task_id)
                    self._todo.append(task)
        if evaluation_task_completed and self._evaluation_service is not None:
            self._evaluation_service.complete_task()
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
        """Training records completed, across epochs."""
        with self._lock:
            return self._completed_records

    def finished(self) -> bool:
        """All epochs exhausted and nothing in flight (True even when
        tasks were dropped; check `has_failed_tasks()`)."""
        with self._lock:
            if self._training_shards and self._epoch < self._num_epochs - 1:
                return False
            return not self._todo and not self._doing

    def pending_count(self, task_type: Optional[str] = None) -> int:
        """Queued (todo) tasks, optionally of one type."""
        with self._lock:
            if task_type is None:
                return len(self._todo)
            return sum(1 for t in self._todo if t.type == task_type)

    def has_failed_tasks(self) -> bool:
        with self._lock:
            return bool(self.failed_tasks)

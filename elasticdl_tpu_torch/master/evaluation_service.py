"""Evaluation during training (`elasticdl_tpu/master/evaluation_service.py`).

- `_EvaluationJob` accumulates each scalar metric as an example-weighted
  sum over the workers' minibatch reports and averages at completion;
  mergeable states (`api/metrics.py`) are summed and finalized exactly;
- the step trigger fires when a version bump crosses a multiple of
  `eval_steps` (floor crossing, so a multi-step bump cannot skip one),
  one evaluation job at a time; the time trigger is a daemon thread
  that fires after `start_delay_secs`, then every `throttle_secs`;
- each job pins the current model through the checkpoint service's
  eval snapshot, written before its EVALUATION tasks exist (a worker
  pulls that version FIXED the moment it gets a task);
- at completion the metrics go to `completed_metrics` (and the job's
  seconds from its creation to its last task to `job_seconds`) and the
  metrics writer, and the snapshot is deleted.

`has_pending` keeps workers alive while a job is in flight (the last
training report can create an evaluation job after the dispatcher has
run dry) and the master up while a finished job delivers its metrics.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from elasticdl_tpu_torch.api.metrics import (
    finalize_metric_state,
    is_mergeable_state,
    merge_metric_states,
)
from elasticdl_tpu_torch.common.log_util import get_logger

logger = get_logger(__name__)


class _EvaluationJob:
    def __init__(self, model_version: int, total_tasks: int = -1):
        self.model_version = model_version
        self._total_tasks = total_tasks
        self._completed_tasks = 0
        self._metric_sums: Dict[str, float] = {}
        self._metric_states: Dict[str, Dict] = {}
        self._num_examples = 0
        self.created = time.monotonic()

    def complete_task(self):
        self._completed_tasks += 1

    def finished(self) -> bool:
        return self._completed_tasks >= self._total_tasks

    def report_metrics(self, metrics: Dict, num_examples: int):
        for name, value in metrics.items():
            if is_mergeable_state(value):
                acc = self._metric_states.get(name)
                self._metric_states[name] = merge_metric_states(acc, value) if acc else dict(value)
            else:
                self._metric_sums[name] = (
                    self._metric_sums.get(name, 0.0) + float(value) * num_examples
                )
        self._num_examples += num_examples

    def get_metrics(self) -> Dict[str, float]:
        # empty only when nothing at all was reported: a states-only job
        # still finalizes its states
        if not self._metric_sums and not self._metric_states:
            return {}
        out = {}
        if self._num_examples:
            out = {k: v / self._num_examples for k, v in self._metric_sums.items()}
        for name, state in self._metric_states.items():
            out[name] = finalize_metric_state(state)
        return out


class _EvaluationTrigger(threading.Thread):
    """The time trigger: a daemon thread."""

    def __init__(self, eval_service, start_delay_secs: float, throttle_secs: float):
        super().__init__(daemon=True)
        self._service = eval_service
        self._start_delay = start_delay_secs
        self._throttle = throttle_secs
        self._stopper = threading.Event()

    def stop(self):
        self._stopper.set()

    def run(self):
        start_time = time.time()
        previous = float("-inf")
        while not self._stopper.is_set():
            now = time.time()
            if now - start_time > self._start_delay and now - previous >= self._throttle:
                self._service.add_evaluation_task()
                previous = now
            self._stopper.wait(1.0)


class EvaluationService:
    def __init__(
        self,
        checkpoint_service,
        task_dispatcher,
        start_delay_secs: float = 0,
        throttle_secs: float = 0,
        eval_steps: int = 0,
        time_based: bool = False,
        current_model_fn: Optional[Callable] = None,
        metrics_writer: Optional[Callable[[int, Dict[str, float]], None]] = None,
    ):
        self._checkpoint_service = checkpoint_service
        self._task_d = task_dispatcher
        self._eval_steps = eval_steps
        self._current_model_fn = current_model_fn  # () -> (params, aux, version)
        self._metrics_writer = metrics_writer
        self._lock = threading.Lock()
        self._eval_job: Optional[_EvaluationJob] = None
        self._last_eval_version = -1
        # completions still delivering their metrics (has_pending covers
        # them, so the master does not tear the writer down under them)
        self._finishing = 0
        self.completed_metrics: List[Tuple[int, Dict[str, float]]] = []
        # each completed job's seconds from its creation to its last task
        self.job_seconds: List[float] = []
        self._trigger: Optional[_EvaluationTrigger] = None
        if time_based:
            self._trigger = _EvaluationTrigger(self, start_delay_secs, throttle_secs)
            self._trigger.start()

    def stop(self):
        if self._trigger:
            self._trigger.stop()

    def has_pending(self) -> bool:
        """True while an evaluation job is in flight or delivering its
        metrics."""
        with self._lock:
            return self._eval_job is not None or self._finishing > 0

    # -- triggering ----------------------------------------------------------

    def add_evaluation_task_if_needed(self, version: int, prev_version=None):
        """The step trigger, called with each applied version."""
        with self._lock:
            if not self._eval_steps or version <= self._last_eval_version:
                return
        prev = prev_version if prev_version is not None else version - 1
        if version // self._eval_steps > prev // self._eval_steps:
            self.add_evaluation_task()

    def start_standalone_job(self, version: int, total_tasks: int):
        """An evaluation-only job: the dispatcher already holds the
        version-pinned tasks; register the job that accumulates them."""
        with self._lock:
            self._eval_job = _EvaluationJob(version, total_tasks=total_tasks)
            self._last_eval_version = version

    def add_evaluation_task(self):
        """Pin the current version and create its evaluation tasks (one
        job at a time)."""
        with self._lock:
            if self._eval_job is not None:
                return
            params, aux, version = self._current_model_fn()
            if params is None or version == self._last_eval_version:
                return
            self._checkpoint_service.save(params, version, is_eval=True, aux=aux)
            n = self._task_d.create_evaluation_tasks(version)
            self._eval_job = _EvaluationJob(version, total_tasks=n)
            self._last_eval_version = version
            logger.info("Evaluation job created at version %d (%d tasks)", version, n)

    # -- worker reports ------------------------------------------------------

    def report_metrics(self, model_version: int, metrics: Dict, num_examples: int):
        with self._lock:
            if self._eval_job is None or model_version != self._eval_job.model_version:
                logger.warning(
                    "Dropping metrics for version %d (no matching eval job)", model_version
                )
                return
            self._eval_job.report_metrics(metrics, num_examples)

    def complete_task(self):
        """The dispatcher's callback when an EVALUATION task completes
        (or is dropped)."""
        finished_job = None
        with self._lock:
            if self._eval_job is None:
                return
            self._eval_job.complete_task()
            if self._eval_job.finished():
                finished_job, self._eval_job = self._eval_job, None
                self._finishing += 1
        if finished_job is None:
            return
        try:
            metrics = finished_job.get_metrics()
            logger.info("Evaluation @v%d complete: %s", finished_job.model_version, metrics)
            self.completed_metrics.append((finished_job.model_version, metrics))
            self.job_seconds.append(time.monotonic() - finished_job.created)
            if self._metrics_writer:
                self._metrics_writer(finished_job.model_version, metrics)
            self._checkpoint_service.remove_eval_checkpoint(finished_job.model_version)
        finally:
            with self._lock:
                self._finishing -= 1

"""Warm standby workers against the reference.

- One script of pod events (a standby, killed active workers, a killed
  standby, SUCCEEDED, EXIT_CODE_JOB_FAILED, EXIT_CODE_MASTER_UNREACHABLE,
  the relaunch budget spent) drives the reference's `WorkerManager` and
  the port's, each over a recording fake backend: the same starts (ids
  and standby flags), deletions, task recoveries, relaunches, promotions,
  phases and `is_standby` answers.
- The port's GetTask answers a standby as the reference's does, and
  GetSampleBatch serves the records of the reference's
  `make_sample_batch_fn` (topped up across shards, short or empty ones
  included).
- An in-process job whose worker pre-warms first ends with the PS's
  parameters, BatchNorm statistics, optimizer state and version, and the
  worker's losses and counters, bit-equal to the same job without the
  pre-warm: per-step and in window mode, both with bf16 error feedback,
  on cifar10_subclass; the pre-warm itself leaves the worker's state as
  the pull left it, but marked stale, so a promoted standby's first
  report is based on the PS's version at its promotion.
"""

import os

import numpy as np
import pytest
import torch

from elasticdl_tpu.cluster import pod_backend as jpod
from elasticdl_tpu.master import main as jmain
from elasticdl_tpu.master.servicer import MasterServicer as JServicer
from elasticdl_tpu.master.task_dispatcher import TaskDispatcher as JDispatcher
from elasticdl_tpu.master.worker_manager import WorkerManager as JWorkerManager
from elasticdl_tpu_torch.api.model_spec_helpers import spec_from_module
from elasticdl_tpu_torch.cluster import pod_backend as tpod
from elasticdl_tpu_torch.common import codec
from elasticdl_tpu_torch.common.constants import (
    EXIT_CODE_JOB_FAILED,
    EXIT_CODE_MASTER_UNREACHABLE,
)
from elasticdl_tpu_torch.master import main as tmain
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.master.worker_manager import WorkerManager
from elasticdl_tpu_torch.models import cifar10_subclass as tcifar
from elasticdl_tpu_torch.models.record_codec import write_synthetic_image_records
from elasticdl_tpu_torch.testing import InProcessMaster, build_job
from elasticdl_tpu_torch.worker.worker import Worker
from _torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)


# -- the worker manager's standby branches -------------------------------------


class _RecordingBackend:
    """Starts fire RUNNING at once; records (id, standby at start)."""

    def __init__(self, pod):
        self._pod = pod
        self.manager = None
        self.started, self.deleted = [], []
        self._cb = None

    def set_event_callback(self, cb):
        self._cb = cb

    def start_worker(self, worker_id, argv, envs):
        self.started.append((worker_id, self.manager.is_standby(worker_id)))
        self._cb(self._pod.PodEvent(worker_id, self._pod.PodPhase.RUNNING))

    def delete_worker(self, worker_id):
        self.deleted.append(worker_id)

    def fire(self, wid, phase, rc):
        self._cb(self._pod.PodEvent(wid, getattr(self._pod.PodPhase, phase), exit_code=rc))


class _Recover:
    def __init__(self):
        self.recovered = []

    def recover_tasks(self, worker_id):
        self.recovered.append(worker_id)


SIGKILL = -9
# (worker id, phase, exit code); 2 active workers (0, 1) and one standby (2)
SCRIPTS = {
    "promote-refill-and-dead-standby": [
        (0, "DELETED", SIGKILL),  # promotes 2, refills standby 3
        (3, "DELETED", SIGKILL),  # a dead standby: refill 4, nothing recovered
        (1, "FAILED", EXIT_CODE_MASTER_UNREACHABLE),  # relaunch-eligible: promotes 4
        (1, "FAILED", 1),  # a repeat of a terminal event is ignored
        (2, "SUCCEEDED", 0),
        (4, "FAILED", EXIT_CODE_JOB_FAILED),  # completed: no promotion, no relaunch
        (5, "SUCCEEDED", 0),
    ],
    "budget-spent-pool-shrinks": [
        (0, "DELETED", SIGKILL), (1, "DELETED", SIGKILL), (2, "FAILED", 1),
        (3, "DELETED", SIGKILL), (4, "DELETED", SIGKILL), (5, "FAILED", 1),
    ],
    "two-deaths-at-once": [
        (0, "DELETED", SIGKILL), (1, "DELETED", SIGKILL),  # the refill is promoted cold
        (2, "SUCCEEDED", 0), (3, "SUCCEEDED", 0), (4, "SUCCEEDED", 0),
    ],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_standby_event_trace_equals_the_references(script):
    results = []
    for pod, cls in ((tpod, WorkerManager), (jpod, JWorkerManager)):
        backend, recover = _RecordingBackend(pod), _Recover()
        manager = cls(backend, recover, num_workers=2, worker_argv_fn=lambda wid: [],
                      max_relaunches=3, num_standby=1)
        backend.manager = manager
        manager.start_workers()
        trace = []
        for wid, phase, rc in SCRIPTS[script]:
            backend.fire(wid, phase, rc)
            trace.append((manager.promotions(), manager.relaunches(),
                          [manager.is_standby(i) for i in range(10)]))
        manager.stop_relaunch_and_remove_workers()
        results.append((backend.started, backend.deleted, recover.recovered, trace,
                        manager.phases(), manager.all_exited()))
    assert results[0] == results[1]
    assert any(standby for _wid, standby in results[0][0])


def test_get_task_answers_a_standby_as_the_reference_does(tmp_path):
    shards = {"a": 8, "b": 8}
    port = MasterServicer(1, task_dispatcher=TaskDispatcher(shards, {}, {}, 4, 1, shuffle_seed=1))
    ref = JServicer(1, task_dispatcher=JDispatcher(shards, {}, {}, 4, 1, shuffle_seed=1))
    for s in (port, ref):
        s.set_standby_fn(lambda wid: wid == 7)

    def ref_task(wid):
        # the reference's task carries `backup` (speculation, not ported)
        resp = ref.get_task({"worker_id": wid})
        assert resp["task"].pop("backup") is False
        return resp

    for wid in (7, 0, 7):
        assert port.get_task({"worker_id": wid}) == ref_task(wid)
    # finished job: the standby is told to exit too
    for s in (port, ref):
        s.report_task_result({"task_id": 1, "worker_id": 0})  # the one worker 0 holds
        for _ in range(8):
            t = s.get_task({"worker_id": 0})["task"]
            if t["task_id"] >= 0:
                s.report_task_result({"task_id": t["task_id"], "worker_id": 0})
        assert s._task_d.finished()
    assert port.get_task({"worker_id": 7}) == ref_task(7)
    assert port.get_task({"worker_id": 7})["finished"] is True


def test_sample_batch_equals_the_references(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    for i, n in enumerate((3, 0, 5, 8)):
        if n:
            write_synthetic_image_records(str(data / f"s{i}.rio"), n, (4, 4, 1), 10, seed=i)
        else:
            (data / f"s{i}.rio").write_bytes(b"")
    port = MasterServicer(1)
    ref = JServicer(1)
    assert port.get_sample_batch({"n": 2}) == ref.get_sample_batch({"n": 2}) == {"records": None}
    port.set_sample_batch_fn(tmain.make_sample_batch_fn(str(data)))
    ref.set_sample_batch_fn(jmain.make_sample_batch_fn(str(data)))
    for n in (1, 3, 4, 16, 40):
        got = port.get_sample_batch({"n": n})
        assert got == ref.get_sample_batch({"n": n})
        assert len(got["records"]) == min(n, 16)


# -- the pre-warm leaves the job bit-equal --------------------------------------

RECORDS, PER_TASK, BATCH = 64, 32, 16
MODES = {
    "per-step": dict(sync_dtype="bfloat16"),
    "window": dict(local_updates=2, sync_dtype="bfloat16"),
}


def _job(data_dir, mode, prewarm):
    path = os.path.join(data_dir, "images.rio")
    dispatcher = TaskDispatcher({path: RECORDS}, {}, {}, PER_TASK, 1, shuffle_seed=3)
    spec = spec_from_module(tcifar)
    servicer, _eval, _ckpt = build_job(spec, dispatcher, 1)
    servicer.set_sample_batch_fn(tmain.make_sample_batch_fn(data_dir))
    worker = Worker(0, InProcessMaster(servicer), spec, minibatch_size=BATCH, device="cpu",
                    **MODES[mode])
    if prewarm:
        worker._standby_prewarm()
        assert worker.standby_prewarmed and not worker.standby_prewarm_failed
    assert worker.run()
    worker.close()
    params, aux, version = servicer.get_params_copy()
    # the PS's optimizer (per-step) and the worker's on-device one (window)
    opt = servicer._opt.state_snapshot() or []
    if worker._opt_state is not None:
        opt += [t.numpy() for t in worker._tx.state_leaves(worker._opt_state)]
    residuals = [r.numpy().tobytes() for r in (worker._ef_residual, worker._ef_grad_residual)
                 if r is not None]
    return {
        "params": codec.ravel_np(params).tobytes(),
        "aux": codec.ravel_np(aux).tobytes(),
        "version": version,
        "exactness": servicer.exactness(),
        "opt": [np.asarray(x).tobytes() for x in opt],
        "residuals": residuals,
        "losses": worker.task_losses,
        "counters": (worker.steps_computed, worker.steps_accepted, worker.merged_back,
                     worker.deduped_windows, dict(worker.aux_absorbed)),
    }


@pytest.mark.parametrize("mode", list(MODES))
def test_prewarmed_job_ends_bit_equal_to_the_job_without(tmp_path, mode):
    write_synthetic_image_records(str(tmp_path / "images.rio"), RECORDS, tcifar.IMAGE_SHAPE, 10,
                                  seed=4)
    cold = _job(str(tmp_path), mode, prewarm=False)
    warm = _job(str(tmp_path), mode, prewarm=True)
    assert warm == cold
    assert cold["version"] == RECORDS // BATCH and cold["opt"] and cold["residuals"]


def test_prewarm_leaves_the_pulled_state_as_it_was(tmp_path):
    write_synthetic_image_records(str(tmp_path / "images.rio"), RECORDS, tcifar.IMAGE_SHAPE, 10,
                                  seed=4)
    spec = spec_from_module(tcifar)
    dispatcher = TaskDispatcher({str(tmp_path / "images.rio"): RECORDS}, {}, {}, PER_TASK, 1)
    servicer, _eval, _ckpt = build_job(spec, dispatcher, 1)
    servicer.set_sample_batch_fn(tmain.make_sample_batch_fn(str(tmp_path)))
    worker = Worker(0, InProcessMaster(servicer), spec, minibatch_size=BATCH, device="cpu",
                    **MODES["window"])
    worker._lazy_init_model()

    def state():
        return (worker._flat.clone(), worker._aux_flat.clone(), worker._version, worker._fresh,
                worker._lineage_version, worker._own_steps_abs, worker._opt_state,
                worker._ef_residual, worker.steps_computed, dict(worker.phase_seconds),
                torch.random.get_rng_state())

    before = state()
    worker._standby_prewarm()
    after = state()
    assert worker.standby_prewarmed and worker.standby_prewarm_seconds > 0
    assert torch.equal(before[0], after[0]) and torch.equal(before[1], after[1])
    # only the model is marked stale: the first task after a promotion pulls
    assert before[3] and not after[3]
    assert before[2:3] + before[4:10] == after[2:3] + after[4:10]
    assert torch.equal(before[10], after[10])


@pytest.mark.parametrize("mode", list(MODES))
def test_promoted_standby_trains_from_the_ps_latest_model(tmp_path, mode):
    """A standby pre-warms at v0, another worker moves the PS on, and the
    standby's first report after its promotion is based on the PS's
    version at the promotion, not on the model it pre-warmed with."""
    path = str(tmp_path / "images.rio")
    write_synthetic_image_records(path, RECORDS, tcifar.IMAGE_SHAPE, 10, seed=4)
    spec = spec_from_module(tcifar)
    dispatcher = TaskDispatcher({path: RECORDS}, {}, {}, BATCH, 1, shuffle_seed=3)
    servicer, _eval, _ckpt = build_job(spec, dispatcher, 1)
    servicer.set_sample_batch_fn(tmain.make_sample_batch_fn(str(tmp_path)))
    bases = []

    def record(req):
        bases.append(req.get("base_version", req.get("version")))
        return req

    standby = Worker(1, InProcessMaster(servicer, {"ReportGradient": record,
                                                   "ReportLocalUpdate": record}),
                     spec, minibatch_size=BATCH, device="cpu", **MODES[mode])
    standby._standby_prewarm()
    assert standby.standby_prewarmed and servicer.get_params_copy()[2] == 0
    active = Worker(0, InProcessMaster(servicer), spec, minibatch_size=BATCH, device="cpu",
                    **MODES[mode])
    task, _ = active.get_task()
    if not active._process_training_task(task):
        active.report_task_result(task.task_id, "")
    active.close()  # window mode: syncs and delivers the deferred report
    at_promotion = servicer.get_params_copy()[2]
    assert at_promotion > 0 and not bases
    assert standby.run()
    standby.close()
    assert bases[0] == at_promotion
    ex = servicer.exactness()
    assert ex["version"] == ex["init_version"] + ex["applied_update_steps"] == RECORDS // BATCH

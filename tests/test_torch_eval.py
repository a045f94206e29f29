"""Evaluation and prediction in the port against the reference.

- The dispatcher's EVALUATION and PREDICTION tasks (ids, files, ranges,
  types, pinned versions, hand-out order) equal the reference's.
- The evaluation service's metrics equal the reference's for the same
  reports (example-weighted scalars and merged AUC states: host float64
  arithmetic in both, compared exactly), and so do its triggers (floor
  crossing, one job at a time, a standalone job, a dropped task, the
  time trigger).
- A standalone evaluation job of cifar10_subclass (BatchNorm on its
  running statistics) and of the transformer zoo gives the reference
  worker's metrics at the same float32 params (`METRIC_TOL`: XLA's and
  torch's float32 forwards).
- An evaluation task leaves the worker's training state as it was: a
  job with evaluation during training ends bit-equal to the same job
  without it, per-step and in window mode.
- A prediction job hands each record's outputs to the spec's processor.
"""

import time

import jax
import numpy as np
import pytest

from elasticdl_tpu.api.metrics import auc_state as jauc_state
from elasticdl_tpu.api.model_spec_helpers import spec_from_module as jspec_from_module
from elasticdl_tpu.master.checkpoint import CheckpointService as JCheckpointService
from elasticdl_tpu.master.evaluation_service import EvaluationService as JEvaluationService
from elasticdl_tpu.master.servicer import MasterServicer as JServicer
from elasticdl_tpu.master.task_dispatcher import TaskDispatcher as JDispatcher
from elasticdl_tpu.models import cifar10_subclass as jcifar_sub
from elasticdl_tpu.models import transformer_lm_zoo as jzoo
from elasticdl_tpu.testing import InProcessMaster as JInProcessMaster
from elasticdl_tpu.worker.worker import Worker as JWorker
from elasticdl_tpu_torch.api.model_spec_helpers import spec_from_module
from elasticdl_tpu_torch.common import codec
from elasticdl_tpu_torch.common.messages import TaskType
from elasticdl_tpu_torch.convert import variables_from_jax
from elasticdl_tpu_torch.master.checkpoint import CheckpointService
from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.models import cifar10_subclass as tcifar_sub
from elasticdl_tpu_torch.models import mnist_functional_api as tmnist
from elasticdl_tpu_torch.models import transformer_lm_zoo as tzoo
from elasticdl_tpu_torch.models.record_codec import (
    write_learnable_token_records,
    write_synthetic_image_records,
)
from elasticdl_tpu_torch.testing import InProcessMaster, build_job
from elasticdl_tpu_torch.worker.worker import Worker, validate_eval_metrics
from _torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
TINY = dict(vocab=16, d_model=16, n_heads=2, d_ff=32, n_layers=1)


def _task_key(t):
    return (t.task_id, t.shard_file_name, t.start, t.end, t.type, t.model_version)


def _drain(d, worker_id=0):
    out = []
    while (t := d.get(worker_id)) is not None:
        out.append(_task_key(t))
    return out


SHARDS = {"/d/a": 10, "/d/b": 7}


@pytest.mark.parametrize("kind", ["evaluation", "prediction"])
def test_standalone_task_lists_equal_the_references(kind):
    args = ({}, SHARDS, {}) if kind == "evaluation" else ({}, {}, SHARDS)
    ref = JDispatcher(*args, 4, 1, eval_model_version=5)
    port = TaskDispatcher(*args, 4, 1, eval_model_version=5)
    want = _drain(ref)
    assert _drain(port) == want and len(want) == 5
    assert {k[4] for k in want} == {kind}


def test_evaluation_tasks_during_training_equal_the_references():
    train = {"/d/t0": 12, "/d/t1": 8}
    ref = JDispatcher(train, SHARDS, {}, 4, 2, shuffle_seed=7)
    port = TaskDispatcher(train, SHARDS, {}, 4, 2, shuffle_seed=7)
    seq = []
    for step in range(40):
        if step in (2, 9):
            n = ref.create_evaluation_tasks(3 + step)
            assert port.create_evaluation_tasks(3 + step) == n == 5
        for kind in (None, TaskType.TRAINING, TaskType.EVALUATION):
            assert port.pending_count(kind) == ref.pending_count(kind)
        want, got = ref.get(0), port.get(0)
        assert (got is None) == (want is None)
        if want is None:
            break
        assert _task_key(got) == _task_key(want)
        seq.append(_task_key(want))
        assert port.report(got.task_id, True, 0) == ref.report(want.task_id, True, 0)
    assert port.finished() and ref.finished()
    assert port.completed_records() == ref.completed_records() == 2 * 20
    assert sum(k[4] == "evaluation" for k in seq) == 10


class _Model:
    """current_model_fn for both services: a settable version."""

    def __init__(self, version=0):
        self.version = version

    def __call__(self):
        return {"w": np.full(3, self.version, np.float32)}, None, self.version


def _services(tmp_path, eval_steps=4, version=0, **kw):
    out = []
    for pkg, (disp, ckpt, svc) in (
        ("ref", (JDispatcher, JCheckpointService, JEvaluationService)),
        ("port", (TaskDispatcher, CheckpointService, EvaluationService)),
    ):
        d = disp({"/d/t": 64}, SHARDS, {}, 4, 1, max_task_retries=2, shuffle_seed=0)
        model = _Model(version)
        written = []
        # the reference writes eval snapshots in the working directory
        # unless it is told to make a directory for them
        kw_ckpt = dict(include_evaluation=True) if pkg == "ref" else {}
        s = svc(ckpt(str(tmp_path / pkg), **kw_ckpt), d, eval_steps=eval_steps,
                current_model_fn=model,
                metrics_writer=lambda v, m, w=written: w.append((v, m)), **kw)
        d.set_evaluation_service(s)
        out.append((d, s, model, written))
    return out


def _states(seed):
    rng = np.random.default_rng(seed)
    scores, labels = rng.standard_normal(16), rng.integers(0, 2, 16)
    state = jauc_state(scores, labels, num_thresholds=8)
    return {k: v if k == "kind" else np.asarray(v) for k, v in state.items()}


def test_evaluation_service_metrics_and_triggers_equal_the_references(tmp_path):
    pairs = _services(tmp_path)
    log = {0: [], 1: []}
    # version bumps 1..13 with one multi-step jump (9 -> 13 crosses 12)
    bumps = [(v, v - 1) for v in range(1, 10)] + [(13, 9)]
    for i, (d, s, model, _w) in enumerate(pairs):
        for v, prev in bumps:
            model.version = v
            s.add_evaluation_task_if_needed(v, prev)
            log[i].append((s.has_pending(), d.pending_count(TaskType.EVALUATION)))
            if v in (6, 13):
                # run the pending job's tasks: scalar + state reports,
                # one task failing until it is dropped
                tasks = [t for t in iter(lambda: d.get(1), None)
                         if t.type == TaskType.EVALUATION]
                for j, t in enumerate(tasks):
                    s.report_metrics(t.model_version, {"acc": 0.1 * j, "auc": _states(j)},
                                     t.end - t.start)
                    s.report_metrics(t.model_version + 1, {"acc": 9.0}, 1)  # dropped
                    if j == 1:
                        assert d.report(t.task_id, False, 1)
                        t2 = next(u for u in iter(lambda: d.get(1), None) if u.task_id == t.task_id)
                        d.report(t2.task_id, False, 1)  # second failure: dropped
                    else:
                        d.report(t.task_id, True, 1)
    assert log[1] == log[0]
    (_rd, ref, _rm, rw), (_pd, port, _pm, pw) = pairs
    assert [v for v, _m in port.completed_metrics] == [v for v, _m in ref.completed_metrics]
    # the crossing of 12 came while the job at 8 was pending: skipped
    assert [v for v, _m in port.completed_metrics] == [4, 8]
    for (_v, got), (_w, want) in zip(port.completed_metrics, ref.completed_metrics):
        assert got == want
    assert pw == rw
    assert not port.has_pending() and not ref.has_pending()


def test_standalone_job_and_time_trigger_equal_the_references(tmp_path):
    for d, s, _model, _w in _services(tmp_path):
        d2 = type(d)({}, SHARDS, {}, 4, 1, eval_model_version=9)
        s2 = type(s)(s._checkpoint_service, d2, current_model_fn=lambda: (None, None, 9))
        d2.set_evaluation_service(s2)
        s2.start_standalone_job(9, d2.pending_count(TaskType.EVALUATION))
        weighted = 0
        for t in iter(lambda: d2.get(0), None):
            weighted += t.start * (t.end - t.start)
            s2.report_metrics(9, {"acc": float(t.start)}, t.end - t.start)
            assert s2.has_pending()
            d2.report(t.task_id, True, 0)
        assert not s2.has_pending()
        assert s2.completed_metrics == [(9, {"acc": weighted / 17})]
    pairs = _services(tmp_path / "timed", eval_steps=0, version=7, time_based=True)
    deadline = time.time() + 5
    while not all(s.has_pending() for _d, s, _m, _w in pairs) and time.time() < deadline:
        time.sleep(0.05)
    for d, s, _model, _w in pairs:
        s.stop()
        assert s.has_pending() and d.pending_count(TaskType.EVALUATION) == 5
        assert s._eval_job.model_version == 7


def test_non_state_dict_metrics_are_refused():
    validate_eval_metrics({"acc": 0.5, "auc": {"kind": "auc_bins", "pos": [1], "neg": [0]}})
    with pytest.raises(TypeError, match="'bad'"):
        validate_eval_metrics({"bad": {"pos": [1]}})


def _standalone_eval(pkg, spec, path, n, params, aux, batch, per_task=None):
    """A standalone evaluation job pinned at version 3 with one worker:
    the service's (version, metrics)."""
    Disp, Svc, Ckpt, Serv, Shim, Wkr = (
        (JDispatcher, JEvaluationService, JCheckpointService, JServicer, JInProcessMaster,
         JWorker) if pkg == "ref" else
        (TaskDispatcher, EvaluationService, CheckpointService, MasterServicer, InProcessMaster,
         Worker))
    d = Disp({}, {path: n}, {}, per_task or n // 2, 1, eval_model_version=3)
    ckpt = Ckpt()
    servicer = Serv(1, task_dispatcher=d, checkpoint_service=ckpt, init_params=params,
                    init_aux=aux, init_version=3)
    s = Svc(ckpt, d, current_model_fn=servicer.get_params_copy)
    d.set_evaluation_service(s)
    servicer.set_evaluation_service(s)
    s.start_standalone_job(3, d.pending_count(TaskType.EVALUATION))
    worker_kw = dict(device="cpu") if pkg == "port" else {}
    worker = Wkr(0, Shim(servicer), spec, minibatch_size=batch, **worker_kw)
    assert worker.run()
    worker.close()
    assert d.finished() and not s.has_pending() and servicer.version == 3
    return s.completed_metrics


def test_cifar10_subclass_evaluation_equals_the_references(tmp_path):
    path = str(tmp_path / "images.rio")
    write_synthetic_image_records(path, 40, tcifar_sub.IMAGE_SHAPE, 10, seed=4)
    x = np.zeros((1,) + tcifar_sub.IMAGE_SHAPE, np.uint8)
    variables = jax.jit(lambda x: jcifar_sub.custom_model().init(
        jax.random.PRNGKey(3), x, train=False))(x)
    params, aux = variables_from_jax(jax.tree_util.tree_map(np.asarray, variables))
    # running statistics off their init, so the eval forward reads them
    rng = np.random.default_rng(5)
    aux = codec.tree_map(lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32), aux)
    want = _standalone_eval("ref", jspec_from_module(jcifar_sub), path, 40, params, aux, 16)
    got = _standalone_eval("port", spec_from_module(tcifar_sub), path, 40, params, aux, 16)
    assert [v for v, _m in got] == [v for v, _m in want] == [3]
    assert set(got[0][1]) == set(want[0][1]) == {"accuracy"}
    np.testing.assert_allclose(got[0][1]["accuracy"], want[0][1]["accuracy"], **METRIC_TOL)


def test_transformer_zoo_evaluation_equals_the_references(tmp_path):
    path = str(tmp_path / "tokens.rio")
    write_learnable_token_records(path, 24, 16, TINY["vocab"], seed=3)
    params = tzoo.custom_model(**TINY).init_params(1)
    want = _standalone_eval("ref", jspec_from_module(jzoo, model=jzoo.custom_model(**TINY)),
                            path, 24, params, None, 8)
    got = _standalone_eval("port", spec_from_module(tzoo, model=tzoo.custom_model(**TINY)),
                           path, 24, params, None, 8)
    assert [v for v, _m in got] == [v for v, _m in want] == [3]
    assert set(got[0][1]) == set(want[0][1]) == {"cross_entropy", "accuracy", "perplexity"}
    for k in want[0][1]:
        np.testing.assert_allclose(got[0][1][k], want[0][1][k], **METRIC_TOL)
    # the job's perplexity is the example-weighted mean of each
    # minibatch's exp(ce), as the reference's: at least exp(mean ce)
    assert got[0][1]["perplexity"] >= np.exp(got[0][1]["cross_entropy"])


EPOCH, PER_TASK, BATCH = 16, 8, 4


def _train_job(tmp_path, name, with_eval, **worker_kw):
    """One worker over 3 epochs of 2 tasks (4 steps an epoch); with
    evaluation every 4 versions, whose tasks run between epochs."""
    train = str(tmp_path / "train.rio")
    evals = str(tmp_path / "eval.rio")
    if not (tmp_path / "train.rio").exists():
        write_learnable_token_records(train, EPOCH, 16, TINY["vocab"], seed=0)
        write_learnable_token_records(evals, 12, 16, TINY["vocab"], seed=9)
    d = TaskDispatcher({train: EPOCH}, {evals: 12} if with_eval else {}, {}, PER_TASK, 3,
                       shuffle_seed=1)
    spec = spec_from_module(tzoo, model=tzoo.custom_model(**TINY))
    servicer, evs, _ckpt = build_job(spec, d, eval_steps=4 if with_eval else 0,
                                     checkpoint_dir=str(tmp_path / name))
    worker = Worker(0, InProcessMaster(servicer), spec, minibatch_size=BATCH, device="cpu",
                    **worker_kw)
    assert worker.run()
    worker.close()
    params, _aux, version = servicer.get_params_copy()
    return codec.ravel_np(params), version, worker, evs


@pytest.mark.parametrize("mode", ["per-step", "window"])
def test_an_evaluation_task_leaves_the_training_state_as_it_was(tmp_path, mode):
    # window syncs block (overlap off), so each epoch's last sync lands,
    # and its evaluation job is queued, before the next epoch rolls
    kw = dict(local_updates=2, sync_dtype="bfloat16", overlap_sync="off") if mode == "window" else {}
    plain, v0, _w0, _ = _train_job(tmp_path, "plain", False, **kw)
    got, v1, worker, evs = _train_job(tmp_path, "eval", True, **kw)
    steps = 3 * EPOCH // BATCH
    assert v0 == v1 == steps
    # 3 jobs of 2 tasks (8 and 4 records: 2 + 1 minibatches)
    assert worker.eval_tasks == 3 * 2 and worker.eval_minibatches == 3 * 3
    assert [v for v, _m in evs.completed_metrics] == [4, 8, 12]
    # BIT-equal: the eval pulls never touched what training reads
    np.testing.assert_array_equal(got, plain)
    assert worker.steps_computed == worker.steps_accepted == steps
    # the eval at v4 scores a model the next epochs improve on
    ce = [m["cross_entropy"] for _v, m in evs.completed_metrics]
    assert all(np.isfinite(ce))


def test_prediction_job_hands_every_record_to_the_processor(tmp_path):
    path = str(tmp_path / "images.rio")
    write_synthetic_image_records(path, 20, tmnist.IMAGE_SHAPE, 10, seed=1)
    spec = spec_from_module(tmnist)
    params = spec.model.init_params(2)
    d = TaskDispatcher({}, {}, {path: 20}, 8, 1)
    servicer = MasterServicer(1, task_dispatcher=d, init_params=params, init_version=5)
    worker = Worker(0, InProcessMaster(servicer), spec, minibatch_size=4, device="cpu")
    assert worker.run()
    worker.close()
    assert worker.prediction_tasks == 3 and d.finished()
    outputs = spec.prediction_outputs_processor.outputs
    assert [wid for wid, _c in outputs] == [0] * 5
    classes = np.concatenate([c for _w, c in outputs])
    assert classes.shape == (20,)
    # the same classes from the model's plain forward on the CPU
    from elasticdl_tpu_torch.convert import load_variables
    from elasticdl_tpu_torch.data.recordio import RecordIOReader

    model = tmnist.custom_model()
    load_variables(model, params)
    with RecordIOReader(path) as r:
        x, _y = tmnist.dataset_fn(list(r.read_range(0, 20)), "prediction")
    import torch

    with torch.no_grad():
        want = model(torch.from_numpy(np.asarray(x))).argmax(-1).numpy()
    np.testing.assert_array_equal(classes, want)


def test_worker_waits_while_an_evaluation_job_is_pending(tmp_path):
    """GetTask answers `finished` only once no evaluation job is
    pending: the last training report can create one after the
    dispatcher ran dry."""
    d = TaskDispatcher({"/d/t": 4}, SHARDS, {}, 4, 1)
    spec = spec_from_module(tzoo, model=tzoo.custom_model(**TINY))
    servicer, evs, _ckpt = build_job(spec, d, eval_steps=1)
    t = d.get(0)
    d.report(t.task_id, True, 0)
    assert d.finished()
    evs.start_standalone_job(0, 1)  # a job whose tasks are not queued yet
    assert servicer.get_task({"worker_id": 0})["finished"] is False
    evs.complete_task()
    assert servicer.get_task({"worker_id": 0})["finished"] is True

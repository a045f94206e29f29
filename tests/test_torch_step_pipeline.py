"""The per-step pipeline (`--step_pipeline`) against the reference's.

The reference's `tests/test_step_pipeline.py` cases, each run through
the port and the reference on the same init and task order:

- `resolve_step_pipeline` and the forwarded argv over a grid of flags,
  equal to the reference's value for value;
- a single worker at depth 1 and 2 (sync with a staleness window) and
  2 and 4 (async), one worker, with a test-side gate on both sides that
  lets the reports into the PS one at a time in dispatch order: the
  trajectory is then deterministic (two port runs agree bit for bit),
  and the port's agrees with the reference's, versions exactly and
  params within 1e-4 (float32 gradients from two frameworks, amplified
  by Adam where |g| is tiny);
- the rejection fallback (every third report made stale), two workers,
  and the sharded PS, held to the same invariants in both packages;
- process mode: `master.main --use_async` forwards depth 4 to its
  worker processes, or 0 when `--step_pipeline 0` pins it.
"""

import logging
import os
import re
import threading

import numpy as np
import pytest

from elasticdl_tpu.api.model_spec_helpers import spec_from_module as jspec_from_module
from elasticdl_tpu.common import args as jargs
from elasticdl_tpu.common import codec as jcodec
from elasticdl_tpu.master.ps_group import PSShardGroup as JPSShardGroup
from elasticdl_tpu.master.ps_optimizer import PSOptimizer as JPSOptimizer
from elasticdl_tpu.master.servicer import MasterServicer as JServicer
from elasticdl_tpu.master.task_dispatcher import TaskDispatcher as JDispatcher
from elasticdl_tpu.models import transformer_lm as jtlm
from elasticdl_tpu.models import transformer_lm_zoo as jzoo
from elasticdl_tpu.testing import InProcessMaster as JInProcessMaster
from elasticdl_tpu.worker.worker import Worker as JWorker
from elasticdl_tpu_torch.api.model_spec_helpers import spec_from_module
from elasticdl_tpu_torch.common import args as targs
from elasticdl_tpu_torch.common import codec
from elasticdl_tpu_torch.common.constants import ENV_WORKER_LOG_DIR
from elasticdl_tpu_torch.master import main as master_main
from elasticdl_tpu_torch.master.ps_group import PSShardGroup
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.models import transformer_lm_zoo as tzoo
from elasticdl_tpu_torch.models.record_codec import write_learnable_token_records
from elasticdl_tpu_torch.testing import InProcessMaster, build_job
from elasticdl_tpu_torch.worker.main import read_summaries
from elasticdl_tpu_torch.worker.worker import Worker
from _torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = os.path.join(REPO, "elasticdl_tpu_torch", "models")
TINY = dict(vocab=32, d_model=16, n_heads=2, d_ff=32, n_layers=1)
SEQ, BATCH, RECORDS, PER_TASK = 16, 8, 96, 32
STEPS = RECORDS // BATCH
JOB_TOL = dict(atol=1e-4, rtol=0)

SPEC_ARGV = ["--model_zoo", "z", "--model_def", "m.custom_model", "--minibatch_size", "8"]


# -- resolve_step_pipeline and the forwarded flags ---------------------------


GRID = [
    (mode, window, local, depth)
    for mode in ("sync", "async")
    for window in (0, 1, 2, 3, 8)
    for local in (0, 4)
    for depth in (None, 0, 1, 3, 6)
]


@pytest.mark.parametrize("mode,window,local,depth", GRID)
def test_resolve_step_pipeline_matches_the_reference(mode, window, local, depth):
    """The resolved depth and the forwarded `--step_pipeline` are the
    reference's on every point of the grid; the worker's parser takes
    what the master forwards."""
    argv = SPEC_ARGV + ["--training_data_dir", "t", "--staleness_window", str(window),
                        "--local_updates", str(local)]
    if mode == "async":
        argv.append("--use_async")
    if depth is not None:
        argv += ["--step_pipeline", str(depth)]
    port = targs.master_parser().parse_args(argv)
    ref = jargs.master_parser().parse_args(argv)
    assert port.step_pipeline == ref.step_pipeline == (-1 if depth is None else depth)
    want = jargs.resolve_step_pipeline(ref)
    assert targs.resolve_step_pipeline(port) == want
    fwd = targs.worker_forward_args(port, 0, "localhost:1")
    jfwd = jargs.worker_forward_args(ref, 0, "localhost:1")
    assert fwd[fwd.index("--step_pipeline") + 1] == jfwd[jfwd.index("--step_pipeline") + 1]
    assert targs.worker_parser().parse_args(fwd).step_pipeline == want


def test_resolve_step_pipeline_auto_cases():
    """The reference's own cases: auto is 4 under async, the window in
    sync mode, 0 for strict sync and in window mode."""
    def resolved(extra):
        return targs.resolve_step_pipeline(
            targs.master_parser().parse_args(SPEC_ARGV + extra))

    assert resolved([]) == 0
    assert resolved(["--staleness_window", "1"]) == 1
    assert resolved(["--staleness_window", "8"]) == 4
    assert resolved(["--use_async"]) == 4
    assert resolved(["--staleness_window", "1", "--local_updates", "4"]) == 0
    assert resolved(["--step_pipeline", "0"]) == 0
    assert resolved(["--step_pipeline", "3", "--use_async"]) == 3
    assert resolved(["--step_pipeline", "3", "--staleness_window", "2"]) == 2


@pytest.mark.parametrize("extra", [[], ["--sync_local_steps", "3"], ["--sync_adaptive", "on"],
                                   ["--sync_adaptive", "off", "--sync_local_steps", "1"]])
def test_ladder_and_adaptive_flags_forward_as_the_references(extra):
    """`--sync_local_steps` and `--sync_adaptive` parse to the
    reference's values on the master and reach the worker's parser."""
    argv = SPEC_ARGV + ["--training_data_dir", "t", "--local_updates", "2"] + extra
    port = targs.master_parser().parse_args(argv)
    ref = jargs.master_parser().parse_args(argv)
    for dest in ("sync_local_steps", "sync_adaptive"):
        assert getattr(port, dest) == getattr(ref, dest), dest
    fwd = targs.worker_forward_args(port, 0, "localhost:1")
    jfwd = jargs.worker_forward_args(ref, 0, "localhost:1")
    for flag in ("--sync_local_steps", "--sync_adaptive"):
        assert (flag in fwd) == (flag in jfwd)
        if flag in fwd:
            assert fwd[fwd.index(flag) + 1] == jfwd[jfwd.index(flag) + 1]
    wargs = targs.worker_parser().parse_args(fwd)
    assert (wargs.sync_local_steps, wargs.sync_adaptive) == (
        port.sync_local_steps, port.sync_adaptive)


# -- the gate: reports into the PS in dispatch order --------------------------


_REPORTER = re.compile(r"^Thread-(\d+) \(report_main\)$")


def _reporters() -> dict:
    """{creation number: thread} of the live pipeline reporter threads
    (both packages name them `Thread-N (report_main)`)."""
    out = {}
    for t in threading.enumerate():
        m = _REPORTER.match(t.name)
        if m:
            out[int(m.group(1))] = t
    return out


class DispatchOrderGate:
    """Wraps a master (either package's). A ReportGradient from a
    pipeline reporter thread waits until every older reporter's report
    has been through the PS, so the reports reach it one at a time in
    the order their threads were created: dispatch order. Everything
    else passes straight through. `wrap` gates any other callable the
    same way (the sharded PS client's `push_grad`)."""

    def __init__(self, master=None):
        self.master = master
        self._cond = threading.Condition()
        self._done: set = set()

    @property
    def calls(self):
        return self.master.calls

    def wrap(self, fn):
        def gated(*args, **kwargs):
            m = _REPORTER.match(threading.current_thread().name)
            if m is None:
                return fn(*args, **kwargs)
            me = int(m.group(1))
            with self._cond:
                while any(n < me and n not in self._done for n in _reporters()):
                    self._cond.wait(0.005)
            try:
                return fn(*args, **kwargs)
            finally:
                with self._cond:
                    self._done.add(me)
                    self._cond.notify_all()
        return gated

    def call(self, method, request=None):
        if method != "ReportGradient":
            return self.master.call(method, request)
        return self.wrap(self.master.call)(method, request)


@pytest.fixture
def records(tmp_path):
    path = str(tmp_path / "tokens.rio")
    write_learnable_token_records(path, RECORDS, SEQ, TINY["vocab"], seed=5)
    return path


def _init():
    return jtlm.init_params(np.random.default_rng(13), jzoo.custom_model(**TINY).cfg)


def _ref_job(path, init, depth, gate=True, intercept=None, **servicer_kw):
    dispatcher = JDispatcher({path: RECORDS}, {}, {}, PER_TASK, 1, shuffle_seed=4)
    spec = jspec_from_module(jzoo, model=jzoo.custom_model(**TINY))
    servicer = JServicer(1, JPSOptimizer(jzoo.optimizer()), task_dispatcher=dispatcher,
                         init_params=init, **servicer_kw)
    master = JInProcessMaster(servicer, intercept=intercept)
    worker = JWorker(0, DispatchOrderGate(master) if gate else master, spec,
                     minibatch_size=BATCH, step_pipeline=depth)
    assert worker.run()
    worker.close()
    assert dispatcher.finished()
    params, _aux, version = servicer.get_params_copy()
    return jcodec.ravel_np(params), version, servicer, worker, master


def _port_job(path, init, depth, gate=True, intercept=None, **servicer_kw):
    dispatcher = TaskDispatcher({path: RECORDS}, {}, {}, PER_TASK, 1, shuffle_seed=4)
    spec = spec_from_module(tzoo, model=tzoo.custom_model(**TINY))
    servicer, _e, _c = build_job(spec, dispatcher, grads_to_wait=1, init_params=init,
                                 **servicer_kw)
    master = InProcessMaster(servicer, intercept=intercept)
    worker = Worker(0, DispatchOrderGate(master) if gate else master, spec,
                    minibatch_size=BATCH, device="cpu", step_pipeline=depth)
    assert worker.run()
    worker.close()
    assert dispatcher.finished()
    params, _aux, version = servicer.get_params_copy()
    return codec.ravel_np(params), version, servicer, worker, master


# -- a single worker ------------------------------------------------------------


@pytest.mark.parametrize("depth,settings", [
    (1, dict(staleness_window=1)),
    (2, dict(staleness_window=2)),
    (2, dict(use_async=True, lr_staleness_modulation=True)),
    (4, dict(use_async=True)),
], ids=["d1-window1", "d2-window2", "d2-async-modulated", "d4-async"])
def test_gated_pipelined_job_matches_the_reference(records, depth, settings):
    """One worker, 12 steps, reports gated into the PS in dispatch order
    on both sides: every report accepted and applied once (version 12 =
    init + applied in both), each batch computed once, a report joined
    for every step but the job's first (it pulls the model through the
    serial loop, as the reference's does), and the params and task
    losses the reference's within the stated tolerance."""
    init = _init()
    jvec, jversion, jservicer, jworker, _jm = _ref_job(records, init, depth, **settings)
    vec, version, servicer, worker, master = _port_job(records, init, depth, **settings)
    assert version == jversion == STEPS
    assert servicer.exactness() == {"version": STEPS, "init_version": 0,
                                    "applied_update_steps": STEPS}
    assert master.calls["ReportGradient"] == STEPS
    assert worker.steps_computed == worker.steps_accepted == STEPS
    assert worker.step_reports_joined == STEPS - 1 and worker.step_retrained == 0
    assert worker.phase_seconds["sync_wait"] > 0
    np.testing.assert_allclose(vec, jvec, **JOB_TOL)
    np.testing.assert_allclose(worker.task_losses, jworker.task_losses, atol=1e-5)
    assert not np.array_equal(vec, jcodec.ravel_np(init))


def test_gated_pipelined_job_is_deterministic_and_differs_from_serial(records):
    """Under the gate two port runs agree bit for bit, and the pipelined
    trajectory (gradients up to 2 versions stale) is not the serial
    job's, whose gradients are all fresh."""
    init = _init()
    a, va, *_ = _port_job(records, init, 2, use_async=True)
    b, vb, *_ = _port_job(records, init, 2, use_async=True)
    serial, vs, _s, sworker, _m = _port_job(records, init, 0, gate=False, use_async=True)
    assert va == vb == vs == STEPS
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, serial)
    assert sworker.step_reports_joined == 0


def _stale_every_third():
    lock, state = threading.Lock(), {"n": 0}

    def make_stale(req):
        with lock:
            state["n"] += 1
            stale = state["n"] % 3 == 0
        if stale:
            req = dict(req)
            req["version"] = req["version"] - 5  # far beyond the window
        return req

    return {"ReportGradient": make_stale}


def test_rejection_falls_back_to_the_serial_retry_as_the_reference(records):
    """Every third report is made 5 versions stale, beyond the window of
    1: the PS rejects it, and the join trains its batch again through
    the serial loop. Both packages finish every task with version =
    applied steps = one per batch, and send more reports than versions."""
    init = _init()
    _jv, jversion, jservicer, _jw, jmaster = _ref_job(
        records, init, 1, gate=False, intercept=_stale_every_third(), staleness_window=1)
    _v, version, servicer, worker, master = _port_job(
        records, init, 1, gate=False, intercept=_stale_every_third(), staleness_window=1)
    assert version == jversion == STEPS
    assert jservicer._applied_update_steps == servicer.exactness()["applied_update_steps"] == STEPS
    assert master.calls["ReportGradient"] > version
    assert jmaster.calls["ReportGradient"] > jversion
    assert worker.step_retrained > 0 and worker.steps_accepted == STEPS
    # each batch dispatched once, each retrained batch at least once more
    assert worker.step_reports_joined == STEPS - 1
    assert worker.steps_computed >= STEPS + worker.step_retrained


def test_two_pipelined_workers_as_the_reference(records):
    """Two workers in threads, depth 1, a staleness window of 2: both
    packages finish every task; the port's version is the steps accepted,
    one per batch."""
    results = {}
    for pkg in ("ref", "port"):
        init = _init()
        if pkg == "ref":
            dispatcher = JDispatcher({records: RECORDS}, {}, {}, 16, 1, shuffle_seed=4)
            servicer = JServicer(1, JPSOptimizer(jzoo.optimizer()), task_dispatcher=dispatcher,
                                 init_params=init, staleness_window=2)
            master = JInProcessMaster(servicer)
            workers = [JWorker(i, master, jspec_from_module(jzoo, model=jzoo.custom_model(**TINY)),
                               minibatch_size=BATCH, step_pipeline=1) for i in range(2)]
        else:
            dispatcher = TaskDispatcher({records: RECORDS}, {}, {}, 16, 1, shuffle_seed=4)
            spec = spec_from_module(tzoo, model=tzoo.custom_model(**TINY))
            servicer, _e, _c = build_job(spec, dispatcher, grads_to_wait=1, init_params=init,
                                         staleness_window=2)
            master = InProcessMaster(servicer)
            workers = [Worker(i, master, spec_from_module(tzoo, model=tzoo.custom_model(**TINY)),
                              minibatch_size=BATCH, device="cpu", step_pipeline=1)
                       for i in range(2)]
        threads = [threading.Thread(target=w.run) for w in workers]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        for w in workers:
            w.close()
        assert dispatcher.finished(), pkg
        results[pkg] = (servicer, workers)
    jservicer, _jw = results["ref"]
    servicer, workers = results["port"]
    assert jservicer.version == STEPS and servicer.version == STEPS
    assert servicer.exactness()["applied_update_steps"] == STEPS
    assert sum(w.steps_accepted for w in workers) == STEPS
    # every dispatched batch is accepted once, on its own report or
    # retrained; each worker's first batch went through the serial loop
    assert all(w.step_reports_joined == w.steps_accepted - 1 for w in workers)


def test_gated_pipelined_job_over_shards_matches_the_reference(records, monkeypatch):
    """Async per-step over 2 inproc PS shards at depth 2, the shard
    clients' pushes gated in both packages: the compute-time shard
    versions ride each fan-out; shard versions 12 on both sides, the
    master's mirror exact, params the reference's within the stated
    tolerance."""
    from elasticdl_tpu.rpc.ps_client import ShardedPS as JShardedPS
    from elasticdl_tpu_torch.rpc.ps_client import ShardedPS

    for cls in (JShardedPS, ShardedPS):
        monkeypatch.setattr(cls, "push_grad", DispatchOrderGate().wrap(cls.push_grad))
    init = _init()
    out = {}
    for pkg in ("ref", "port"):
        if pkg == "ref":
            group = JPSShardGroup(2, mode="inproc", optimizer_factory=jzoo.optimizer,
                                  use_async=True, fanin_combine=False)
        else:
            group = PSShardGroup(2, mode="inproc", optimizer_factory=tzoo.optimizer,
                                 use_async=True)
        group.start()
        try:
            if pkg == "ref":
                dispatcher = JDispatcher({records: RECORDS}, {}, {}, PER_TASK, 1, shuffle_seed=4)
                spec = jspec_from_module(jzoo, model=jzoo.custom_model(**TINY))
                servicer = JServicer(1, JPSOptimizer(jzoo.optimizer()),
                                     task_dispatcher=dispatcher, init_params=init,
                                     use_async=True, ps_group=group)
                group.ensure_init(jcodec.ravel_np(init), 0)
                worker = JWorker(0, JInProcessMaster(servicer), spec,
                                 minibatch_size=BATCH, ps_endpoints=group.endpoints,
                                 step_pipeline=2)
            else:
                dispatcher = TaskDispatcher({records: RECORDS}, {}, {}, PER_TASK, 1,
                                            shuffle_seed=4)
                spec = spec_from_module(tzoo, model=tzoo.custom_model(**TINY))
                servicer, _e, _c = build_job(spec, dispatcher, grads_to_wait=1,
                                             init_params=init, use_async=True, ps_group=group)
                worker = Worker(0, InProcessMaster(servicer), spec,
                                minibatch_size=BATCH, device="cpu",
                                ps_endpoints=group.endpoints, step_pipeline=2)
            assert worker.run()
            worker.close()
            assert dispatcher.finished()
            versions, vec = group.assemble()
            out[pkg] = (versions, vec, servicer, worker)
        finally:
            group.stop()
    jversions, jvec, _js, _jw = out["ref"]
    versions, vec, servicer, worker = out["port"]
    assert versions == jversions == [STEPS, STEPS]
    assert servicer.exactness()["version"] == STEPS
    assert worker.step_reports_joined == STEPS - 1
    assert worker.shard_versions == [STEPS, STEPS]
    np.testing.assert_allclose(vec, jvec, **JOB_TOL)


# -- process mode ----------------------------------------------------------------


@pytest.fixture
def _root_log_level():
    level = logging.getLogger().level
    yield
    logging.getLogger().setLevel(level)


@pytest.mark.parametrize("pin", [None, "0"], ids=["auto", "pinned-0"])
def test_async_process_job_forwards_the_resolved_depth(tmp_path, monkeypatch, _root_log_level,
                                                       pin):
    """`master.main --use_async` with 2 worker processes on the CPU: auto
    forwards depth 4 and each worker joins one report a step; `--step_pipeline
    0` forwards 0 and the reports run serially. Every report is applied
    once either way: version = init + applied = the steps accepted."""
    data = tmp_path / "train"
    os.makedirs(data)
    for i in range(2):
        write_learnable_token_records(str(data / f"shard-{i}.rio"), 16, SEQ, TINY["vocab"],
                                      seed=i)
    monkeypatch.setenv(ENV_WORKER_LOG_DIR, str(tmp_path / "logs"))
    argv = ["--model_zoo", ZOO, "--model_def", "transformer_lm_zoo.custom_model",
            "--model_params", ",".join(f"{k}={v}" for k, v in TINY.items()),
            "--minibatch_size", "4", "--records_per_task", "8", "--device", "cpu",
            "--training_data_dir", str(data), "--num_workers", "2", "--use_async",
            "--envs", "OMP_NUM_THREADS=1"]
    if pin is not None:
        argv += ["--step_pipeline", pin]
    rc, summary = master_main.run(argv)
    assert rc == 0
    steps = 2 * 16 // 4
    assert {k: summary[k] for k in ("version", "init_version", "applied_update_steps")} == {
        "version": steps, "init_version": 0, "applied_update_steps": steps}
    workers = read_summaries(str(tmp_path / "logs"))
    depth = 4 if pin is None else 0
    assert {s["step_pipeline"] for s in workers.values()} == {depth}
    assert sum(s["steps_accepted"] for s in workers.values()) == steps
    assert all(s["steps_computed"] == s["steps_accepted"] for s in workers.values())
    joined = sum(s["step_reports_joined"] for s in workers.values())
    # each worker's first batch pulls the model through the serial loop
    trained = sum(1 for s in workers.values() if s["steps_accepted"])
    assert joined == (steps - trained if depth else 0)
    assert all(s["step_retrained"] == 0 for s in workers.values())

"""The port's PhaseTimers (elasticdl_tpu_torch/common/timing.py) and the
phase telemetry (elasticdl_tpu_torch/sched/telemetry.py) against the
reference's (elasticdl_tpu/common/timing.py, elasticdl_tpu/sched/
telemetry.py), bit for bit on the same scripted clock; and the worker's
use of them: the reference's phase names, exclusive seconds that sum to
the run loop's wall clock, and ReportPhaseStats every
EDL_SCHED_PHASE_SECS."""

import threading
import time

import numpy as np
import pytest

from elasticdl_tpu.common import timing as jtiming
from elasticdl_tpu.common.constants import ENV_REGISTRY as JENV_REGISTRY
from elasticdl_tpu.sched import telemetry as jtelemetry
from elasticdl_tpu_torch.api.model_spec_helpers import spec_from_module
from elasticdl_tpu_torch.common import constants as tconstants
from elasticdl_tpu_torch.common import timing as ttiming
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.models import transformer_lm_zoo as tzoo
from elasticdl_tpu_torch.models.record_codec import write_learnable_token_records
from elasticdl_tpu_torch.sched import telemetry as ttelemetry
from elasticdl_tpu_torch.testing import InProcessMaster, build_job
from elasticdl_tpu_torch.worker.worker import Worker
from _torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

VOCAB, SEQ, BATCH = 64, 32, 8


class _Clock:
    """perf_counter's stand-in: each read advances by the next step."""

    def __init__(self, steps):
        self._steps = list(steps)
        self.now = 0.0
        self._lock = threading.Lock()

    def __call__(self):
        with self._lock:
            self.now += self._steps.pop(0) if self._steps else 1.0
            return self.now


def _scripted(timers_cls, monkeypatch):
    """Nested phases on the main thread, then a second thread's own nest
    while the main thread holds a phase open: per-thread stacks, one
    locked total."""
    clock = _Clock([0.5, 0.25, 1.0, 0.125, 2.0, 0.0625, 4.0, 0.5, 0.75, 3.0, 1.5])
    monkeypatch.setattr(time, "perf_counter", clock)
    timers = timers_cls()
    with timers.phase("task_other"):
        with timers.phase("compute"):
            with timers.phase("report_gradient"):
                pass
        with timers.phase("get_batch"):
            pass
        gate = threading.Event()

        def other():
            with timers.phase("sync_wait"):
                with timers.phase("encode"):
                    pass
            gate.set()

        t = threading.Thread(target=other)
        t.start()
        gate.wait()
        t.join()
    timers.add("compute", 0.25)
    return timers.snapshot(), timers.summary()


def test_phase_timers_match_the_reference_bit_for_bit(monkeypatch):
    port = _scripted(ttiming.PhaseTimers, monkeypatch)
    ref = _scripted(jtiming.PhaseTimers, monkeypatch)
    assert port == ref
    snap = port[0]
    # exclusive: the parents exclude their children, so the sum is the
    # outermost phases' wall clock (task_other's, and the second
    # thread's sync_wait, plus the added 0.25)
    assert snap["compute"]["count"] == 2 and snap["task_other"]["count"] == 1


def test_phase_timers_reset_and_seconds():
    timers = ttiming.PhaseTimers()
    timers.add("a", 1.5)
    timers.add("a", 0.5)
    assert timers.seconds() == {"a": 2.0}
    assert timers.snapshot() == {"a": {"seconds": 2.0, "count": 2}}
    timers.reset()
    assert timers.snapshot() == {} and timers.summary() == ""


def test_phase_timers_totals_are_exact_across_threads():
    """8 threads add 500 phases each: no update is lost."""
    timers = ttiming.PhaseTimers()

    def work():
        for _ in range(500):
            timers.add("x", 0.5)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert timers.snapshot() == {"x": {"seconds": 2000.0, "count": 4000}}


# -- the telemetry sink --------------------------------------------------------------


_SNAPS = [
    {"compute": {"seconds": 1.0, "count": 2}, "sync_wait": {"seconds": 0.5, "count": 1}},
    None,
    {"compute": {"seconds": 0.25, "count": 1}, "get_task": {"seconds": 0.125, "count": 3}},
]


def _feed(mod):
    now = [0.0]
    agg = mod.PhaseStatsAggregator(horizon_secs=10.0, clock=lambda: now[0])
    out = [agg.fractions()]
    for t, (wid, snap) in enumerate([
        (0, {"compute": {"seconds": 1.0, "count": 1}}),
        (1, {"compute": {"seconds": 2.0, "count": 1}, "sync_wait": {"seconds": 1.0, "count": 1}}),
        (0, {"compute": {"seconds": 3.0, "count": 2}, "sync_wait": {"seconds": 0.5, "count": 1}}),
        (1, {"compute": {"seconds": 5.0, "count": 2}, "sync_wait": {"seconds": 2.0, "count": 2}}),
        # worker 0 relaunched: its counters restart
        (0, {"compute": {"seconds": 0.5, "count": 1}}),
        (0, {"compute": {"seconds": 1.5, "count": 2}, "get_task": {"seconds": 0.5, "count": 1}}),
        (2, "not a dict"),
    ]):
        now[0] = 4.0 * t
        agg.ingest(wid, snap)
        out.append((agg.fractions(), agg.recent_seconds()))
    out.append((agg.latest_cumulative(), agg.snapshot()))
    agg.forget(1)
    out.append(agg.snapshot())
    return out


def test_telemetry_matches_the_reference_bit_for_bit():
    assert ttelemetry.merge_phase_snapshots(_SNAPS) == jtelemetry.merge_phase_snapshots(_SNAPS)
    assert ttelemetry.merge_phase_snapshots(_SNAPS)["compute"] == {"seconds": 1.25, "count": 3}
    assert _feed(ttelemetry) == _feed(jtelemetry)


def test_obs_env_knobs_carry_the_references_help():
    for name in ("ENV_TRACE_SAMPLE", "ENV_METRICS_PORT", "ENV_FLIGHT_RECORDER_EVENTS",
                 "ENV_FLIGHT_DIR", "ENV_SCHED_PHASE_SECS"):
        env = getattr(tconstants, name)
        assert tconstants.ENV_REGISTRY[env] == JENV_REGISTRY[env], name


# -- the worker's phases --------------------------------------------------------------


REFERENCE_PHASES = {"get_task", "wait_poll", "task_other", "read_records", "get_batch",
                    "compute", "report_gradient", "sync_wait", "get_model", "rebase",
                    "device_wait"}
PORT_ONLY = {"lookup", "eval", "predict"}


@pytest.fixture
def records(tmp_path):
    path = str(tmp_path / "tokens.rio")
    write_learnable_token_records(path, 64, SEQ, VOCAB, seed=3)
    return path


class _Counting:
    def __init__(self, master):
        self.master, self.phase_reports = master, []

    def call(self, method, request=None):
        if method == "ReportPhaseStats":
            self.phase_reports.append(request)
        return self.master.call(method, request)


@pytest.mark.parametrize("local_updates", [0, 2])
def test_worker_phases_are_exclusive_and_reported(records, local_updates, monkeypatch):
    """A per-step and a window job: the phases the worker names are the
    reference's (or the port's own lookup/eval/predict), their exclusive
    seconds sum to at most the run's wall clock (within 1 ms for the
    timer reads between phases), and with EDL_SCHED_PHASE_SECS at 0.001
    every pass of the run loop reports the cumulative snapshot, the
    last one equal to the timers at that point."""
    monkeypatch.setenv("EDL_SCHED_PHASE_SECS", "0.001")
    dispatcher = TaskDispatcher({records: 64}, {}, {}, 16, 1, shuffle_seed=1)
    spec = spec_from_module(tzoo, model=tzoo.custom_model(vocab=VOCAB))
    servicer, _e, _c = build_job(spec, dispatcher)
    got = []
    servicer.set_phase_stats_sink(lambda wid, phases: got.append((wid, phases)))
    master = _Counting(InProcessMaster(servicer))
    worker = Worker(3, master, spec, minibatch_size=BATCH, device="cpu",
                    local_updates=local_updates)
    t0 = time.perf_counter()
    assert worker.run()
    wall = time.perf_counter() - t0
    worker.close()
    names = set(worker.phase_seconds)
    assert {"get_task", "task_other", "read_records", "get_batch", "compute"} <= names
    assert names <= REFERENCE_PHASES | PORT_ONLY
    assert ("report_gradient" in names) == (local_updates == 0)
    assert sum(worker.phase_seconds.values()) <= wall + 1e-3
    assert len(got) == len(master.phase_reports) >= 4  # 4 tasks, then the finish
    assert all(wid == 3 for wid, _ in got)
    last = got[-1][1]
    assert set(last) <= names and all(
        last[k]["count"] <= worker.timers.snapshot()[k]["count"] for k in last)
    assert np.isfinite(worker.task_losses).all()


def test_phase_reports_off_at_zero(records, monkeypatch):
    monkeypatch.setenv("EDL_SCHED_PHASE_SECS", "0")
    dispatcher = TaskDispatcher({records: 64}, {}, {}, 32, 1, shuffle_seed=1)
    spec = spec_from_module(tzoo, model=tzoo.custom_model(vocab=VOCAB))
    servicer, _e, _c = build_job(spec, dispatcher)
    master = _Counting(InProcessMaster(servicer))
    worker = Worker(0, master, spec, minibatch_size=BATCH, device="cpu")
    assert worker.run()
    worker.close()
    assert master.phase_reports == []

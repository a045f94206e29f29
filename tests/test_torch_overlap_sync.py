"""Window mode's overlap plane and wire plane against the reference's.

The reference's `tests/test_overlap.py` (the overlap gate, the staged
page-in's hand-off rules, the background pull) and
`tests/test_adaptive_sync.py` (the wire-form policy, the link
estimate, the knobs, the local-steps ladder, the adaptive cold start;
its bucketed pushes are not ported), each held against the reference
on the same inputs:

- host logic bit for bit: `sync_policy.decide` over a grid of weather,
  sizes and histories, `LinkWeather` on the same observation sequences,
  the staged apply's and the background pull's state transitions on the
  same skeleton workers, and, in jobs, versions, push counts and report
  keys;
- float compute within a stated tolerance: the window jobs' params
  (1e-4: float32 gradients from two frameworks, amplified by Adam where
  |g| is tiny), and the adaptive (bf16 error-feedback) job against the
  float32 job (2e-2, the reference's band).

Training tasks announce no version (-1), so in window mode the page-in
starts where the local model is not fresh: after a reset. The page-in
jobs make one deterministic with a test-side fault: the shard client's
second window push raises before it reaches the shards, the sync fails,
its task is requeued and the worker resets; with `EDL_SYNC_DEPTH=0` the
chain is idle when the next task starts.
"""

import threading
import types

import numpy as np
import pytest

from elasticdl_tpu.api.model_spec_helpers import spec_from_module as jspec_from_module
from elasticdl_tpu.common import codec as jcodec
from elasticdl_tpu.common import messages as jmessages
from elasticdl_tpu.common import sync_policy as jpolicy
from elasticdl_tpu.common.linkprobe import LinkWeather as JLinkWeather
from elasticdl_tpu.master.ps_group import PSShardGroup as JPSShardGroup
from elasticdl_tpu.master.ps_optimizer import PSOptimizer as JPSOptimizer
from elasticdl_tpu.master.servicer import MasterServicer as JServicer
from elasticdl_tpu.master.task_dispatcher import TaskDispatcher as JDispatcher
from elasticdl_tpu.models import transformer_lm as jtlm
from elasticdl_tpu.models import transformer_lm_zoo as jzoo
from elasticdl_tpu.rpc.ps_client import ShardedPS as JShardedPS
from elasticdl_tpu.testing import InProcessMaster as JInProcessMaster
from elasticdl_tpu.worker.worker import Worker as JWorker
from elasticdl_tpu_torch.api.model_spec_helpers import spec_from_module
from elasticdl_tpu_torch.common import codec, messages, sync_policy
from elasticdl_tpu_torch.common.constants import (
    ENV_OVERLAP_SYNC,
    ENV_SYNC_ADAPTIVE,
    ENV_SYNC_DEPTH,
    ENV_SYNC_LOCAL_STEPS,
)
from elasticdl_tpu_torch.common.linkprobe import LinkWeather
from elasticdl_tpu_torch.master.ps_group import PSShardGroup
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.models import transformer_lm_zoo as tzoo
from elasticdl_tpu_torch.models.record_codec import write_learnable_token_records
from elasticdl_tpu_torch.rpc.ps_client import ShardedPS
from elasticdl_tpu_torch.testing import InProcessMaster, build_job
from elasticdl_tpu_torch.worker.worker import Worker
from _torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

TINY = dict(vocab=32, d_model=16, n_heads=2, d_ff=32, n_layers=1)
SEQ, BATCH, RECORDS, PER_TASK = 16, 8, 96, 32
STEPS = RECORDS // BATCH
JOB_TOL = dict(atol=1e-4, rtol=0)


# -- sync_policy.decide and projected_push_seconds -----------------------------


def test_decide_policy_rungs_cold_start_hysteresis_and_jumps():
    """The reference's own cases, answered the same by both copies."""
    mb = 1_000_000
    cases = [
        (80.0, mb, None, "f32"), (10.0, mb, None, "bf16"), (4.0, mb, None, "int8"),
        (1.0, mb, None, "topk"),
        (None, 123, None, sync_policy.COLD_START_FORM),
        (None, 123, [{"form": "int8"}], "int8"), (None, 123, ["topk"], "topk"),
        (None, 123, [{"form": "xyzzy"}], sync_policy.COLD_START_FORM),
        (8e6 / 0.27e6, mb, ["f32"], "f32"), (8e6 / 0.27e6, mb, [{"form": "f32"}], "f32"),
        (8e6 / 0.27e6, mb, None, "bf16"), (8e6 / 0.22e6, mb, [{"form": "bf16"}], "bf16"),
        (8e6 / 0.22e6, mb, None, "f32"), (8e6 / 0.50e6, mb, [{"form": "f32"}], "bf16"),
        (8e6 / 2.0e6, mb, [{"form": "f32"}], "int8"),  # a jump of two rungs
    ]
    for mbps, nbytes, history, want in cases:
        assert sync_policy.decide(mbps, nbytes, history) == want, (mbps, history)
        assert jpolicy.decide(mbps, nbytes, history) == want
    assert sync_policy.COLD_START_FORM == jpolicy.COLD_START_FORM == "bf16"
    assert sync_policy.WIRE_FORMS == jpolicy.WIRE_FORMS


def test_decide_matches_the_reference_bit_for_bit_over_a_grid():
    """Link speeds log-uniform over 0.01-10,000 Mbps (and None), delta
    sizes over 1 B-1 GB, every history shape (none, each form as a
    string and as a log dict, junk): the same form from both copies,
    and the same projected push seconds to the bit."""
    rng = np.random.default_rng(7)
    speeds = [None] + list(10 ** rng.uniform(-2, 4, 400))
    sizes = [int(x) for x in 10 ** rng.uniform(0, 9, 60)]
    histories = [None, [], ["junk"]] + [[f] for f in jpolicy.WIRE_FORMS] + [
        [{"form": f, "round": 0}] for f in jpolicy.WIRE_FORMS]
    n = 0
    for i, mbps in enumerate(speeds):
        for nbytes in sizes[i % 7::7]:
            for history in histories:
                assert sync_policy.decide(mbps, nbytes, history) == jpolicy.decide(
                    mbps, nbytes, history)
                n += 1
            if mbps is not None:
                assert sync_policy.projected_push_seconds(mbps, nbytes) == \
                    jpolicy.projected_push_seconds(mbps, nbytes)
    assert n > 20_000
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError, match="link_mbps"):
            sync_policy.projected_push_seconds(bad, 100)
    assert sync_policy.projected_push_seconds(8.0, 1_000_000) == 1.0


# -- LinkWeather -----------------------------------------------------------------


def test_link_weather_median_and_discards():
    """The reference's case: cold start, discarded dispatch-sized
    samples, a median one stalled push does not drag, the ring."""
    for cls in (LinkWeather, JLinkWeather):
        w = cls(window=4)
        assert w.mbps() is None
        w.observe(0, 1.0)
        w.observe(1000, 1e-4)
        assert w.mbps() is None and w.observations == 0
        for _ in range(3):
            w.observe(1_000_000, 1.0)
        w.observe(100_000, 1.0)
        assert w.observations == 4 and w.mbps() == pytest.approx(8.0)
        assert len(w.history()) == 4
        for _ in range(4):
            w.observe(500_000, 1.0)
        assert w.mbps() == pytest.approx(4.0)


@pytest.mark.parametrize("window", [1, 2, 5, 8])
def test_link_weather_matches_the_reference_on_the_same_sequence(window):
    """400 random pushes (some of no bytes, some under a millisecond):
    after every one the estimate, the history and the count are the
    reference's, bit for bit."""
    rng = np.random.default_rng(window)
    port, ref = LinkWeather(window=window), JLinkWeather(window=window)
    for _ in range(400):
        nbytes = int(rng.choice([0, rng.integers(1, 10**9)]))
        seconds = float(rng.choice([1e-4, 1e-3, rng.uniform(1e-3, 5.0)]))
        port.observe(nbytes, seconds)
        ref.observe(nbytes, seconds)
        assert port.mbps() == ref.mbps()
        assert port.history() == ref.history()
        assert port.observations == ref.observations


# -- the knobs -------------------------------------------------------------------


def _bare(pkg, **kw):
    if pkg == "ref":
        return JWorker(0, None, jspec_from_module(jzoo, model=jzoo.custom_model(**TINY)),
                       minibatch_size=4, **kw)
    return Worker(0, None, spec_from_module(tzoo, model=tzoo.custom_model(**TINY)),
                  minibatch_size=4, device="cpu", **kw)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_knob_env_fallbacks_and_validation(pkg, monkeypatch):
    """EDL_SYNC_LOCAL_STEPS, EDL_SYNC_ADAPTIVE and EDL_OVERLAP_SYNC apply
    when the argument is unset, and junk raises, in both packages alike."""
    monkeypatch.setenv(ENV_SYNC_LOCAL_STEPS, "3")
    monkeypatch.setenv(ENV_SYNC_ADAPTIVE, "on")
    monkeypatch.setenv(ENV_OVERLAP_SYNC, "off")
    w = _bare(pkg, local_updates=2)
    assert (w._sync_local_steps, w._sync_adaptive) == (3, True)
    assert (w._overlap_sync, w._max_inflight_syncs) == (False, 0)
    w = _bare(pkg, local_updates=2, sync_local_steps=2, sync_adaptive="off",
              overlap_sync="on")
    assert (w._sync_local_steps, w._sync_adaptive, w._overlap_sync) == (2, False, True)
    for env in (ENV_SYNC_LOCAL_STEPS, ENV_SYNC_ADAPTIVE, ENV_OVERLAP_SYNC):
        monkeypatch.delenv(env)
    w = _bare(pkg, local_updates=2)
    assert (w._sync_local_steps, w._sync_adaptive, w._overlap_sync) == (1, False, True)
    assert w._max_inflight_syncs == 2
    monkeypatch.setenv(ENV_SYNC_DEPTH, "0")
    w = _bare(pkg, local_updates=2)
    assert (w._overlap_sync, w._max_inflight_syncs) == (True, 0)  # the page-in stays on
    with pytest.raises(ValueError, match="sync_local_steps"):
        _bare(pkg, sync_local_steps=0)
    with pytest.raises(ValueError, match="sync_adaptive"):
        _bare(pkg, sync_adaptive="sometimes")
    with pytest.raises(ValueError, match="overlap_sync"):
        _bare(pkg, overlap_sync="sideways")


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_adaptive_counts_as_lossy_and_supersedes_the_transport_cast(pkg):
    w = _bare(pkg, sync_adaptive="on", transport_dtype="bfloat16")
    assert w._lossy_sync() and w._transport_dtype == "float32"
    assert w._model_wire_dtype() == "bfloat16"
    assert not _bare(pkg)._lossy_sync()


# -- the staged page-in: hand-off rules on skeleton workers --------------------


BOUNDS = [(0, 4), (4, 8)]


def _skeleton(pkg):
    """A worker with exactly the overlap plane's state, in either
    package (the reference's `test_overlap._staged_worker`)."""
    cls = JWorker if pkg == "ref" else Worker
    w = cls.__new__(cls)
    w._pkg = pkg
    w._report_lock = threading.Lock()
    w._overlap_sync = True
    w._absorb_staged = None
    w._sync_result = None
    w._sync_thread = None
    w._version = 4
    w._lineage_version = 4
    w._own_steps_abs = 9
    w._lineage_anchor_abs = 2
    w._shard_versions = None
    w._shard_lineage = None
    w._restore_snap = None
    w._fresh = False
    w._opt_state = object()
    w._id = 0
    w._sync_epoch = 0
    w._bg_pull_thread = None
    w._ensure_ps = lambda: None
    w._model_wire_dtype = lambda: None
    w._applied = []
    if pkg == "ref":
        w._base_version = 4
        w._staged_applied = 0
        w._bg_pulls = 0
        w._aux = None
        w._use_flat = lambda: True
        w._set_flat = lambda vec, aux: w._applied.append((np.asarray(vec), aux))
    else:
        w.staged_applied = 0
        w.bg_pulls = 0
        w._aux_flat = None
        w._ps = types.SimpleNamespace(bounds=BOUNDS, num_shards=2)
        w._set_flat = lambda vec: w._applied.append((np.asarray(vec), None))
        w._set_aux = lambda aux, rpc: w._applied.append((None, aux))
    return w


def _observed(w) -> dict:
    """The skeleton's state after a hand-off, in one form for both."""
    if w._pkg == "ref":
        applied = [(v, a) for v, a in w._applied]
        snap = w._restore_snap
        snap = None if snap is None else [(v, snap[1][s:e]) for v, (s, e) in zip(snap[0], BOUNDS)]
        counts = (w._staged_applied, w._bg_pulls)
    else:
        vecs = [v for v, _a in w._applied if v is not None]
        auxes = [a for v, a in w._applied if v is None]
        applied = list(zip(vecs, auxes))
        snap = w._restore_snap
        counts = (w.staged_applied, w.bg_pulls)
    return {
        "versions": (w._version, w._lineage_version, w._lineage_anchor_abs),
        "shards": (w._shard_versions, w._shard_lineage),
        "fresh": w._fresh, "opt_reset": w._opt_state is None,
        "staged": w._absorb_staged, "counts": counts,
        "applied": [(v.tolist(), a) for v, a in applied],
        "snap": None if snap is None else [(int(v), np.asarray(sl).tolist()) for v, sl in snap],
    }


@pytest.mark.parametrize("sharded", [False, True], ids=["single", "sharded"])
def test_staged_apply_folds_in_and_rebases_as_the_reference(sharded):
    """A newer staged model is folded in: the version, the lineage and
    (over shards) the shard versions and the restore snapshot reset to
    it, the optimizer state restarts, the stage empties; the same state
    in both packages."""
    out = {}
    for pkg in ("ref", "port"):
        w = _skeleton(pkg)
        vec = np.arange(8, dtype=np.float32)
        w._absorb_staged = ([7, 9] if sharded else None, 7, vec, {"m": 1})
        assert w._apply_staged_model() is True
        out[pkg] = _observed(w)
    assert out["port"] == out["ref"]
    got = out["port"]
    assert got["versions"] == (7, 7, 9) and got["fresh"] and got["opt_reset"]
    assert got["counts"] == (1, 0) and got["staged"] is None
    assert got["shards"] == (([7, 9], [7, 9]) if sharded else (None, None))
    assert (got["snap"] is not None) == sharded


def test_staged_apply_monotonic_guard_and_gate_off_as_the_reference():
    """A staged model no newer than the local one is dropped; with the
    overlap plane off a staged model is never folded in."""
    for pkg in ("ref", "port"):
        w = _skeleton(pkg)
        w._absorb_staged = (None, 4, np.zeros(4, np.float32), None)
        assert w._apply_staged_model() is False
        assert w._absorb_staged is None and w._applied == []
        w = _skeleton(pkg)
        w._overlap_sync = False
        w._absorb_staged = (None, 9, np.zeros(4, np.float32), None)
        assert w._apply_staged_model() is False
        assert w._applied == [] and w._absorb_staged is not None


def test_staged_apply_defers_to_a_waiting_merge_and_a_busy_chain_as_the_reference():
    """An unabsorbed merged model goes first, and a running sync chain
    defers the fold; the staged model survives both, and folds once the
    chain is idle."""
    for pkg in ("ref", "port"):
        w = _skeleton(pkg)
        staged = (None, 9, np.zeros(4, np.float32), None)
        w._absorb_staged = staged
        w._sync_result = (1, np.zeros(4, np.float32), None, 5, None)
        assert w._apply_staged_model() is False and w._absorb_staged is staged
        w._sync_result = None
        gate = threading.Event()
        t = threading.Thread(target=gate.wait, daemon=True)
        t.start()
        w._sync_thread = t
        try:
            assert w._apply_staged_model() is False and w._absorb_staged is staged
        finally:
            gate.set()
            t.join()
        w._sync_thread = None
        assert w._apply_staged_model() is True


class _FakeMaster:
    def __init__(self, served):
        self.served, self.calls = served, 0

    def call(self, method, req):
        assert method == "GetModel" and req["only_if_newer"]
        self.calls += 1
        return {"version": 9, "params_flat": self.served}


def test_bg_pull_stages_only_newer_and_same_epoch_as_the_reference():
    """A current worker never pulls; one behind stages the newer model;
    a pull whose epoch flipped meanwhile (a reset) is dropped; the same
    in both packages."""
    served = np.arange(6, dtype=np.float32)
    for pkg in ("ref", "port"):
        w = _skeleton(pkg)
        w._master = _FakeMaster(served)
        w._fresh = True
        w._maybe_start_bg_pull(4)
        assert w._bg_pull_thread is None and _observed(w)["counts"] == (0, 0)
        w._maybe_start_bg_pull(8)
        assert _observed(w)["counts"] == (0, 1)
        w._join_bg_pull()
        assert w._master.calls == 1 and w._absorb_staged[1] == 9
        np.testing.assert_array_equal(w._absorb_staged[2], served)

        w._absorb_staged = None
        real_lock = w._report_lock

        class FlippingLock:
            def __enter__(self):
                real_lock.acquire()
                w._sync_epoch += 1  # a reset raced the pull
                return self

            def __exit__(self, *exc):
                real_lock.release()
                return False

        w._sync_epoch = 0
        w._report_lock = FlippingLock()
        w._bg_pull_once(None, None, 4, False, 0)
        w._report_lock = real_lock
        assert w._absorb_staged is None


# -- window jobs -------------------------------------------------------------------


@pytest.fixture
def records(tmp_path):
    path = str(tmp_path / "tokens.rio")
    write_learnable_token_records(path, RECORDS, SEQ, TINY["vocab"], seed=5)
    return path


def _init():
    return jtlm.init_params(np.random.default_rng(13), jzoo.custom_model(**TINY).cfg)


class _Recording:
    """Records each window push's (report key, steps, packed bytes)."""

    def __init__(self, master, pack):
        self.master, self.pushes, self._pack = master, [], pack

    @property
    def calls(self):
        return self.master.calls

    def call(self, method, request=None):
        if method == "ReportLocalUpdate":
            self.pushes.append((request["report_key"], request["steps"],
                                len(self._pack(request))))
        return self.master.call(method, request)


def _window_job(pkg, path, init, per_task=PER_TASK, **worker_kw):
    if pkg == "ref":
        dispatcher = JDispatcher({path: RECORDS}, {}, {}, per_task, 1, shuffle_seed=4)
        spec = jspec_from_module(jzoo, model=jzoo.custom_model(**TINY))
        servicer = JServicer(1, JPSOptimizer(jzoo.optimizer()), task_dispatcher=dispatcher,
                             init_params=init)
        master_cls, worker_cls, extra = JInProcessMaster, JWorker, {}
    else:
        dispatcher = TaskDispatcher({path: RECORDS}, {}, {}, per_task, 1, shuffle_seed=4)
        spec = spec_from_module(tzoo, model=tzoo.custom_model(**TINY))
        servicer, _e, _c = build_job(spec, dispatcher, grads_to_wait=1, init_params=init)
        master_cls, worker_cls, extra = InProcessMaster, Worker, {"device": "cpu"}

    pack = jmessages.pack if pkg == "ref" else messages.pack
    master = _Recording(master_cls(servicer), pack)
    worker = worker_cls(0, master, spec, minibatch_size=BATCH, **extra, **worker_kw)
    assert worker.run()
    worker.close()
    assert dispatcher.finished()
    params, _aux, version = servicer.get_params_copy()
    ravel = jcodec.ravel_np if pkg == "ref" else codec.ravel_np
    return ravel(params), version, worker, master


def _counts(w):
    if isinstance(w, JWorker):
        return w._bg_pulls, w._staged_applied
    return w.bg_pulls, w.staged_applied


def test_overlap_off_is_the_serial_path_and_on_changes_nothing_the_ps_sees(records):
    """One worker, W = 2: overlap off twice agrees bit for bit; on, the
    PS sees the same pushes (keys, steps, bytes) and ends at the same
    model, with no page-in (an up-to-date worker needs none); off holds
    the reference's off job within the stated tolerance."""
    init = _init()
    off_a, va, w_off, m_off = _window_job("port", records, init, local_updates=2,
                                          overlap_sync="off")
    off_b, vb, _w, m_off_b = _window_job("port", records, init, local_updates=2,
                                         overlap_sync="off")
    on, von, w_on, m_on = _window_job("port", records, init, local_updates=2,
                                      overlap_sync="on")
    ref, vref, _jw, m_ref = _window_job("ref", records, init, local_updates=2,
                                        overlap_sync="off")
    assert va == vb == von == vref == STEPS
    np.testing.assert_array_equal(off_a, off_b)
    assert m_off.pushes == m_off_b.pushes == m_on.pushes
    assert [p[:2] for p in m_off.pushes] == [p[:2] for p in m_ref.pushes]
    assert len(m_off.pushes) == STEPS // 2
    np.testing.assert_array_equal(on, off_a)
    np.testing.assert_allclose(off_a, ref, **JOB_TOL)
    assert (w_off._overlap_sync, w_off._max_inflight_syncs) == (False, 0)
    assert _counts(w_off) == (0, 0) and _counts(w_on) == (0, 0)
    assert w_on._max_inflight_syncs > 0


def _fail_second_push(monkeypatch, cls, failed: list):
    """The shard client's second window push raises before it reaches
    the shards (test-side, either package's `ShardedPS`)."""
    orig = cls.push_delta
    calls = []

    def push_delta(self, *a, **kw):
        calls.append(1)
        if len(calls) == 2:
            failed.append(1)
            raise RuntimeError("injected push failure")
        return orig(self, *a, **kw)

    monkeypatch.setattr(cls, "push_delta", push_delta)


def _count_pull_async(monkeypatch, cls, pulls: list):
    orig = cls.pull_async

    def pull_async(self, *a, **kw):
        pulls.append(1)
        return orig(self, *a, **kw)

    monkeypatch.setattr(cls, "pull_async", pull_async)


def _sharded_window_job(pkg, path, init, **worker_kw):
    if pkg == "ref":
        group = JPSShardGroup(2, mode="inproc", optimizer_factory=jzoo.optimizer,
                              fanin_combine=False)
    else:
        group = PSShardGroup(2, mode="inproc", optimizer_factory=tzoo.optimizer)
    group.start()
    try:
        if pkg == "ref":
            dispatcher = JDispatcher({path: RECORDS}, {}, {}, PER_TASK, 1, shuffle_seed=4)
            spec = jspec_from_module(jzoo, model=jzoo.custom_model(**TINY))
            servicer = JServicer(1, JPSOptimizer(jzoo.optimizer()), task_dispatcher=dispatcher,
                                 init_params=init, ps_group=group)
            group.ensure_init(jcodec.ravel_np(init), 0)
            worker = JWorker(0, JInProcessMaster(servicer), spec, minibatch_size=BATCH,
                             ps_endpoints=group.endpoints, local_updates=2, **worker_kw)
        else:
            dispatcher = TaskDispatcher({path: RECORDS}, {}, {}, PER_TASK, 1, shuffle_seed=4)
            spec = spec_from_module(tzoo, model=tzoo.custom_model(**TINY))
            servicer, _e, _c = build_job(spec, dispatcher, grads_to_wait=1, init_params=init,
                                         ps_group=group)
            worker = Worker(0, InProcessMaster(servicer), spec, minibatch_size=BATCH,
                            device="cpu", ps_endpoints=group.endpoints, local_updates=2,
                            **worker_kw)
        assert worker.run()
        worker.close()
        assert dispatcher.finished()
        versions, vec = group.assemble()
        return versions, vec, servicer, worker
    finally:
        group.stop()


def test_page_in_after_a_reset_over_shards_as_the_reference(records, monkeypatch):
    """Over 2 inproc PS shards, a serialized chain: the second window
    push fails, its task is requeued and the worker resets (version -1,
    not fresh). The next task starts a background pull through
    `ShardedPS.pull_async`, and the first window boundary folds it in,
    as the reference's worker does: 1 pull and 1 fold in both. Shard
    versions [12, 12] and the master's mirror exact (the failed window
    never landed and was trained again); params the reference's within
    the stated tolerance, and the overlap-off job's (its blocking pull
    fetches the same model) bit for bit."""
    monkeypatch.setenv(ENV_SYNC_DEPTH, "0")
    init = _init()
    failed, pulls = [], []
    out = {}
    for pkg, cls in (("ref", JShardedPS), ("port", ShardedPS), ("off", ShardedPS)):
        with monkeypatch.context() as m:
            _fail_second_push(m, cls, failed)
            _count_pull_async(m, cls, pulls)
            kw = {"overlap_sync": "off"} if pkg == "off" else {}
            out[pkg] = _sharded_window_job("ref" if pkg == "ref" else "port", records, init,
                                           **kw)
        out[pkg] += (len(pulls),)
        pulls.clear()
    assert len(failed) == 3
    jversions, jvec, _js, jworker, jpulls = out["ref"]
    versions, vec, servicer, worker, npulls = out["port"]
    offv, off, _so, w_off, off_pulls = out["off"]
    assert versions == jversions == offv == [STEPS, STEPS]
    assert servicer.exactness() == {"version": STEPS, "init_version": 0,
                                    "applied_update_steps": STEPS}
    assert _counts(worker) == _counts(jworker) == (1, 1) and npulls == jpulls == 1
    assert _counts(w_off) == (0, 0) and off_pulls == 0
    assert worker.shard_versions == [STEPS, STEPS]
    # the fold reset the restore snapshot to the paged-in model's slices
    assert worker._restore_snap is not None and len(worker._restore_snap) == 2
    np.testing.assert_allclose(vec, jvec, **JOB_TOL)
    np.testing.assert_array_equal(vec, off)


def test_no_page_in_on_the_single_ps_after_a_reset_as_the_reference(records, monkeypatch):
    """On the single PS a reset worker (version -1) makes first contact
    through the blocking pull, as the reference's does: no background
    pull in either package, and the job still ends exact."""
    monkeypatch.setenv(ENV_SYNC_DEPTH, "0")
    init = _init()
    out = {}
    for pkg in ("ref", "port"):
        calls = []

        def fail_second(req, calls=calls):
            calls.append(1)
            if len(calls) == 2:
                raise RuntimeError("injected push failure")
            return req

        if pkg == "ref":
            dispatcher = JDispatcher({records: RECORDS}, {}, {}, PER_TASK, 1, shuffle_seed=4)
            spec = jspec_from_module(jzoo, model=jzoo.custom_model(**TINY))
            servicer = JServicer(1, JPSOptimizer(jzoo.optimizer()), task_dispatcher=dispatcher,
                                 init_params=init)
            worker = JWorker(0, JInProcessMaster(servicer,
                                                 intercept={"ReportLocalUpdate": fail_second}),
                             spec, minibatch_size=BATCH, local_updates=2)
        else:
            dispatcher = TaskDispatcher({records: RECORDS}, {}, {}, PER_TASK, 1, shuffle_seed=4)
            spec = spec_from_module(tzoo, model=tzoo.custom_model(**TINY))
            servicer, _e, _c = build_job(spec, dispatcher, grads_to_wait=1, init_params=init)
            worker = Worker(0, InProcessMaster(servicer,
                                               intercept={"ReportLocalUpdate": fail_second}),
                            spec, minibatch_size=BATCH, device="cpu", local_updates=2)
        assert worker.run()
        worker.close()
        assert dispatcher.finished()
        out[pkg] = (servicer.version, _counts(worker))
    assert out["port"] == out["ref"] == (STEPS, (0, 0))


# -- the local-steps ladder ----------------------------------------------------------


def test_ladder_at_k1_is_bit_identical_to_no_flag(records):
    """`sync_local_steps=1` with adaptive off is the knobless chain to
    the last bit: the same pushes and the same model."""
    init = _init()
    ref, v, _w, m = _window_job("port", records, init, local_updates=2)
    vec, v1, _w1, m1 = _window_job("port", records, init, local_updates=2,
                                   sync_local_steps=1, sync_adaptive="off")
    assert v == v1 == STEPS and m.pushes == m1.pushes
    np.testing.assert_array_equal(vec, ref)


def test_ladder_at_k2_rebrackets_exactly_as_the_reference(records):
    """k = 2 x W = 2 pushes the cumulative delta of 4 steps under one
    report key: the port's pushes (keys and steps) are the reference's
    and the same as k = 1 x W = 4's, the model the latter's bit for
    bit, and the reference's within the stated tolerance; the version
    advances by the steps a push, to 12 exactly."""
    init = _init()
    w4, v4, _w, m4 = _window_job("port", records, init, local_updates=4)
    k2, vk, wk, mk = _window_job("port", records, init, local_updates=2, sync_local_steps=2)
    jk2, jvk, jw, jmk = _window_job("ref", records, init, local_updates=2, sync_local_steps=2)
    assert v4 == vk == jvk == STEPS
    assert [p[:2] for p in mk.pushes] == [p[:2] for p in jmk.pushes] == [p[:2] for p in m4.pushes]
    assert [p[1] for p in mk.pushes] == [4] * (STEPS // 4)
    np.testing.assert_array_equal(k2, w4)
    np.testing.assert_allclose(k2, jk2, **JOB_TOL)
    assert wk.steps_accepted == STEPS and wk._sync_local_steps == 2


def test_ladder_version_accounting_with_ragged_tasks(records):
    """k = 4 x W = 2 with tasks of 3 minibatches: a push never straddles
    a task, so each task's tail goes out short; the keys and steps are
    the reference's, and the version is the steps trained."""
    init = _init()
    _v, version, _w, m = _window_job("port", records, init, per_task=24, local_updates=2,
                                     sync_local_steps=4)
    _jv, jversion, _jw, jm = _window_job("ref", records, init, per_task=24, local_updates=2,
                                         sync_local_steps=4)
    assert version == jversion == STEPS
    assert [p[:2] for p in m.pushes] == [p[:2] for p in jm.pushes]
    assert [p[1] for p in m.pushes] == [3] * (RECORDS // 24)


# -- the adaptive wire plane -----------------------------------------------------------


class _Weather(LinkWeather):
    """A link estimate the test fixes: in-process pushes take a time
    that depends on the machine's load, which would make the decisions
    a race. Observations are counted, not used."""

    def __init__(self, mbps):
        super().__init__()
        self.fixed = mbps

    def mbps(self):
        return self.fixed


class _JWeather(JLinkWeather):
    def __init__(self, mbps):
        super().__init__()
        self.fixed = mbps

    def mbps(self):
        return self.fixed


def _adaptive_job(pkg, path, init, mbps, **kw):
    """The adaptive window job with the link estimate fixed at `mbps`."""
    cls = JWorker if pkg == "ref" else Worker
    orig = cls.__init__

    def init_with_weather(self, *a, **k):
        orig(self, *a, **k)
        self._link_weather = (_JWeather if pkg == "ref" else _Weather)(mbps)

    cls.__init__ = init_with_weather
    try:
        return _window_job(pkg, path, init, local_updates=2, sync_adaptive="on", **kw)
    finally:
        cls.__init__ = orig


def test_adaptive_cold_start_decisions_match_the_reference(records):
    """No link estimate: every round rides the bf16 cold-start rung. The
    decision log is the reference's entry for entry (round, form, no
    estimate, the float32 delta's bytes, steps), each push's wire bytes
    are counted under "bf16" at half the float32 size, and the model
    stays within the bf16 error-feedback band of the float32 job and
    within the stated tolerance of the reference's adaptive job."""
    init = _init()
    f32, _v, _w, _m = _window_job("port", records, init, local_updates=2)
    vec, version, worker, master = _adaptive_job("port", records, init, None)
    jvec, jversion, jworker, _jm = _adaptive_job("ref", records, init, None)
    assert version == jversion == STEPS
    log = worker.sync_decisions
    assert log == jworker.sync_decisions
    assert [d["round"] for d in log] == list(range(STEPS // 2))
    n = jcodec.ravel_np(init).size
    assert all(d["form"] == "bf16" and d["link_mbps"] is None and d["delta_bytes"] == 4 * n
               and d["steps"] == 2 for d in log)
    assert worker.wire_forms == {"bf16": {"bytes_sent": 2 * n * len(log), "rounds": len(log)}}
    np.testing.assert_allclose(vec, f32, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(vec, jvec, **JOB_TOL)
    _v, _v2, off_worker, _mo = _window_job("port", records, init, local_updates=2,
                                           sync_adaptive="off")
    assert off_worker.sync_decisions == [] and off_worker.wire_forms == {}


@pytest.mark.parametrize("seconds,form", [(0.1, "f32"), (2.0, "int8"), (10.0, "topk")])
def test_adaptive_rung_sets_the_wire_form_as_the_reference(records, seconds, form):
    """With the estimate fixed where a float32 push would take `seconds`,
    every push goes out in that rung's form (the decision log the
    reference's, entry for entry): an f32 round at the full 4 bytes an
    element, int8 and top-k well under it; the model the reference's
    within the stated tolerance (an f32 round sends the corrected delta
    exactly and clears the residual)."""
    init = _init()
    n = jcodec.ravel_np(init).size
    mbps = n * 4 * 8 / (seconds * 1e6)
    vec, version, worker, _m = _adaptive_job("port", records, init, mbps)
    jvec, jversion, jworker, _jm = _adaptive_job("ref", records, init, mbps)
    assert version == jversion == STEPS
    assert worker.sync_decisions == jworker.sync_decisions
    assert {d["form"] for d in worker.sync_decisions} == {form}
    rounds = len(worker.sync_decisions)
    assert set(worker.wire_forms) == {form} and worker.wire_forms[form]["rounds"] == rounds
    sent = worker.wire_forms[form]["bytes_sent"]
    if form == "f32":
        assert sent == 4 * n * rounds
    else:
        assert sent < 2 * n * rounds
    np.testing.assert_allclose(vec, jvec, **JOB_TOL)

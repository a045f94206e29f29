"""The port's sharded PS (`--num_ps`) against the reference's, on the CPU:
`slice_boundaries`, the wire deltas' slicing, a scripted shard sequence
through both servicers, the slice clip of the transformer zoo's
optimizer, a concurrent push and pull, small transformer jobs over inproc
shards (window and async per-step), two workers, the checkpoint cadence
through ReportWindowMeta, exact resume and its shard count, an
evaluation job, the refusals, the worker's paired reads of the sync
threads' state, and a process-mode job over 2 shard processes.

Tolerances: boundaries, the codec, the scripted sequence (plain SGD and
window adds: float32 numpy on both sides) and the dedup ring are held
bit for bit; the slice clip (clip + Adam over the same gradients) to
1e-6 absolute and relative, as `tests/test_torch_ps.py`'s optimizer
test; the jobs to 1e-4 absolute, as `tests/test_torch_window.py`'s
(float32 gradients from two frameworks, amplified by Adam where |g| is
tiny).
"""

import os
import threading
import time

import numpy as np
import pytest

from elasticdl_tpu.api.model_spec_helpers import spec_from_module as jspec_from_module
from elasticdl_tpu.common import codec as jcodec
from elasticdl_tpu.common import messages as jmessages
from elasticdl_tpu.master import ps_shard as jps_shard
from elasticdl_tpu.master.checkpoint import load_model_file as jload_model_file
from elasticdl_tpu.master.checkpoint import save_model_file as jsave_model_file
from elasticdl_tpu.master.ps_group import PSShardGroup as JPSShardGroup
from elasticdl_tpu.master.ps_optimizer import PSOptimizer as JPSOptimizer
from elasticdl_tpu.master.servicer import MasterServicer as JServicer
from elasticdl_tpu.master.task_dispatcher import TaskDispatcher as JDispatcher
from elasticdl_tpu.models import transformer_lm as jtlm
from elasticdl_tpu.models import transformer_lm_zoo as jzoo
from elasticdl_tpu.testing import InProcessMaster as JInProcessMaster
from elasticdl_tpu.worker.worker import Worker as JWorker
from elasticdl_tpu_torch.api.model_spec_helpers import spec_from_module
from elasticdl_tpu_torch.common import codec as tcodec
from elasticdl_tpu_torch.common.args import master_parser, validate_ps_args
from elasticdl_tpu_torch.common.constants import ENV_WORKER_LOG_DIR
from elasticdl_tpu_torch.master import main as master_main
from elasticdl_tpu_torch.master.checkpoint import load_model_file
from elasticdl_tpu_torch.master.ps_group import PSShardGroup
from elasticdl_tpu_torch.master.ps_optimizer import PSOptimizer
from elasticdl_tpu_torch.master.ps_shard import PSShardServicer, slice_boundaries
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.models import transformer_lm_zoo as tzoo
from elasticdl_tpu_torch.models.record_codec import write_learnable_token_records
from elasticdl_tpu_torch.rpc import policy
from elasticdl_tpu_torch.testing import InProcessMaster, build_job
from elasticdl_tpu_torch.worker import main as worker_main
from elasticdl_tpu_torch.worker.worker import Worker
from _torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = os.path.join(REPO, "elasticdl_tpu_torch", "models")
VOCAB, SEQ, BATCH = 64, 128, 16
JOB_TOL = dict(atol=1e-4, rtol=0)
OPT = dict(atol=1e-6, rtol=1e-6)


def _bits(a):
    """The raw bytes of a wire array: BF16Bits' bits, a reference bf16
    array's bits, or float32 bytes."""
    if isinstance(a, tcodec.BF16Bits):
        return a.bits.tobytes()
    a = np.asarray(a)
    return (a.view(np.uint16) if a.dtype.itemsize == 2 else a).tobytes()


# -- the split -----------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 7, 100, 1001, 74_048, 436_242_432])
def test_slice_boundaries_are_the_references(n):
    for shards in range(1, 9):
        assert slice_boundaries(n, shards) == jps_shard.slice_boundaries(n, shards)
    with pytest.raises(ValueError):
        slice_boundaries(n, 0)


def test_slice_delta_of_every_wire_form_is_the_references():
    """A shard's slice of an int8, top-k, top-k over int8, bf16 or f32
    delta, bit for bit the reference's, and its decode the dense slice."""
    rng = np.random.default_rng(0)
    n, chunk = 10_000, 2048
    vec = rng.standard_normal(n).astype(np.float32)
    tq, jq = tcodec.quantize_int8(vec, chunk), jcodec.quantize_int8(vec, chunk)
    idx = np.sort(rng.choice(n, 900, replace=False)).astype(np.int32)
    tsd = tcodec.SparseDelta(indices=idx, values=vec[idx], n=n)
    jsd = jcodec.SparseDelta(indices=idx, values=vec[idx], n=n)
    tsq = tcodec.SparseDelta(indices=idx, values=tcodec.quantize_int8(vec[idx], 128), n=n)
    jsq = jcodec.SparseDelta(indices=idx, values=jcodec.quantize_int8(vec[idx], 128), n=n)
    bf = tcodec.BF16Bits.from_f32(vec)
    for s, e in slice_boundaries(n, 3) + [(5, 5), (2047, 2049)]:
        for t, j in ((tq, jq), (tsd, jsd), (tsq, jsq)):
            ts, js = tcodec.slice_delta(t, s, e), jcodec.slice_delta(j, s, e)
            # through the wire and back, then decoded
            ts = tcodec.loads(tcodec.dumps({"d": ts}))["d"]
            assert tcodec.delta_to_f32(ts).tobytes() == jcodec.delta_to_f32(js).tobytes()
        assert tcodec.slice_delta(bf, s, e).bits.tobytes() == bf.bits[s:e].tobytes()
        assert tcodec.slice_delta(vec, s, e).tobytes() == vec[s:e].tobytes()
    # the slice of an int8 delta keeps the offset of its first element
    assert tcodec.slice_delta(tq, 3000, 5000).offset == 3000


# -- the servicer ----------------------------------------------------------------------


def _answer(resp):
    """A shard's answer in plain terms: versions and flags, each slice as
    its bytes (f32, or bf16 bits)."""
    if not isinstance(resp, dict):  # the reference's prepacked pull frame
        resp = jmessages.unpack(jmessages.pack(resp))
    out = {}
    for k, v in resp.items():
        out[k] = None if v is None else _bits(v) if k == "vec" else v
    return out


SCRIPT = [
    ("PSInit", {"vec": np.linspace(-1, 1, 37, dtype=np.float32), "version": 3}),
    ("PSInit", {"vec": np.zeros(37, np.float32), "version": 9}),  # SETNX: no-op
    ("PSPull", {"only_if_newer": True, "version": 3}),
    ("PSPull", {"only_if_newer": True, "version": 2, "model_dtype": "bfloat16"}),
    ("PSPushGrad", {"grad": "g0", "version": 3, "report_key": "a", "return_model": True}),
    ("PSPushGrad", {"grad": "g1", "version": 3, "report_key": "b", "return_model": True}),
    ("PSPushGrad", {"grad": "g1", "version": 3, "report_key": "b", "return_model": True}),
    ("PSPushGrad", {"grad": "g2", "version": 0, "report_key": "c"}),  # beyond the window
    ("PSPushGrad", {"grad": "g3", "version": 4, "report_key": "d", "return_model": True,
                    "model_dtype": "bfloat16"}),
    ("PSPushDelta", {"delta": "d0", "steps": 2, "base_version": 5, "report_key": "w0"}),
    ("PSPushDelta", {"delta": "d1", "steps": 3, "base_version": 5, "report_key": "w1"}),
    ("PSPushDelta", {"delta": "d1", "steps": 3, "base_version": 5, "report_key": "w1"}),
    ("PSPushDelta", {"delta": "d2", "steps": 1, "base_version": 0, "report_key": "w2",
                     "model_dtype": "bfloat16"}),
    ("PSPushDelta", {"delta": "d3", "steps": 1, "base_version": 11, "want_model": True}),
    ("PSPull", {}),
    ("PSOptState", {}),
]


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_scripted_shard_sequence_is_the_references(mode):
    """PSInit (SETNX), PSPull (only_if_newer, bf16), PSPushGrad (windowed
    sync with grads_to_wait 2 and staleness window 2, or async with
    1/staleness modulation), PSPushDelta (merged slices back when the base
    fell behind, the window's down-weight, want_model) and re-sent report
    keys, through the port's servicer and the reference's: the same
    answers bit for bit (plain SGD: no optimizer on either side), a
    re-sent key applied once, the same counts."""
    rng = np.random.default_rng(1)
    arrays = {k: rng.standard_normal(37).astype(np.float32) * 0.1 for k in
              ("g0", "g1", "g2", "g3", "d0", "d1", "d2", "d3")}
    kw = (dict(grads_to_wait=2, staleness_window=2) if mode == "sync"
          else dict(use_async=True, lr_staleness_modulation=True, staleness_window=2))
    port = PSShardServicer(1, 3, **kw)
    ref = jps_shard.PSShardServicer(1, 3, fanin_combine=False, **kw)
    th, jh = port.handlers(), ref.handlers()
    for method, req in SCRIPT:
        treq = {k: arrays[v] if isinstance(v, str) and v in arrays else v
                for k, v in req.items()}
        tresp = th[method](tcodec.loads(tcodec.dumps(treq)))
        jresp = jh[method](dict(treq))
        if method == "PSOptState":
            assert tresp == jresp == {"leaves": None}
            continue
        assert _answer(tresp) == _answer(jresp), (method, req)
    tstats, jstats = port.stats(), ref.stats()
    for k in ("applied_pushes", "duplicate_pushes", "version"):
        assert tstats[k] == jstats[k], k
    assert tstats["duplicate_pushes"] == 2


def test_slice_clip_quirk_matches_the_references_two_shards():
    """The transformer zoo's clip 1.0 + Adam on 2 shards clips each slice
    by its own norm, as the reference's 2 shards do (within 1e-6), and
    so differs from the single PS, which clips by the global norm."""
    rng = np.random.default_rng(2)
    n = 1000
    vec = rng.standard_normal(n).astype(np.float32)
    bounds = slice_boundaries(n, 2)
    tshards = [PSShardServicer(i, 2, optimizer=PSOptimizer(tzoo.optimizer()), use_async=True)
               for i in range(2)]
    jshards = [jps_shard.PSShardServicer(i, 2, optimizer=JPSOptimizer(jzoo.optimizer()),
                                         use_async=True, fanin_combine=False)
               for i in range(2)]
    single = PSOptimizer(tzoo.optimizer())
    whole = vec
    for (s, e), t, j in zip(bounds, tshards, jshards):
        t.init_slice({"vec": vec[s:e]})
        j.init_slice({"vec": vec[s:e]})
    # one slice's gradient far above the clip, the other below it
    for step in range(3):
        g = rng.standard_normal(n).astype(np.float32) * np.where(np.arange(n) < n // 2, 1.0, 1e-3)
        g = g.astype(np.float32)
        for (s, e), t, j in zip(bounds, tshards, jshards):
            t.push_grad({"grad": g[s:e], "version": step})
            j.push_grad({"grad": g[s:e], "version": step})
        whole = single.step(whole, g)
    tvec = np.concatenate([t.pull({})["vec"] for t in tshards])
    jvec = np.concatenate([_pulled(j) for j in jshards])
    np.testing.assert_allclose(tvec, jvec, **OPT)
    assert [t.version for t in tshards] == [3, 3]
    # the small slice was never clipped on its shard, where the single
    # PS scaled it down with the other slice's norm: the two differ by
    # far more than the packages do
    assert np.abs(tvec - whole).max() > 10 * OPT["atol"]


def _pulled(shard):
    """A reference shard's slice."""
    return np.asarray(jmessages.unpack(jmessages.pack(shard.pull({})))["vec"])


def test_concurrent_push_and_pull_never_tear_a_slice():
    """Pushes add a constant delta in place while pulls snapshot the
    slice: every pulled slice is uniform and equals its version's value
    (a pull that read the slice while an add ran would hold two)."""
    n = 1 << 20
    shard = PSShardServicer(0, 1)
    shard.init_slice({"vec": np.zeros(n, np.float32)})
    stop = threading.Event()
    torn = []

    def pull():
        while not stop.is_set():
            r = shard.pull({})
            v = r["vec"]
            if v.min() != v.max() or v[0] != r["version"]:
                torn.append((r["version"], v.min(), v.max()))

    pullers = [threading.Thread(target=pull) for _ in range(2)]
    for t in pullers:
        t.start()
    delta = np.ones(n, np.float32)
    for k in range(60):
        shard.push_delta({"delta": delta, "steps": 1, "base_version": k, "report_key": f"k{k}"})
    stop.set()
    for t in pullers:
        t.join()
    assert not torn and shard.version == 60
    assert shard.stats()["pulls"] > 0


# -- jobs --------------------------------------------------------------------------------


@pytest.fixture
def records(tmp_path):
    path = str(tmp_path / "tokens.rio")
    write_learnable_token_records(path, 128, SEQ, VOCAB, seed=2)
    return path


def _init():
    return jtlm.init_params(np.random.default_rng(11), jzoo.custom_model(vocab=VOCAB).cfg)


def _ref_job(path, num_ps, init, task_records=64, use_async=False, **worker_kw):
    """The reference's job over `num_ps` inproc shards: (flat model,
    shard versions, master version, worker)."""
    group = JPSShardGroup(num_ps, mode="inproc", optimizer_factory=jzoo.optimizer,
                          use_async=use_async, fanin_combine=False)
    group.start()
    try:
        dispatcher = JDispatcher({path: 128}, {}, {}, task_records, 1, shuffle_seed=3)
        jspec = jspec_from_module(jzoo, model=jzoo.custom_model(vocab=VOCAB))
        servicer = JServicer(1, JPSOptimizer(jzoo.optimizer()), task_dispatcher=dispatcher,
                             init_params=init, use_async=use_async, ps_group=group)
        group.ensure_init(jcodec.ravel_np(init), 0)
        worker = JWorker(0, JInProcessMaster(servicer), jspec, minibatch_size=BATCH,
                         ps_endpoints=group.endpoints, **worker_kw)
        assert worker.run()
        worker.close()
        assert dispatcher.finished()
        versions, vec = group.assemble()
        return vec, versions, servicer.version, worker
    finally:
        group.stop()


def _port_job(path, num_ps, init, task_records=64, use_async=False, **worker_kw):
    group = PSShardGroup(num_ps, mode="inproc", optimizer_factory=tzoo.optimizer,
                         use_async=use_async)
    group.start()
    try:
        dispatcher = TaskDispatcher({path: 128}, {}, {}, task_records, 1, shuffle_seed=3)
        spec = spec_from_module(tzoo, model=tzoo.custom_model(vocab=VOCAB))
        servicer, _eval, _ckpt = build_job(spec, dispatcher, grads_to_wait=1, init_params=init,
                                           use_async=use_async, ps_group=group)
        master = InProcessMaster(servicer)
        worker = Worker(0, master, spec, minibatch_size=BATCH, device="cpu",
                        ps_endpoints=group.endpoints, **worker_kw)
        assert worker.run()
        worker.close()
        assert dispatcher.finished()
        versions, vec = group.assemble()
        stats = group.stats()
        return vec, versions, servicer, worker, master, stats
    finally:
        group.stop()


def test_window_job_on_3_shards_matches_the_references(records):
    """One worker, W = 4, float32 sync, 2 tasks of 4 minibatches, over 3
    inproc shards in both packages from the same init and task order:
    shard versions and the master's mirror 8, params within 1e-4; the
    master served no ReportLocalUpdate, every window went to the
    shards, and nothing merged back (one worker)."""
    init = _init()
    jvec, jversions, jversion, _jw = _ref_job(records, 3, init, local_updates=4,
                                              sync_dtype="float32")
    vec, versions, servicer, worker, master, stats = _port_job(
        records, 3, init, local_updates=4, sync_dtype="float32")
    assert versions == jversions == [8, 8, 8] and jversion == 8
    assert servicer.exactness() == {"version": 8, "init_version": 0, "applied_update_steps": 8}
    assert master.calls.get("ReportLocalUpdate", 0) == 0
    assert master.calls["ReportWindowMeta"] == 2
    assert [s["applied_pushes"] for s in stats] == [2, 2, 2]
    assert worker.merged_back == 0 and worker.shard_versions == [8, 8, 8]
    np.testing.assert_allclose(vec, jvec, **JOB_TOL)


def test_async_per_step_job_on_2_shards_matches_the_references(records):
    """One worker, async per-step, 8 minibatches, over 2 inproc shards
    running the zoo's clip + Adam on their slices, in both packages:
    shard versions 8, params within 1e-4, task losses within 1e-5."""
    init = _init()
    jvec, jversions, _jv, jworker = _ref_job(records, 2, init, use_async=True)
    vec, versions, servicer, worker, master, _stats = _port_job(records, 2, init,
                                                                use_async=True)
    assert versions == jversions == [8, 8]
    assert servicer.exactness()["version"] == 8
    assert master.calls.get("ReportGradient", 0) == 0 and master.calls["ReportWindowMeta"] == 8
    np.testing.assert_allclose(vec, jvec, **JOB_TOL)
    np.testing.assert_allclose(worker.task_losses, jworker.task_losses, atol=1e-5)


def test_two_workers_over_sharded_window_mode_end_exact(records):
    """Two workers in threads, W = 2, bf16 EF deltas and a bf16 model
    back, over 2 inproc shards, 2 epochs: the job completes, and at
    quiescence every shard's version, the master's mirror and init +
    applied steps agree on the 16 steps; merged slices were absorbed."""
    group = PSShardGroup(2, mode="inproc", optimizer_factory=tzoo.optimizer, num_workers=2)
    group.start()
    try:
        dispatcher = TaskDispatcher({records: 128}, {}, {}, 32, 2, shuffle_seed=3)
        spec0 = spec_from_module(tzoo, model=tzoo.custom_model(vocab=VOCAB))
        servicer, _eval, _ckpt = build_job(spec0, dispatcher, grads_to_wait=1, ps_group=group)
        master = InProcessMaster(servicer)
        workers = [
            Worker(i, master, spec_from_module(tzoo, model=tzoo.custom_model(vocab=VOCAB)),
                   minibatch_size=BATCH, device="cpu", local_updates=2, sync_dtype="bf16",
                   ps_endpoints=group.endpoints)
            for i in range(2)
        ]
        results = []
        threads = [threading.Thread(target=lambda w=w: results.append(w.run())) for w in workers]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for w in workers:
            w.close()
        assert results == [True, True] and dispatcher.finished()
        total = 2 * 128 // BATCH
        stats = group.stats()
        versions = [s["version"] for s in stats]
        ex = servicer.exactness()
        assert min(versions) == max(versions) == ex["version"] == total
        assert ex == {"version": total, "init_version": 0, "applied_update_steps": total}
        assert sum(w.steps_accepted for w in workers) == total
        assert sum(w.steps_computed for w in workers) == total
        # one ReportVariable seeded the shards (first writer wins)
        assert master.calls["ReportVariable"] >= 1
        assert master.calls["ReportWindowMeta"] == sum(len(w.window_log) for w in workers)
        assert all(s["applied_pushes"] == master.calls["ReportWindowMeta"] for s in stats)
        assert sum(w.merged_back for w in workers) > 0
        _params, _aux, version = servicer.get_params_copy()
        assert version == total
    finally:
        group.stop()


def test_checkpoint_cadence_through_window_meta(records, tmp_path):
    """Window mode over 2 shards with a checkpoint every 4 versions: the
    cadence runs on ReportWindowMeta's mirror, and each file holds the
    model assembled from the shards at its version and each shard's
    optimizer state (None here: in window mode the worker's optimizer
    moves the params and the shards only add)."""
    group = PSShardGroup(2, mode="inproc", optimizer_factory=tzoo.optimizer)
    group.start()
    try:
        dispatcher = TaskDispatcher({records: 128}, {}, {}, 64, 1, shuffle_seed=3)
        spec = spec_from_module(tzoo, model=tzoo.custom_model(vocab=VOCAB))
        ckpt_dir = str(tmp_path / "ckpt")
        servicer, _eval, ckpt = build_job(spec, dispatcher, grads_to_wait=1, init_params=_init(),
                                          checkpoint_dir=ckpt_dir, checkpoint_steps=4,
                                          ps_group=group)
        worker = Worker(0, InProcessMaster(servicer), spec, minibatch_size=BATCH, device="cpu",
                        local_updates=4, sync_dtype="float32", overlap_sync="off",
                        ps_endpoints=group.endpoints)
        assert worker.run()
        worker.close()
        ckpt.flush()
        assert sorted(os.listdir(ckpt_dir)) == ["model_v4.ckpt", "model_v8.ckpt"]
        m8 = load_model_file(os.path.join(ckpt_dir, "model_v8.ckpt"))
        _versions, vec = group.assemble()
        assert m8.version == 8
        assert tcodec.ravel_np(m8.params).tobytes() == vec.tobytes()
        assert m8.opt_state == {"kind": "sharded", "shards": [None, None]}
    finally:
        group.stop()


def _async_run(path, epochs, num_ps=2, ckpt_init="", save=""):
    """Async per-step over `num_ps` inproc shards, one task an epoch:
    (flat model, version)."""
    group = PSShardGroup(num_ps, mode="inproc", optimizer_factory=tzoo.optimizer,
                         use_async=True)
    group.start()
    try:
        dispatcher = TaskDispatcher({path: 128}, {}, {}, 128, epochs, shuffle_seed=3)
        spec = spec_from_module(tzoo, model=tzoo.custom_model(vocab=VOCAB))
        servicer, _eval, _ckpt = build_job(
            spec, dispatcher, grads_to_wait=1, use_async=True, ps_group=group,
            init_params=None if ckpt_init else _init(),
            checkpoint_filename_for_init=ckpt_init)
        worker = Worker(0, InProcessMaster(servicer), spec, minibatch_size=BATCH, device="cpu",
                        ps_endpoints=group.endpoints)
        assert worker.run()
        worker.close()
        if save:
            servicer.save_latest_checkpoint(save)
        _params, _aux, version = servicer.get_params_copy()
        return group.assemble()[1], version
    finally:
        group.stop()


def test_sharded_checkpoint_resumes_exactly_and_needs_the_same_shard_count(records, tmp_path):
    """Async per-step over 2 shards: 1 epoch, a checkpoint with both
    shards' Adam state, a resumed epoch from it equals 2 epochs run
    straight, bit for bit. The shards' state refuses another shard
    count; the file loads in the reference, and the reference's sharded
    file in the port."""
    full_vec, full_v = _async_run(records, 2)
    ckpt = str(tmp_path / "mid.ckpt")
    _vec, v1 = _async_run(records, 1, save=ckpt)
    model = load_model_file(ckpt)
    assert v1 == model.version == 8
    assert model.opt_state["kind"] == "sharded" and len(model.opt_state["shards"]) == 2
    assert [int(s[0]) for s in model.opt_state["shards"]] == [8, 8]  # Adam's count
    resumed_vec, resumed_v = _async_run(records, 1, ckpt_init=ckpt)
    assert resumed_v == full_v == 16
    np.testing.assert_array_equal(resumed_vec, full_vec)

    group = PSShardGroup(3, mode="inproc", optimizer_factory=tzoo.optimizer)
    group.start()
    try:
        group.ensure_init(tcodec.ravel_np(model.params), model.version)
        with pytest.raises(ValueError, match="same --num_ps"):
            group.restore_opt(model.opt_state["shards"])
    finally:
        group.stop()

    jmodel = jload_model_file(ckpt)
    assert jmodel.version == 8 and jmodel.opt_state["kind"] == "sharded"
    assert jcodec.ravel_np(jmodel.params).tobytes() == tcodec.ravel_np(model.params).tobytes()
    for js, ts in zip(jmodel.opt_state["shards"], model.opt_state["shards"]):
        assert all(np.asarray(a).tobytes() == np.asarray(b).tobytes() for a, b in zip(js, ts))
    jpath = str(tmp_path / "ref.ckpt")
    jsave_model_file(jpath, jmodel.params, 8, opt_state=jmodel.opt_state)
    back = load_model_file(jpath)
    assert back.opt_state["kind"] == "sharded"
    assert tcodec.ravel_np(back.params).tobytes() == tcodec.ravel_np(model.params).tobytes()


EVAL_EPOCH, EVAL_TASK, EVAL_BATCH = 16, 8, 4


def _eval_job(tmp_path, name, with_eval):
    train, evals = str(tmp_path / "train.rio"), str(tmp_path / "eval.rio")
    if not os.path.exists(train):
        write_learnable_token_records(train, EVAL_EPOCH, 16, VOCAB, seed=0)
        write_learnable_token_records(evals, 12, 16, VOCAB, seed=9)
    group = PSShardGroup(2, mode="inproc", optimizer_factory=tzoo.optimizer)
    group.start()
    try:
        d = TaskDispatcher({train: EVAL_EPOCH}, {evals: 12} if with_eval else {}, {}, EVAL_TASK,
                           2, shuffle_seed=1)
        spec = spec_from_module(tzoo, model=tzoo.custom_model(vocab=VOCAB))
        servicer, evs, _ckpt = build_job(spec, d, eval_steps=4 if with_eval else 0,
                                         checkpoint_dir=str(tmp_path / name), ps_group=group)
        worker = Worker(0, InProcessMaster(servicer), spec, minibatch_size=EVAL_BATCH,
                        device="cpu", local_updates=2, sync_dtype="bfloat16",
                        overlap_sync="off", ps_endpoints=group.endpoints)
        assert worker.run()
        worker.close()
        return group.assemble()[1], servicer.version, worker, evs
    finally:
        group.stop()


def test_evaluation_job_pins_its_version_over_shards(tmp_path):
    """Window mode over 2 shards with evaluation every 4 versions: each
    job is pinned at its version (served from the snapshot, never the
    shards' moving model), and the trained model is bit-equal to the
    same job's without evaluation."""
    plain, v0, _w, _ = _eval_job(tmp_path, "plain", False)
    got, v1, worker, evs = _eval_job(tmp_path, "eval", True)
    assert v0 == v1 == 2 * EVAL_EPOCH // EVAL_BATCH == 8
    assert [v for v, _m in evs.completed_metrics] == [4, 8]
    assert worker.eval_tasks == 2 * 2
    np.testing.assert_array_equal(got, plain)
    assert all(np.isfinite(m["cross_entropy"]) for _v, m in evs.completed_metrics)


# -- refusals ------------------------------------------------------------------------


def test_strict_sync_and_master_pushes_are_refused_with_shards():
    """`validate_ps_args` refuses --num_ps with strict per-step sync and
    takes window mode, async or a staleness window; with shards the
    master refuses ReportGradient and ReportLocalUpdate (pushes go to
    the shards) and master.main exits 1 on the strict combination."""
    base = ["--model_def", "transformer_lm_zoo.custom_model", "--minibatch_size", "4",
            "--training_data_dir", "/nonexistent", "--num_ps", "2"]
    with pytest.raises(ValueError, match="strict per-step sync"):
        validate_ps_args(master_parser().parse_args(base))
    for extra in (["--local_updates", "2"], ["--use_async"], ["--staleness_window", "1"]):
        validate_ps_args(master_parser().parse_args(base + extra))
    validate_ps_args(master_parser().parse_args(base[:-2]))  # no shards: no check
    assert master_main.run(base + ["--device", "cpu"])[0] == 1

    group = PSShardGroup(2, mode="inproc")
    group.start()
    try:
        dispatcher = TaskDispatcher({"/d/t": 4}, {}, {}, 4, 1)
        spec = spec_from_module(tzoo, model=tzoo.custom_model(vocab=VOCAB))
        servicer, _e, _c = build_job(spec, dispatcher, use_async=True, init_params=_init(),
                                     ps_group=group)
        n = sum(int(np.asarray(p).size) for p in tcodec.tree_leaves(_init()))
        with pytest.raises(ValueError, match="PSPushGrad"):
            servicer.report_gradient({"version": 0, "gradient_flat": np.zeros(n, np.float32)})
        with pytest.raises(ValueError, match="PSPushDelta"):
            servicer.report_local_update({"delta_flat": np.zeros(n, np.float32), "steps": 1,
                                          "base_version": 0})
        cfg = servicer.get_ps_config({})
        assert cfg["endpoints"] == group.endpoints and cfg["n_params"] == n
    finally:
        group.stop()
    assert {"PSPushGrad", "PSPushDelta"} <= policy.DEDUP_KEYED_METHODS <= policy.IDEMPOTENT_METHODS
    assert "ReportWindowMeta" not in policy.IDEMPOTENT_METHODS


# -- the worker's reads of the sync threads' state -------------------------------------


class _OwnedLock:
    """A lock that knows which thread holds it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._owner = None

    def __enter__(self):
        self._lock.acquire()
        self._owner = threading.get_ident()
        return self

    def __exit__(self, *exc):
        self._owner = None
        self._lock.release()

    def held(self) -> bool:
        return self._owner == threading.get_ident()


SHARED = ("_fresh", "_version", "_shard_versions")


class _AuditedWorker(Worker):
    """Records every read of the sync threads' state made without
    `_report_lock`, by the reading function's name."""

    def __getattribute__(self, name):
        if name in SHARED:
            lock = object.__getattribute__(self, "__dict__").get("_report_lock")
            if isinstance(lock, _OwnedLock) and not lock.held():
                object.__getattribute__(self, "unlocked").add(
                    (name, __import__("sys")._getframe(1).f_code.co_name))
        return object.__getattribute__(self, name)


@pytest.mark.parametrize("mode", ["per-step", "window", "sharded-async", "sharded-window"])
def test_worker_reads_the_sync_state_under_its_lock(records, mode):
    """`_fresh`, `_version` and `_shard_versions` are written by window
    mode's sync threads under `_report_lock`; every read of them (the
    freshness check before a step, the absorb of a report's response,
    the final loss log, a report's version) holds that lock too, so a
    sync landing between two reads cannot pair a fresh flag with another
    sync's version. The audit fails on any unlocked read."""
    sharded = mode.startswith("sharded")
    use_async = mode == "sharded-async"
    kw = dict(local_updates=2, sync_dtype="float32") if mode.endswith("window") else {}
    group = None
    if sharded:
        group = PSShardGroup(2, mode="inproc", optimizer_factory=tzoo.optimizer,
                             use_async=use_async)
        group.start()
    try:
        dispatcher = TaskDispatcher({records: 128}, {}, {}, 32, 1, shuffle_seed=3)
        spec = spec_from_module(tzoo, model=tzoo.custom_model(vocab=VOCAB))
        servicer, _e, _c = build_job(spec, dispatcher, use_async=use_async,
                                     init_params=_init(), ps_group=group)
        worker = _AuditedWorker(0, InProcessMaster(servicer), spec, minibatch_size=BATCH,
                                device="cpu", ps_endpoints=group.endpoints if group else None,
                                **kw)
        worker.unlocked = set()
        worker._report_lock = _OwnedLock()
        assert worker.run()
        worker.close()
        assert dispatcher.finished() and servicer.version == 8
        assert worker.unlocked == set()
    finally:
        if group is not None:
            group.stop()


# -- process mode ----------------------------------------------------------------------


def _live_pids(pids) -> list:
    return [p for p in pids if os.path.exists(f"/proc/{p}")]


def test_process_mode_job_over_2_shard_processes(records, tmp_path, monkeypatch):
    """master.main with `--num_ps 2 --ps_mode process`, one worker
    process on the CPU, window mode, over the shm tier: rc 0, both
    shards at the job's 8 steps and the master's version with them, the
    links on shm, and after the job no shard process, port file or shm
    segment of theirs left. The KV shard groups run on the same
    `shard_host` (tests/test_torch_kv_shards.py)."""
    import tempfile

    from elasticdl_tpu_torch.rpc import transport

    uds = tempfile.mkdtemp(prefix="edlt")
    ports = tmp_path / "ports"
    ports.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(ports))
    monkeypatch.setenv("EDL_UDS_DIR", uds)
    monkeypatch.setenv("EDL_TRANSPORT", "shm")
    monkeypatch.setenv(ENV_WORKER_LOG_DIR, str(tmp_path / "logs"))
    data = tmp_path / "data"
    data.mkdir()
    os.rename(records, data / "tokens.rio")
    argv = ["--model_zoo", ZOO, "--model_def", "transformer_lm_zoo.custom_model",
            "--model_params", f"vocab={VOCAB}", "--minibatch_size", str(BATCH),
            "--training_data_dir", str(data), "--records_per_task", "64",
            "--num_workers", "1", "--device", "cpu", "--local_updates", "4",
            "--num_ps", "2", "--ps_mode", "process", "--envs", "OMP_NUM_THREADS=2",
            "--output", str(tmp_path / "m.ckpt")]
    try:
        rc, summary = master_main.run(argv)
        assert rc == 0
        shards = summary["ps_shards"]
        assert [s["version"] for s in shards] == [8, 8] and summary["version"] == 8
        assert summary["applied_update_steps"] == 8
        assert all(s["applied_pushes"] == 2 for s in shards)
        assert "ReportWindowMeta" in summary["server"]["calls"]
        assert "ReportLocalUpdate" not in summary["server"]["calls"]
        workers = worker_main.read_summaries(str(tmp_path / "logs"))
        assert workers[0]["ps_tiers"] == ["shm", "shm"] and workers[0]["tier"] == "shm"
        assert workers[0]["shard_versions"] == [8, 8] and workers[0]["steps_accepted"] == 8
        assert load_model_file(str(tmp_path / "m.ckpt")).version == 8
        pids = [s["pid"] for s in shards]
        assert pids and os.getpid() not in pids
        deadline = time.monotonic() + 5
        while _live_pids(pids) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not _live_pids(pids)
        assert os.listdir(ports) == []
        left = [n for n in os.listdir("/dev/shm") if n.startswith(transport.SHM_SEGMENT_PREFIX)
                and any(f".{p}." in n for p in pids)]
        assert left == []
    finally:
        import shutil

        shutil.rmtree(uds, ignore_errors=True)


class _DeafListener:
    """A listening socket whose shutdown() does not wake accept(), as on
    the card machine's kernel for AF_UNIX listeners."""

    def __init__(self, sock):
        self._real = sock

    def shutdown(self, how):
        pass

    def __getattr__(self, name):
        return getattr(self._real, name)


def test_servers_close_promptly_when_shutdown_does_not_wake_accept(monkeypatch, tmp_path):
    """On the card machine, shutdown() of a listening AF_UNIX socket left
    the shm listener's accept thread blocked, so every shm server's stop
    waited out its 5 s join, and a PS shard process overran its group's
    grace period, was killed, and left its rendezvous files. close() now
    connects to its own listener once to wake accept(): with shutdown()
    made deaf on every listener, the tcp, uds and shm listeners of one
    server stop within 2 s and leave no file."""
    import tempfile

    uds = tempfile.mkdtemp(prefix="edlt")
    monkeypatch.setenv("EDL_UDS_DIR", uds)
    monkeypatch.setenv("EDL_TRANSPORT", "auto")
    from elasticdl_tpu_torch.rpc.server import RpcServer

    try:
        srv = RpcServer({"Echo": lambda req: req}, port=0)
        srv.start()
        listeners = [srv._tcp, srv._uds, srv._shm]
        assert all(x is not None for x in listeners)
        for x in listeners:
            x._sock = _DeafListener(x._sock)
        t0 = time.monotonic()
        srv.stop()
        assert time.monotonic() - t0 < 2.0
        assert not any(x._thread.is_alive() for x in listeners)
        assert os.listdir(uds) == []
    finally:
        import shutil

        shutil.rmtree(uds, ignore_errors=True)


def test_reset_clears_the_shard_versions_as_the_references_does():
    """After a failed sync the sharded pull must fetch every slice: a
    surviving version vector would make only_if_newer send nothing back
    and the diverged local params outlive the reset. The port's reset
    leaves the same state as the reference's (tests/test_ps_shards.py's
    reset test, on both workers)."""
    workers = [Worker.__new__(Worker), JWorker.__new__(JWorker)]
    for w in workers:
        w._report_lock = threading.Lock()
        w._ef_lock = threading.Lock()
        w._sync_epoch, w._fresh, w._version = 0, True, 7
        w._shard_versions, w._shard_lineage = [7, 7, 7], [7, 7, 7]
        w._sync_result = (1, None, None, 9, None)
        w._base_snapshots, w._spawn_abs = {1: None}, {1: 4}
        w._lineage_version, w._own_steps_abs, w._lineage_anchor_abs = 7, 4, 2
        w._opt_state, w._pending_steps, w._pending_losses = object(), 3, [0.1]
        w._pending_edl = []
        w._ef_residual = w._ef_grad_residual = object()
        w._reset_local_state()
    fields = ("_shard_versions", "_shard_lineage", "_version", "_fresh", "_sync_result",
              "_base_snapshots", "_lineage_version", "_spawn_abs", "_ef_residual",
              "_ef_grad_residual", "_pending_steps")
    port, ref = workers
    assert {f: getattr(port, f) for f in fields} == {f: getattr(ref, f) for f in fields}
    assert port._shard_versions is None and port._shard_lineage is None

"""Window mode of the port (`--local_updates W`) against the reference,
on the CPU: the compressed wire deltas and their frames, the worker's
error-feedback compression, the servicer's `report_local_update`, the
in-place `ClipAdam`, the attention dispatcher's shape predicate, and the
slice as a whole (in-process jobs against the reference's and against
the port's per-step job; window report keys and their dedup on replay;
process-mode jobs with a SIGTERM drain and a SIGKILL).

Tolerances: the codec, the EF compression and the servicer are held bit
for bit (the same float32 numpy or elementwise math on both sides).
`ClipAdam` against optax: 1e-6 absolute and relative (other reduction
order for the clip norm). Jobs: see each test.
"""

import os
import signal
import threading
import time
import types
from collections import Counter

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.api.model_spec_helpers import spec_from_module as jspec_from_module
from elasticdl_tpu.common import codec as jcodec
from elasticdl_tpu.master.ps_optimizer import PSOptimizer as JPSOptimizer
from elasticdl_tpu.master.servicer import MasterServicer as JServicer
from elasticdl_tpu.master.task_dispatcher import TaskDispatcher as JDispatcher
from elasticdl_tpu.models import transformer_lm as jtlm
from elasticdl_tpu.models import transformer_lm_zoo as jzoo
from elasticdl_tpu.testing import InProcessMaster as JInProcessMaster
from elasticdl_tpu.worker.worker import Worker as JWorker
from elasticdl_tpu_torch.api.model_spec_helpers import spec_from_module
from elasticdl_tpu_torch.cluster import pod_backend as tpod
from elasticdl_tpu_torch.common import codec as tcodec
from elasticdl_tpu_torch.common import messages
from elasticdl_tpu_torch.common.args import master_parser, worker_forward_args
from elasticdl_tpu_torch.common.constants import ENV_WORKER_LOG_DIR
from elasticdl_tpu_torch.master import main as master_main
from elasticdl_tpu_torch.master.checkpoint import load_model_file
from elasticdl_tpu_torch.master.ps_optimizer import ClipAdam, PSOptimizer
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.master.worker_manager import WorkerManager
from elasticdl_tpu_torch.models import transformer_lm_zoo as tzoo
from elasticdl_tpu_torch.models.record_codec import write_learnable_token_records
from elasticdl_tpu_torch.ops import flash_attention as fa
from elasticdl_tpu_torch.rpc.server import RpcServer
from elasticdl_tpu_torch.testing import InProcessMaster, build_job
from elasticdl_tpu_torch.worker import main as worker_main
from elasticdl_tpu_torch.worker.worker import Worker
from _torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = os.path.join(REPO, "elasticdl_tpu_torch", "models")
VOCAB, SEQ, BATCH = 64, 128, 16
CHUNK = tcodec.DEFAULT_INT8_CHUNK


def _delta(n, seed, zero_chunk=True):
    """Continuous random data (no top-k ties), one all-zero int8 chunk
    and a ragged last chunk (n % CHUNK != 0)."""
    v = (np.random.default_rng(seed).standard_normal(n) * 1e-3).astype(np.float32)
    if zero_chunk:
        v[CHUNK : 2 * CHUNK] = 0.0
    return v


def _bits(a):
    """Bytes of an array, bf16 (either package's form) as uint16 bits."""
    if isinstance(a, tcodec.BF16Bits):
        return a.bits.tobytes()
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return a.view(np.uint16).tobytes()
    return a.tobytes()


# -- the codec's delta forms -----------------------------------------------


def test_int8_quantization_and_delta_forms_bit_for_bit():
    vec = _delta(3 * CHUNK + 77, seed=1)
    t, j = tcodec.quantize_int8(vec), jcodec.quantize_int8(vec)
    assert t.q.dtype == np.int8 and t.q.tobytes() == j.q.tobytes()
    assert t.scale.tobytes() == j.scale.tobytes() and t.chunk == j.chunk
    assert t.scale[1] == 1.0  # the all-zero chunk
    assert t.dequantize().tobytes() == j.dequantize().tobytes()
    assert tcodec.delta_to_f32(t).tobytes() == jcodec.delta_to_f32(j).tobytes()
    # top-k over int8 and over bf16, and a dense bf16 vector
    idx = np.sort(np.random.default_rng(2).choice(vec.size, 300, replace=False)).astype(np.int32)
    vals = vec[idx]
    forms = [
        (tcodec.SparseDelta(idx, tcodec.quantize_int8(vals), vec.size),
         jcodec.SparseDelta(idx, jcodec.quantize_int8(vals), vec.size)),
        (tcodec.SparseDelta(idx, tcodec.BF16Bits.from_f32(vals), vec.size),
         jcodec.SparseDelta(idx, vals.astype(ml_dtypes.bfloat16), vec.size)),
        (tcodec.SparseDelta(idx, vals, vec.size), jcodec.SparseDelta(idx, vals, vec.size)),
        (tcodec.BF16Bits.from_f32(vec), vec.astype(ml_dtypes.bfloat16)),
        (vec, vec),
    ]
    for tf, jf in forms:
        assert tcodec.delta_to_f32(tf, vec.size).tobytes() == jcodec.delta_to_f32(jf).tobytes()
        assert tcodec.delta_length(tf) == jcodec.delta_length(jf) == vec.size
        assert tcodec.delta_nbytes(tf) == jcodec.delta_nbytes(jf)
    with pytest.raises(ValueError):
        tcodec.delta_to_f32(forms[0][0], vec.size + 1)


def test_delta_forms_round_trip_through_frames():
    vec = _delta(2 * CHUNK + 5, seed=3)
    idx = np.arange(0, vec.size, 7, dtype=np.int32)
    msg = {
        "int8": tcodec.quantize_int8(vec),
        "topk_int8": tcodec.SparseDelta(idx, tcodec.quantize_int8(vec[idx]), vec.size),
        "topk_bf16": tcodec.SparseDelta(idx, tcodec.BF16Bits.from_f32(vec[idx]), vec.size),
        "topk": tcodec.SparseDelta(idx, vec[idx], vec.size),
        "nested": [(tcodec.quantize_int8(vec[:9]), 1)],
    }
    back = messages.unpack(messages.pack(msg))
    for key in ("int8", "topk_int8", "topk_bf16", "topk"):
        assert type(back[key]) is type(msg[key])
        assert tcodec.delta_to_f32(back[key]).tobytes() == tcodec.delta_to_f32(msg[key]).tobytes()
    assert isinstance(back["topk_int8"].values, tcodec.QuantizedDelta)
    assert back["topk_int8"].values.chunk == CHUNK and back["topk_int8"].n == vec.size
    assert back["topk_int8"].indices.dtype == np.int32
    assert isinstance(back["topk_bf16"].values, tcodec.BF16Bits)
    assert back["nested"][0][0].q.tobytes() == msg["nested"][0][0].q.tobytes()


# -- the worker's error-feedback compression --------------------------------


def _jax_ef(comp, topk, dtype, ratio):
    """The reference worker's _ef_compress on CPU jax, on a stand-in
    for its `self` (the method reads these attributes only)."""
    fake = types.SimpleNamespace(
        _sync_dtype=dtype,
        _topk_ratio=ratio,
        _int8_quantize_dev=lambda c: JWorker._int8_quantize_dev(None, c),
    )
    meta, arrays, residual = JWorker._ef_compress(fake, jnp.asarray(comp), topk=topk)
    arrays_h, residual_h = jax.device_get((arrays, residual))
    return meta, JWorker._materialize_wire_delta(meta, arrays_h), residual_h


def _port_ef(comp, topk, dtype, ratio):
    fake = types.SimpleNamespace(
        _sync_dtype=dtype, _topk_ratio=ratio, _int8_quantize_dev=Worker._int8_quantize_dev
    )
    from elasticdl_tpu_torch.worker.worker import _wire_array

    meta, arrays, residual = Worker._ef_compress(fake, torch.from_numpy(comp.copy()), topk=topk)
    wire = Worker._materialize_wire_delta(meta, [_wire_array(a) for a in arrays])
    return meta, wire, residual.numpy()


def test_int8_quantize_dev_bit_for_bit_with_the_codec_and_the_reference():
    vec = _delta(5 * CHUNK + 1234, seed=4)
    q, scale, deq = Worker._int8_quantize_dev(torch.from_numpy(vec))
    host = tcodec.quantize_int8(vec)
    jq, jscale, jdeq = jax.device_get(JWorker._int8_quantize_dev(None, jnp.asarray(vec)))
    assert q.numpy().tobytes() == host.q.tobytes() == np.asarray(jq).tobytes()
    assert scale.numpy().tobytes() == host.scale.tobytes() == np.asarray(jscale).tobytes()
    assert deq.numpy().tobytes() == host.dequantize().tobytes() == np.asarray(jdeq).tobytes()


@pytest.mark.parametrize(
    "topk,dtype",
    [(False, "bfloat16"), (False, "int8"), (True, "float32"), (True, "bfloat16"),
     (True, "int8")],
    ids=["bf16", "int8", "topk", "topk-bf16", "topk-int8"],
)
def test_ef_compress_bit_for_bit_with_the_reference(topk, dtype):
    comp = _delta(3 * CHUNK + 321, seed=5)
    tmeta, twire, tres = _port_ef(comp, topk, dtype, 0.05)
    jmeta, jwire, jres = _jax_ef(comp, topk, dtype, 0.05)
    assert tmeta == jmeta
    assert tres.tobytes() == np.asarray(jres).tobytes()
    assert type(twire).__name__ == type(jwire).__name__ or isinstance(twire, tcodec.BF16Bits)
    if topk:
        assert twire.indices.dtype == np.int32
        assert twire.indices.tobytes() == np.asarray(jwire.indices).tobytes()
    assert (
        tcodec.delta_to_f32(twire).tobytes() == jcodec.delta_to_f32(jwire).tobytes()
    )
    if dtype == "int8":
        tq = twire.values if topk else twire
        jq = jwire.values if topk else jwire
        assert tq.q.tobytes() == np.asarray(jq.q).tobytes()
        assert tq.scale.tobytes() == np.asarray(jq.scale).tobytes()
    elif dtype == "bfloat16":
        assert _bits(twire.values if topk else twire) == _bits(jwire.values if topk else jwire)
    # the residual is exactly what the wire did not carry
    sent = tcodec.delta_to_f32(twire)
    assert (tres + sent).tobytes() == comp.tobytes() or np.array_equal(
        tres, comp - sent
    )


def test_absorb_shifts_like_the_reference():
    """A merged model for sync 2 lands while sync 3 is in flight: both
    workers shift their params, base and the younger snapshot by merged -
    snapshot_2 and advance the lineage alike (bit for bit, f32)."""
    rng = np.random.default_rng(12)
    n = 1000
    flat, base, snap2, snap3, merged = (
        rng.standard_normal(n).astype(np.float32) for _ in range(5)
    )
    ref = JWorker.__new__(JWorker)
    port = Worker.__new__(Worker)
    for w, arr in ((ref, jnp.asarray), (port, lambda a: torch.from_numpy(a.copy()))):
        w._report_lock = threading.Lock()
        w._stats_lock = threading.Lock()
        w.sync_seconds = Counter()
        w.merged_back = 0
        w._device = torch.device("cpu")
        w._flat, w._base_flat = arr(flat), arr(base)
        w._base_snapshots = {2: arr(snap2), 3: arr(snap3)}
        w._spawn_abs = {2: 8, 3: 12}
        w._own_steps_abs, w._lineage_anchor_abs, w._lineage_version = 12, 0, 0
        w._shard_lineage, w._ps, w._aux = None, None, {}
        w._sync_result = (2, merged, None, 16, None)
    JWorker._absorb_sync_result_traced(ref)
    port._absorb_sync_result()
    assert port.merged_back == 1
    for name in ("_flat", "_base_flat"):
        assert getattr(port, name).numpy().tobytes() == np.asarray(getattr(ref, name)).tobytes()
    assert list(port._base_snapshots) == list(ref._base_snapshots) == [3]
    assert (port._base_snapshots[3].numpy().tobytes()
            == np.asarray(ref._base_snapshots[3]).tobytes())
    for name in ("_lineage_version", "_lineage_anchor_abs", "_spawn_abs"):
        assert getattr(port, name) == getattr(ref, name), name


def test_task_reports_wait_for_their_covering_sync(records):
    """With syncs in flight (depth 2, each ReportLocalUpdate slowed), a
    task's ReportTaskResult goes out only after the sync covering its
    last step has landed: W = 4 and tasks of 4 minibatches, so task k's
    report follows the k-th sync."""
    order, lock = [], threading.Lock()

    def slow_sync(req):
        time.sleep(0.05)
        with lock:
            order.append("sync")
        return req

    def report(req):
        with lock:
            order.append("report")
        return req

    dispatcher = TaskDispatcher({records: 128}, {}, {}, 64, 1, shuffle_seed=3)
    spec = spec_from_module(tzoo, model=tzoo.custom_model(vocab=VOCAB))
    servicer, _eval, _ckpt = build_job(spec, dispatcher, grads_to_wait=1)
    master = InProcessMaster(
        servicer, intercept={"ReportLocalUpdate": slow_sync, "ReportTaskResult": report}
    )
    worker = Worker(0, master, spec, minibatch_size=BATCH, device="cpu", local_updates=4)
    assert worker.run()
    worker.close()
    assert dispatcher.finished()
    # tasks of 64 records = 4 minibatches = 1 window each
    assert order.count("sync") == order.count("report") == 2
    for k in (1, 2):
        nth_report = [i for i, x in enumerate(order) if x == "report"][k - 1]
        assert order[:nth_report].count("sync") >= k


def test_failed_last_sync_requeues_its_task_and_the_job_finishes(records):
    """The sync of the job's last window fails on its background thread
    while the worker polls WAIT (its task's report is deferred behind that
    sync). The worker surfaces the failure, which reports the task failed,
    so the dispatcher requeues it; the worker retrains it from a fresh
    pull and the job finishes exact: the failed window was never applied."""
    calls = []

    def fail_second_sync(req):
        calls.append(req["report_key"])
        if len(calls) == 2:
            time.sleep(0.5)  # fail after the worker has gone on to poll WAIT
            raise ConnectionError("sync lost")
        return req

    dispatcher = TaskDispatcher({records: 128}, {}, {}, 64, 1, shuffle_seed=3)
    spec = spec_from_module(tzoo, model=tzoo.custom_model(vocab=VOCAB))
    servicer, _eval, _ckpt = build_job(spec, dispatcher, grads_to_wait=1)
    master = InProcessMaster(servicer, intercept={"ReportLocalUpdate": fail_second_sync})
    worker = Worker(0, master, spec, minibatch_size=BATCH, device="cpu", local_updates=4)
    done = []
    t = threading.Thread(target=lambda: done.append(worker.run()), daemon=True)
    t.start()
    t.join(timeout=120)
    assert done == [True], "the worker never finished after a failed sync"
    worker.close()
    assert dispatcher.finished()
    assert len(calls) == 3  # the failed window's task ran again
    assert servicer.exactness() == {"version": 8, "init_version": 0, "applied_update_steps": 8}


# -- the servicer ------------------------------------------------------------


def _params(seed=0):
    cfg = jtlm.TransformerConfig(vocab=64, d_model=64, n_heads=4, d_ff=128, n_layers=2)
    return jtlm.init_params(np.random.default_rng(seed), cfg)


def test_report_local_update_matches_the_reference():
    """Two workers syncing windows of 4; worker 1's base falls behind (it
    gets the merged model back); a repeated report_key is absorbed with
    the merged model; deltas in f32, bf16, int8 and top-k forms, and the
    model asked for in bf16. Params bit for bit, every response field
    equal."""
    params = _params(7)
    n = jcodec.ravel_np(params).size
    jserv = JServicer(1, JPSOptimizer(jzoo.optimizer()), init_params=params)
    tserv = MasterServicer(1, PSOptimizer(tzoo.optimizer()), init_params=params)
    rng = np.random.default_rng(8)

    def d():
        return (rng.standard_normal(n) * 1e-3).astype(np.float32)

    v1, v2, v3, v4 = d(), d(), d(), d()
    idx = np.sort(rng.choice(n, 500, replace=False)).astype(np.int32)
    # (worker form, reference form, steps, base_version, key, model_dtype)
    seq = [
        (v1, v1, 4, 0, "w0.a", None),
        (tcodec.BF16Bits.from_f32(v2), v2.astype(ml_dtypes.bfloat16), 4, 0, "w1.a", None),
        (tcodec.quantize_int8(v3), jcodec.quantize_int8(v3), 4, 8, "w1.b", "bfloat16"),
        (v1, v1, 4, 0, "w0.a", None),  # a resend
        (tcodec.SparseDelta(idx, v4[idx], n), jcodec.SparseDelta(idx, v4[idx], n),
         2, 4, "w0.b", "bfloat16"),
        (tcodec.SparseDelta(idx, tcodec.quantize_int8(v4[idx]), n),
         jcodec.SparseDelta(idx, jcodec.quantize_int8(v4[idx]), n), 3, 14, "w0.c", None),
    ]
    merged_back = []
    for twire, jwire, steps, base, key, md in seq:
        req = {"steps": steps, "base_version": base, "report_key": key, "aux_state": None}
        if md:
            req["model_dtype"] = md
        jr = jserv.report_local_update(dict(req, delta_flat=jwire))
        tr = messages.unpack(messages.pack(
            tserv.report_local_update(dict(req, delta_flat=twire))
        ))
        assert tr["version"] == jr["version"]
        assert tr.get("duplicate", False) == jr.get("duplicate", False)
        assert ("params_flat" in tr) == ("params_flat" in jr)
        merged_back.append("params_flat" in tr)
        if "params_flat" in jr:
            assert _bits(tr["params_flat"]) == _bits(jr["params_flat"])
        tparams, _aux, tv = tserv.get_params_copy()
        jparams, _jaux, jv = jserv.get_params_copy()
        assert tv == jv
        assert tcodec.ravel_np(tparams).tobytes() == jcodec.ravel_np(jparams).tobytes()
    assert merged_back == [False, True, False, True, True, False]
    assert tserv.exactness() == {"version": 17, "init_version": 0, "applied_update_steps": 17}
    assert tserv.duplicate_local_updates == 1


# -- ClipAdam, in place --------------------------------------------------------


def test_clip_adam_on_a_flat_tensor_matches_optax():
    n = 5000
    rng = np.random.default_rng(9)
    params = rng.standard_normal(n).astype(np.float32)
    tx = jzoo.optimizer()
    jstate = tx.init(jnp.asarray(params))
    jp = jnp.asarray(params)
    tadam = tzoo.optimizer()
    tp = torch.from_numpy(params.copy())
    tstate = tadam.init([tp])
    for step, scale in enumerate((1e-3, 1.0, 2e-3)):  # step 2 is clipped
        g = (rng.standard_normal(n) * scale).astype(np.float32)
        assert (np.linalg.norm(g) > 1.0) == (step == 1)
        updates, jstate = tx.update(jnp.asarray(g), jstate, jp)
        jp = jp + updates
        (u,) = tadam.update([torch.from_numpy(g.copy())], tstate)
        tp.add_(u)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6, rtol=1e-6)
    assert int(tstate["count"]) == 3
    np.testing.assert_allclose(
        tstate["mu"][0].numpy(), np.asarray(jstate[1][0].mu), atol=1e-6, rtol=1e-6
    )
    np.testing.assert_allclose(
        tstate["nu"][0].numpy(), np.asarray(jstate[1][0].nu), atol=1e-6, rtol=1e-6
    )


def test_ps_optimizer_snapshot_is_a_copy_and_step_leaves_params():
    params = _params(1)
    before = jcodec.ravel_np(params).copy()
    opt = PSOptimizer(ClipAdam())
    g = jax.tree_util.tree_map(lambda p: np.full(p.shape, 1e-3, np.float32), params)
    g_before = jcodec.ravel_np(g).copy()
    out = opt.step(params, g)
    assert jcodec.ravel_np(params).tobytes() == before.tobytes()
    assert jcodec.ravel_np(g).tobytes() == g_before.tobytes()
    snap = opt.state_snapshot()
    kept = [a.copy() for a in snap]
    out2 = opt.step(out, g)
    for a, b in zip(snap, kept):
        assert a.tobytes() == b.tobytes()
    assert int(opt.state_snapshot()[0]) == 2 and int(snap[0]) == 1
    # the second step's output is fresh: the first's stays as it was
    assert not np.array_equal(tcodec.ravel_np(out2), tcodec.ravel_np(out))


# -- the attention dispatcher ---------------------------------------------------


@pytest.mark.parametrize(
    "shape,dtype,takes",
    [
        ((2, 128, 4, 64), torch.bfloat16, True),
        ((2, 1024, 8, 64), torch.float32, True),
        ((2, 128, 4, 16), torch.bfloat16, True),  # the zoo's default head dim
        ((2, 100, 4, 64), torch.bfloat16, False),  # L % 64 != 0
        ((2, 128, 4, 128), torch.float32, True),  # the large config's head dim
        ((2, 1024, 8, 128), torch.bfloat16, True),
        ((2, 128, 4, 32), torch.bfloat16, True),  # the reference kernel test's head dim
        ((2, 128, 4, 64), torch.float16, False),
        ((2, 128, 8, 8), torch.bfloat16, False),  # the zoo width with 8 heads
        ((8, 1024, 4, 16), torch.float16, False),
    ],
)
def test_dispatcher_predicate_by_shape_alone(shape, dtype, takes):
    assert fa.kernels_take(shape, dtype) is takes


def test_cpu_attention_runs_the_plain_versions_for_any_shape():
    g = torch.Generator().manual_seed(0)
    before = fa.attention.fallbacks
    for shape in ((1, 100, 2, 16), (2, 64, 3, 64), (1, 70, 2, 32)):
        q, k, v = (torch.randn(*shape, generator=g) for _ in range(3))
        torch.testing.assert_close(
            fa.attention(q, k, v), fa.reference_attention(q, k, v), atol=1e-5, rtol=1e-5
        )
    assert fa.attention.fallbacks == before  # the CPU is no fallback
    with pytest.raises(ValueError):  # the wrappers still refuse
        fa._check_operands(torch.zeros(1, 100, 2, 16))


# -- the slice as a whole, in process ---------------------------------------------


@pytest.fixture
def records(tmp_path):
    path = str(tmp_path / "tokens.rio")
    write_learnable_token_records(path, 128, SEQ, VOCAB, seed=2)
    return path


def _port_job(path, init=None, **worker_kw):
    dispatcher = TaskDispatcher({path: 128}, {}, {}, 64, 1, shuffle_seed=3)
    spec = spec_from_module(tzoo, model=tzoo.custom_model(vocab=VOCAB))
    servicer, _eval, _ckpt = build_job(spec, dispatcher, grads_to_wait=1, init_params=init)
    worker = Worker(0, InProcessMaster(servicer), spec, minibatch_size=BATCH, device="cpu",
                    **worker_kw)
    assert worker.run()
    worker.close()
    assert dispatcher.finished()
    return servicer, worker


def test_window_job_matches_the_reference_window_job_and_the_per_step_job(records):
    """One worker, W = 4, float32 sync, 2 tasks of 4 minibatches (two full
    windows). Against the reference's window job from the same init over
    the same task order: versions equal, params within 1e-4 (as the
    per-step job test: float32 gradients from two frameworks, amplified
    by Adam where |g| is tiny). Against the port's per-step job: versions
    equal, params within 1e-6 (the same ClipAdam on the flat buffer and
    on the PS's leaves: only the clip norm's summation order and the
    delta's round trip through the PS differ)."""
    init = jtlm.init_params(np.random.default_rng(11), jzoo.custom_model(vocab=VOCAB).cfg)
    jdispatcher = JDispatcher({records: 128}, {}, {}, 64, 1, shuffle_seed=3)
    jspec = jspec_from_module(jzoo, model=jzoo.custom_model(vocab=VOCAB))
    jservicer = JServicer(1, JPSOptimizer(jzoo.optimizer()), task_dispatcher=jdispatcher,
                          init_params=init)
    jworker = JWorker(0, JInProcessMaster(jservicer), jspec, minibatch_size=BATCH,
                      local_updates=4, sync_dtype="float32")
    assert jworker.run()
    jworker.close()
    jparams, _aux, jversion = jservicer.get_params_copy()

    servicer, worker = _port_job(records, init=init, local_updates=4, sync_dtype="float32")
    params, _aux, version = servicer.get_params_copy()
    assert version == jversion == 8
    assert servicer.exactness() == {"version": 8, "init_version": 0, "applied_update_steps": 8}
    assert [steps for _t, steps, _l in worker.window_log] == [4, 4]
    assert worker.steps_computed == worker.steps_accepted == 8
    assert worker.merged_back == 0  # one worker: never merged back
    np.testing.assert_allclose(
        tcodec.ravel_np(params), jcodec.ravel_np(jparams), atol=1e-4, rtol=0
    )
    np.testing.assert_allclose(worker.task_losses, jworker.task_losses, atol=1e-5)

    step_servicer, _w = _port_job(records, init=init)
    step_params, _aux, step_version = step_servicer.get_params_copy()
    assert step_version == version
    np.testing.assert_allclose(
        tcodec.ravel_np(params), tcodec.ravel_np(step_params), atol=1e-6, rtol=0
    )


@pytest.mark.parametrize(
    "wire", [dict(transport_dtype="bfloat16"), dict(sync_dtype="int8")],
    ids=["transport-bf16", "sync-int8"],
)
def test_per_step_wire_forms_match_the_reference(records, wire):
    """The per-step path's compressed gradients: a plain bf16 cast
    (`transport_dtype`) or int8 with an error-feedback residual
    (`sync_dtype`), each asking for the model back in bf16, against the
    reference's same job from the same init: versions equal; all but
    0.1% of the params within 1e-4, as the float32 job, and every one
    within 2e-3. The float32 gradients of the two packages differ in the
    last bits, so a few elements land on the other side of a bf16 or
    int8 rounding; an int8 quantum (max |g| / 127 of its chunk) can
    exceed a small element, whose Adam step (lr 1e-3, normalized per
    element) then differs by up to about two steps (measured: 12 of
    74,048 elements beyond 1e-4, at most 1.9e-4). Task losses within
    1e-3 (the model comes back in bf16)."""
    init = jtlm.init_params(np.random.default_rng(11), jzoo.custom_model(vocab=VOCAB).cfg)
    jdispatcher = JDispatcher({records: 128}, {}, {}, 64, 1, shuffle_seed=3)
    jspec = jspec_from_module(jzoo, model=jzoo.custom_model(vocab=VOCAB))
    jservicer = JServicer(1, JPSOptimizer(jzoo.optimizer()), task_dispatcher=jdispatcher,
                          init_params=init)
    jmaster = JInProcessMaster(jservicer)
    jworker = JWorker(0, jmaster, jspec, minibatch_size=BATCH, **wire)
    assert jworker.run()
    jworker.close()
    jparams, _aux, jversion = jservicer.get_params_copy()

    seen = []
    dispatcher = TaskDispatcher({records: 128}, {}, {}, 64, 1, shuffle_seed=3)
    spec = spec_from_module(tzoo, model=tzoo.custom_model(vocab=VOCAB))
    servicer, _eval, _ckpt = build_job(spec, dispatcher, grads_to_wait=1, init_params=init)
    master = InProcessMaster(servicer, intercept={
        "ReportGradient": lambda req: seen.append(
            (type(req["gradient_flat"]).__name__, req.get("model_dtype"))) or req
    })
    worker = Worker(0, master, spec, minibatch_size=BATCH, device="cpu", **wire)
    assert worker.run()
    worker.close()
    params, _aux, version = servicer.get_params_copy()
    form = "BF16Bits" if "transport_dtype" in wire else "QuantizedDelta"
    assert seen == [(form, "bfloat16")] * 8
    assert version == jversion == 8
    diff = np.abs(tcodec.ravel_np(params) - jcodec.ravel_np(jparams))
    assert np.mean(diff > 1e-4) <= 1e-3 and diff.max() <= 2e-3, diff.max()
    np.testing.assert_allclose(worker.task_losses, jworker.task_losses, atol=1e-3)


def test_two_in_process_workers_with_bf16_ef(records, tmp_path):
    """Two workers in threads on one servicer, W = 2, bf16 EF deltas and
    a bf16 model back: every step is applied once (no stale recomputes in
    window mode), the exactness block holds, merged models are absorbed,
    and the loss falls over 2 epochs."""
    dispatcher = TaskDispatcher({records: 128}, {}, {}, 32, 2, shuffle_seed=3)
    spec0 = spec_from_module(tzoo, model=tzoo.custom_model(vocab=VOCAB))
    servicer, _eval, _ckpt = build_job(spec0, dispatcher, grads_to_wait=1)
    master = InProcessMaster(servicer)
    workers = [
        Worker(i, master, spec_from_module(tzoo, model=tzoo.custom_model(vocab=VOCAB)),
               minibatch_size=BATCH, device="cpu", local_updates=2, sync_dtype="bf16")
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
    ex = servicer.exactness()
    total = 2 * 128 // BATCH
    assert ex == {"version": total, "init_version": 0, "applied_update_steps": total}
    assert sum(w.steps_computed for w in workers) == sum(w.steps_accepted for w in workers)
    assert sum(w.steps_accepted for w in workers) == total
    assert master.calls["ReportLocalUpdate"] == sum(len(w.window_log) for w in workers)
    losses = sorted((t, loss) for w in workers for t, _s, loss in w.window_log)
    first, last = np.mean([x for _t, x in losses[:2]]), np.mean([x for _t, x in losses[-2:]])
    assert np.isfinite([x for _t, x in losses]).all() and last < first


# -- report keys: f"{spec_key}.w{i}" ------------------------------------------------


def _keys_of(calls):
    """An intercept that records each ReportLocalUpdate's (report key,
    steps) in `calls`."""
    def record(req):
        calls.append((req["report_key"], req["steps"]))
        return req
    return {"ReportLocalUpdate": record}


def test_window_report_keys_are_the_reference_workers(records):
    """Tasks of 48 records (3 minibatches) at W = 2: every task ends with
    its ragged tail window, so windows never straddle tasks and each
    task's keys run `{spec_key}.w0`, `.w1`. The port's keys are the
    reference worker's for the same task sequence, window for window."""
    init = jtlm.init_params(np.random.default_rng(11), jzoo.custom_model(vocab=VOCAB).cfg)
    jcalls, calls = [], []
    jdispatcher = JDispatcher({records: 128}, {}, {}, 48, 1, shuffle_seed=3)
    jspec = jspec_from_module(jzoo, model=jzoo.custom_model(vocab=VOCAB))
    jservicer = JServicer(1, JPSOptimizer(jzoo.optimizer()), task_dispatcher=jdispatcher,
                          init_params=init)
    jworker = JWorker(0, JInProcessMaster(jservicer, intercept=_keys_of(jcalls)), jspec,
                      minibatch_size=BATCH, local_updates=2, sync_dtype="float32")
    assert jworker.run()
    jworker.close()

    dispatcher = TaskDispatcher({records: 128}, {}, {}, 48, 1, shuffle_seed=3)
    spec = spec_from_module(tzoo, model=tzoo.custom_model(vocab=VOCAB))
    servicer, _eval, _ckpt = build_job(spec, dispatcher, grads_to_wait=1, init_params=init)
    worker = Worker(0, InProcessMaster(servicer, intercept=_keys_of(calls)), spec,
                    minibatch_size=BATCH, device="cpu", local_updates=2, sync_dtype="float32")
    assert worker.run()
    worker.close()
    assert calls == jcalls
    # 3 tasks (48, 48, 32 records): windows of 2 + 1, 2 + 1, 2 steps
    tasks = {}
    for key, steps in calls:
        spec_key, window = key.rsplit(".w", 1)
        tasks.setdefault(spec_key, []).append((int(window), steps))
    assert sorted(tasks.values()) == [[(0, 2)], [(0, 2), (1, 1)], [(0, 2), (1, 1)]]
    assert all(k.startswith("t") and ".a" in k for k in tasks)
    assert servicer.exactness()["applied_update_steps"] == 128 // BATCH


class _DyingMaster:
    """A window worker's link to the master that dies after its first
    ReportLocalUpdate landed: later ones raise, and task reports are
    lost (the worker was killed before it could send them)."""

    def __init__(self, master):
        self.master, self.landed = master, []

    def call(self, method, request=None):
        if method == "ReportTaskResult":
            return {}
        if method == "ReportLocalUpdate":
            if self.landed:
                raise ConnectionError("worker killed")
            self.landed.append(request["report_key"])
        return self.master.call(method, request)


def test_replayed_windows_are_deduped_by_their_spec_key(records):
    """Worker 0 trains a task (4 minibatches, 2 windows at W = 2) and dies
    after its first window landed; the dispatcher recovers the task and
    worker 1 replays it under the task's pinned spec_key: its first
    window carries the landed window's key and is absorbed, its second is
    applied, and each record's step is applied exactly once."""
    dispatcher = TaskDispatcher({records: 128}, {}, {}, 64, 1, shuffle_seed=3)
    spec = spec_from_module(tzoo, model=tzoo.custom_model(vocab=VOCAB))
    servicer, _eval, _ckpt = build_job(spec, dispatcher, grads_to_wait=1)
    calls = []
    master = InProcessMaster(servicer, intercept=_keys_of(calls))
    dying = _DyingMaster(master)
    w0 = Worker(0, dying, spec, minibatch_size=BATCH, device="cpu", local_updates=2,
                sync_dtype="float32")
    task, _ = w0.get_task()
    with pytest.raises(RuntimeError, match="sync failed"):
        w0._process_training_task(task)  # the dead link surfaces here or at the join
        w0._join_sync()
    assert dying.landed == [f"{task.spec_key}.w0"]
    assert servicer.exactness()["applied_update_steps"] == 2
    dispatcher.recover_tasks(0)

    w1 = Worker(1, master, spec_from_module(tzoo, model=tzoo.custom_model(vocab=VOCAB)),
                minibatch_size=BATCH, device="cpu", local_updates=2, sync_dtype="float32")
    assert w1.run()
    w1.close()
    assert dispatcher.finished() and not dispatcher.has_failed_tasks()
    replayed = [k for k, _steps in calls if k.startswith(f"{task.spec_key}.w")]
    assert replayed == [f"{task.spec_key}.w0", f"{task.spec_key}.w0", f"{task.spec_key}.w1"]
    assert servicer.duplicate_local_updates == 1 and w1.deduped_windows == 1
    minibatches = 128 // BATCH
    assert servicer.exactness() == {
        "version": minibatches, "init_version": 0, "applied_update_steps": minibatches
    }
    assert w1.steps_computed == minibatches and w1.steps_accepted == minibatches - 2
    # the replay absorbed the model that holds the landed window
    assert w1.merged_back >= 1
    params, _aux, _v = servicer.get_params_copy()
    assert np.isfinite(tcodec.ravel_np(params)).all()


def test_failed_window_task_leaves_no_step_to_the_next_task(records):
    """A task that fails with a step not yet synced drops it: the next
    task's window holds only its own steps, the failed task is retrained
    under its pinned keys, and every record's step is applied once."""
    spec = spec_from_module(tzoo, model=tzoo.custom_model(vocab=VOCAB))
    parse = spec.dataset_fn
    seen = []

    def dataset_fn(chunk, mode):  # the second minibatch of the job fails once
        seen.append(len(chunk))
        if len(seen) == 2:
            raise ValueError("unreadable minibatch")
        return parse(chunk, mode)

    spec.dataset_fn = dataset_fn
    dispatcher = TaskDispatcher({records: 128}, {}, {}, 48, 1, shuffle_seed=3)
    servicer, _eval, _ckpt = build_job(spec, dispatcher, grads_to_wait=1)
    calls = []
    worker = Worker(0, InProcessMaster(servicer, intercept=_keys_of(calls)), spec,
                    minibatch_size=BATCH, device="cpu", local_updates=2, sync_dtype="float32")
    assert worker.run()
    worker.close()
    assert dispatcher.finished() and not dispatcher.has_failed_tasks()
    tasks = {}
    for key, steps in calls:
        spec_key, window = key.rsplit(".w", 1)
        tasks.setdefault(spec_key, []).append((int(window), steps))
    assert sorted(tasks.values()) == [[(0, 2)], [(0, 2), (1, 1)], [(0, 2), (1, 1)]]
    minibatches = 128 // BATCH
    assert servicer.exactness() == {
        "version": minibatches, "init_version": 0, "applied_update_steps": minibatches
    }
    assert worker.steps_computed == minibatches + 1  # the dropped step


# -- process mode on the CPU --------------------------------------------------------


def _shards(data_dir, n_files, records_each=64):
    os.makedirs(data_dir, exist_ok=True)
    for i in range(n_files):
        write_learnable_token_records(
            os.path.join(data_dir, f"shard-{i}.rio"), records_each, SEQ, VOCAB, seed=i
        )


def _argv(data_dir, output, num_workers, *extra):
    return [
        "--model_zoo", ZOO, "--model_def", "transformer_lm_zoo.custom_model",
        "--model_params", f"vocab={VOCAB}", "--minibatch_size", str(BATCH),
        "--training_data_dir", data_dir, "--records_per_task", "32",
        "--num_epochs", "1", "--grads_to_wait", "1", "--num_workers", str(num_workers),
        "--worker_backend", "process", "--device", "cpu", "--envs", "OMP_NUM_THREADS=2",
        "--local_updates", "2", "--sync_dtype", "bf16", "--output", output, *extra,
    ]


def test_window_process_job_is_exact(tmp_path, monkeypatch):
    data = str(tmp_path / "data")
    _shards(data, 2)
    output = str(tmp_path / "final.ckpt")
    monkeypatch.setenv(ENV_WORKER_LOG_DIR, str(tmp_path / "logs"))
    rc, summary = master_main.run(_argv(data, output, 2))
    assert rc == 0
    minibatches = 2 * 64 // BATCH
    summaries = worker_main.read_summaries(str(tmp_path / "logs"))
    assert sorted(summaries) == [0, 1]
    assert load_model_file(output).version == minibatches
    assert sum(s["steps_accepted"] for s in summaries.values()) == minibatches
    assert summary["version"] == summary["applied_update_steps"] == minibatches
    for s in summaries.values():
        assert s["steps_computed"] == s["steps_accepted"]  # no stale recomputes
        assert s["drained"] is False
        assert all(np.isfinite([loss for _t, _s, loss in s["windows"]]))
        assert set(s["sync_seconds"]) >= {"quantize", "encode", "rpc"}


def _window_job(tmp_path, n_shards):
    """The master's parts driven directly (as master.main wires them), 2
    process workers in window mode; returns what the tests need."""
    data = str(tmp_path / "data")
    _shards(data, n_shards)
    args = master_parser().parse_args(_argv(data, "", 2))
    _spec, dispatcher, servicer, _eval, _ckpt = master_main.build_master(args)
    server = RpcServer(servicer.handlers(), port=0)
    server.start()
    addr = f"localhost:{server.port}"
    log_dir = str(tmp_path / "logs")
    backend = tpod.ProcessBackend(log_dir=log_dir)
    requeued = []
    recover = dispatcher.recover_tasks

    def recording_recover(worker_id):
        with dispatcher._lock:
            requeued.extend(t for t, (w, _) in dispatcher._doing.items() if w == worker_id)
        recover(worker_id)

    dispatcher.recover_tasks = recording_recover
    manager = WorkerManager(
        backend, dispatcher, num_workers=2,
        worker_argv_fn=lambda wid: worker_forward_args(args, wid, addr),
        envs={"OMP_NUM_THREADS": "2"}, max_relaunches=4,
    )
    return dispatcher, servicer, server, backend, manager, requeued, log_dir


def _when_worker0_holds_a_task(dispatcher, backend):
    """Worker 0's pid once it holds a task and the PS has applied a
    window (so later windows are on their way)."""
    deadline = time.time() + 60
    while time.time() < deadline:
        with dispatcher._lock:
            holds = [t for t, (wid, _) in dispatcher._doing.items() if wid == 0]
        pid = backend.pid_of(0)
        if holds and pid and dispatcher.completed_records() > 0:
            return pid
        time.sleep(0.01)
    raise AssertionError("worker 0 never held a task after the first report")


def _finish(dispatcher, manager, backend, server):
    try:
        deadline = time.time() + 90
        while not dispatcher.finished() and time.time() < deadline:
            time.sleep(0.05)
        deadline = time.time() + 30
        while not manager.all_exited() and time.time() < deadline:
            time.sleep(0.05)
    finally:
        manager.stop_relaunch_and_remove_workers()
        backend.stop()
        server.stop()


def test_sigterm_drains_a_window_worker_with_nothing_to_requeue(tmp_path):
    dispatcher, servicer, server, backend, manager, requeued, log_dir = _window_job(tmp_path, 4)
    manager.start_workers()
    try:
        os.kill(_when_worker0_holds_a_task(dispatcher, backend), signal.SIGTERM)
    finally:
        _finish(dispatcher, manager, backend, server)
    assert dispatcher.finished() and not dispatcher.has_failed_tasks()
    assert manager.phases()[0] == tpod.PodPhase.SUCCEEDED  # exit 0
    assert manager.relaunches() == 0 and requeued == []
    minibatches = 4 * 64 // BATCH
    # every record trained exactly once
    assert dispatcher.completed_records() == 4 * 64
    assert servicer.exactness() == {
        "version": minibatches, "init_version": 0, "applied_update_steps": minibatches
    }
    summaries = worker_main.read_summaries(log_dir)
    assert summaries[0]["drained"] is True
    with open(os.path.join(log_dir, "worker-0.log")) as f:
        assert "drain requested, exiting at task boundary" in f.read()
    assert sum(s["steps_accepted"] for s in summaries.values()) == minibatches


def test_sigkilled_window_worker_has_its_tasks_requeued(tmp_path):
    dispatcher, servicer, server, backend, manager, requeued, log_dir = _window_job(tmp_path, 4)
    manager.start_workers()
    try:
        os.kill(_when_worker0_holds_a_task(dispatcher, backend), signal.SIGKILL)
    finally:
        _finish(dispatcher, manager, backend, server)
    assert dispatcher.finished() and not dispatcher.has_failed_tasks()
    assert manager.phases()[0] == tpod.PodPhase.DELETED
    assert requeued, "the killed worker's task was not requeued"
    assert manager.relaunches() >= 1
    ex = servicer.exactness()
    assert ex["version"] == ex["init_version"] + ex["applied_update_steps"]
    # every record's step applied once: the windows of the killed worker
    # that had landed are replayed under the same report keys and absorbed
    assert ex["applied_update_steps"] == 4 * 64 // BATCH
    assert dispatcher.completed_records() == 4 * 64
    assert 0 not in worker_main.read_summaries(log_dir)

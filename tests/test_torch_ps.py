"""The port's host-side PS plane against the reference: the flat layer's
leaf order, the frame codec and messages, the PS optimizer, the
servicer's sync accumulation, the task dispatcher, and RecordIO token
files.

Flat order, frames, record files and task order are bit-exact. Optimizer and servicer
results are float32 allclose at 1e-6 (optax runs under XLA, the port in
torch: the same formulas, other fusion and reduction order).
"""

import jax
import ml_dtypes
import numpy as np
import pytest

from elasticdl_tpu.common import codec as jcodec
from elasticdl_tpu.master.ps_optimizer import PSOptimizer as JPSOptimizer
from elasticdl_tpu.master.servicer import MasterServicer as JServicer
from elasticdl_tpu.master.task_dispatcher import TaskDispatcher as JDispatcher
from elasticdl_tpu.models import transformer_lm as jtlm
from elasticdl_tpu.models import transformer_lm_zoo as jzoo
from elasticdl_tpu_torch.common import codec as tcodec
from elasticdl_tpu_torch.common import messages
from elasticdl_tpu_torch.master.ps_optimizer import ClipAdam, PSOptimizer
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.models import transformer_lm_zoo as tzoo
from _torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

OPT = dict(atol=1e-6, rtol=1e-6)


def _params(seed=0):
    cfg = jtlm.TransformerConfig(vocab=64, d_model=64, n_heads=4, d_ff=128, n_layers=2)
    return jtlm.init_params(np.random.default_rng(seed), cfg)


def _grads(params, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * scale).astype(np.float32), params
    )


def test_flat_order_bit_equal_to_reference():
    params = _params()
    # a nested tree with lists, tuples and None, beyond the transformer's
    tree = {"b": [np.arange(3, dtype=np.float32), None], "a": (np.ones((2, 2), np.float32),),
            "model": params}
    for t in (params, tree):
        got = tcodec.ravel_np(t)
        want = jcodec.ravel_np(t)
        assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
        back = tcodec.make_unraveler(t)(got)
        assert tcodec.tree_flatten(back)[1] == tcodec.tree_flatten(t)[1]
        for a, b in zip(tcodec.tree_leaves(back), jax.tree_util.tree_leaves(t)):
            assert a.shape == np.shape(b) and np.array_equal(a, b)
    paths = tcodec.tree_paths(params)
    jpaths = [
        tuple(k.key for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]
    ]
    assert paths == jpaths


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_frames_round_trip_bit_for_bit(dtype):
    rng = np.random.default_rng(1)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    f32[0, :3] = [np.inf, -0.0, np.nan]
    if dtype == "float32":
        arr = f32
    elif dtype == "int32":
        arr = rng.integers(-(2**31), 2**31 - 1, (4, 7)).astype(np.int32)
    else:
        arr = tcodec.BF16Bits.from_f32(f32)
        # the port's bf16 rounding is ml_dtypes' bit for bit
        assert arr.bits.tobytes() == f32.astype(ml_dtypes.bfloat16).view(np.uint16).tobytes()
    msg = {"x": arr, "nest": [arr, (arr, 3, "s", None, 2.5, True)], "n": np.int64(7)}
    back = messages.unpack(messages.pack(msg))
    for got in (back["x"], back["nest"][0], back["nest"][1][0]):
        if dtype == "bfloat16":
            assert isinstance(got, tcodec.BF16Bits)
            assert got.bits.tobytes() == arr.bits.tobytes() and got.shape == arr.shape
        else:
            assert got.dtype == arr.dtype and got.shape == arr.shape
            assert got.tobytes() == arr.tobytes()
    assert back["nest"][1][1:] == (3, "s", None, 2.5, True) and back["n"] == 7
    assert isinstance(back["nest"][1], tuple)


def test_frames_align_segments_and_reject_bad_input():
    frame = tcodec.dumps({"a": np.ones(3, np.float32), "b": np.ones(5, np.int8)})
    header_len = int.from_bytes(frame[2:6], "little")
    pad = int.from_bytes(frame[6:8], "little")
    assert (8 + header_len + pad) % 64 == 0
    with pytest.raises(TypeError):
        tcodec.dumps({1: np.ones(2)})
    with pytest.raises(ValueError):
        tcodec.loads(b"not a frame")


def test_ps_optimizer_matches_reference_over_three_steps():
    params = _params()
    jopt = JPSOptimizer(jzoo.optimizer())
    topt = PSOptimizer(tzoo.optimizer())
    assert tzoo.optimizer() == ClipAdam(max_norm=1.0, learning_rate=1e-3)
    jp, tp = params, params
    # step 2 has a global norm far above 1.0 (clipped), 1 and 3 below it
    for step, scale in enumerate((1e-4, 1.0, 2e-4)):
        g = _grads(params, seed=step, scale=scale)
        jp = jopt.step(jp, g)
        tp = topt.step(tp, g)
        np.testing.assert_allclose(tcodec.ravel_np(tp), jcodec.ravel_np(jp), **OPT)
    jstate, tstate = jopt.state_snapshot(), topt.state_snapshot()
    assert len(tstate) == len(jstate) and int(tstate[0]) == int(jstate[0]) == 3
    for a, b in zip(tstate[1:], jstate[1:]):
        np.testing.assert_allclose(a, b, **OPT)
    # a restored state continues the trajectory
    again = PSOptimizer(tzoo.optimizer())
    again.restore_state(params, jstate)
    g = _grads(params, seed=9, scale=1e-3)
    np.testing.assert_allclose(
        tcodec.ravel_np(again.step(tp, g)), tcodec.ravel_np(topt.step(tp, g)), **OPT
    )


def test_servicer_sync_accumulation_matches_reference():
    """grads_to_wait=2: two reports average in f32 and apply once; a
    stale report is rejected with the fresh model piggybacked."""
    params = _params(3)
    jserv = JServicer(2, JPSOptimizer(jzoo.optimizer()), init_params=params)
    tserv = MasterServicer(2, PSOptimizer(tzoo.optimizer()), init_params=params)
    for rnd in range(2):
        for w in range(2):
            g = jcodec.ravel_np(_grads(params, seed=10 * rnd + w, scale=1e-3))
            req = {"worker_id": w, "version": rnd, "gradient_flat": g, "return_model": True}
            jr = jserv.report_gradient(dict(req))
            tr = messages.unpack(messages.pack(tserv.report_gradient(dict(req))))
            assert tr["accepted"] and jr["accepted"]
            assert tr["version"] == jr["version"] == rnd + w
            if w == 1:
                np.testing.assert_allclose(tr["params_flat"], jr["params_flat"], **OPT)
    stale = {"worker_id": 0, "version": 0, "gradient_flat": g, "return_model": True}
    jr, tr = jserv.report_gradient(dict(stale)), tserv.report_gradient(dict(stale))
    assert not tr["accepted"] and tr["version"] == jr["version"] == 2
    np.testing.assert_allclose(tr["params_flat"], jr["params_flat"], **OPT)
    assert tserv.exactness() == {"version": 2, "init_version": 0, "applied_update_steps": 2}
    with pytest.raises(ValueError, match="future"):
        tserv.report_gradient({"version": 5, "gradient_flat": g})
    with pytest.raises(ValueError, match="length"):
        tserv.report_gradient({"version": 2, "gradient_flat": g[:-1]})


def test_dispatcher_order_matches_reference():
    shards = {"a.rio": 100, "b.rio": 64}
    jd = JDispatcher(shards, {}, {}, 16, 2, shuffle_seed=5)
    td = TaskDispatcher(shards, {}, {}, 16, 2, shuffle_seed=5)
    seen = []
    while True:
        jt, tt = jd.get(0), td.get(0)
        if jt is None:
            assert tt is None
            break
        assert (tt.task_id, tt.shard_file_name, tt.start, tt.end, tt.spec_key) == (
            jt.task_id, jt.shard_file_name, jt.start, jt.end, jt.spec_key
        )
        seen.append(tt.task_id)
        ok = len(seen) != 3  # fail the third task once: it requeues
        jd.report(jt.task_id, ok, worker_id=0)
        td.report(tt.task_id, ok, worker_id=0)
    assert td.finished() and jd.finished()
    assert td.completed_records() == jd.completed_records() == 2 * 164
    assert not td.has_failed_tasks()


def test_recordio_and_token_records_interoperate_with_reference(tmp_path):
    """Files the port writes read back in the reference's reader and the
    port's, record for record; the token writer draws the reference's
    sequences for one seed."""
    from elasticdl_tpu.data.recordio import RecordIOReader as JReader
    from elasticdl_tpu.models import record_codec as jrc
    from elasticdl_tpu_torch.data.recordio import RecordIOReader, count_records
    from elasticdl_tpu_torch.models import record_codec as trc

    ours, theirs = str(tmp_path / "t.rio"), str(tmp_path / "j.rio")
    trc.write_learnable_token_records(ours, 40, 16, 64, seed=4)
    jrc.write_learnable_token_records(theirs, 40, 16, 64, seed=4)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    assert count_records(ours) == 40
    with RecordIOReader(ours) as r, JReader(ours) as jr:
        got = list(r.read_range(5, 17))
        assert got == list(jr.read_range(5, 17)) and len(got) == 12
        assert list(r.read_range(38, 99)) == list(jr.read_range(38, 99))
    np.testing.assert_array_equal(
        trc.decode_token_records(got), jrc.decode_token_records(got)
    )


def test_dispatcher_recovers_a_dead_workers_tasks_like_reference():
    shards = {"a.rio": 64}
    jd = JDispatcher(shards, {}, {}, 16, 1, shuffle_seed=1)
    td = TaskDispatcher(shards, {}, {}, 16, 1, shuffle_seed=1)
    for d in (jd, td):
        d.get(0), d.get(1), d.get(0)
        d.recover_tasks(0)
    order = lambda d: [t.task_id for t in iter(lambda: d.get(2), None)]  # noqa: E731
    assert order(td) == order(jd)
    assert not td.finished()  # worker 1 still holds a task


def test_messages_round_trip_tasks_and_models():
    task = messages.Task(task_id=3, shard_file_name="f", start=2, end=9,
                         type=messages.TaskType.TRAINING, spec_key="t3.a1")
    model = messages.Model(version=5, params=_params(), aux=None)
    back = messages.unpack(messages.pack({"task": task.to_wire(), "model": model.to_wire()}))
    assert messages.Task.from_wire(back["task"]) == task
    m = messages.Model.from_wire(back["model"])
    assert m.version == 5 and m.aux is None
    assert tcodec.ravel_np(m.params).tobytes() == tcodec.ravel_np(model.params).tobytes()


def test_hazard_ps_averages_gradients_in_f32_numpy():
    """The reference PS sums reports and divides by their count in
    float32 numpy before the optimizer sees them; the port's average is
    that, bit for bit."""
    params = _params(4)

    class Recorder:
        def step(self, p, grads):
            self.grads = grads
            return p

    rec = Recorder()
    serv = MasterServicer(3, rec, init_params=params)
    flats = [jcodec.ravel_np(_grads(params, seed=20 + w, scale=1e-2)) for w in range(3)]
    for w, g in enumerate(flats):
        serv.report_gradient({"worker_id": w, "version": 0, "gradient_flat": g})
    want = (flats[0] + flats[1] + flats[2]) / np.float32(3)
    got = tcodec.ravel_np(rec.grads)
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()

"""The image zoo's host-side planes against the reference, on the CPU:
the zoo's optimizers against optax, the servicer's aux plane against the
reference servicer, the image record codec and synthetic writer, the
ImageNet data-prep hook, and the worker's uint8 path to the device.

Optimizer results are float32 allclose at 1e-6 absolute and relative:
the same formulas in the same order, but XLA:CPU contracts a multiply
and an add into one fused multiply-add where torch rounds twice (one
ulp). The schedule and the state's leaf order, the servicer's aux plane
(with no optimizer, so every number it holds is its own arithmetic),
the codec, the writer and the data prep are bit for bit.
"""

import io
import os
import tarfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from elasticdl_tpu.master.ps_optimizer import PSOptimizer as JPSOptimizer  # noqa: E402
from elasticdl_tpu.master.servicer import MasterServicer as JServicer  # noqa: E402
from elasticdl_tpu.models import cifar10_functional_api as jcifar  # noqa: E402
from elasticdl_tpu.models import cifar10_subclass as jcifar_sub  # noqa: E402
from elasticdl_tpu.models import imagenet_resnet50 as jimagenet  # noqa: E402
from elasticdl_tpu.models import mnist_functional_api as jmnist  # noqa: E402
from elasticdl_tpu.models import mnist_subclass as jmnist_sub  # noqa: E402
from elasticdl_tpu.models import record_codec as jrc  # noqa: E402
from elasticdl_tpu.models import resnet50_subclass as jresnet  # noqa: E402
from elasticdl_tpu_torch.api.model_spec_helpers import spec_from_module  # noqa: E402
from elasticdl_tpu_torch.common import codec, messages  # noqa: E402
from elasticdl_tpu_torch.master.ps_optimizer import PSOptimizer, WarmupCosineDecay  # noqa: E402
from elasticdl_tpu_torch.master.servicer import MasterServicer  # noqa: E402
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher  # noqa: E402
from elasticdl_tpu_torch.models import cifar10_functional_api as tcifar  # noqa: E402
from elasticdl_tpu_torch.models import cifar10_subclass as tcifar_sub  # noqa: E402
from elasticdl_tpu_torch.models import imagenet_resnet50 as timagenet  # noqa: E402
from elasticdl_tpu_torch.models import mnist_functional_api as tmnist  # noqa: E402
from elasticdl_tpu_torch.models import mnist_subclass as tmnist_sub  # noqa: E402
from elasticdl_tpu_torch.models import record_codec as trc  # noqa: E402
from elasticdl_tpu_torch.models import resnet50_subclass as tresnet  # noqa: E402
from elasticdl_tpu_torch.models import transformer_lm_zoo as tzoo  # noqa: E402
from elasticdl_tpu_torch.testing import InProcessMaster, build_job  # noqa: E402
from elasticdl_tpu_torch.worker.worker import Worker  # noqa: E402
from _torch_threads import two_torch_threads  # noqa: E402,F401 (autouse fixture)

OPT = dict(atol=1e-6, rtol=1e-6)

# the zoo's optimizers: (reference module, port module)
OPTIMIZERS = {
    "mnist_functional_api": (jmnist, tmnist),
    "mnist_subclass": (jmnist_sub, tmnist_sub),
    "cifar10_functional_api": (jcifar, tcifar),
    "cifar10_subclass": (jcifar_sub, tcifar_sub),
    "resnet50_subclass": (jresnet, tresnet),
}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {
        "conv": {"kernel": (rng.standard_normal((3, 3, 4, 8)) * scale).astype(np.float32)},
        "dense": {"bias": (rng.standard_normal(10) * scale).astype(np.float32),
                  "kernel": (rng.standard_normal((32, 10)) * scale).astype(np.float32)},
    }


def _flat(tree):
    return codec.ravel_np(tree)


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_zoo_optimizer_matches_optax(name):
    """Three steps from a fresh state (the second's global norm above the
    clip), the state's leaves in optax's order and dtypes, then a state
    restored from the reference's snapshot at count 198 steps four more
    times on both: across the end of cifar10_functional_api's warmup
    (200 steps) for the scheduled one."""
    jmod, tmod = OPTIMIZERS[name]
    params = _tree(0)
    jopt, topt = JPSOptimizer(jmod.optimizer()), PSOptimizer(tmod.optimizer())
    jp = tp = params
    for step, scale in enumerate((1e-2, 3.0, 2e-2)):
        g = _tree(10 + step, scale)
        jp, tp = jopt.step(jp, g), topt.step(tp, g)
        np.testing.assert_allclose(_flat(tp), _flat(jp), **OPT)
    jstate, tstate = jopt.state_snapshot(), topt.state_snapshot()
    assert [(a.dtype, a.shape) for a in tstate] == [(np.asarray(a).dtype, np.shape(a)) for a in jstate]
    for a, b in zip(tstate, jstate):
        np.testing.assert_allclose(a, b, **OPT)

    moved = [np.asarray(a) + 0 for a in jstate]
    for i, a in enumerate(moved):
        if a.dtype == np.int32:
            moved[i] = np.asarray(198, np.int32)
    jopt.restore_state(params, moved)
    topt.restore_state(params, moved)
    jp = tp = params
    for step in range(4):
        g = _tree(20 + step, 1e-1)
        jp, tp = jopt.step(jp, g), topt.step(tp, g)
        np.testing.assert_allclose(_flat(tp), _flat(jp), **OPT)
    counts = [int(a) for a in topt.state_snapshot() if a.dtype == np.int32]
    assert counts == [int(a) for a in jopt.state_snapshot() if np.asarray(a).dtype == np.int32]
    assert counts == ([202] if name == "cifar10_functional_api" else [])


def test_warmup_cosine_schedule_is_optaxs_bit_for_bit():
    port = WarmupCosineDecay(0.0, 0.05, 200, 4000, 0.005)
    ref = optax.warmup_cosine_decay_schedule(0.0, 0.05, 200, 4000, 0.005)
    for count in (0, 1, 7, 199, 200, 201, 1000, 3999, 4000, 5000):
        got = port(torch.tensor(count, dtype=torch.int32))
        want = np.asarray(ref(jnp.asarray(count, jnp.int32)))
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == want.tobytes(), count


@pytest.mark.parametrize("name", ["cifar10_functional_api", "resnet50_subclass"])
def test_optimizer_on_one_flat_buffer_equals_the_tree(name):
    """Window mode runs the spec's optimizer over the worker's flat
    buffer (one leaf): clip, weight decay and momentum are elementwise
    or over the global norm, so four steps there equal the PS's steps
    over the tree within the clip norm's summation order."""
    tx = OPTIMIZERS[name][1].optimizer()
    params = _tree(1)
    opt = PSOptimizer(tx)
    flat = torch.from_numpy(_flat(params).copy())
    state = tx.init([flat])
    tree = params
    for step in range(4):
        g = _tree(30 + step, 3.0 if step == 1 else 1e-2)
        tree = opt.step(tree, g)
        (u,) = tx.update([torch.from_numpy(_flat(g).copy())], state, [flat])
        flat.add_(u)
    np.testing.assert_allclose(flat.numpy(), _flat(tree), **OPT)


def _aux(seed):
    rng = np.random.default_rng(seed)
    return {"batch_stats": {"bn": {"mean": rng.standard_normal(8).astype(np.float32),
                                   "var": rng.uniform(0.5, 2, 8).astype(np.float32)}}}


def _aux_calls(params):
    """A request sequence over the aux plane: lazy init with aux, pulls
    (tree, flat, only_if_newer), GetAux, two reports under grads_to_wait
    = 2 (the second's aux lands with the step), a stale report (rejected,
    the model and aux back), window syncs with and without aux, a
    resend, and a sync whose base fell behind (merged model and aux back)."""
    g = lambda s: _flat(_tree(s, 1e-2))  # noqa: E731
    return [
        ("GetModel", {"version": -1, "method": "minimum", "only_if_newer": True}),
        ("ReportVariable", {"params": params, "aux": _aux(1)}),
        ("ReportVariable", {"params": _tree(9), "aux": _aux(9)}),  # second: ignored
        ("GetAux", {}),
        ("GetModel", {"version": -1, "method": "minimum"}),
        ("GetModel", {"version": -1, "method": "minimum", "flat": True}),
        ("ReportGradient", {"worker_id": 0, "version": 0, "gradient_flat": g(1),
                            "aux_state": _aux(2), "return_model": True}),
        ("GetAux", {}),
        ("ReportGradient", {"worker_id": 1, "version": 0, "gradient_flat": g(2),
                            "aux_state": _aux(3), "return_model": True}),
        ("GetAux", {}),
        ("ReportGradient", {"worker_id": 0, "version": 0, "gradient_flat": g(3),
                            "aux_state": _aux(4), "return_model": True}),
        ("ReportGradient", {"worker_id": 0, "version": 1, "gradient_flat": g(4),
                            "aux_state": None, "return_model": True}),
        ("ReportGradient", {"worker_id": 1, "version": 1, "gradient_flat": g(5),
                            "aux_state": None, "return_model": True}),
        ("GetModel", {"version": 1, "method": "minimum", "only_if_newer": True}),
        ("ReportLocalUpdate", {"delta_flat": g(6), "steps": 3, "base_version": 2,
                               "report_key": "t1.w0", "aux_state": _aux(5)}),
        ("ReportLocalUpdate", {"delta_flat": g(6), "steps": 3, "base_version": 2,
                               "report_key": "t1.w0", "aux_state": _aux(5)}),
        ("ReportLocalUpdate", {"delta_flat": g(7), "steps": 2, "base_version": 2,
                               "report_key": "t2.w0", "aux_state": None}),
        ("ReportLocalUpdate", {"delta_flat": g(8), "steps": 1, "base_version": 7,
                               "report_key": "t3.w0", "aux_state": _aux(6),
                               "want_model": True}),
        ("GetAux", {}),
        ("GetModel", {"version": -1, "method": "minimum", "flat": True}),
    ]


def _same(got, want, where):
    """Equal bit for bit: arrays by bytes, trees leaf by leaf, scalars by value."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            _same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (np.ndarray, np.generic)) or hasattr(want, "__array__"):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert got.tobytes() == want.tobytes(), where
    else:
        assert got == want, where


def test_servicer_aux_plane_matches_the_reference_bit_for_bit():
    """Every response of the sequence: params, aux and version equal the
    reference servicer's, bit for bit (both over the wire codec, no
    optimizer: the version bumps and the aux plane are the servicers'
    own); the exactness block and the final model and aux too."""
    params = _tree(0)
    ref = JServicer(2)
    port = InProcessMaster(MasterServicer(2))
    for i, (method, req) in enumerate(_aux_calls(params)):
        want = ref.handlers()[method](messages.unpack(messages.pack(req)))
        got = port.call(method, req)
        want = messages.unpack(messages.pack(want))
        _same(got, want, f"call {i} {method}")
    assert port.servicer.exactness() == {
        "version": ref._version, "init_version": 0,
        "applied_update_steps": ref._applied_update_steps,
    }
    for got, want in zip(port.servicer.get_params_copy(), ref.get_params_copy()):
        _same(got, want, "final")


def test_checkpoint_and_init_aux_carry_the_aux(tmp_path):
    """`init_aux` seeds the PS's aux; the final model file holds it."""
    from elasticdl_tpu_torch.master.checkpoint import load_model_file

    serv = MasterServicer(1, init_params=_tree(0), init_aux=_aux(1))
    serv.report_local_update({"delta_flat": _flat(_tree(1, 1e-2)), "steps": 2,
                              "base_version": 0, "aux_state": _aux(2)})
    path = str(tmp_path / "final.ckpt")
    serv.save_latest_checkpoint(path)
    model = load_model_file(path)
    assert model.version == 2
    _same(model.aux, _aux(2), "aux")
    _same(serv.get_aux({})["aux"], _aux(2), "GetAux")


def test_image_codec_and_writer_are_the_references_byte_for_byte(tmp_path):
    ours, theirs = str(tmp_path / "t.rio"), str(tmp_path / "j.rio")
    trc.write_synthetic_image_records(ours, 24, (32, 32, 3), 10, seed=4)
    jrc.write_synthetic_image_records(theirs, 24, (32, 32, 3), 10, seed=4)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    img = np.random.default_rng(0).integers(0, 256, (28, 28, 1)).astype(np.uint8)
    rec = trc.encode_image_record(img, 7)
    assert rec == jrc.encode_image_record(img, 7)
    decoded = {}
    for scale in (True, False):
        got = trc.decode_image_records([rec, rec], (28, 28, 1), scale=scale)
        want = jrc.decode_image_records([rec, rec], (28, 28, 1), scale=scale)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        decoded[scale] = got[0]
    # normalizing the uint8 on the device gives the host's float32 decode
    # bit for bit, as the reference's does
    x = torch.from_numpy(decoded[False])
    assert trc.normalize_on_device(x).numpy().tobytes() == decoded[True].tobytes()
    assert np.asarray(jrc.normalize_on_device(jnp.asarray(decoded[False]))).tobytes() == (
        decoded[True].tobytes())


def test_prepare_data_for_a_single_file_is_the_references(tmp_path):
    rng = np.random.default_rng(5)
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        for i, label in enumerate((3, 0, 7, 3)):
            arr = io.BytesIO()
            np.save(arr, rng.integers(0, 256, (16, 16, 3)).astype(np.uint8))
            info = tarfile.TarInfo(f"{label}/img{i}.npy")
            info.size = arr.tell()
            arr.seek(0)
            tar.addfile(info, arr)
        readme = tarfile.TarInfo("README.txt")
        readme.size = 2
        tar.addfile(readme, io.BytesIO(b"hi"))
    data = buf.getvalue()
    got = timagenet.prepare_data_for_a_single_file(io.BytesIO(data), "x.tar.gz")
    want = jimagenet.prepare_data_for_a_single_file(io.BytesIO(data), "x.tar.gz")
    assert len(got) == 4 and got == want
    images, labels = trc.decode_image_records(got, (16, 16, 3), scale=False)
    assert labels.tolist() == [3, 0, 7, 3] and images.dtype == np.uint8


def test_images_reach_the_model_as_uint8_and_tokens_as_int64(tmp_path):
    """The worker widens only signed integers: a CIFAR minibatch reaches
    the model as uint8 NHWC (its labels int64), the transformer's int32
    token ids as int64."""
    seen = []

    def spy(model):
        model.register_forward_pre_hook(
            lambda _m, args: seen.append((args[0].dtype, tuple(args[0].shape))))
        return model

    path = str(tmp_path / "img.rio")
    trc.write_synthetic_image_records(path, 8, tcifar.IMAGE_SHAPE, 10, seed=0)
    tok = str(tmp_path / "tok.rio")
    trc.write_learnable_token_records(tok, 8, 16, 64, seed=0)
    for rec, module, model in ((path, tcifar, tcifar.custom_model()),
                               (tok, tzoo, tzoo.custom_model(vocab=64))):
        dispatcher = TaskDispatcher({rec: 8}, {}, {}, 8, 1, shuffle_seed=0)
        spec = spec_from_module(module, model=spy(model))
        servicer, _eval, _ckpt = build_job(spec, dispatcher, 1)
        worker = Worker(0, InProcessMaster(servicer), spec, minibatch_size=4, device="cpu")
        assert worker.run()
        worker.close()
    assert seen == [(torch.uint8, (4, 32, 32, 3))] * 2 + [(torch.int64, (4, 16))] * 2


def test_lazy_init_offers_the_models_aux_and_every_step_reports_its_new_stats(tmp_path):
    """No init at the PS: the first ReportVariable carries the model's
    `init_aux()` (flax's: mean 0, var 1); each ReportGradient carries the
    step's new batch stats, which the piggybacked model brings back."""
    reqs = []
    path = str(tmp_path / "img.rio")
    trc.write_synthetic_image_records(path, 16, tcifar.IMAGE_SHAPE, 10, seed=1)
    dispatcher = TaskDispatcher({path: 16}, {}, {}, 8, 1, shuffle_seed=0)
    spec = spec_from_module(tcifar)
    servicer, _eval, _ckpt = build_job(spec, dispatcher, 1)
    record = lambda req: reqs.append(req) or req  # noqa: E731
    master = InProcessMaster(servicer, intercept={"ReportVariable": record,
                                                  "ReportGradient": record})
    worker = Worker(0, master, spec, minibatch_size=4, device="cpu")
    assert worker.run()
    worker.close()
    init = spec.model.init_aux()
    _same(reqs[0]["aux"], init, "ReportVariable aux")
    reported = [r["aux_state"] for r in reqs[1:]]
    assert len(reported) == 4
    _same(servicer.get_aux({})["aux"], reported[-1], "PS aux")
    assert not np.array_equal(_flat(reported[0]), _flat(init))
    # the worker's buffers hold the PS's aux after each piggybacked model
    # the pull after init, then each step's piggybacked model
    assert worker.aux_absorbed == {"GetModel": 1, "ReportGradient": 4}
    assert worker._aux_flat.numpy().tobytes() == _flat(reported[-1]).tobytes()


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_eval_metrics_fn_is_the_references(name):
    """The zoo's accuracy metric on the same predictions and labels (a
    tie at the argmax goes to the first class in both), and mnist's
    prediction sink."""
    jmod, tmod = OPTIMIZERS[name]
    rng = np.random.default_rng(3)
    preds = rng.standard_normal((32, 10)).astype(np.float32)
    preds[0, :] = 1.0
    labels = rng.integers(0, 10, 32)
    got = tmod.eval_metrics_fn(torch.from_numpy(preds), torch.from_numpy(labels))
    want = jmod.eval_metrics_fn(jnp.asarray(preds), jnp.asarray(labels))
    assert float(got["accuracy"]) == float(want["accuracy"])
    if name == "mnist_functional_api":
        sink, jsink = tmod.PredictionOutputsProcessor(), jmod.PredictionOutputsProcessor()
        sink.process(preds, 2)
        jsink.process(preds, 2)
        assert [(w, p.tolist()) for w, p in sink.outputs] == [
            (w, p.tolist()) for w, p in jsink.outputs]

"""The async PS and the staleness rules of the port's servicer against
the reference's, and the job-kind flags.

The reference's `tests/test_servicer_modes.py` cases (async apply, the
1/staleness gradient scale, the sync staleness window, the stale
rejection's piggybacked model, the delta down-weighting) run as the same
report sequences into both servicers, under SGD momentum and clip +
Adam: the versions and exactness blocks are equal, the params float32
allclose at 1e-6 (`OPT`: optax under XLA against the same formulas in
torch), and every response's accepted flag and version equal.
"""

import threading

import numpy as np
import optax
import pytest

from elasticdl_tpu.common import args as jargs
from elasticdl_tpu.common import codec as jcodec
from elasticdl_tpu.master.ps_optimizer import PSOptimizer as JPSOptimizer
from elasticdl_tpu.master.servicer import MasterServicer as JServicer
from elasticdl_tpu_torch.api.model_spec_helpers import spec_from_module
from elasticdl_tpu_torch.common import args as targs
from elasticdl_tpu_torch.common import codec
from elasticdl_tpu_torch.master.ps_optimizer import ClipAdam, PSOptimizer, Sgd
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.models import transformer_lm_zoo as tzoo
from elasticdl_tpu_torch.models.record_codec import write_learnable_token_records
from elasticdl_tpu_torch.testing import InProcessMaster, build_job
from elasticdl_tpu_torch.worker.worker import Worker
from _torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

OPT = dict(atol=1e-6, rtol=1e-6)
OPTIMIZERS = {
    "sgd_momentum": (lambda: optax.sgd(0.5, momentum=0.9), lambda: Sgd(0.5, momentum=0.9)),
    "clip_adam": (
        lambda: optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3)),
        lambda: ClipAdam(max_norm=1.0, learning_rate=1e-3),
    ),
}
SHAPES = {"b": (3,), "w": (2, 3)}
N = 9


def _init():
    rng = np.random.default_rng(0)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}


def _grad(i, scale=1.0):
    return (np.random.default_rng(100 + i).standard_normal(N) * scale).astype(np.float32)


def _pair(opt, **kw):
    jopt, topt = OPTIMIZERS[opt]
    ref = JServicer(grads_to_wait=kw.pop("grads_to_wait", 1), optimizer=JPSOptimizer(jopt()),
                    init_params=_init(), **kw)
    port = MasterServicer(grads_to_wait=ref._grads_to_wait, optimizer=PSOptimizer(topt()),
                          init_params=_init(), **kw)
    return ref, port


def _grad_req(version, i, scale=1.0, **extra):
    return {"worker_id": i % 2, "version": version, "gradient_flat": _grad(i, scale),
            "loss": 0.5, **extra}


def _delta_req(base, i, steps, key):
    return {"delta_flat": _grad(i, 1e-2), "steps": steps, "base_version": base,
            "report_key": key}


# (servicer settings, [(method, request)]) of the reference's cases
CASES = {
    "async_applies_every_report": (
        dict(use_async=True),
        [("g", (0, 0)), ("g", (1, 1)), ("g", (2, 2)), ("g", (0, 3)), ("g", (1, 4))],
    ),
    "async_scales_the_gradient_by_one_over_staleness": (
        dict(use_async=True, lr_staleness_modulation=True),
        # staleness 0, 0, 2 (scale 1/2), 1 (scale 1), 4 (scale 1/4)
        [("g", (0, 0)), ("g", (1, 1)), ("g", (0, 2)), ("g", (2, 3)), ("g", (0, 4))],
    ),
    "sync_staleness_window_accepts_slightly_stale": (
        dict(staleness_window=1),
        # v0 applied; stale 1 accepted; stale 2 rejected; fresh applied
        [("g", (0, 0)), ("g", (0, 1)), ("g", (0, 2)), ("g", (2, 3))],
    ),
    "sync_window_with_two_reports_a_step": (
        dict(staleness_window=1, grads_to_wait=2),
        [("g", (0, 0)), ("g", (0, 1)), ("g", (0, 2)), ("g", (1, 3)), ("g", (0, 4)),
         ("g", (1, 5))],
    ),
    "stale_rejection_piggybacks_the_model": (
        dict(),
        [("g", (0, 0)), ("gm", (0, 1)), ("gm", (1, 2))],
    ),
    "delta_down_weighted_beyond_the_window": (
        dict(staleness_window=2),
        # the PS advances 4 by one sync; a delta based at 0 (staleness 4
        # > window 2) lands at scale 1/2; one within the window at 1
        [("d", (0, 0, 4, "a")), ("d", (0, 1, 1, "b")), ("d", (4, 2, 2, "c")),
         ("d", (0, 3, 3, "d"))],
    ),
    "delta_at_full_weight_without_a_window": (
        dict(),
        [("d", (0, 0, 4, "a")), ("d", (0, 1, 1, "b")), ("d", (0, 1, 1, "b"))],
    ),
}


def _send(servicer, kind, args):
    if kind == "d":
        return servicer.report_local_update(_delta_req(*args))
    version, i = args
    extra = {"return_model": True} if kind == "gm" else {}
    return servicer.report_gradient(_grad_req(version, i, **extra))


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
@pytest.mark.parametrize("case", list(CASES))
def test_report_sequences_match_the_reference(case, opt):
    settings, seq = CASES[case]
    ref, port = _pair(opt, **settings)
    for kind, args in seq:
        want, got = _send(ref, kind, args), _send(port, kind, args)
        for key in ("accepted", "version", "duplicate"):
            assert got.get(key) == want.get(key), (kind, args, key)
        if "params_flat" in want:
            np.testing.assert_allclose(got["params_flat"], want["params_flat"], **OPT)
    jparams, _jaux, jversion = ref.get_params_copy()
    params, _aux, version = port.get_params_copy()
    assert version == jversion
    assert port.exactness() == {"version": jversion, "init_version": ref._init_version,
                                "applied_update_steps": ref._applied_update_steps}
    np.testing.assert_allclose(codec.ravel_np(params), jcodec.ravel_np(jparams), **OPT)
    assert not np.array_equal(codec.ravel_np(params), codec.ravel_np(_init()))


def test_async_modulation_scales_the_gradient_not_the_learning_rate():
    """The reference's quirk, kept: under SGD the 1/staleness scale
    halves the step of a report 2 versions behind; under Adam the scale
    mostly cancels (the moments see the scaled gradient)."""
    ref, port = _pair("sgd_momentum", use_async=True, lr_staleness_modulation=True)
    plain_ref, plain = _pair("sgd_momentum", use_async=True)
    for s in (ref, port, plain_ref, plain):
        s.report_gradient(_grad_req(0, 0))
        s.report_gradient(_grad_req(1, 1))
    before = codec.ravel_np(port.get_params_copy()[0])
    port.report_gradient(_grad_req(0, 2))
    plain.report_gradient(_grad_req(0, 2))
    ref.report_gradient(_grad_req(0, 2))
    # SGD momentum 0.9 at lr 0.5: the new trace is 0.9 * trace + g / 2
    step = codec.ravel_np(port.get_params_copy()[0]) - before
    plain_step = codec.ravel_np(plain.get_params_copy()[0]) - before
    np.testing.assert_allclose(plain_step - step, -0.5 * _grad(2) * 0.5, **OPT)
    np.testing.assert_allclose(codec.ravel_np(port.get_params_copy()[0]),
                               jcodec.ravel_np(ref.get_params_copy()[0]), **OPT)


def test_future_gradient_raises_in_both_modes():
    for settings in (dict(), dict(use_async=True)):
        _ref, port = _pair("sgd_momentum", **settings)
        with pytest.raises(ValueError, match="future gradient"):
            port.report_gradient(_grad_req(3, 0))
        assert port.exactness()["applied_update_steps"] == 0


TINY = dict(vocab=16, d_model=16, n_heads=2, d_ff=32, n_layers=1)


def test_two_async_workers_in_threads_converge(tmp_path):
    """Two port workers in threads over one async servicer with
    staleness modulation: every report is applied once (version = the
    steps both accepted, none rejected), and the loss falls."""
    path = str(tmp_path / "tokens.rio")
    write_learnable_token_records(path, 256, 16, TINY["vocab"], seed=0)
    dispatcher = TaskDispatcher({path: 256}, {}, {}, 32, 2, shuffle_seed=0)
    specs = [spec_from_module(tzoo, model=tzoo.custom_model(**TINY)) for _ in range(2)]
    servicer, _eval, _ckpt = build_job(specs[0], dispatcher, use_async=True,
                                       lr_staleness_modulation=True)
    master = InProcessMaster(servicer)
    workers = [Worker(i, master, specs[i], minibatch_size=8, device="cpu", seed=i)
               for i in range(2)]
    threads = [threading.Thread(target=w.run) for w in workers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert dispatcher.finished()
    steps = 2 * 256 // 8
    assert servicer.exactness() == {"version": steps, "init_version": 0,
                                    "applied_update_steps": steps}
    assert sum(w.steps_accepted for w in workers) == steps
    assert all(w.steps_computed == w.steps_accepted for w in workers)
    losses = sorted((t, loss) for w in workers for t, loss in w.step_log)
    first = np.mean([loss for _t, loss in losses[:8]])
    last = np.mean([loss for _t, loss in losses[-8:]])
    assert np.isfinite(last) and last < first - 0.3, (first, last)


SPEC_ARGV = ["--model_zoo", "z", "--model_def", "m.custom_model", "--minibatch_size", "4"]
JOB_KINDS = [
    ["--training_data_dir", "t"],
    ["--training_data_dir", "t", "--evaluation_data_dir", "e"],
    ["--evaluation_data_dir", "e"],
    ["--evaluation_data_dir", "e", "--checkpoint_filename_for_init", "c"],
    ["--prediction_data_dir", "p"],
    ["--prediction_data_dir", "p", "--checkpoint_filename_for_init", "c"],
    ["--prediction_data_dir", "p", "--training_data_dir", "t",
     "--checkpoint_filename_for_init", "c"],
    ["--prediction_data_dir", "p", "--evaluation_data_dir", "e"],
    [],
]


@pytest.mark.parametrize("argv", JOB_KINDS, ids=lambda a: "_".join(a[::2]) or "none")
def test_job_kind_validation_matches_the_reference(argv):
    flags = ["--use_async", "--lr_staleness_modulation", "--staleness_window", "2",
             "--eval_steps", "3", "--checkpoint_steps", "5", "--keep_checkpoint_max", "2",
             "--tensorboard_log_dir", "tb"]
    port = targs.master_parser().parse_args(SPEC_ARGV + flags + argv)
    ref = jargs.master_parser().parse_args(SPEC_ARGV + flags + argv)
    for dest, value in vars(port).items():
        if dest != "device":
            assert value == getattr(ref, dest), dest
    try:
        want = jargs.validate_master_args(ref)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            targs.validate_master_args(port)
        assert str(got.value) == str(e)
    else:
        assert targs.validate_master_args(port) == want


def test_the_spec_flags_reach_the_workers():
    args = targs.master_parser().parse_args(
        SPEC_ARGV + ["--training_data_dir", "t", "--prediction_outputs_processor", "P",
                     "--eval_metrics_fn", "metrics"])
    argv = targs.worker_forward_args(args, 0, "localhost:1")
    worker = targs.worker_parser().parse_args(argv)
    assert (worker.prediction_outputs_processor, worker.eval_metrics_fn) == ("P", "metrics")

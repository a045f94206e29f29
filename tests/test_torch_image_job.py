"""The image zoo's training jobs on the CPU: an in-process job of the
port (master/PS + worker) against the reference's, from the reference's
own init (params and batch_stats) over the same synthetic image records
in the same task order, per-step and in window mode (W = 2, float32
syncs); and the headline model in process mode, whose BatchNorm
statistics come back to the workers through GetModel frames.

Versions are equal exactly. Final parameters and batch statistics agree
within 1e-5 absolute (measured at most 1e-6 and 5e-7 after 4 updates:
float32 gradients from two frameworks differ in summation order; the
updates move the parameters by 1e-4 (cifar's warmup) to 0.3 (mnist)),
task losses within 1e-5 relative (measured 4.6e-6).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from elasticdl_tpu.api.model_spec_helpers import spec_from_module as jspec_from_module  # noqa: E402
from elasticdl_tpu.common import codec as jcodec  # noqa: E402
from elasticdl_tpu.master.ps_optimizer import PSOptimizer as JPSOptimizer  # noqa: E402
from elasticdl_tpu.master.servicer import MasterServicer as JServicer  # noqa: E402
from elasticdl_tpu.master.task_dispatcher import TaskDispatcher as JDispatcher  # noqa: E402
from elasticdl_tpu.models import cifar10_functional_api as jcifar  # noqa: E402
from elasticdl_tpu.models import mnist_functional_api as jmnist  # noqa: E402
from elasticdl_tpu.testing import InProcessMaster as JInProcessMaster  # noqa: E402
from elasticdl_tpu.worker.worker import Worker as JWorker  # noqa: E402
from elasticdl_tpu_torch.api.model_spec_helpers import spec_from_module  # noqa: E402
from elasticdl_tpu_torch.common import codec  # noqa: E402
from elasticdl_tpu_torch.convert import variables_from_jax  # noqa: E402
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher  # noqa: E402
from elasticdl_tpu_torch.models import cifar10_functional_api as tcifar  # noqa: E402
from elasticdl_tpu_torch.models import mnist_functional_api as tmnist  # noqa: E402
from elasticdl_tpu_torch.models.record_codec import write_synthetic_image_records  # noqa: E402
from elasticdl_tpu_torch.testing import InProcessMaster, build_job  # noqa: E402
from elasticdl_tpu_torch.worker.worker import Worker  # noqa: E402
from _torch_threads import two_torch_threads  # noqa: E402,F401 (autouse fixture)

RECORDS, PER_TASK, BATCH = 64, 32, 16
STEPS = RECORDS // BATCH
TOL = 1e-5
MODELS = {"mnist_functional_api": (jmnist, tmnist), "cifar10_functional_api": (jcifar, tcifar)}
MODES = {"per-step": {}, "window": dict(local_updates=2, sync_dtype="float32")}


def _reference_init(jmod):
    x = np.zeros((1,) + jmod.IMAGE_SHAPE, np.uint8)
    model = jmod.custom_model()
    kw = {"train": False} if jmod is jcifar else {}
    xin = x if kw else x.astype(np.float32)
    v = jax.jit(lambda x: model.init(jax.random.PRNGKey(3), x, **kw))(xin)
    return variables_from_jax(jax.tree_util.tree_map(np.asarray, v))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", list(MODELS))
def test_image_job_matches_the_reference_job(tmp_path, name, mode):
    jmod, tmod = MODELS[name]
    path = str(tmp_path / "images.rio")
    write_synthetic_image_records(path, RECORDS, jmod.IMAGE_SHAPE, 10, seed=2)
    params, aux = _reference_init(jmod)
    init_aux = aux or None

    jdispatcher = JDispatcher({path: RECORDS}, {}, {}, PER_TASK, 1, shuffle_seed=3)
    jservicer = JServicer(1, JPSOptimizer(jmod.optimizer()), task_dispatcher=jdispatcher,
                          init_params=params, init_aux=init_aux)
    jworker = JWorker(0, JInProcessMaster(jservicer), jspec_from_module(jmod),
                      minibatch_size=BATCH, **MODES[mode])
    assert jworker.run()
    jworker.close()
    jparams, jaux, jversion = jservicer.get_params_copy()

    dispatcher = TaskDispatcher({path: RECORDS}, {}, {}, PER_TASK, 1, shuffle_seed=3)
    spec = spec_from_module(tmod)
    servicer, _eval, _ckpt = build_job(spec, dispatcher, 1, init_params=params, init_aux=init_aux)
    worker = Worker(0, InProcessMaster(servicer), spec, minibatch_size=BATCH, device="cpu",
                    **MODES[mode])
    assert worker.run()
    worker.close()
    tparams, taux, version = servicer.get_params_copy()

    assert version == jversion == STEPS
    assert servicer.exactness() == {"version": STEPS, "init_version": 0,
                                    "applied_update_steps": STEPS}
    assert worker.steps_computed == worker.steps_accepted == STEPS
    np.testing.assert_allclose(codec.ravel_np(tparams), jcodec.ravel_np(jparams), atol=TOL, rtol=0)
    assert not np.array_equal(codec.ravel_np(tparams), codec.ravel_np(params))
    np.testing.assert_allclose(worker.task_losses, jworker.task_losses, rtol=TOL, atol=0)
    if aux:
        np.testing.assert_allclose(codec.ravel_np(taux), jcodec.ravel_np(jaux), atol=TOL, rtol=0)
        assert not np.array_equal(codec.ravel_np(taux), codec.ravel_np(aux))
        # the worker's buffers hold the statistics it last synced or absorbed
        np.testing.assert_array_equal(worker._aux_flat.numpy(), codec.ravel_np(taux))
    else:
        assert taux is None and jaux is None


def test_cifar_process_job_brings_the_batch_stats_back_through_get_model(tmp_path, monkeypatch):
    """`python -m elasticdl_tpu_torch.master.main --model_def
    cifar10_functional_api.custom_model --worker_backend process` (the
    port's zoo by default), 2 workers per-step on the CPU: exit 0, every
    step applied once, the final model file holds batch statistics moved
    from flax's init, every worker that trained absorbed the PS's
    statistics from its GetModel responses, and one worker absorbed them
    from both its GetModel and its ReportGradient responses. A worker
    pulls the model only when it takes a task: on a loaded machine one
    worker can start after the other took all 4 tasks, and it then
    trains nothing and pulls nothing."""
    from elasticdl_tpu_torch.common.constants import ENV_WORKER_LOG_DIR
    from elasticdl_tpu_torch.master import main as master_main
    from elasticdl_tpu_torch.master.checkpoint import load_model_file
    from elasticdl_tpu_torch.worker.main import read_summaries

    data = tmp_path / "data"
    data.mkdir()
    for i in range(2):
        write_synthetic_image_records(str(data / f"shard-{i}.rio"), 32, tcifar.IMAGE_SHAPE, 10,
                                      seed=i)
    log_dir = str(tmp_path / "logs")
    monkeypatch.setenv(ENV_WORKER_LOG_DIR, log_dir)
    output = str(tmp_path / "final.ckpt")
    rc, summary = master_main.run([
        "--model_def", "cifar10_functional_api.custom_model", "--minibatch_size", "8",
        "--training_data_dir", str(data), "--records_per_task", "16", "--num_epochs", "1",
        "--grads_to_wait", "1", "--num_workers", "2", "--worker_backend", "process",
        "--device", "cpu", "--envs", "OMP_NUM_THREADS=2", "--output", output,
    ])
    assert rc == 0
    steps = 2 * 32 // 8
    assert summary["version"] == summary["applied_update_steps"] == steps
    model = load_model_file(output)
    init = tcifar.custom_model().init_aux()
    assert codec.tree_paths(model.aux) == codec.tree_paths(init)
    assert not np.array_equal(codec.ravel_np(model.aux), codec.ravel_np(init))
    summaries = read_summaries(log_dir)
    assert sorted(summaries) == [0, 1]
    assert sum(s["steps_accepted"] for s in summaries.values()) == steps
    absorbed = {wid: s["aux_absorbed"] for wid, s in summaries.items()}
    trained = [wid for wid, s in summaries.items() if s["steps_accepted"] > 0]
    assert trained and all(absorbed[wid].get("GetModel", 0) > 0 for wid in trained), absorbed
    assert any(a.get("GetModel", 0) > 0 and a.get("ReportGradient", 0) > 0
               for a in absorbed.values()), absorbed

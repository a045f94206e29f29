"""The port's training slice as a whole, on the CPU: an in-process job of
the port (master/PS + worker) against the reference's, from the same
initial parameters over the same records in the same task order; and
the port's isolation from the reference package.

Final parameters agree within 1e-4 absolute (measured 3.5e-6 after 4
Adam steps that move them by up to 4e-3: float32 gradients from two
frameworks differ in summation order, and Adam amplifies a difference
where |g| is tiny), task losses within 1e-5; versions are equal exactly.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

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
from elasticdl_tpu_torch.common import codec as tcodec
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.models import transformer_lm_zoo as tzoo
from elasticdl_tpu_torch.models.record_codec import write_learnable_token_records
from elasticdl_tpu_torch.testing import InProcessMaster, build_job
from elasticdl_tpu_torch.worker.worker import Worker
from _torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, SEQ, RECORDS, PER_TASK, BATCH = 64, 128, 64, 32, 16
STEPS = RECORDS // BATCH


@pytest.fixture
def records(tmp_path):
    path = str(tmp_path / "tokens.rio")
    write_learnable_token_records(path, RECORDS, SEQ, VOCAB, seed=2)
    return path


def _port_job(path, init_params=None, intercept=None):
    dispatcher = TaskDispatcher({path: RECORDS}, {}, {}, PER_TASK, 1, shuffle_seed=3)
    spec = spec_from_module(tzoo, model=tzoo.custom_model(vocab=VOCAB))
    servicer, _eval, _ckpt = build_job(spec, dispatcher, grads_to_wait=1, init_params=init_params)
    master = InProcessMaster(servicer, intercept=intercept)
    worker = Worker(0, master, spec, minibatch_size=BATCH, device="cpu")
    assert worker.run()
    worker.close()
    assert dispatcher.finished()
    return servicer, worker, master


def test_port_job_matches_reference_job(records):
    init = jtlm.init_params(
        np.random.default_rng(11), jzoo.custom_model(vocab=VOCAB).cfg
    )
    jdispatcher = JDispatcher({records: RECORDS}, {}, {}, PER_TASK, 1, shuffle_seed=3)
    jspec = jspec_from_module(jzoo, model=jzoo.custom_model(vocab=VOCAB))
    jservicer = JServicer(
        grads_to_wait=1,
        optimizer=JPSOptimizer(jzoo.optimizer()),
        task_dispatcher=jdispatcher,
        init_params=init,
    )
    jworker = JWorker(0, JInProcessMaster(jservicer), jspec, minibatch_size=BATCH)
    assert jworker.run()
    jworker.close()
    jparams, _aux, jversion = jservicer.get_params_copy()

    servicer, worker, _ = _port_job(records, init_params=init)
    params, _aux, version = servicer.get_params_copy()
    assert version == jversion == STEPS
    assert servicer.exactness()["applied_update_steps"] == STEPS
    np.testing.assert_allclose(
        tcodec.ravel_np(params), jcodec.ravel_np(jparams), atol=1e-4, rtol=0
    )
    np.testing.assert_allclose(worker.task_losses, jworker.task_losses, atol=1e-5)
    # the worker absorbed the final model into its flat buffer
    assert np.array_equal(worker._flat.numpy(), tcodec.ravel_np(params))


def test_two_workers_of_one_spec_bind_parameters_of_their_own(records):
    """Two in-process Workers handed one spec, as the reference's
    in-process workers share theirs: each binds a module of its own, so
    neither computes with the other's flat buffer (a sharded boot's
    buffer is uninitialized until its pull fills it), and each runs on
    the values it was given."""
    dispatcher = TaskDispatcher({records: RECORDS}, {}, {}, PER_TASK, 1, shuffle_seed=3)
    spec = spec_from_module(tzoo, model=tzoo.custom_model(vocab=VOCAB))
    servicer, _eval, _ckpt = build_job(spec, dispatcher, grads_to_wait=1)
    master = InProcessMaster(servicer)
    a, b = (Worker(i, master, spec, minibatch_size=BATCH, device="cpu") for i in range(2))
    try:
        assert a._model is spec.model and b._model is not spec.model
        tree_a, tree_b = spec.model.init_params(0), spec.model.init_params(1)
        a._init_flat_from_tree(tree_a)
        b._init_flat_from_tree(tree_b)
        for worker, tree in ((a, tree_a), (b, tree_b)):
            bound = np.concatenate([p.detach().numpy().ravel() for p in worker._params])
            assert bound.tobytes() == tcodec.ravel_np(tree).tobytes()
            assert all(p.data_ptr() >= worker._flat.data_ptr() for p in worker._params)
    finally:
        a.close()
        b.close()


def test_lazy_init_offers_the_reference_init_and_retries_stale_reports(records):
    """No init at the PS: the worker's ReportVariable carries the
    reference's init for seed + worker id, bit for bit. A report forced
    stale is rejected, and the recomputed minibatch lands: the versions
    stay exact."""
    offered, forced = [], []

    def capture(req):
        offered.append(req["params"])
        return req

    def stale_once(req):
        if not forced:
            forced.append(req["version"])
            req["version"] -= 1
        return req

    servicer, _worker, master = _port_job(
        records, intercept={"ReportVariable": capture, "ReportGradient": stale_once}
    )
    want = jtlm.init_params(np.random.default_rng(0), jzoo.custom_model(vocab=VOCAB).cfg)
    assert tcodec.ravel_np(offered[0]).tobytes() == jcodec.ravel_np(want).tobytes()
    assert master.calls["ReportGradient"] == STEPS + 1
    assert servicer.exactness() == {
        "version": STEPS, "init_version": 0, "applied_update_steps": STEPS
    }


def _port_files():
    root = os.path.join(REPO, "elasticdl_tpu_torch")
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


# the reference, and the packages the card's machine is not promised to
# have: the port's RPC plane is the stdlib's socket module
BANNED = (
    "jax", "jaxlib", "flax", "optax", "elasticdl_tpu", "grpc", "msgpack", "ml_dtypes"
)


def test_port_sources_import_nothing_of_jax_or_the_reference():
    """Every import statement, top level or inside a function."""
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in BANNED, f"{path} imports {name}"


def test_the_audit_covers_the_overlap_plane_modules():
    """The overlap plane's modules (the adaptive policy, the link
    estimate, the pipelined worker, the sharded client's async pull)
    are among the audited files, and import nothing of JAX or the
    reference."""
    audited = {os.path.relpath(p, REPO) for p in _port_files()}
    for rel in ("common/sync_policy.py", "common/linkprobe.py", "common/args.py",
                "worker/worker.py", "worker/main.py", "rpc/ps_client.py"):
        assert os.path.join("elasticdl_tpu_torch", rel) in audited, rel
    from elasticdl_tpu_torch.common import linkprobe, sync_policy

    for mod in (sync_policy, linkprobe):
        with open(mod.__file__) as f:
            tree = ast.parse(f.read())
        names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names}
        names |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.level == 0}
        assert names <= {"__future__", "threading", "collections", "typing"}, names


def test_the_audit_covers_the_fault_plane_modules():
    """The fault-injection plane's module and the modules that carry it
    (the policy, the tiers, the client and server, the spawners, the
    fence) are among the audited files; `rpc/chaos.py` imports only the
    standard library and the port's own modules."""
    audited = {os.path.relpath(p, REPO) for p in _port_files()}
    for rel in ("rpc/chaos.py", "rpc/policy.py", "rpc/transport.py", "rpc/client.py",
                "rpc/server.py", "rpc/fencing.py", "cluster/pod_backend.py",
                "master/shard_host.py", "master/worker_manager.py", "common/constants.py",
                "obs/metrics.py", "obs/flight.py"):
        assert os.path.join("elasticdl_tpu_torch", rel) in audited, rel
    from elasticdl_tpu_torch.rpc import chaos

    with open(chaos.__file__) as f:
        tree = ast.parse(f.read())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert names <= {"__future__", "hashlib", "json", "os", "threading", "time",
                     "dataclasses", "typing", "elasticdl_tpu_torch"}, names


def test_port_modules_import_with_jax_and_the_reference_unimportable():
    """A fresh interpreter (conftest imports jax into this one) with
    every BANNED package made unimportable imports every port module
    (the rpc, cluster and entry-point modules included) and chip_smoke."""
    code = (
        "import sys\n"
        f"for name in {BANNED!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib, pkgutil\n"
        "import elasticdl_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'elasticdl_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "print(len(mods))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30


def test_get_model_spec_loads_the_zoo_by_model_def():
    """`--model_def` strings of the reference's zoo load the port's
    module; model_params parse as literals (dtype by name)."""
    import torch

    from elasticdl_tpu_torch.api.model_spec import get_model_spec

    zoo_dir = os.path.join(REPO, "elasticdl_tpu_torch", "models")
    spec = get_model_spec(
        zoo_dir, "transformer_lm_zoo.custom_model", "vocab=96,n_layers=3,dtype=bfloat16"
    )
    cfg = spec.model.cfg
    assert (cfg.vocab, cfg.n_layers, cfg.dtype) == (96, 3, torch.bfloat16)
    tree = spec.model.init_params(0)
    names = [".".join(p) for p in tcodec.tree_paths(tree)]
    assert sorted(n for n, _ in spec.model.named_parameters()) == sorted(names)
    assert spec.optimizer() == tzoo.optimizer()
    with pytest.raises(FileNotFoundError):
        get_model_spec(zoo_dir, "no_such_module.custom_model")

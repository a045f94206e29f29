"""The port's process mode on the CPU: `master.main` spawns
`python -m elasticdl_tpu_torch.worker.main` subprocesses (`--device
cpu`) that train the small zoo transformer (vocab 64, seq 128, 2
layers, width 64) over the TCP transport.

One worker's job ends with the in-process port job's parameters bit for
bit: both run torch on two threads (`--envs OMP_NUM_THREADS=2`, the
test fixture), from the same lazy init (seed 0 + worker 0), over one
task per epoch (so the dispatcher's unseeded epoch shuffle cannot
reorder them). The in-process job is held against the JAX job in
tests/test_torch_job.py. The worker manager is held against the
reference's on the same pod events.
"""

import logging
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from elasticdl_tpu.cluster import pod_backend as jpod
from elasticdl_tpu.master.worker_manager import WorkerManager as JWorkerManager
from elasticdl_tpu_torch.api.model_spec_helpers import spec_from_module
from elasticdl_tpu_torch.cluster import pod_backend as tpod
from elasticdl_tpu_torch.common import codec
from elasticdl_tpu_torch.common.args import master_parser, worker_forward_args
from elasticdl_tpu_torch.common.constants import ENV_WORKER_LOG_DIR
from elasticdl_tpu_torch.data.recordio import RecordIOWriter
from elasticdl_tpu_torch.master import main as master_main
from elasticdl_tpu_torch.master.checkpoint import load_model_file
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.master.worker_manager import WorkerManager
from elasticdl_tpu_torch.models import transformer_lm_zoo as tzoo
from elasticdl_tpu_torch.models.record_codec import write_learnable_token_records
from elasticdl_tpu_torch.ops import build
from elasticdl_tpu_torch.rpc.server import RpcServer
from elasticdl_tpu_torch.testing import InProcessMaster, build_job
from elasticdl_tpu_torch.worker import main as worker_main
from elasticdl_tpu_torch.worker.worker import Worker
from _torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = os.path.join(REPO, "elasticdl_tpu_torch", "models")
VOCAB, SEQ, BATCH = 64, 128, 16


@pytest.fixture(autouse=True)
def _root_log_level():
    """The entry points set the root logger's level from --log_level."""
    level = logging.getLogger().level
    yield
    logging.getLogger().setLevel(level)


def _shards(data_dir, n_files, records_each):
    os.makedirs(data_dir, exist_ok=True)
    for i in range(n_files):
        write_learnable_token_records(
            os.path.join(data_dir, f"shard-{i}.rio"), records_each, SEQ, VOCAB, seed=i
        )


def _argv(data_dir, output, num_workers, *extra):
    return [
        "--model_zoo", ZOO,
        "--model_def", "transformer_lm_zoo.custom_model",
        "--model_params", f"vocab={VOCAB}",
        "--minibatch_size", str(BATCH),
        "--training_data_dir", data_dir,
        "--records_per_task", "32",
        "--num_epochs", "1",
        "--grads_to_wait", "1",
        "--num_workers", str(num_workers),
        "--worker_backend", "process",
        "--device", "cpu",
        "--envs", "OMP_NUM_THREADS=2",
        "--output", output,
        *extra,
    ]


def _run_master(tmp_path, monkeypatch, argv):
    log_dir = str(tmp_path / "logs")
    monkeypatch.setenv(ENV_WORKER_LOG_DIR, log_dir)
    rc, summary = master_main.run(argv)
    # the master never touches the card: a CUDA context there would be
    # shared with every worker on it
    assert not torch.cuda.is_initialized()
    return rc, summary, log_dir


def test_one_worker_job_equals_the_in_process_job_bit_for_bit(tmp_path, monkeypatch):
    data = str(tmp_path / "data")
    _shards(data, 1, 64)
    output = str(tmp_path / "final.ckpt")
    rc, summary, log_dir = _run_master(
        tmp_path, monkeypatch,
        _argv(data, output, 1, "--records_per_task", "64", "--num_epochs", "2"),
    )
    assert rc == 0
    steps = 2 * 64 // BATCH
    model = load_model_file(output)
    assert model.version == steps
    assert summary["version"] == summary["applied_update_steps"] == steps

    path = os.path.join(data, "shard-0.rio")
    dispatcher = TaskDispatcher({path: 64}, {}, {}, 64, 2, shuffle_seed=0)
    spec = spec_from_module(tzoo, model=tzoo.custom_model(vocab=VOCAB))
    servicer = build_job(spec, dispatcher, grads_to_wait=1)
    worker = Worker(0, InProcessMaster(servicer), spec, minibatch_size=BATCH, device="cpu")
    assert worker.run()
    worker.close()
    params, _aux, version = servicer.get_params_copy()
    assert version == model.version
    assert codec.ravel_np(model.params).tobytes() == codec.ravel_np(params).tobytes()

    (s,) = worker_main.read_summaries(log_dir).values()
    assert s["device"] == "cpu"
    assert s["steps_accepted"] == s["steps_computed"] == steps
    assert s["losses"] == [loss for _t, loss in worker.step_log]
    # on the CPU the wrappers run their plain versions: no launches
    assert s["launches"] == {
        f"{k}_d{d}": 0 for k in ("flash_forward", "flash_dq", "flash_dkv") for d in (64, 128)
    }
    assert set(s["rpc_seconds"]) == set(summary["server"]["calls"])


def test_two_workers_fault_free_versions_equal_the_accepted_reports(tmp_path, monkeypatch):
    data = str(tmp_path / "data")
    _shards(data, 2, 64)
    output = str(tmp_path / "final.ckpt")
    rc, summary, log_dir = _run_master(tmp_path, monkeypatch, _argv(data, output, 2))
    assert rc == 0
    minibatches = 2 * 64 // BATCH
    summaries = worker_main.read_summaries(log_dir)
    assert sorted(summaries) == [0, 1]
    accepted = sum(s["steps_accepted"] for s in summaries.values())
    assert load_model_file(output).version == accepted == minibatches
    assert summary["version"] == summary["init_version"] + summary["applied_update_steps"]
    assert summary["applied_update_steps"] == minibatches
    assert summary["relaunches"] == 0
    for s in summaries.values():
        # stale rejections are recomputed, never errors
        assert s["steps_computed"] >= s["steps_accepted"]
        assert all(np.isfinite(s["losses"]))


def test_sigkilled_worker_is_recovered_and_relaunched(tmp_path):
    data = str(tmp_path / "data")
    # enough tasks (8) that worker 0 holds one even if it boots last
    _shards(data, 4, 64)
    args = master_parser().parse_args(_argv(data, "", 2))
    _spec, dispatcher, servicer = master_main.build_master(args)
    server = RpcServer(servicer.handlers(), port=0)
    server.start()
    addr = f"localhost:{server.port}"
    log_dir = str(tmp_path / "logs")
    backend = tpod.ProcessBackend(log_dir=log_dir)
    manager = WorkerManager(
        backend,
        dispatcher,
        num_workers=2,
        worker_argv_fn=lambda wid: worker_forward_args(args, wid, addr),
        envs={"OMP_NUM_THREADS": "2"},
        max_relaunches=4,
    )
    manager.start_workers()
    try:
        # SIGKILL worker 0 once it holds a task: a real preemption
        deadline = time.time() + 60
        victim = None
        while time.time() < deadline:
            with dispatcher._lock:
                holds = [t for t, (wid, _) in dispatcher._doing.items() if wid == 0]
            victim = backend.pid_of(0)
            if holds and victim:
                break
            time.sleep(0.02)
        assert holds and victim, "worker 0 never held a task"
        os.kill(victim, signal.SIGKILL)
        deadline = time.time() + 60
        while not dispatcher.finished() and time.time() < deadline:
            time.sleep(0.1)
        assert dispatcher.finished(), "the job did not finish after the preemption"
        assert not dispatcher.has_failed_tasks()
        assert manager.relaunches() >= 1
        assert manager.phases()[0] == tpod.PodPhase.DELETED
        assert 2 in manager.phases()  # the replacement has a fresh id
        ex = servicer.exactness()
        assert ex["version"] == ex["init_version"] + ex["applied_update_steps"]
        assert ex["applied_update_steps"] >= 4 * 64 // BATCH
        deadline = time.time() + 30
        while not manager.all_exited() and time.time() < deadline:
            time.sleep(0.1)
    finally:
        manager.stop_relaunch_and_remove_workers()
        backend.stop()
        server.stop()
    summaries = worker_main.read_summaries(log_dir)
    assert 0 not in summaries  # killed before it could write one
    assert all(np.isfinite(s["losses"]).all() for s in summaries.values())


def test_poison_shard_ends_the_job_with_exit_2(tmp_path, monkeypatch):
    data = str(tmp_path / "data")
    _shards(data, 1, 64)
    with RecordIOWriter(os.path.join(data, "poison.rio")) as w:
        for _ in range(32):
            w.write(b"\x01")  # not a whole int32 token: dataset_fn fails
    rc, summary, log_dir = _run_master(
        tmp_path, monkeypatch, _argv(data, str(tmp_path / "final.ckpt"), 1,
                                     "--max_worker_relaunches", "2"),
    )
    assert rc == 2
    # the worker reported each failure and went on: the dispatcher dropped
    # the poison task, and the worker's exit 2 was not relaunched
    assert summary["relaunches"] == 0
    assert worker_main.read_summaries(log_dir)[0]["steps_accepted"] == 64 // BATCH
    assert not os.path.exists(tmp_path / "final.ckpt")


@pytest.mark.parametrize(
    "argv",
    [
        ["--model_zoo", ZOO, "--model_def", "transformer_lm_zoo.custom_model",
         "--minibatch_size", "8"],
        ["--model_zoo", ZOO, "--model_def", "transformer_lm_zoo.custom_model",
         "--minibatch_size", "8", "--training_data_dir", "d", "--worker_backend", "k8s"],
        ["--model_zoo", ZOO, "--model_def", "transformer_lm_zoo.custom_model",
         "--minibatch_size", "8", "--training_data_dir", "/no/such/dir", "--device", "cpu"],
    ],
    ids=["no-data-dir", "k8s-backend", "missing-data-dir"],
)
def test_master_config_errors_exit_1(argv):
    assert master_main.main(argv) == 1


def _closed_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_worker_exits_3_when_the_master_is_unreachable(monkeypatch):
    monkeypatch.setattr(worker_main, "BOOT_WAIT_SECONDS", 0.5)
    rc = worker_main.main([
        "--worker_id", "0", "--master_addr", f"localhost:{_closed_port()}",
        "--model_zoo", ZOO, "--model_def", "transformer_lm_zoo.custom_model",
        "--model_params", f"vocab={VOCAB}", "--minibatch_size", "8", "--device", "cpu",
    ])
    assert rc == 3


def test_worker_without_device_flag_refuses_to_run_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA card")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "elasticdl_tpu_torch.worker.main",
         "--worker_id", "0", "--master_addr", f"localhost:{_closed_port()}",
         "--model_zoo", ZOO, "--model_def", "transformer_lm_zoo.custom_model",
         "--minibatch_size", "8"],
        env=env, capture_output=True, text=True, timeout=60,
    )
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr


# -- the worker manager against the reference's, on the same pod events ------


class _FakeBackend:
    def __init__(self, running_event):
        self._running = running_event
        self.started, self.deleted = [], []
        self._cb = None

    def set_event_callback(self, cb):
        self._cb = cb

    def start_worker(self, worker_id, argv, envs):
        self.started.append(worker_id)
        self._cb(self._running(worker_id))

    def delete_worker(self, worker_id):
        self.deleted.append(worker_id)

    def fire(self, event):
        self._cb(event)


class _FakeDispatcher:
    def __init__(self):
        self.recovered = []

    def recover_tasks(self, worker_id):
        self.recovered.append(worker_id)


_EVENTS = {
    "crash-relaunch-and-dedupe": [(0, "FAILED", 1), (0, "FAILED", 1), (1, "SUCCEEDED", 0),
                                  (2, "SUCCEEDED", 0)],
    "job-failed-is-not-relaunched": [(0, "FAILED", 2), (1, "FAILED", 2)],
    "unreachable-and-sigkill-relaunch": [(0, "FAILED", 3), (1, "DELETED", -9),
                                         (2, "SUCCEEDED", 0), (3, "SUCCEEDED", 0)],
    "budget-spent": [(0, "FAILED", 1), (1, "FAILED", 1), (2, "FAILED", 1),
                     (3, "DELETED", -15)],
}


@pytest.mark.parametrize("script", sorted(_EVENTS))
def test_worker_manager_matches_the_reference_on_the_same_events(script):
    results = []
    for pod, manager_cls in ((tpod, WorkerManager), (jpod, JWorkerManager)):
        backend = _FakeBackend(lambda wid, pod=pod: pod.PodEvent(wid, pod.PodPhase.RUNNING))
        dispatcher = _FakeDispatcher()
        manager = manager_cls(backend, dispatcher, num_workers=2,
                              worker_argv_fn=lambda wid: [], max_relaunches=2)
        manager.start_workers()
        for wid, phase, rc in _EVENTS[script]:
            backend.fire(pod.PodEvent(wid, getattr(pod.PodPhase, phase), exit_code=rc))
        manager.stop_relaunch_and_remove_workers()
        results.append((backend.started, backend.deleted, dispatcher.recovered,
                        manager.relaunches(), manager.phases(), manager.all_exited()))
    assert results[0] == results[1]


def test_concurrent_builds_run_the_compiler_once(tmp_path, monkeypatch):
    """Two callers that find no library at once: the flock makes the
    second wait and then find the first one's library."""
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "k.cu").write_text("// kernel\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path / "csrc"))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    runs = []

    def fake_nvcc(cmd, **kw):
        runs.append(cmd)
        time.sleep(0.3)
        with open(cmd[cmd.index("-o") + 1], "w") as f:
            f.write("lib")
        return subprocess.CompletedProcess(cmd, 0, "ptxas info\n", "")

    monkeypatch.setattr(build.subprocess, "run", fake_nvcc)
    paths = []
    threads = [threading.Thread(target=lambda: paths.append(build.build("k")))
               for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert len(runs) == 1
    assert paths == [build.library_path("k")] * 3
    assert os.path.exists(paths[0])

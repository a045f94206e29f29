"""Process mode over the shm tier, and warm standby workers as processes,
on the CPU.

- The process backend hands every worker the master's environment
  (`EDL_TRANSPORT`, `EDL_UDS_DIR`, the shm settings).
- A one-worker per-step job over shm (a ring smaller than the model, so
  every frame takes the chunked path) ends bit-equal to the same job
  over TCP, its worker's link on the tier asked for.
- A two-worker mnist window job with one standby, worker 0 SIGKILLed
  once it holds a task and the standby has pre-warmed, ends with a
  promotion of that pre-warmed standby, no failed task, every minibatch
  applied exactly once, and no segment or file left behind
  (`_torch_tiers.tier_dir`).
"""

import logging
import os
import signal
import time

import pytest
import torch

from elasticdl_tpu_torch.cluster import pod_backend
from elasticdl_tpu_torch.common import codec
from elasticdl_tpu_torch.common.args import master_parser, parse_envs, worker_forward_args
from elasticdl_tpu_torch.common.constants import ENV_WORKER_LOG_DIR
from elasticdl_tpu_torch.master import main as master_main
from elasticdl_tpu_torch.master.checkpoint import load_model_file
from elasticdl_tpu_torch.master.worker_manager import WorkerManager
from elasticdl_tpu_torch.models.record_codec import (
    write_learnable_token_records,
    write_synthetic_image_records,
)
from elasticdl_tpu_torch.rpc.server import RpcServer
from elasticdl_tpu_torch.worker import main as worker_main
from _torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)
from _torch_tiers import tier_dir  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = os.path.join(REPO, "elasticdl_tpu_torch", "models")
VOCAB, SEQ, BATCH = 64, 128, 16


@pytest.fixture(autouse=True)
def _root_log_level():
    """The entry points set the root logger's level from --log_level."""
    level = logging.getLogger().level
    yield
    logging.getLogger().setLevel(level)


ENV_DUMP = r"""
import json, os, sys
keys = ("EDL_TRANSPORT", "EDL_UDS_DIR", "EDL_TRANSPORT_SHM_RING_BYTES",
        "EDL_TRANSPORT_SHM_DOORBELL_TIMEOUT", "EXTRA")
with open(sys.argv[1], "w") as f:
    json.dump({k: os.environ.get(k) for k in keys}, f)
"""


def test_workers_inherit_the_transport_environment(tmp_path, tier_dir, monkeypatch):
    import json

    (tmp_path / "envdump.py").write_text(ENV_DUMP)
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    monkeypatch.setattr(pod_backend, "WORKER_MODULE", "envdump")
    env = {"EDL_TRANSPORT": "shm", "EDL_TRANSPORT_SHM_RING_BYTES": "65536",
           "EDL_TRANSPORT_SHM_DOORBELL_TIMEOUT": "2.5"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    backend = pod_backend.ProcessBackend()
    try:
        out = tmp_path / "env.json"
        backend.start_worker(0, [str(out)], {"EXTRA": "1"})
        deadline = time.monotonic() + 30
        while backend.pid_of(0) is not None and time.monotonic() < deadline:
            time.sleep(0.05)
        got = json.loads(out.read_text())
    finally:
        backend.stop()
    assert got == dict(env, EDL_UDS_DIR=tier_dir, EXTRA="1")


def _token_argv(data_dir, output):
    return [
        "--model_zoo", ZOO, "--model_def", "transformer_lm_zoo.custom_model",
        "--model_params", f"vocab={VOCAB}", "--minibatch_size", str(BATCH),
        "--training_data_dir", data_dir, "--records_per_task", "64", "--num_epochs", "2",
        "--grads_to_wait", "1", "--num_workers", "1", "--worker_backend", "process",
        "--device", "cpu", "--envs", "OMP_NUM_THREADS=2", "--output", output,
    ]


def test_one_worker_job_over_shm_equals_the_job_over_tcp(tmp_path, monkeypatch):
    data = str(tmp_path / "data")
    os.makedirs(data)
    write_learnable_token_records(os.path.join(data, "shard-0.rio"), 64, SEQ, VOCAB, seed=0)
    runs = {}
    for mode in ("grpc", "shm"):
        monkeypatch.setenv("EDL_TRANSPORT", mode)
        # 16 KiB rings: every model and gradient frame goes in chunks
        monkeypatch.setenv("EDL_TRANSPORT_SHM_RING_BYTES", "16384")
        log_dir = str(tmp_path / f"logs-{mode}")
        monkeypatch.setenv(ENV_WORKER_LOG_DIR, log_dir)
        output = str(tmp_path / f"{mode}.ckpt")
        rc, summary = master_main.run(_token_argv(data, output))
        assert rc == 0 and not torch.cuda.is_initialized()
        (s,) = worker_main.read_summaries(log_dir).values()
        runs[mode] = (load_model_file(output), summary, s)
    (tcp_model, tcp_sum, tcp_w), (shm_model, shm_sum, shm_w) = runs["grpc"], runs["shm"]
    assert (tcp_w["tier"], shm_w["tier"]) == ("tcp", "shm")
    steps = 2 * 64 // BATCH
    assert tcp_model.version == shm_model.version == steps
    assert shm_sum["version"] == shm_sum["applied_update_steps"] == steps
    assert codec.ravel_np(shm_model.params).tobytes() == codec.ravel_np(tcp_model.params).tobytes()
    assert shm_w["losses"] == tcp_w["losses"]
    assert shm_w["steps_accepted"] == shm_w["steps_computed"] == steps


MNIST_RECORDS, MNIST_TASK, MNIST_BATCH = 256, 32, 16


def _log_has(log_dir, wid, text):
    try:
        with open(os.path.join(log_dir, f"worker-{wid}.log")) as f:
            return text in f.read()
    except OSError:
        return False


def test_window_job_promotes_a_prewarmed_standby_after_a_sigkill(tmp_path, monkeypatch):
    monkeypatch.setenv("EDL_TRANSPORT", "shm")
    data, log_dir = str(tmp_path / "data"), str(tmp_path / "logs")
    os.makedirs(data)
    for i in range(4):
        write_synthetic_image_records(os.path.join(data, f"s{i}.rio"), MNIST_RECORDS,
                                      (28, 28, 1), 10, seed=i)
    args = master_parser().parse_args([
        "--model_def", "mnist_functional_api.custom_model", "--minibatch_size", str(MNIST_BATCH),
        "--training_data_dir", data, "--records_per_task", str(MNIST_TASK),
        "--local_updates", "2", "--num_workers", "2", "--num_standby_workers", "1",
        "--device", "cpu", "--envs", "OMP_NUM_THREADS=1",
    ])
    _spec, dispatcher, servicer, _eval, _ckpt = master_main.build_master(args)
    server = RpcServer(servicer.handlers(), port=0)
    server.start()
    addr = f"localhost:{server.port}"
    backend = pod_backend.ProcessBackend(log_dir=log_dir)
    manager = WorkerManager(backend, dispatcher, num_workers=2,
                            worker_argv_fn=lambda wid: worker_forward_args(args, wid, addr),
                            envs=parse_envs(args.envs), max_relaunches=4, num_standby=1)
    servicer.set_standby_fn(manager.is_standby)
    servicer.set_sample_batch_fn(master_main.make_sample_batch_fn(data))
    killed = False
    try:
        manager.start_workers()
        deadline = time.monotonic() + 120
        while not dispatcher.finished() and time.monotonic() < deadline:
            if not killed and _log_has(log_dir, 2, "standby pre-warm complete"):
                with dispatcher._lock:
                    holds = any(w == 0 for w, _ in dispatcher._doing.values())
                pid = backend.pid_of(0)
                if holds and pid:
                    os.kill(pid, signal.SIGKILL)
                    killed = True
            time.sleep(0.01)
        finished = dispatcher.finished()
        deadline = time.monotonic() + 60
        while not manager.all_exited() and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        manager.stop_relaunch_and_remove_workers()
        backend.stop()
        server.stop()
    assert killed, "worker 0 never held a task once the standby had pre-warmed"
    assert finished and not dispatcher.has_failed_tasks()
    assert manager.promotions() >= 1 and manager.relaunches() >= 1
    minibatches = 4 * MNIST_RECORDS // MNIST_BATCH
    ex = servicer.exactness()
    assert ex == {"version": minibatches, "init_version": 0, "applied_update_steps": minibatches}
    summaries = worker_main.read_summaries(log_dir)
    standby = summaries[2]
    assert standby["was_standby"] and standby["standby_prewarmed"]
    assert not standby["standby_prewarm_failed"] and standby["promoted_at"] is not None
    assert _log_has(log_dir, 2, "promoted from standby")
    for wid, s in summaries.items():
        assert s["tier"] == "shm", wid
        assert s["steps_computed"] == s["steps_accepted"] + 2 * s["deduped_windows"], wid

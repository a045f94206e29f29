"""Master process entry point: task dispatcher + parameter server +
worker manager.

    python -m elasticdl_tpu_torch.master.main \\
        --model_zoo elasticdl_tpu_torch/models \\
        --model_def transformer_lm_zoo.custom_model \\
        --training_data_dir <shards> --minibatch_size 8 \\
        --num_workers 2 --worker_backend process

The reference's master main (`elasticdl_tpu/master/main.py`) for a
training job on the single PS:

1. count the RecordIO shards -> TaskDispatcher;
2. load the model spec (the model is built on the CPU, for the
   optimizer factory only: the PS is numpy on the host, and the master
   never initializes CUDA, whose context every worker would then share
   the card with);
3. start the RPC server, before the workers;
4. launch workers through the WorkerManager over the process backend
   (`python -m elasticdl_tpu_torch.worker.main` subprocesses, logs in
   `$EDL_WORKER_LOG_DIR/worker-<id>.log` when it is set);
5. poll until the job finishes, save `--output`, tear down: manager,
   backend, server.

Exit codes: 0 success; 1 boot or config error; 2 the job completed with
dropped (poison) tasks, or every worker exited with tasks outstanding.

At exit the master logs one line, `master summary: {json}`, with the
server's seconds per method (handler and codec), the job's exactness
block and the relaunches; `run(argv)` returns the same summary to an
in-process caller.

Not ported yet: evaluation and prediction jobs, boot from a checkpoint,
the checkpoint and evaluation services, the sharded PS, KV shards and
aggregators, standby workers, the policy and observability planes,
TensorBoard, speculation, master migration and the k8s backend.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

from elasticdl_tpu_torch.common.args import (
    master_parser,
    parse_envs,
    validate_master_args,
    worker_forward_args,
)
from elasticdl_tpu_torch.common.constants import ENV_WORKER_LOG_DIR
from elasticdl_tpu_torch.common.log_util import get_logger

logger = get_logger(__name__)

# Once the job is finished, each worker exits by itself at its next
# GetTask; teardown deletes only those still running after this long.
EXIT_GRACE_SECONDS = 30.0
SUMMARY_TAG = "master summary: "


def collect_shards(path: str) -> dict:
    """{file: record_count} for a RecordIO file or directory of shards."""
    from elasticdl_tpu_torch.data.recordio import count_records

    if not path:
        return {}
    if os.path.isfile(path):
        files = [path]
    else:
        # regular files only: a stray subdirectory must not fail the boot
        files = sorted(
            p
            for f in os.listdir(path)
            if not f.startswith(".") and os.path.isfile(p := os.path.join(path, f))
        )
    shards = {f: count_records(f) for f in files}
    if not shards or not any(shards.values()):
        raise ValueError(f"no records found under {path!r}")
    return shards


def build_master(args):
    """(spec, dispatcher, servicer) for a training job on the single PS,
    shared by main() and tests."""
    from elasticdl_tpu_torch.api.model_spec import get_model_spec
    from elasticdl_tpu_torch.master.ps_optimizer import PSOptimizer
    from elasticdl_tpu_torch.master.servicer import MasterServicer
    from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher

    spec = get_model_spec(
        model_zoo=args.model_zoo,
        model_def=args.model_def,
        model_params=args.model_params,
        dataset_fn=args.dataset_fn,
        loss=args.loss,
        optimizer=args.optimizer,
    )
    dispatcher = TaskDispatcher(
        collect_shards(args.training_data_dir),
        {},
        {},
        args.records_per_task,
        args.num_epochs,
    )
    servicer = MasterServicer(
        grads_to_wait=args.grads_to_wait,
        optimizer=PSOptimizer(spec.optimizer()),
        task_dispatcher=dispatcher,
    )
    return spec, dispatcher, servicer


def make_backend(args):
    """The worker backend; raises ValueError for one not ported yet."""
    if args.worker_backend != "process":
        raise ValueError(
            f"--worker_backend {args.worker_backend} is not ported yet "
            "(the port runs process workers only)"
        )
    from elasticdl_tpu_torch.cluster.pod_backend import ProcessBackend

    return ProcessBackend(log_dir=os.environ.get(ENV_WORKER_LOG_DIR, ""))


def run(argv=None):
    """(exit code, summary): the summary is None when the job did not
    start."""
    args = master_parser().parse_args(argv)
    try:
        job_type = validate_master_args(args)
        backend = make_backend(args)
    except ValueError as e:
        logger.error("invalid arguments: %s", e)
        return 1, None

    logging.getLogger().setLevel(args.log_level.upper())

    from elasticdl_tpu_torch.master.worker_manager import WorkerManager
    from elasticdl_tpu_torch.rpc.server import RpcServer

    try:
        _spec, dispatcher, servicer = build_master(args)
    except (ValueError, OSError) as e:
        # a bad data dir or unreadable shards are config errors
        logger.error("master boot failed: %s", e)
        backend.stop()
        return 1, None

    server = RpcServer(servicer.handlers(), port=args.port)
    server.start()
    addr = f"localhost:{server.port}"
    logger.info("Master (%s job) listening on %s", job_type, addr)
    manager = WorkerManager(
        backend,
        dispatcher,
        num_workers=args.num_workers,
        worker_argv_fn=lambda wid: worker_forward_args(args, wid, addr),
        envs=parse_envs(args.envs),
        max_relaunches=args.max_worker_relaunches,
    )
    t0 = time.perf_counter()
    manager.start_workers()

    exit_code = 0
    try:
        while not dispatcher.finished():
            if manager.all_exited():
                logger.error(
                    "all workers exited (relaunch budget spent) with "
                    "tasks outstanding"
                )
                exit_code = 2
                break
            time.sleep(0.5)
        if exit_code == 0 and dispatcher.has_failed_tasks():
            logger.error("job completed with dropped (poison) tasks")
            exit_code = 2
        if exit_code == 0 and args.output and servicer.model_initialized():
            servicer.save_latest_checkpoint(args.output)
            logger.info("Final model saved to %s", args.output)
        deadline = time.monotonic() + EXIT_GRACE_SECONDS
        while not manager.all_exited() and time.monotonic() < deadline:
            time.sleep(0.1)
    finally:
        manager.stop_relaunch_and_remove_workers()
        backend.stop()
        server.stop()
    summary = {
        "exit_code": exit_code,
        "seconds": time.perf_counter() - t0,
        **servicer.exactness(),
        "relaunches": manager.relaunches(),
        "server": server.stats(),
    }
    logger.info("%s%s", SUMMARY_TAG, json.dumps(summary))
    return exit_code, summary


def main(argv=None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())

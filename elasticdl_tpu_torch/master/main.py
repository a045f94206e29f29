"""Master process entry point: task dispatcher + parameter server +
worker manager.

    python -m elasticdl_tpu_torch.master.main \\
        --model_zoo elasticdl_tpu_torch/models \\
        --model_def transformer_lm_zoo.custom_model \\
        --training_data_dir <shards> --minibatch_size 8 \\
        --num_workers 2 --worker_backend process

The reference's master main (`elasticdl_tpu/master/main.py`) on the
single PS, for training, training with evaluation, evaluation and
prediction jobs:

1. count the RecordIO shards of each data dir -> TaskDispatcher;
2. load the model spec (the model is built on the CPU, for the
   optimizer factory only: the PS is numpy on the host, and the master
   never initializes CUDA, whose context every worker would then share
   the card with);
3. for a model with `embedding_specs`, the sparse plane: the embedding
   store (in the master, or `--num_kv_shards N` KV shards, `--kv_mode`
   process or inproc, whose endpoints GetPSConfig advertises to the
   workers) and the sparse optimizer over it; then boot from
   `--checkpoint_filename_for_init` when given: params, aux and version,
   the optimizer's state from the file's `opt_state` (exact resume),
   and the file's embedding tables into the store; evaluation and
   prediction jobs need it. With `--num_ps N` (`--ps_mode` process or
   inproc) the dense model lives on N PS shards (`ps_group`), booted
   here, seeded from the checkpoint (each shard takes its slice and,
   from a sharded file of the same N, its optimizer state; any other
   pairing warns and starts the optimizer cold) or from the first
   worker's ReportVariable, and stopped on every exit path;
4. wire the job services: the checkpoint service (`--checkpoint_dir`,
   `--checkpoint_steps`, `--keep_checkpoint_max`), the evaluation
   service (`--evaluation_data_dir`: every `--eval_steps` versions or,
   with `--eval_throttle_secs`, on a timer; an evaluation-only job is
   one job pinned to the booted version) and the metrics sink
   (`--tensorboard_log_dir`: train loss and evaluation metrics);
5. start the RPC server, before the workers;
6. launch workers through the WorkerManager over the process backend
   (`python -m elasticdl_tpu_torch.worker.main` subprocesses, logs in
   `$EDL_WORKER_LOG_DIR/worker-<id>.log` when it is set), with
   `--num_standby_workers` warm standbys beside them, which GetTask holds
   in reserve and GetSampleBatch feeds the first training records to
   pre-warm on;
7. poll until the job finishes and no evaluation job is pending, flush
   the checkpoint writer, save `--output` (with the embedding tables),
   tear down: manager, backend, server, checkpoint writer, metrics
   sink, PS and KV shards.

Whenever the job has PS or KV shards, the shard recovery plane
(`master/recovery.py`) is armed before the workers start: a dead shard
is fenced, relaunched at the next generation and restored, and the job
goes on; the plane stops on every exit path, before the shards.

Exit codes: 0 success; 1 boot or config error; 2 the job completed with
dropped (poison) tasks, every worker exited with tasks outstanding, or a
PS or KV shard was unrecoverable.

At exit the master logs one line, `master summary: {json}`, with the
job type, the server's seconds per method (handler and codec), the
job's exactness block, each PS shard's counters (`ps_shards`: version,
applied and duplicate pushes, apply and lock-wait seconds, pulls), the
sparse plane (the store that served, its
rows, the sparse apply's seconds), the shard recovery plane
(`recoveries` as [kind, shard, generation], `unrecoverable`, the
groups' `generations` and each recovery's timeline), the relaunches and promotions, the completed evaluation
jobs (`[version, metrics]`, and each one's seconds from its creation to
its last task); `run(argv)` returns the same summary to an
in-process caller.

The workers reach the master over the tier `EDL_TRANSPORT` selects (the
environment passes to them as it is).

The observability plane (`observe_master`): the crash flight dump, the
fleet phase metrics from ReportPhaseStats, and the `EDL_METRICS_PORT`
listener; GetTrace and GetMetrics answer on the master's server, and
`--profile_dir` reaches every worker, which writes one torch.profiler
trace under `<profile_dir>/worker-<id>/`.

Not ported yet: the aggregators, the k8s KV mode, the policy plane
(autoscaler, arbiter, QoS), the tensorboard process,
speculation, master migration and the k8s backend (and with it the pod
events that route a shard's death to the recovery plane: the plane
polls the shard processes).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time

from elasticdl_tpu_torch.common.args import (
    master_parser,
    parse_envs,
    ps_shard_forward_args,
    validate_master_args,
    validate_ps_args,
    worker_forward_args,
)
from elasticdl_tpu_torch.common.constants import ENV_WORKER_LOG_DIR
from elasticdl_tpu_torch.common.log_util import get_logger
from elasticdl_tpu_torch.obs import flight as obs_flight
from elasticdl_tpu_torch.obs import metrics as obs_metrics

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


def make_sample_batch_fn(training_data_dir: str):
    """Serves the first n raw records of the training shards, topped up
    across shards in order: the batch a standby pre-warms on."""

    def fn(n: int):
        from elasticdl_tpu_torch.data.recordio import RecordIOReader

        shards = collect_shards(training_data_dir)
        records: list = []
        for path in sorted(shards):
            take = min(n - len(records), shards[path])
            if take > 0:
                with RecordIOReader(path) as reader:
                    records.extend(reader.read_range(0, take))
            if len(records) >= n:
                break
        if records and len(records) < n:
            logger.warning(
                "sample batch short: %d/%d records; standby pre-warm will run "
                "another shape than the job's", len(records), n,
            )
        return records or None

    return fn


def build_master(args, job_type=None):
    """(spec, dispatcher, servicer, evaluation service or None,
    checkpoint service), shared by run() and tests; the metrics sink,
    when there is one, is `servicer.tb_service` (its owner tears it
    down), the KV and PS shards, when there are, `servicer.kv_group` and
    `servicer.ps_group`.
    `job_type` defaults to the one the flags give."""
    from elasticdl_tpu_torch.api.model_spec import get_model_spec
    from elasticdl_tpu_torch.master.ps_optimizer import PSOptimizer

    if job_type is None:
        job_type = validate_master_args(args)
    spec = get_model_spec(
        model_zoo=args.model_zoo,
        model_def=args.model_def,
        model_params=args.model_params,
        dataset_fn=args.dataset_fn,
        loss=args.loss,
        optimizer=args.optimizer,
        eval_metrics_fn=args.eval_metrics_fn,
        prediction_outputs_processor=args.prediction_outputs_processor,
    )
    validate_ps_args(args)
    ps_opt = PSOptimizer(spec.optimizer())
    store, sparse_opt, kv_group = build_sparse_plane(spec, args.num_kv_shards, args.kv_mode)
    ps_group = None
    try:
        if args.num_ps > 0:
            from elasticdl_tpu_torch.master.ps_group import PSShardGroup

            ps_group = PSShardGroup(
                args.num_ps,
                mode=args.ps_mode,
                optimizer_factory=spec.optimizer,
                shard_argv=ps_shard_forward_args(args),
                grads_to_wait=args.grads_to_wait,
                use_async=args.use_async,
                lr_staleness_modulation=args.lr_staleness_modulation,
                staleness_window=args.staleness_window,
                num_workers=args.num_workers + args.num_standby_workers,
            )
            ps_group.start()
        return _finish_build(args, job_type, spec, ps_opt, store, sparse_opt, kv_group, ps_group)
    except BaseException:
        # no shard process may outlive a failed boot
        if ps_group is not None:
            ps_group.stop()
        if kv_group is not None:
            kv_group.stop()
        raise


def build_sparse_plane(spec, num_kv_shards: int = 0, kv_mode: str = "process", store=None):
    """(embedding store, sparse optimizer, KV shard group) for a model
    with `embedding_specs`, else (None, None, None): the tables in
    `store` when given (a ShardedEmbeddingStore, say), else behind
    `num_kv_shards` KV shards, else in a new store in the master."""
    from elasticdl_tpu_torch.master.embedding_store import EmbeddingStore
    from elasticdl_tpu_torch.master.sparse_optimizer import SparseOptimizer

    if not spec.embedding_specs:
        return None, None, None
    kv_group = None
    # `store is None`, not `not store`: a store with no rows has len 0
    if store is None and num_kv_shards > 0:
        from elasticdl_tpu_torch.master.kv_group import KVShardGroup

        kv_group = KVShardGroup(num_kv_shards, mode=kv_mode)
        try:
            kv_group.start()
            store = kv_group.store()
        except Exception:
            kv_group.stop()
            raise
    elif store is None:
        store = EmbeddingStore()
    return store, SparseOptimizer(store, **(spec.sparse_optimizer or {})), kv_group


def _finish_build(args, job_type, spec, ps_opt, store, sparse_opt, kv_group, ps_group=None):
    from elasticdl_tpu_torch.common.constants import JobType
    from elasticdl_tpu_torch.master.checkpoint import CheckpointService, restore_for_init
    from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
    from elasticdl_tpu_torch.master.servicer import MasterServicer
    from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher

    init_params = init_aux = None
    init_version = 0
    if args.checkpoint_filename_for_init:
        init_params, init_aux, init_version = restore_for_init(
            args.checkpoint_filename_for_init, ps_opt, store, ps_group
        )
    dispatcher = TaskDispatcher(
        collect_shards(args.training_data_dir),
        collect_shards(args.evaluation_data_dir),
        collect_shards(args.prediction_data_dir),
        args.records_per_task,
        args.num_epochs,
        eval_model_version=init_version,
    )
    ckpt = CheckpointService(
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_steps=args.checkpoint_steps,
        keep_checkpoint_max=args.keep_checkpoint_max,
        embedding_store=store,
    )
    servicer = MasterServicer(
        grads_to_wait=args.grads_to_wait,
        optimizer=ps_opt,
        task_dispatcher=dispatcher,
        checkpoint_service=ckpt,
        init_params=init_params,
        init_aux=init_aux,
        init_version=init_version,
        use_async=args.use_async,
        lr_staleness_modulation=args.lr_staleness_modulation,
        staleness_window=args.staleness_window,
        embedding_store=store,
        sparse_optimizer=sparse_opt,
        kv_group=kv_group,
        ps_group=ps_group,
    )
    tb_service = None
    if args.tensorboard_log_dir:
        from elasticdl_tpu_torch.master.tensorboard_service import TensorBoardService

        tb_service = TensorBoardService(args.tensorboard_log_dir)
        servicer.set_train_loss_hook(tb_service.write_train_loss)
    eval_service = None
    if job_type in (JobType.TRAINING_WITH_EVALUATION, JobType.EVALUATION_ONLY):
        eval_service = EvaluationService(
            ckpt,
            dispatcher,
            eval_steps=args.eval_steps,
            start_delay_secs=args.eval_start_delay_secs,
            throttle_secs=args.eval_throttle_secs,
            # a throttle means the time trigger's thread
            time_based=args.eval_throttle_secs > 0
            and job_type == JobType.TRAINING_WITH_EVALUATION,
            current_model_fn=servicer.get_params_copy,
            metrics_writer=tb_service.write_eval_metrics if tb_service else None,
        )
        dispatcher.set_evaluation_service(eval_service)
        servicer.set_evaluation_service(eval_service)
    servicer.tb_service = tb_service
    return spec, dispatcher, servicer, eval_service, ckpt


def stop_shard_groups(servicer):
    """Stop the job's PS and KV shard groups (the PS first: its pushes
    need no embedding rows)."""
    if servicer.ps_group is not None:
        servicer.ps_group.stop()
    if servicer.kv_group is not None:
        servicer.kv_group.stop()


def arm_recovery_plane(servicer, on_unrecoverable):
    """The shard recovery plane, started, when the job has PS or KV
    shards (else None)."""
    if servicer.ps_group is None and servicer.kv_group is None:
        return None
    from elasticdl_tpu_torch.master.recovery import RecoveryPlane

    plane = RecoveryPlane(servicer, ps_group=servicer.ps_group, kv_group=servicer.kv_group,
                          on_unrecoverable=on_unrecoverable)
    servicer.set_recovery_plane(plane)
    plane.start()
    return plane


def recovery_summary(servicer, plane) -> dict:
    return {
        "recoveries": [list(r) for r in plane.recoveries()] if plane else [],
        "unrecoverable": [list(u) for u in plane.unrecoverable()] if plane else [],
        "recovery_timelines": plane.timelines() if plane else [],
        "generations": {
            "ps": list(servicer.ps_group.generations) if servicer.ps_group else [],
            "kv": list(servicer.kv_group.generations) if servicer.kv_group else [],
        },
    }


def make_backend(args):
    """The worker backend; raises ValueError for one not ported yet."""
    if args.worker_backend != "process":
        raise ValueError(
            f"--worker_backend {args.worker_backend} is not ported yet "
            "(the port runs process workers only)"
        )
    from elasticdl_tpu_torch.cluster.pod_backend import ProcessBackend

    return ProcessBackend(log_dir=os.environ.get(ENV_WORKER_LOG_DIR, ""))


def observe_master(servicer):
    """The master's observability plane: an uncaught exception dumps the
    flight recorder (`obs/flight.py`); ReportPhaseStats feeds a
    `PhaseStatsAggregator`, whose newest cumulative snapshot per worker
    the metrics registry reads as `edl_phase_seconds_total` and
    `edl_phase_count_total` {phase, worker}; the `EDL_METRICS_PORT`
    listener starts when that is set. Returns the phase collector, which
    the caller unregisters when the job ends."""
    from elasticdl_tpu_torch.sched.telemetry import PhaseStatsAggregator

    obs_flight.install_crash_dump()
    aggregator = PhaseStatsAggregator()
    servicer.set_phase_stats_sink(aggregator.ingest)

    def phase_collector(sink):
        for wid, phases in aggregator.latest_cumulative().items():
            for name, cell in (phases or {}).items():
                sink.counter("edl_phase_seconds_total", float(cell.get("seconds", 0.0)),
                             phase=name, worker=str(wid))
                sink.counter("edl_phase_count_total", float(cell.get("count", 0.0)),
                             phase=name, worker=str(wid))

    obs_metrics.get_registry().register_collector(phase_collector)
    obs_metrics.maybe_serve_from_env()
    return phase_collector


def run(argv=None, on_start=None):
    """(exit code, summary): the summary is None when the job did not
    start. `on_start(servicer)`, for an in-process caller that watches
    or perturbs the running job (its shard groups hang on the servicer),
    runs once the server listens and the recovery plane is armed, before
    the workers start."""
    args = master_parser().parse_args(argv)
    try:
        job_type = validate_master_args(args)
        backend = make_backend(args)
    except ValueError as e:
        logger.error("invalid arguments: %s", e)
        return 1, None

    logging.getLogger().setLevel(args.log_level.upper())

    from elasticdl_tpu_torch.common.constants import JobType
    from elasticdl_tpu_torch.common.messages import TaskType
    from elasticdl_tpu_torch.master.worker_manager import WorkerManager
    from elasticdl_tpu_torch.rpc.server import RpcServer

    try:
        _spec, dispatcher, servicer, eval_service, ckpt = build_master(args, job_type)
    except (ValueError, OSError, RuntimeError) as e:
        # a bad data dir, unreadable shards or a bad checkpoint are
        # config errors
        logger.error("master boot failed: %s", e)
        backend.stop()
        return 1, None
    shard_lost = threading.Event()
    plane = None
    phase_collector = None
    try:
        if job_type == JobType.EVALUATION_ONLY:
            eval_service.start_standalone_job(
                servicer.version, dispatcher.pending_count(TaskType.EVALUATION)
            )

        phase_collector = observe_master(servicer)
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
            num_standby=args.num_standby_workers,
        )
        if args.num_standby_workers:
            servicer.set_standby_fn(manager.is_standby)
            if args.training_data_dir:
                servicer.set_sample_batch_fn(make_sample_batch_fn(args.training_data_dir))
        plane = arm_recovery_plane(servicer, lambda kind, shard: shard_lost.set())
        if on_start is not None:
            on_start(servicer)
        t0 = time.perf_counter()
        manager.start_workers()
    except BaseException:
        # no shard process may outlive a failed start
        if plane is not None:
            plane.stop()
        stop_shard_groups(servicer)
        if phase_collector is not None:
            obs_metrics.get_registry().unregister_collector(phase_collector)
        raise

    exit_code = 0
    try:
        while not dispatcher.finished() or (
            eval_service is not None and eval_service.has_pending()
        ):
            if shard_lost.is_set():
                logger.error("a PS or KV shard is unrecoverable: aborting the job")
                exit_code = 2
                break
            if manager.all_exited():
                logger.error(
                    "all workers exited (relaunch budget spent) with "
                    "tasks outstanding"
                )
                exit_code = 2
                break
            time.sleep(0.2)
        if exit_code == 0 and dispatcher.has_failed_tasks():
            logger.error("job completed with dropped (poison) tasks")
            exit_code = 2
        # the last cadence files may still be in the writer's queue
        ckpt.flush()
        if exit_code == 0 and args.output and servicer.model_initialized():
            servicer.save_latest_checkpoint(args.output)
            logger.info("Final model saved to %s", args.output)
        # an aborted job's workers do not finish by themselves
        deadline = time.monotonic() + (0.0 if shard_lost.is_set() else EXIT_GRACE_SECONDS)
        while not manager.all_exited() and time.monotonic() < deadline:
            time.sleep(0.1)
    finally:
        if plane is not None:
            plane.stop()
        manager.stop_relaunch_and_remove_workers()
        backend.stop()
        server.stop()
        ckpt.close()
        if eval_service is not None:
            eval_service.stop()
        if servicer.tb_service is not None:
            servicer.tb_service.close()
        obs_metrics.get_registry().unregister_collector(phase_collector)
        sparse = servicer.sparse_summary()
        try:
            shards = servicer.ps_summary()
        finally:
            stop_shard_groups(servicer)
    summary = {
        "exit_code": exit_code,
        "job_type": job_type,
        "seconds": time.perf_counter() - t0,
        **servicer.exactness(),
        "sparse": sparse,
        "ps_shards": shards,
        **recovery_summary(servicer, plane),
        "relaunches": manager.relaunches(),
        "promotions": manager.promotions(),
        "evaluations": [
            [v, m] for v, m in (eval_service.completed_metrics if eval_service else [])
        ],
        "evaluation_seconds": eval_service.job_seconds if eval_service else [],
        "server": server.stats(),
    }
    logger.info("%s%s", SUMMARY_TAG, json.dumps(summary))
    return exit_code, summary


def main(argv=None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())

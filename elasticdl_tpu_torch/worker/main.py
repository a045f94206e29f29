"""Worker process entry point.

    python -m elasticdl_tpu_torch.worker.main --worker_id 0 \\
        --master_addr localhost:<port> --model_zoo ... --model_def ... \\
        --minibatch_size 8 [--device cpu]

The reference's worker main (`elasticdl_tpu/worker/main.py`): resolve
the device (CUDA unless `--device cpu`: without a card the worker exits
with the "no CUDA device" error before anything else), load the model
spec, wait for the master, fetch its PS config (the boot handshake:
the PS shards' endpoints when the dense model is sharded, and the KV
shards' endpoints when the embedding tables live there, which the
worker then pushes to and looks rows up from directly), run the task
loop.

Exit codes: 0 the job finished cleanly; 1 a crash;
EXIT_CODE_JOB_FAILED (2) the master reported dropped (poison) tasks;
EXIT_CODE_MASTER_UNREACHABLE (3) the master stayed unreachable past the
retry budget, at boot or later (the WorkerManager relaunches it).

SIGTERM (the backend's teardown and `delete_worker`, or a preemption)
latches a drain, as the reference's worker does: the run loop exits at
the next task boundary with every window synced and every task report
delivered, logs "drain requested, exiting at task boundary" and exits
0, so the dispatcher has nothing of it to requeue. A drain that
outlives the backend's grace period is SIGKILLed, and its tasks are
requeued.

At exit the worker logs one line, `worker summary: {json}`: its device,
steps accepted and computed (in per-step mode the difference is stale
recomputes; window mode computes each step once), the evaluation tasks
(and their minibatches) and prediction tasks done, phase seconds, window
mode's sync seconds and merged-back absorbs, whether it drained, the
client's seconds per method and the tier its link runs on, the three
attention kernels' launches by head dim (`launch_counts`) and the
dispatcher's attention fallbacks, the sparse plane's counters (the
KV links' tiers, the rows this worker lazily initialized, the
`edl_gradient` bytes it sent), the sharded PS's (the shard links' tiers,
their seconds per method, the shard versions last seen), the shard
recoveries it waited out and the restore slices the master took from it,
the device's peak allocated bytes,
whether it stood by as a standby (pre-warmed, or failed to) and when it
was promoted, each accepted step's (or landed window's) time
(`time.perf_counter()`) and loss, the per-step pipeline's depth, reports
joined and batches trained again, the background page-in's pulls and
staged models folded in, and the ladder's windows a push with the
adaptive plane's decisions and bytes by wire form.

Not ported yet: master failover candidates and the profiler trace.
"""

from __future__ import annotations

import json
import os
import signal
import sys

from elasticdl_tpu_torch.common.args import worker_parser
from elasticdl_tpu_torch.common.constants import (
    EXIT_CODE_JOB_FAILED,
    EXIT_CODE_MASTER_UNREACHABLE,
)
from elasticdl_tpu_torch.common.log_util import get_logger
from elasticdl_tpu_torch.rpc.policy import StatusCode

logger = get_logger(__name__)

# how long a booting worker waits for its master to listen
BOOT_WAIT_SECONDS = 60.0
SUMMARY_TAG = "worker summary: "


def _is_unreachable(e: BaseException) -> bool:
    """True when an error, or one in its cause/context chain, means the
    master is gone past the retry budget rather than a worker bug."""
    exc, hops = e, 0
    while exc is not None and hops < 8:
        code = getattr(exc, "code", lambda: None)()
        if code in (
            StatusCode.UNAVAILABLE,
            StatusCode.DEADLINE_EXCEEDED,
            StatusCode.CANCELLED,
        ):
            return True
        exc = exc.__cause__ or exc.__context__
        hops += 1
    return False


def _boot_handshake(client) -> dict:
    """First master contact: wait for the listener, then ask for the PS
    config (the PS and KV shards' endpoints, or none)."""
    client.wait_ready(timeout=BOOT_WAIT_SECONDS)
    return client.call("GetPSConfig", {})


def _summary(worker_id, worker, client, device) -> dict:
    import torch

    from elasticdl_tpu_torch.ops import flash_attention as fa

    return {
        "worker_id": worker_id,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "steps_accepted": worker.steps_accepted,
        "steps_computed": worker.steps_computed,
        "phase_seconds": dict(worker.phase_seconds),
        "sync_seconds": dict(worker.sync_seconds),
        "merged_back": worker.merged_back,
        "deduped_windows": worker.deduped_windows,
        "drained": worker.drained,
        "eval_tasks": worker.eval_tasks,
        "eval_minibatches": worker.eval_minibatches,
        "prediction_tasks": worker.prediction_tasks,
        # aux trees (BatchNorm statistics) taken from the PS, by RPC
        "aux_absorbed": dict(worker.aux_absorbed),
        "rpc_seconds": dict(client.seconds),
        "rpc_codec_seconds": dict(client.codec_seconds),
        "tier": client.tier,
        "kv_tiers": worker.kv_tiers,
        # the sharded PS: each shard link's tier, the fan-out's seconds
        # per method summed over the links, and the shard versions last seen
        "ps_tiers": worker.ps_tiers,
        "ps_rpc_seconds": worker.ps_rpc_seconds(),
        "shard_versions": worker.shard_versions,
        # shard recovery: recoveries waited out, restore slices uploaded
        "shard_recoveries_observed": worker.shard_recoveries_observed,
        "restore_uploads": worker.restore_uploads,
        "lazy_init_rows": worker.lazy_init_rows,
        "edl_gradient_bytes": worker.edl_gradient_bytes,
        "peak_memory_bytes": (
            torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        ),
        "was_standby": worker.was_standby,
        "standby_prewarmed": worker.standby_prewarmed,
        "standby_prewarm_failed": worker.standby_prewarm_failed,
        "standby_prewarm_seconds": worker.standby_prewarm_seconds,
        "promoted_at": worker.promoted_at,
        "launches": fa.launch_counts(),
        "attention_fallbacks": fa.attention.fallbacks,
        "accepted_at": [t for t, _loss in worker.step_log],
        "losses": [loss for _t, loss in worker.step_log],
        # window mode: (time landed, steps, last step's loss) per window sync
        "windows": [list(w) for w in worker.window_log],
        # the per-step pipeline: its depth, reports joined, batches
        # trained again after a rejection
        "step_pipeline": worker._step_pipeline,
        "step_reports_joined": worker.step_reports_joined,
        "step_retrained": worker.step_retrained,
        # the background page-in: pulls started, staged models folded in
        "bg_pulls": worker.bg_pulls,
        "staged_applied": worker.staged_applied,
        # the ladder and the adaptive plane: windows a push, each
        # adaptive round's decision, the bytes and rounds of each form
        "sync_local_steps": worker._sync_local_steps,
        "sync_decisions": worker.sync_decisions,
        "wire_forms": worker.wire_forms,
    }


def read_summaries(log_dir: str) -> dict:
    """{worker id: summary} from the worker logs in `log_dir` (a worker
    killed before its exit has none)."""
    out = {}
    for name in sorted(os.listdir(log_dir)):
        with open(os.path.join(log_dir, name)) as f:
            for line in f:
                if SUMMARY_TAG in line:
                    summary = json.loads(line.split(SUMMARY_TAG, 1)[1])
                    out[summary["worker_id"]] = summary
    return out


def main(argv=None) -> int:
    args = worker_parser().parse_args(argv)

    import logging

    logging.getLogger().setLevel(args.log_level.upper())

    from elasticdl_tpu_torch.api.model_spec import get_model_spec
    from elasticdl_tpu_torch.rpc.client import RpcClient
    from elasticdl_tpu_torch.worker.worker import Worker, resolve_device

    device = resolve_device(args.device)
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
    client = RpcClient(args.master_addr)
    try:
        ps_config = _boot_handshake(client)
    except Exception as e:
        client.close()
        if _is_unreachable(e):
            logger.error(
                "master %s unreachable past the retry budget; exiting %d "
                "for relaunch: %s",
                args.master_addr,
                EXIT_CODE_MASTER_UNREACHABLE,
                e,
            )
            return EXIT_CODE_MASTER_UNREACHABLE
        raise
    worker = Worker(
        args.worker_id,
        client,
        spec,
        minibatch_size=args.minibatch_size,
        device=device,
        local_updates=args.local_updates,
        transport_dtype=args.transport_dtype,
        sync_dtype=args.sync_dtype or None,
        sync_compress=args.sync_compress or None,
        overlap_sync=args.overlap_sync or None,
        kv_endpoints=ps_config.get("kv_endpoints") or None,
        ps_endpoints=ps_config.get("endpoints") or None,
        step_pipeline=args.step_pipeline,
        # unset flags leave EDL_SYNC_LOCAL_STEPS / EDL_SYNC_ADAPTIVE to apply
        sync_local_steps=args.sync_local_steps if args.sync_local_steps != 1 else None,
        sync_adaptive=args.sync_adaptive or None,
    )
    # teardown and preemption send SIGTERM: drain at the next task
    # boundary instead of dying with windows and reports in flight
    signal.signal(signal.SIGTERM, lambda s, f: worker.request_drain())
    unreachable = False
    try:
        clean = worker.run()
    except Exception as e:
        if not _is_unreachable(e):
            raise
        logger.error(
            "master unreachable past the retry budget; exiting %d for relaunch: %s",
            EXIT_CODE_MASTER_UNREACHABLE,
            e,
        )
        unreachable = True
        clean = False
    finally:
        try:
            worker.close()  # window mode: joins the sync chain, flushes reports
        except Exception:
            # a failed final sync has already reported its tasks as
            # failed, so the dispatcher requeues them
            logger.exception("worker %d: final sync failed", args.worker_id)
        summary = _summary(args.worker_id, worker, client, device)
        logger.info("%s%s", SUMMARY_TAG, json.dumps(summary))
        client.close()
    if unreachable:
        return EXIT_CODE_MASTER_UNREACHABLE
    return 0 if clean else EXIT_CODE_JOB_FAILED


if __name__ == "__main__":
    sys.exit(main())

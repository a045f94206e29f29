"""Command-line flags: the config protocol between the master and its
workers.

The reference's layered flag sets (`elasticdl_tpu/common/args.py`),
carrying only the flags that the process-mode training job reads, under
the reference's names and defaults. The master forwards the model-spec
subset to each worker as its argv (`worker_forward_args`).

One flag is the port's own: `--device` (default "cuda") on both
parsers, which the master forwards to its workers. It is the explicit
CPU request that tests make; a worker never falls back to the CPU on
its own.

Window mode and its sync plane are carried (`--local_updates`,
`--transport_dtype`, `--sync_dtype`, `--sync_compress`,
`--overlap_sync`, the local-steps ladder `--sync_local_steps` and the
adaptive wire plane `--sync_adaptive`), and so is the per-step pipeline
(`--step_pipeline`: -1, auto, on the master, which
`resolve_step_pipeline` turns into the depth it forwards to every
worker), and so are the master's job services: async and staleness
(`--use_async`, `--lr_staleness_modulation`, `--staleness_window`),
evaluation and prediction data and the evaluation cadence, checkpoints
and resume (`--checkpoint_filename_for_init`), the metrics sink
(`--tensorboard_log_dir`), warm standby workers
(`--num_standby_workers`: a master flag, not forwarded; the master tells
a standby through GetTask), and the KV shards of the embedding tables
(`--num_kv_shards`, `--kv_mode`: master flags; workers learn the
endpoints from GetPSConfig), and the sharded PS (`--num_ps`,
`--ps_mode`: master flags; `validate_ps_args` refuses strict per-step
sync with shards; each shard process gets `ps_shard_forward_args`, and
workers learn the endpoints from GetPSConfig), and `--profile_dir`
(forwarded: each worker process writes its torch.profiler trace under
`<profile_dir>/worker-<id>/`). Not carried, so argparse rejects them:
the bucketed push (`--sync_bucket_bytes`), the fan-in combine, the
aggregators, the policy plane, the k8s pod settings,
`--keep_tensorboard_running` and master failover candidates.
"""

from __future__ import annotations

import argparse
import os
from typing import List

# the port's model zoo, where `--model_def` resolves by default
ZOO_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "models")


def pos_int(value: str) -> int:
    v = int(value)
    if v <= 0:
        raise argparse.ArgumentTypeError(f"must be > 0, got {value}")
    return v


def non_neg_int(value: str) -> int:
    v = int(value)
    if v < 0:
        raise argparse.ArgumentTypeError(f"must be >= 0, got {value}")
    return v


def parse_envs(env_str: str) -> dict:
    """``"k=v,k2=v2"`` -> dict."""
    out = {}
    if not env_str:
        return out
    for kv in env_str.split(","):
        if not kv.strip():
            continue
        k, _, v = kv.partition("=")
        out[k.strip()] = v.strip()
    return out


def add_model_spec_args(parser: argparse.ArgumentParser):
    """Flags describing the user model, shared by master and worker and
    forwarded master -> worker."""
    parser.add_argument(
        "--model_zoo", default=ZOO_DIR,
        help="directory containing the model-zoo modules (default: the "
        "port's own, elasticdl_tpu_torch/models)",
    )
    parser.add_argument(
        "--model_def", required=True,
        help='"file.symbol" of the model factory inside --model_zoo, '
        'e.g. "transformer_lm_zoo.custom_model"',
    )
    parser.add_argument("--model_params", default="", help='"k=v,k2=v2" ctor params')
    parser.add_argument("--dataset_fn", default="dataset_fn")
    parser.add_argument("--loss", default="loss")
    parser.add_argument("--optimizer", default="optimizer")
    parser.add_argument("--eval_metrics_fn", default="eval_metrics_fn")
    parser.add_argument(
        "--prediction_outputs_processor", default="PredictionOutputsProcessor"
    )
    parser.add_argument("--minibatch_size", type=pos_int, required=True)
    parser.add_argument(
        "--local_updates", type=non_neg_int, default=0,
        help="N>0: on-device optimizer with one delta sync per N steps "
        "(SSP/local-SGD); 0: per-step sync SGD via the PS",
    )
    parser.add_argument(
        "--transport_dtype", default="float32", choices=("float32", "bfloat16"),
        help="wire dtype for gradients/deltas",
    )
    parser.add_argument(
        "--sync_dtype", default="",
        choices=("", "float32", "bfloat16", "bf16", "int8"),
        help="sync-plane wire dtype: bf16/int8 send window deltas / "
        "per-step grads quantized (int8 = per-chunk scaled) with an "
        "error-feedback residual held on the worker (default float32 = "
        "bit-exact)",
    )
    parser.add_argument(
        "--sync_compress", default="",
        help="sync-plane delta sparsification: topk:<ratio> ships only "
        "the ratio*n largest-magnitude window-delta entries, "
        "error-feedback corrected; composes with --sync_dtype int8/bf16 "
        "for the values (default off)",
    )
    parser.add_argument(
        "--sync_local_steps", type=pos_int, default=1,
        help="local-steps ladder: accumulate k windows of on-device "
        "deltas before pushing one combined super-window delta (one "
        "report_key per push; error-feedback residuals absorb the "
        "longer horizon). 1 = the per-window chain, bit for bit. "
        "EDL_SYNC_LOCAL_STEPS applies when unset",
    )
    parser.add_argument(
        "--sync_adaptive", default="", choices=("", "on", "off"),
        help="link-weather-adaptive wire selection: on lets "
        "sync_policy.decide() pick f32/bf16/int8/topk per round from "
        "push-timing link estimates (mixed rounds are legal); off "
        "(default) keeps the static --sync_dtype/--sync_compress form. "
        "EDL_SYNC_ADAPTIVE applies when unset",
    )
    parser.add_argument(
        "--overlap_sync", default="", choices=("", "on", "off"),
        help="worker overlap plane: on (default) pipelines window-delta "
        "syncs on background threads, pages model-down in on a "
        "background thread and enables BET prefetch; off makes each "
        "window's sync block (depth 0), with no background pull and no "
        "prefetch. EDL_OVERLAP_SYNC applies when unset",
    )
    parser.add_argument("--log_level", default="INFO")
    parser.add_argument(
        "--profile_dir", default="",
        help="write one torch.profiler trace (CPU and CUDA activity, "
        "Chrome trace JSON) per worker process under "
        "<profile_dir>/worker-<id>/",
    )
    parser.add_argument(
        "--device", default="cuda",
        help='torch device the workers compute on; "cpu" only when asked '
        "for (a worker raises when CUDA is asked for and absent)",
    )


def add_master_args(parser: argparse.ArgumentParser):
    """Master-only flags."""
    parser.add_argument("--port", type=non_neg_int, default=0)
    parser.add_argument(
        "--training_data_dir", default="",
        help="RecordIO file or directory of shards for training",
    )
    parser.add_argument("--evaluation_data_dir", default="")
    parser.add_argument("--prediction_data_dir", default="")
    parser.add_argument("--records_per_task", type=pos_int, default=4096)
    parser.add_argument("--num_epochs", type=pos_int, default=1)
    parser.add_argument("--grads_to_wait", type=pos_int, default=2)
    parser.add_argument("--use_async", action="store_true")
    parser.add_argument("--lr_staleness_modulation", action="store_true")
    parser.add_argument("--staleness_window", type=non_neg_int, default=0)
    parser.add_argument(
        "--step_pipeline", type=int, default=-1,
        help="per-step pipeline depth: up to N gradient reports in "
        "flight while later batches compute, so the report round's "
        "latency is divided across N batches (each report may land up "
        "to N versions stale). 0 = off; -1 = auto (4, clamped to "
        "--staleness_window in sync mode; async mode accepts any "
        "depth and down-weights by staleness)",
    )
    parser.add_argument(
        "--num_kv_shards", type=non_neg_int, default=0,
        help="N>0: host the embedding tables behind N KV shard "
        "endpoints (workers look rows up directly, bypassing the "
        "master — the reference's worker->Redis topology); 0: tables "
        "live in the master process",
    )
    parser.add_argument(
        "--kv_mode", default="process", choices=("process", "inproc"),
        help="KV shard hosting: shard subprocesses, or servers in the "
        "master's process",
    )
    parser.add_argument(
        "--num_ps", type=non_neg_int, default=0,
        help="N>0: shard the dense model across N parameter-server "
        "endpoints (workers push and pull slices in parallel); 0: the "
        "master is the single PS",
    )
    parser.add_argument(
        "--ps_mode", default="process", choices=("process", "inproc"),
        help="sharded-PS hosting: shard subprocesses (default) or servers "
        "in the master's process",
    )
    parser.add_argument("--eval_steps", type=non_neg_int, default=0)
    parser.add_argument("--eval_start_delay_secs", type=float, default=0.0)
    parser.add_argument("--eval_throttle_secs", type=float, default=0.0)
    parser.add_argument("--checkpoint_dir", default="")
    parser.add_argument("--checkpoint_steps", type=non_neg_int, default=0)
    parser.add_argument("--keep_checkpoint_max", type=non_neg_int, default=0)
    parser.add_argument(
        "--checkpoint_filename_for_init", default="",
        help="boot the PS from this checkpoint (required for "
        "evaluate/predict jobs)",
    )
    parser.add_argument(
        "--output", default="",
        help="save the final model here when the job finishes",
    )
    parser.add_argument(
        "--tensorboard_log_dir", default="",
        help="write train-loss + eval-metric summaries here "
        "(torch SummaryWriter when available, JSONL fallback)",
    )
    parser.add_argument("--num_workers", type=pos_int, default=1)
    parser.add_argument(
        "--worker_backend", default="process", choices=("process", "k8s"),
        help="process: local subprocess workers; k8s is not ported yet",
    )
    parser.add_argument(
        "--max_worker_relaunches", type=non_neg_int, default=10,
        help="total replacement workers to launch before giving up",
    )
    parser.add_argument(
        "--num_standby_workers", type=non_neg_int, default=0,
        help="warm standby workers held in reserve (pre-booted and "
        "pre-warmed); a standby is promoted instantly when an active "
        "worker dies, removing the boot transient from preemption "
        "recovery",
    )
    parser.add_argument("--envs", default="", help='extra worker env "k=v,..."')


def add_worker_args(parser: argparse.ArgumentParser):
    """Worker-process flags."""
    parser.add_argument("--worker_id", type=non_neg_int, required=True)
    parser.add_argument("--master_addr", required=True)
    # already resolved by the master (resolve_step_pipeline): the
    # worker itself does not know the PS's staleness policy
    parser.add_argument("--step_pipeline", type=non_neg_int, default=0)


def resolve_step_pipeline(args) -> int:
    """The per-step pipeline depth (gradient reports in flight). A
    report may be up to `depth` versions stale when it lands, so sync
    mode clamps the depth to --staleness_window (anything deeper would
    bounce off the rejection path); async mode accepts any staleness
    (down-weighted), so the requested depth stands. Auto (-1) picks 4,
    capped by the window. Window mode (--local_updates) has its own
    chained-sync pipeline and keeps per-step off."""
    if args.local_updates:
        return 0
    depth = 4 if args.step_pipeline < 0 else args.step_pipeline
    if not args.use_async:
        depth = min(depth, args.staleness_window)
    return depth


def master_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="elasticdl_tpu_torch.master", description="ElasticDL (PyTorch) master"
    )
    add_model_spec_args(p)
    add_master_args(p)
    return p


def worker_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="elasticdl_tpu_torch.worker", description="ElasticDL (PyTorch) worker"
    )
    add_model_spec_args(p)
    add_worker_args(p)
    return p


def validate_master_args(args) -> str:
    """Job-type inference and the combination checks; returns the job
    type, raises ValueError for a combination the reference refuses."""
    from elasticdl_tpu_torch.common.constants import JobType

    if args.prediction_data_dir:
        if args.training_data_dir or args.evaluation_data_dir:
            raise ValueError(
                "prediction_data_dir is exclusive of training/evaluation dirs"
            )
        if not args.checkpoint_filename_for_init:
            raise ValueError(
                "prediction jobs require --checkpoint_filename_for_init"
            )
        return JobType.PREDICTION_ONLY
    if args.training_data_dir and args.evaluation_data_dir:
        return JobType.TRAINING_WITH_EVALUATION
    if args.training_data_dir:
        return JobType.TRAINING_ONLY
    if args.evaluation_data_dir:
        if not args.checkpoint_filename_for_init:
            raise ValueError(
                "evaluation jobs require --checkpoint_filename_for_init"
            )
        return JobType.EVALUATION_ONLY
    raise ValueError("one of training/evaluation/prediction data dirs required")


def validate_ps_args(args):
    """The sharded PS's combination check: a strict per-step sync
    rejection cannot be atomic across shards, so `--num_ps` > 0 needs
    window mode, async or a staleness window."""
    if getattr(args, "num_ps", 0) <= 0:
        return
    if not args.use_async and args.local_updates == 0 and args.staleness_window == 0:
        raise ValueError(
            "--num_ps > 0 with strict per-step sync SGD is not supported (a "
            "stale-gradient rejection cannot be atomic across shards): use "
            "--local_updates N, --use_async, or --staleness_window W"
        )


def ps_shard_forward_args(args) -> List[str]:
    """The model-spec flag subset a master forwards to each PS shard
    process (the shard resolves the zoo's `optimizer()` from it)."""
    argv = [
        "--model_zoo", args.model_zoo,
        "--model_def", args.model_def,
        "--minibatch_size", str(args.minibatch_size),
        "--log_level", args.log_level,
    ]
    for flag in ("model_params", "dataset_fn", "loss", "optimizer", "eval_metrics_fn",
                 "prediction_outputs_processor"):
        value = getattr(args, flag)
        if value:
            argv += [f"--{flag}", value]
    return argv


def worker_forward_args(args, worker_id: int, master_addr: str) -> List[str]:
    """The model-spec flag subset a master forwards to each worker."""
    argv = [
        "--worker_id", str(worker_id),
        "--master_addr", master_addr,
        "--model_zoo", args.model_zoo,
        "--model_def", args.model_def,
        "--minibatch_size", str(args.minibatch_size),
        "--local_updates", str(args.local_updates),
        "--transport_dtype", args.transport_dtype,
        "--step_pipeline", str(resolve_step_pipeline(args)),
        "--log_level", args.log_level,
        "--device", args.device,
    ]
    for flag in ("sync_dtype", "sync_compress", "overlap_sync", "sync_adaptive"):
        value = getattr(args, flag)
        if value:
            argv += [f"--{flag}", value]
    if args.sync_local_steps != 1:
        argv += ["--sync_local_steps", str(args.sync_local_steps)]
    for flag in ("model_params", "dataset_fn", "loss", "optimizer", "eval_metrics_fn",
                 "prediction_outputs_processor", "profile_dir"):
        value = getattr(args, flag)
        if value:
            argv += [f"--{flag}", value]
    return argv

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

Not carried, so argparse rejects them: window mode and the sync plane
(`--local_updates`, `--sync_*`, `--transport_dtype`, `--overlap_sync`),
the step pipeline, async and staleness, evaluation and prediction data,
checkpoints and resume, the sharded PS, KV shards and aggregators,
standby workers, the policy plane, the k8s pod settings, TensorBoard,
profiling and master failover candidates.
"""

from __future__ import annotations

import argparse
from typing import List


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
        "--model_zoo", required=True,
        help="directory containing the model-zoo modules",
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
    parser.add_argument("--minibatch_size", type=pos_int, required=True)
    parser.add_argument("--log_level", default="INFO")
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
    parser.add_argument("--records_per_task", type=pos_int, default=4096)
    parser.add_argument("--num_epochs", type=pos_int, default=1)
    parser.add_argument("--grads_to_wait", type=pos_int, default=2)
    parser.add_argument(
        "--output", default="",
        help="save the final model here when the job finishes",
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
    parser.add_argument("--envs", default="", help='extra worker env "k=v,..."')


def add_worker_args(parser: argparse.ArgumentParser):
    """Worker-process flags."""
    parser.add_argument("--worker_id", type=non_neg_int, required=True)
    parser.add_argument("--master_addr", required=True)


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
    """The job type; raises ValueError without training data (the only
    job type ported)."""
    from elasticdl_tpu_torch.common.constants import JobType

    if args.training_data_dir:
        return JobType.TRAINING_ONLY
    raise ValueError("one of training/evaluation/prediction data dirs required")


def worker_forward_args(args, worker_id: int, master_addr: str) -> List[str]:
    """The model-spec flag subset a master forwards to each worker."""
    argv = [
        "--worker_id", str(worker_id),
        "--master_addr", master_addr,
        "--model_zoo", args.model_zoo,
        "--model_def", args.model_def,
        "--minibatch_size", str(args.minibatch_size),
        "--log_level", args.log_level,
        "--device", args.device,
    ]
    for flag in ("model_params", "dataset_fn", "loss", "optimizer"):
        value = getattr(args, flag)
        if value:
            argv += [f"--{flag}", value]
    return argv

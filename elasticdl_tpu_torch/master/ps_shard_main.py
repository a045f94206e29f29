"""PS shard process entry point.

    python -m elasticdl_tpu_torch.master.ps_shard_main --shard_id 0 \\
        --num_shards 2 --model_def transformer_lm_zoo.custom_model \\
        --minibatch_size 8 [--port 0 --port_file <path>] [--use_async ...] \\
        [--generation 1 --shm_scope <job nonce>.ps0]

The reference's `elasticdl_tpu/master/ps_shard_main.py`: one
`PSShardServicer` (a contiguous slice of the flat model and its
optimizer state) behind an RPC endpoint, spawned by the master's
`PSShardGroup` in process mode. The slice math is model-oblivious, so
the shard needs only the user's optimizer: it takes the model-spec flags
and resolves the zoo's `optimizer()` as master and workers do. It binds
an ephemeral port and publishes it through `--port_file` (written to a
temporary file and renamed), keeps its slice and optimizer in host
memory (the optimizer runs in torch on the CPU, as the master's PS
does: a shard never touches the card), and exits 0 on SIGTERM or SIGINT
after closing its listeners, logging its `stats()` as `PS shard stats:
{json}`. `--generation` is the slot's fencing epoch (bumped on every
relaunch: requests stamped with another are rejected, `rpc/fencing.py`),
and `--shm_scope` the slot's shm segment namespace, stable across
relaunches, so that a relaunch sweeps a SIGKILLed predecessor's
segments.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
import threading

from elasticdl_tpu_torch.common.args import add_model_spec_args, non_neg_int, pos_int
from elasticdl_tpu_torch.common.log_util import get_logger

logger = get_logger(__name__)

STATS_TAG = "PS shard stats: "


def ps_shard_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="elasticdl_tpu_torch.master.ps_shard_main",
        description="ElasticDL (PyTorch) parameter-server shard",
    )
    add_model_spec_args(p)
    p.add_argument("--shard_id", type=non_neg_int, required=True)
    p.add_argument("--num_shards", type=pos_int, required=True)
    p.add_argument("--port", type=non_neg_int, default=0)
    p.add_argument("--port_file", default="",
                   help="publish the bound port here (ephemeral-port discovery)")
    p.add_argument("--grads_to_wait", type=pos_int, default=1)
    p.add_argument("--use_async", action="store_true")
    p.add_argument("--lr_staleness_modulation", action="store_true")
    p.add_argument("--staleness_window", type=non_neg_int, default=0)
    p.add_argument("--generation", type=non_neg_int, default=0,
                   help="fencing epoch of this shard slot (bumped per relaunch; requests "
                   "carrying another epoch are rejected)")
    p.add_argument("--shm_scope", default="",
                   help="shm-tier segment namespace of this shard slot (stable across "
                   "relaunches; keys the sweep of a dead predecessor's segments)")
    p.add_argument("--dedup_cap", type=non_neg_int, default=0,
                   help="push dedup ring capacity (0: the servicer's default; the "
                   "group sizes it by the job's workers)")
    return p


def main(argv=None) -> int:
    args = ps_shard_parser().parse_args(argv)
    logging.getLogger().setLevel(args.log_level.upper())

    from elasticdl_tpu_torch.api.model_spec import get_model_spec
    from elasticdl_tpu_torch.master.ps_optimizer import PSOptimizer
    from elasticdl_tpu_torch.master.ps_shard import PSShardServicer
    from elasticdl_tpu_torch.rpc.server import RpcServer

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
    servicer = PSShardServicer(
        args.shard_id,
        args.num_shards,
        optimizer=PSOptimizer(spec.optimizer()),
        grads_to_wait=args.grads_to_wait,
        use_async=args.use_async,
        lr_staleness_modulation=args.lr_staleness_modulation,
        staleness_window=args.staleness_window,
        generation=args.generation,
        dedup_cap=args.dedup_cap or None,
    )
    server = RpcServer(servicer.handlers(), port=args.port,
                       shm_scope=args.shm_scope or None, shm_generation=args.generation)
    server.start()
    servicer.register_metrics()
    # an uncaught exception leaves a flight-recorder dump (obs/flight.py)
    from elasticdl_tpu_torch.obs import flight

    flight.install_crash_dump()
    logger.info("PS shard %d/%d (generation %d) listening on :%d", args.shard_id,
                args.num_shards, args.generation, server.port)
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(server.port))
        os.replace(tmp, args.port_file)

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda s, f: stop.set())
    signal.signal(signal.SIGINT, lambda s, f: stop.set())
    stop.wait()
    server.stop()
    logger.info("%s%s", STATS_TAG, json.dumps(servicer.stats()))
    return 0


if __name__ == "__main__":
    sys.exit(main())

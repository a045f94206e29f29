"""KV shard process entry point.

    python -m elasticdl_tpu_torch.master.kv_shard_main --shard_id 0 \\
        --num_shards 2 [--port 0 --port_file <path>] [--generation 1 \\
        --shm_scope <job nonce>.kv0]

The reference's `elasticdl_tpu/master/kv_shard_main.py`: one
`KVShardServicer` (an id-hash slice of the embedding tables and their
optimizer slot rows) behind an RPC endpoint, spawned by the master's
`KVShardGroup` in process mode. A shard is model-oblivious (id-keyed
rows; the sparse optimizer runs in the master) and keeps its rows in
host memory: it never touches the card. It publishes its bound port
through `--port_file` (written to a temporary file and renamed), logs
which store serves ("native" or "python"), and exits 0 on SIGTERM or
SIGINT after closing its listeners and joining its mirror thread.
`--generation` and `--shm_scope` are the slot's fencing epoch and shm
segment namespace, as for a PS shard (`ps_shard_main`).
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import threading

from elasticdl_tpu_torch.common.args import non_neg_int, pos_int
from elasticdl_tpu_torch.common.log_util import get_logger

logger = get_logger(__name__)


def kv_shard_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="elasticdl_tpu_torch.master.kv_shard_main",
        description="ElasticDL (PyTorch) embedding KV shard",
    )
    p.add_argument("--shard_id", type=non_neg_int, required=True)
    p.add_argument("--num_shards", type=pos_int, required=True)
    p.add_argument("--port", type=non_neg_int, default=0)
    p.add_argument("--port_file", default="",
                   help="publish the bound port here (ephemeral-port discovery)")
    p.add_argument("--log_level", default="INFO")
    p.add_argument("--generation", type=non_neg_int, default=0,
                   help="fencing epoch of this shard slot (bumped per relaunch; requests "
                   "carrying another epoch are rejected)")
    p.add_argument("--shm_scope", default="",
                   help="shm-tier segment namespace of this shard slot (stable across "
                   "relaunches; keys the sweep of a dead predecessor's segments)")
    return p


def main(argv=None) -> int:
    args = kv_shard_parser().parse_args(argv)
    logging.getLogger().setLevel(args.log_level.upper())

    from elasticdl_tpu_torch.master.embedding_store import NativeEmbeddingStore
    from elasticdl_tpu_torch.master.kv_shard import KVShardServicer
    from elasticdl_tpu_torch.rpc.server import RpcServer

    servicer = KVShardServicer(args.shard_id, args.num_shards, generation=args.generation)
    server = RpcServer(servicer.handlers(), port=args.port,
                       shm_scope=args.shm_scope or None, shm_generation=args.generation)
    server.start()
    servicer.register_metrics()
    # an uncaught exception leaves a flight-recorder dump (obs/flight.py)
    from elasticdl_tpu_torch.obs import flight

    flight.install_crash_dump()
    native = isinstance(servicer.store, NativeEmbeddingStore)
    logger.info("KV shard %d/%d (generation %d) listening on :%d (%s store)", args.shard_id,
                args.num_shards, args.generation, server.port,
                "native" if native else "python")
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
    servicer.close()  # joins the mirror thread
    st = servicer.stats()
    logger.info("KV shard %d: %d lookups, %d updates, %d rows, %d writes mirrored, "
                "%d mirror drops", args.shard_id, st["lookups"], st["updates"], st["n"],
                st["mirrored_writes"], st["mirror_drops"])
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Constants the port reads (a subset of the reference's registry)."""

# Process exit code for "job completed but with dropped poison tasks":
# deliberate partial-data completion, distinct from a crash. The
# WorkerManager does not relaunch a worker that exits with it.
EXIT_CODE_JOB_FAILED = 2

# Worker exit code for "master unreachable past the retry budget":
# distinct from a crash (1), and relaunch-eligible (the master may be
# back by relaunch time).
EXIT_CODE_MASTER_UNREACHABLE = 3


class JobType(object):
    TRAINING_ONLY = "training"
    EVALUATION_ONLY = "evaluation"
    PREDICTION_ONLY = "prediction"
    TRAINING_WITH_EVALUATION = "training_with_evaluation"


class Mode(object):
    TRAINING = "training"
    EVALUATION = "evaluation"
    PREDICTION = "prediction"


# Worker gives up on a minibatch after this many stale-gradient retries
MAX_MINIBATCH_RETRY_NUM = 64

# Directory the process backend writes worker-<id>.log files into
ENV_WORKER_LOG_DIR = "EDL_WORKER_LOG_DIR"

# The metrics sink's writer backend (master/tensorboard_service.py):
# "torch" (tfevents through torch's SummaryWriter) or "jsonl"; unset,
# the service's own default ("auto": torch where it imports, else jsonl)
ENV_TB_BACKEND = "EDL_TPU_TB_BACKEND"

# Window mode's sync plane (worker/worker.py), the reference's names and
# defaults: how many window syncs may be in flight per worker (0: each
# window's sync blocks; default 2), and the overlap gate ("on" by
# default; "off" forces depth 0). --overlap_sync takes precedence.
ENV_SYNC_DEPTH = "EDL_SYNC_DEPTH"
DEFAULT_SYNC_DEPTH = 2
ENV_OVERLAP_SYNC = "EDL_OVERLAP_SYNC"
# The local-steps ladder (windows a push) and the adaptive wire plane;
# --sync_local_steps and --sync_adaptive take precedence
ENV_SYNC_LOCAL_STEPS = "EDL_SYNC_LOCAL_STEPS"
ENV_SYNC_ADAPTIVE = "EDL_SYNC_ADAPTIVE"

# The RPC plane's transport tiers (rpc/transport.py), the reference's
# names and defaults; `ENV_REGISTRY` carries the reference's help text
# (its "grpc" is the port's TCP tier, and the port's socket, rendezvous
# and segment names start with "edlt", so that they never collide with
# the reference's on one host)
ENV_TRANSPORT = "EDL_TRANSPORT"
ENV_UDS_DIR = "EDL_UDS_DIR"
ENV_TRANSPORT_SHM_RING = "EDL_TRANSPORT_SHM_RING_BYTES"
ENV_TRANSPORT_SHM_DOORBELL_TIMEOUT = "EDL_TRANSPORT_SHM_DOORBELL_TIMEOUT"

# The sparse plane (api/layers.py, master/embedding_store.py): window
# mode's BET lookahead on a background thread ("0" turns it off), and
# the switch that forces the Python embedding store over the C++ one
ENV_BET_PREFETCH = "EDL_BET_PREFETCH"
ENV_NO_NATIVE_KV = "EDL_TPU_NO_NATIVE_KV"

# The shard recovery plane (master/recovery.py): seconds between the
# snapshots of each PS shard's optimizer state (default 2.0)
ENV_OPT_MIRROR_SECS = "EDL_OPT_MIRROR_SECS"

# Every environment variable the port reads, with its help text. The PS
# and KV shard processes read the transport tier's (EDL_TRANSPORT,
# EDL_UDS_DIR and the shm ring's), which their group passes on.
ENV_REGISTRY = {
    ENV_TB_BACKEND: (
        "TensorBoard event-writer backend override "
        "(master/tensorboard_service.py)"
    ),
    ENV_WORKER_LOG_DIR: (
        "directory for per-worker log files under the ProcessBackend "
        "(empty = inherit stdio)"
    ),
    ENV_SYNC_DEPTH: (
        "max in-flight pipelined window syncs per worker (0 serializes; "
        "default 2)"
    ),
    ENV_OVERLAP_SYNC: (
        "worker overlap plane: on (default) pipelines window-delta "
        "syncs on sync threads, pages model-down in on a background "
        "thread and enables BET prefetch; off restores the serial "
        "blocking sync chain (worker/worker.py; CLI --overlap_sync)"
    ),
    ENV_SYNC_LOCAL_STEPS: (
        "local-steps ladder: accumulate k windows of on-device deltas "
        "before pushing one combined super-window delta (one "
        "report_key per push; error-feedback residuals absorb the "
        "longer horizon). Default 1 = today's per-window chain, "
        "bit-for-bit (CLI --sync_local_steps)"
    ),
    ENV_SYNC_ADAPTIVE: (
        "link-weather-adaptive wire selection: on lets "
        "sync_policy.decide() pick f32/bf16/int8/topk per round from "
        "push-timing link estimates (mixed rounds are legal; the PS "
        "decodes every form per-push); off (default) keeps the static "
        "--sync_dtype/--sync_compress form (CLI --sync_adaptive)"
    ),
    ENV_BET_PREFETCH: (
        "0 disables the batched-embedding-training lookup prefetch "
        "overlap (default on)"
    ),
    ENV_NO_NATIVE_KV: (
        "1 disables the C++ embedding-store arena, forcing the "
        "lock-striped Python store"
    ),
    ENV_OPT_MIRROR_SECS: (
        "recovery plane: seconds between PS optimizer-state mirror "
        "snapshots (bounded-staleness restore ring, master/recovery.py; "
        "default 2.0)"
    ),
    ENV_TRANSPORT: (
        "RPC transport tier: grpc (default), uds (Unix-domain-socket "
        "fast path to co-located shards), shm (shared-memory rings "
        "with a UDS doorbell — codec frames never cross a socket), "
        "inproc (same-interpreter direct dispatch), or auto (prefer "
        "inproc, then shm, then uds, then grpc); non-grpc tiers apply "
        "when the endpoint resolves local, else fall back to grpc "
        "(rpc/transport.py)"
    ),
    ENV_UDS_DIR: (
        "directory for the UDS fast-path sockets (edlt-uds-<port>.sock) "
        "and the shm tier's doorbell sockets + rendezvous files "
        "(edlt-shm-<port>.{sock,json}); default: the system temp dir — "
        "must be shared by co-located processes"
    ),
    ENV_TRANSPORT_SHM_RING: (
        "shm tier: per-direction ring capacity in bytes for each "
        "connection's shared-memory segment (default 4194304 = 4 MiB, "
        "rounded up to the 64-byte codec segment alignment); frames "
        "larger than the ring fall back to a chunked copy path"
    ),
    ENV_TRANSPORT_SHM_DOORBELL_TIMEOUT: (
        "shm tier: seconds for doorbell handshake and chunk-ack socket "
        "operations (default 5.0); per-call deadlines still come from "
        "the caller's RPC timeout budget"
    ),
}

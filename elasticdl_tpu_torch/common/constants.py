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

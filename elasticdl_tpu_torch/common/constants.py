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
    """The one job type ported."""

    TRAINING_ONLY = "training"


class Mode(object):
    TRAINING = "training"
    EVALUATION = "evaluation"
    PREDICTION = "prediction"


# Worker gives up on a minibatch after this many stale-gradient retries
MAX_MINIBATCH_RETRY_NUM = 64

# Directory the process backend writes worker-<id>.log files into
ENV_WORKER_LOG_DIR = "EDL_WORKER_LOG_DIR"

"""Constants the port reads (a subset of the reference's registry)."""


class Mode(object):
    TRAINING = "training"
    EVALUATION = "evaluation"
    PREDICTION = "prediction"


# Worker gives up on a minibatch after this many stale-gradient retries
MAX_MINIBATCH_RETRY_NUM = 64

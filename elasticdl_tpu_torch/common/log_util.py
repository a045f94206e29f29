"""Cached stderr loggers."""

import functools
import logging
import sys

_FORMAT = (
    "%(asctime)s %(levelname)s [%(processName)s] "
    "%(module)s:%(lineno)d : %(message)s"
)


@functools.lru_cache(maxsize=None)
def get_logger(name: str, level: str = "INFO") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not logger.handlers:
        handler = logging.StreamHandler(stream=sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
    logger.propagate = False
    return logger

"""The master's metrics sink (`elasticdl_tpu/master/tensorboard_service.py`).

The writer backend is `torch.utils.tensorboard.SummaryWriter` when it
imports (real tfevents files TensorBoard can serve), else a JSONL event
log (`events.jsonl`: one `{"tag", "value", "step", "ts"}` per line).
`EDL_TPU_TB_BACKEND` ("torch" or "jsonl") overrides the "auto" rule.

The service has the two hook shapes the master wires:
`write_eval_metrics(version, metrics)` for the evaluation service's
`metrics_writer` and `write_train_loss(version, loss)` for the
servicer's train-loss hook.

Not ported yet: the local `tensorboard` process and keeping the master
up to serve it after the job (`--keep_tensorboard_running`).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict

from elasticdl_tpu_torch.common.constants import ENV_TB_BACKEND
from elasticdl_tpu_torch.common.log_util import get_logger

logger = get_logger(__name__)


class JsonlSummaryWriter:
    """Append-only JSONL scalar log; the no-dependency fallback."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._path = os.path.join(logdir, "events.jsonl")
        self._f = open(self._path, "a", buffering=1)
        self._lock = threading.Lock()

    def add_scalar(self, tag: str, value: float, step: int):
        with self._lock:
            self._f.write(
                json.dumps({"tag": tag, "value": float(value), "step": int(step),
                            "ts": time.time()})
                + "\n"
            )

    def flush(self):
        with self._lock:
            self._f.flush()

    def close(self):
        with self._lock:
            self._f.close()


def _make_writer(logdir: str, backend: str = "auto"):
    if backend in ("auto", "torch"):
        try:
            from torch.utils.tensorboard import SummaryWriter

            return SummaryWriter(log_dir=logdir)
        except Exception:
            if backend == "torch":
                raise
    return JsonlSummaryWriter(logdir)


class TensorBoardService:
    """Scalar sink for evaluation metrics and the training loss."""

    def __init__(self, logdir: str, backend: str = "auto"):
        self.logdir = logdir
        backend = os.environ.get(ENV_TB_BACKEND, backend)
        self._writer = _make_writer(logdir, backend)
        logger.info("Metrics sink: %s -> %s", type(self._writer).__name__, logdir)

    def write_eval_metrics(self, version: int, metrics: Dict[str, float]):
        """EvaluationService `metrics_writer` callback."""
        for name, value in metrics.items():
            self._writer.add_scalar(f"eval/{name}", value, version)
        self._writer.flush()

    def write_train_loss(self, version: int, loss: float):
        """Servicer train-loss hook."""
        self._writer.add_scalar("train/loss", loss, version)

    def write_scalar(self, tag: str, value: float, step: int):
        self._writer.add_scalar(tag, value, step)

    def close(self):
        self._writer.flush()
        self._writer.close()

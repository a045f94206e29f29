"""The worker: stateless data-plane client of the master/PS.

The reference worker's per-step sync-SGD path on PyTorch:

- GetTask -> read the task's records -> for each minibatch: forward and
  backward on the device -> ReportGradient (flat float32 gradient) with
  the updated model piggybacked back -> absorb it; ReportTaskResult.
- On a stale-version rejection the response already carries the fresh
  model, so the minibatch is recomputed at once, up to
  MAX_MINIBATCH_RETRY_NUM times.
- Lazy PS init: the first worker initializes the model on the host,
  offers it with ReportVariable (first writer wins) and pulls whatever
  won.

The model's parameters live in ONE float32 device buffer (`_flat`, the
wire's flat vector in the reference's leaf order); every module
parameter is a view into it, so absorbing a pulled model is one copy
into that buffer and the gradient comes back as one flat vector.

The worker computes on `device` ("cuda" by default) and raises if that
device is absent; the CPU runs only when the caller asks for it.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from collections import Counter
from typing import Optional

import numpy as np
import torch

from elasticdl_tpu_torch.api.model_spec import ModelSpec
from elasticdl_tpu_torch.common import codec
from elasticdl_tpu_torch.common.constants import MAX_MINIBATCH_RETRY_NUM, Mode
from elasticdl_tpu_torch.common.log_util import get_logger
from elasticdl_tpu_torch.common.messages import MethodType, Task, TaskType
from elasticdl_tpu_torch.worker.task_data_service import ReaderCache, iter_minibatches

logger = get_logger(__name__)


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over `a` without a copy. Decoded wire arrays are
    read-only views; the tensor is only ever read (copied to the
    device), so torch's warning about non-writable arrays is moot."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(a)


class Worker:
    def __init__(
        self,
        worker_id: int,
        master,  # object with .call(method, request) -> dict
        model_spec: ModelSpec,
        minibatch_size: int,
        device="cuda",
        seed: int = 0,
    ):
        self._id = worker_id
        self._master = master
        self._spec = model_spec
        self._model: torch.nn.Module = model_spec.model
        self._minibatch_size = minibatch_size
        self._device = resolve_device(device)
        self._seed = seed
        self._version = -1
        self._fresh = False  # local params == PS latest (skip the next pull)
        self._template = None  # host tree: the model's structure and shapes
        self._flat: Optional[torch.Tensor] = None  # device [n_params] f32
        self._params: list = []  # module parameters in leaf order
        self._job_failed = False
        self._readers = ReaderCache()
        self.task_losses: list = []  # last loss of each training task
        # (time.perf_counter() at acceptance, loss) of every accepted step
        self.step_log: list = []
        # forward + backward passes run, stale recomputes included
        self.steps_computed = 0
        # wall-clock seconds per phase: "compute" (forward + backward,
        # ending in the gradient's copy to the host) and "report" (the
        # ReportGradient round and the model absorb)
        self.phase_seconds: Counter = Counter()

    @contextlib.contextmanager
    def _phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phase_seconds[name] += time.perf_counter() - t0

    # ------------------------------------------------------------------ RPCs

    def get_task(self):
        resp = self._master.call("GetTask", {"worker_id": self._id})
        self._job_failed = resp.get("failed", False)
        return Task.from_wire(resp["task"]), resp.get("finished", False)

    def pull_model(self) -> bool:
        """MINIMUM pull of anything newer than the local model; False if
        the PS holds no model yet."""
        req = {
            "version": self._version,
            "method": MethodType.MINIMUM,
            "only_if_newer": True,
            "flat": self._template is not None,
        }
        resp = self._master.call("GetModel", req)
        if resp["version"] < 0:
            return False
        if resp.get("params_flat") is not None:
            self._set_flat(resp["params_flat"])
        elif resp.get("params") is not None:
            self._init_flat_from_tree(resp["params"])
        self._version = resp["version"]
        self._fresh = True
        return True

    def report_variable(self, params):
        self._master.call("ReportVariable", {"params": params, "aux": None})

    def report_gradient(self, grad_flat: torch.Tensor, loss: torch.Tensor):
        """One ReportGradient round; returns (response, loss value)."""
        req = {
            "worker_id": self._id,
            "version": self._version,
            "gradient_flat": grad_flat.detach().cpu().numpy(),
            "loss": float(loss),
            "return_model": True,
        }
        return self._master.call("ReportGradient", req), req["loss"]

    def report_task_result(self, task_id: int, err: str = ""):
        self._master.call(
            "ReportTaskResult",
            {"task_id": task_id, "err_message": err, "worker_id": self._id},
        )

    # ------------------------------------------------------ flat param buffer

    def _init_flat_from_tree(self, params):
        """Learn the model's structure from a host tree, copy it into one
        device buffer and make every module parameter a view into it."""
        self._template = codec.tree_map(np.asarray, params)
        shapes, sizes, _ = codec.template_meta(self._template)
        flat = _host_tensor(codec.ravel_np(self._template)).to(self._device)
        self._params = []
        off = 0
        for path, shape, n in zip(codec.tree_paths(self._template), shapes, sizes):
            p = self._model.get_parameter(".".join(path))
            if tuple(p.shape) != shape:
                raise ValueError(
                    f"parameter {'.'.join(path)}: model shape {tuple(p.shape)} "
                    f"!= PS shape {shape}"
                )
            p.data = flat[off : off + n].view(shape)
            self._params.append(p)
            off += n
        n_model = sum(p.numel() for p in self._model.parameters())
        if n_model != off:
            raise ValueError(
                f"the model has {n_model} parameters, the PS tree {off}"
            )
        self._flat = flat

    def _set_flat(self, vec):
        self._flat.copy_(_host_tensor(codec.as_f32(vec)))

    def _lazy_init_model(self):
        """Init on the host, offer it to the PS (SETNX: first worker
        wins), then pull whatever won."""
        params = self._model.init_params(self._seed + self._id)
        self._init_flat_from_tree(params)
        self.report_variable(params)
        self.pull_model()

    # ------------------------------------------------------------- training

    def _ensure_step_ready(self, task: Task):
        if not self._fresh or self._version < task.model_version:
            if not self.pull_model():
                self._lazy_init_model()

    def _to_device(self, a) -> torch.Tensor:
        a = np.asarray(a)
        if a.dtype.kind in "iu":
            a = a.astype(np.int64)
        return _host_tensor(a).to(self._device)

    def _train_step(self, features, labels):
        """(loss, flat gradient) on the device, from the current model."""
        outputs = self._model(self._to_device(features))
        loss = self._spec.loss(outputs, self._to_device(labels))
        grads = torch.autograd.grad(loss, self._params)
        return loss.detach(), torch.cat([g.reshape(-1) for g in grads])

    def _absorb_report_response(self, resp):
        """Track freshness and absorb a piggybacked model. Monotonic: an
        older response never rolls the local model back."""
        v = resp["version"]
        if resp.get("params_flat") is not None and v > self._version:
            self._set_flat(resp["params_flat"])
            self._version = v
            self._fresh = True
        elif v == self._version:
            self._fresh = True
        elif v > self._version:
            self._fresh = False  # the PS ran ahead without a piggyback

    def _process_minibatch(self, features, labels, task: Task) -> float:
        """Sync-SGD retry loop: one ReportGradient per minibatch in the
        steady state."""
        for _ in range(MAX_MINIBATCH_RETRY_NUM):
            self._ensure_step_ready(task)
            with self._phase("compute"):
                loss, grad = self._train_step(features, labels)
                grad_h = grad.cpu()
            self.steps_computed += 1
            with self._phase("report"):
                resp, loss_h = self.report_gradient(grad_h, loss)
                self._absorb_report_response(resp)
            if resp["accepted"]:
                self.step_log.append((time.perf_counter(), loss_h))
                return loss_h
        raise RuntimeError("worker stuck: minibatch retries exhausted")

    def _process_training_task(self, task: Task):
        reader = self._readers.get(task.shard_file_name)
        records = list(reader.read_range(task.start, task.end))
        loss = None
        for chunk in iter_minibatches(records, self._minibatch_size):
            features, labels = self._spec.dataset_fn(chunk, Mode.TRAINING)
            loss = self._process_minibatch(features, labels, task)
        if loss is not None:
            self.task_losses.append(loss)
            logger.info(
                "Worker %d task %d done (last loss %.4f, v%d)",
                self._id, task.task_id, loss, self._version,
            )

    def run(self) -> bool:
        """Task loop over TRAINING tasks (the port's dispatcher makes no
        other kind yet). Returns True on clean completion, False when the
        master reported the job finished with dropped tasks. A failure
        inside a task is reported to the master, which requeues the task
        (and drops it after its retry budget), and the loop goes on."""
        while True:
            task, finished = self.get_task()
            if task.type == TaskType.WAIT:
                if finished:
                    return not self._job_failed
                time.sleep(0.05)
                continue
            err = ""
            try:
                self._process_training_task(task)
            except Exception as e:
                logger.exception("Worker %d task %d failed", self._id, task.task_id)
                err = f"{type(e).__name__}: {e}"
            self.report_task_result(task.task_id, err)

    def close(self):
        self._readers.close()

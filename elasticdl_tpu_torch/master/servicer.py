"""The master servicer: task front-end + parameter server.

The reference's `MasterServicer` on the slice's path, sync mode: the
master holds the model as a numpy tree + version counter, serves tasks
and model pulls, and applies gradients. It accepts only flat gradients
computed at the current version, accumulates them, and on the
`grads_to_wait`-th report averages them in float32 numpy, runs the
optimizer and bumps the version. A rejected
report, and an accepted one that saw the version move, carry the fresh
model back (`return_model`), so a steady-state step is one RPC.

Exactness block: `version == init_version + applied_update_steps` holds
under the lock at every instant.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

import numpy as np

from elasticdl_tpu_torch.common import codec
from elasticdl_tpu_torch.common.log_util import get_logger
from elasticdl_tpu_torch.common.messages import MethodType, Task, TaskType
from elasticdl_tpu_torch.master.ps_optimizer import PSOptimizer

logger = get_logger(__name__)


def _to_f32(tree):
    return codec.tree_map(
        lambda a: codec.as_f32(a).copy()
        if isinstance(a, codec.BF16Bits) or np.asarray(a).dtype.kind == "f"
        else np.asarray(a),
        tree,
    )


def _copy(tree):
    return codec.tree_map(np.copy, tree)


class MasterServicer:
    def __init__(
        self,
        grads_to_wait: int,
        optimizer: Optional[PSOptimizer] = None,
        task_dispatcher=None,
        init_params: Any = None,
    ):
        self._lock = threading.Lock()
        self._grads_to_wait = grads_to_wait
        self._opt = optimizer
        self._task_d = task_dispatcher
        self._params = _to_f32(init_params) if init_params is not None else None
        self._aux = None
        self._version = 0
        self._init_version = 0
        self._applied_update_steps = 0
        self._grad_sum = None  # flat f32 accumulator
        self._grad_n = 0
        self._unraveler = None

    def handlers(self) -> Dict[str, Any]:
        return {
            "GetTask": self.get_task,
            "ReportTaskResult": self.report_task_result,
            "GetModel": self.get_model,
            "ReportVariable": self.report_variable,
            "ReportGradient": self.report_gradient,
            "GetPSConfig": self.get_ps_config,
        }

    # -- model state --------------------------------------------------------

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def exactness(self) -> dict:
        """One consistent snapshot of the exactness block."""
        with self._lock:
            return {
                "version": self._version,
                "init_version": self._init_version,
                "applied_update_steps": self._applied_update_steps,
            }

    def model_initialized(self) -> bool:
        with self._lock:
            return self._params is not None

    def get_params_copy(self):
        with self._lock:
            return (
                _copy(self._params) if self._params is not None else None,
                _copy(self._aux) if self._aux is not None else None,
                self._version,
            )

    def save_latest_checkpoint(self, output_path: str):
        """The final model, as `--output` (single PS)."""
        from elasticdl_tpu_torch.master.checkpoint import save_model_file

        with self._lock:
            save_model_file(output_path, self._params, self._version, aux=self._aux)

    # -- RPC: tasks ---------------------------------------------------------

    def get_task(self, req: dict) -> dict:
        """The next shard, or WAIT; `finished` tells workers to exit."""
        task = self._task_d.get(req["worker_id"])
        if task is None:
            finished = self._task_d.finished()
            resp = {"task": Task(type=TaskType.WAIT).to_wire(), "finished": finished}
            if finished:
                resp["failed"] = self._task_d.has_failed_tasks()
            return resp
        return {"task": task.to_wire(), "finished": False}

    def report_task_result(self, req: dict) -> dict:
        err = req.get("err_message", "")
        if err:
            logger.warning("Worker reported error: %s", err)
        self._task_d.report(req["task_id"], not err, worker_id=req.get("worker_id"))
        return {}

    def get_ps_config(self, req: dict) -> dict:
        """Shard discovery for a booting worker: the master is the single
        PS, so there are no PS or KV shard endpoints."""
        return {"endpoints": [], "kv_endpoints": []}

    # -- RPC: model ---------------------------------------------------------

    def get_model(self, req: dict) -> dict:
        """MINIMUM pull of the latest model (tree or flat form)."""
        if req.get("method", MethodType.MINIMUM) != MethodType.MINIMUM:
            raise ValueError("only MINIMUM model pulls are ported")
        with self._lock:
            if self._params is None:
                return {"version": -1, "params": None, "aux": None}
            if req.get("only_if_newer") and self._version <= req.get("version", 0):
                return {"version": self._version, "params": None, "aux": None}
            if req.get("flat"):
                return {
                    "version": self._version,
                    "params_flat": codec.ravel_np(self._params),
                    "aux": self._aux,
                }
            return {
                "version": self._version,
                "params": _copy(self._params),
                "aux": self._aux,
            }

    def report_variable(self, req: dict) -> dict:
        """Lazy model init from the first worker (SETNX: first wins)."""
        with self._lock:
            if self._params is None:
                self._params = _to_f32(req["params"])
                if req.get("aux") is not None:
                    self._aux = req["aux"]
        return {}

    # -- RPC: gradients (the hot path) --------------------------------------

    def report_gradient(self, req: dict) -> dict:
        """Returns {accepted, version[, params_flat, aux]}."""
        report_version = req.get("version", -1)
        with self._lock:
            if self._params is None:
                raise ValueError("gradient reported before model init")
            if req.get("gradient_flat") is None:
                raise ValueError("ReportGradient carries no gradient_flat")
            n_params = sum(
                int(np.asarray(p).size) for p in codec.tree_leaves(self._params)
            )
            grad = codec.delta_to_f32(req["gradient_flat"], n_params)
            if report_version < self._version:
                # stale: reject AND piggyback the fresh model so the
                # worker's retry needs no separate pull
                resp = {"accepted": False, "version": self._version}
                if req.get("return_model"):
                    resp["params_flat"] = codec.ravel_np(self._params)
                    resp["aux"] = self._aux
                return resp
            if report_version > self._version:
                raise ValueError(
                    f"future gradient version {report_version} > {self._version}"
                )
            if self._grad_sum is None:
                self._grad_sum = np.array(grad, dtype=np.float32)
            else:
                self._grad_sum += grad
            self._grad_n += 1
            if self._grad_n >= self._grads_to_wait:
                avg = self._grad_sum / np.float32(self._grad_n)
                # clear BEFORE apply: a failed apply raises to the
                # reporter, and leftovers would double-count its retry
                self._grad_sum = None
                self._grad_n = 0
                self._apply(avg)
            resp = {"accepted": True, "version": self._version}
            if req.get("return_model") and self._version != report_version:
                resp["params_flat"] = codec.ravel_np(self._params)
                resp["aux"] = self._aux
            return resp

    def _apply(self, flat_grad: np.ndarray):  # caller holds self._lock
        if self._unraveler is None:
            self._unraveler = codec.make_unraveler(self._params)
        if self._opt is not None:
            self._params = self._opt.step(self._params, self._unraveler(flat_grad))
        self._version += 1
        self._applied_update_steps += 1

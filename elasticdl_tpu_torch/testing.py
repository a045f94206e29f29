"""Hermetic job harness.

`InProcessMaster` exposes the master's RPC surface to a real Worker
without a network, so a whole training job runs in one process; every
request and response is round-tripped through the wire codec, so
serialization is exercised too. It is thread-safe: window mode calls
it from sync threads beside the worker's main thread.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from typing import Any, Callable, Dict, Optional

from elasticdl_tpu_torch.common import messages


class InProcessMaster:
    """Worker-facing shim over a real MasterServicer. `intercept`
    hooks {method: fn(request) -> request} let tests perturb traffic.
    `handler_seconds` and `codec_seconds` split each method's wall clock
    between the servicer and the wire codec (pack + unpack, both ways)."""

    def __init__(self, servicer, intercept: Optional[Dict[str, Callable]] = None):
        self.servicer = servicer
        self._handlers = servicer.handlers()
        self._intercept = intercept or {}
        self.calls: Dict[str, int] = {}
        self.handler_seconds: Counter = Counter()
        self.codec_seconds: Counter = Counter()
        # window mode calls from its sync threads beside the main thread
        self._lock = threading.Lock()

    def call(self, method: str, request: Any = None) -> Any:
        with self._lock:
            self.calls[method] = self.calls.get(method, 0) + 1
        t0 = time.perf_counter()
        req = messages.unpack(messages.pack(request if request is not None else {}))
        if method in self._intercept:
            req = self._intercept[method](req)
        t1 = time.perf_counter()
        resp = self._handlers[method](req)
        t2 = time.perf_counter()
        out = messages.unpack(messages.pack(resp))
        t3 = time.perf_counter()
        with self._lock:
            self.handler_seconds[method] += t2 - t1
            self.codec_seconds[method] += (t1 - t0) + (t3 - t2)
        return out


def build_job(
    spec,
    dispatcher,
    grads_to_wait: int = 1,
    eval_steps: int = 0,
    checkpoint_dir: str = "",
    checkpoint_steps: int = 0,
    keep_checkpoint_max: int = 0,
    use_async: bool = False,
    lr_staleness_modulation: bool = False,
    staleness_window: int = 0,
    checkpoint_filename_for_init: str = "",
    init_params=None,
    init_aux=None,
    embedding_store=None,
    ps_group=None,
):
    """Wire a MasterServicer and its services from a ModelSpec over
    `dispatcher`, as the master's boot does, the boot from a checkpoint
    included (its params, aux, version and optimizer state). Returns
    (servicer, evaluation service or None, checkpoint service); the
    evaluation service runs when `eval_steps` is set. `init_params` and
    `init_aux` seed the PS at version 0 without a file, else the
    checkpoint or the first worker does. The same servicer takes
    per-step and window-mode workers: window mode's settings are the
    Worker's (`local_updates`, `sync_dtype`, ...). A model with
    `embedding_specs` gets its embedding store (`embedding_store`, e.g.
    a ShardedEmbeddingStore over KV shards, or a new in-process one) and
    the sparse optimizer over it; a checkpoint's tables go into it.
    `ps_group`, a started `PSShardGroup`, makes the PS sharded: the
    checkpoint or `init_params` seed its shards (else the first worker's
    ReportVariable does), and the caller stops it."""
    from elasticdl_tpu_torch.master.checkpoint import CheckpointService, restore_for_init
    from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
    from elasticdl_tpu_torch.master.main import build_sparse_plane
    from elasticdl_tpu_torch.master.ps_optimizer import PSOptimizer
    from elasticdl_tpu_torch.master.servicer import MasterServicer

    ps_opt = PSOptimizer(spec.optimizer())
    store, sparse_opt, _kv = build_sparse_plane(spec, store=embedding_store)
    init_version = 0
    if checkpoint_filename_for_init:
        init_params, init_aux, init_version = restore_for_init(
            checkpoint_filename_for_init, ps_opt, store, ps_group
        )
    elif ps_group is not None and init_params is not None:
        from elasticdl_tpu_torch.common import codec

        ps_group.ensure_init(codec.ravel_np(init_params), init_version)
    ckpt = CheckpointService(
        checkpoint_dir=checkpoint_dir,
        checkpoint_steps=checkpoint_steps,
        keep_checkpoint_max=keep_checkpoint_max,
        embedding_store=store,
    )
    servicer = MasterServicer(
        grads_to_wait=grads_to_wait,
        optimizer=ps_opt,
        task_dispatcher=dispatcher,
        checkpoint_service=ckpt,
        init_params=init_params,
        init_aux=init_aux,
        init_version=init_version,
        use_async=use_async,
        lr_staleness_modulation=lr_staleness_modulation,
        staleness_window=staleness_window,
        embedding_store=store,
        sparse_optimizer=sparse_opt,
        ps_group=ps_group,
    )
    eval_service = None
    if eval_steps:
        eval_service = EvaluationService(
            ckpt, dispatcher, eval_steps=eval_steps, current_model_fn=servicer.get_params_copy
        )
        dispatcher.set_evaluation_service(eval_service)
        servicer.set_evaluation_service(eval_service)
    return servicer, eval_service, ckpt

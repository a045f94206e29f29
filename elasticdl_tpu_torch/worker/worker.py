"""The worker: stateless data-plane client of the master/PS.

The reference worker's two dense training paths on PyTorch:

- **Per-step sync SGD** (`local_updates=0`): GetTask -> read the task's
  records -> for each minibatch: forward and backward on the device ->
  ReportGradient (one flat gradient) with the updated model piggybacked
  back -> absorb it; ReportTaskResult. On a stale-version rejection the
  response already carries the fresh model, so the minibatch is
  recomputed at once, up to MAX_MINIBATCH_RETRY_NUM times.
  `transport_dtype="bfloat16"` sends the gradient as a plain bf16 cast
  and asks for a bf16 model back; `sync_dtype` bfloat16 or int8 sends
  it compressed with an error-feedback residual kept on the device.
- **Window mode** (`local_updates=W > 0`): the optimizer (the spec's
  `ClipAdam`, in place) runs on the device over the flat buffer for W
  minibatches; then one cumulative delta (flat - base) goes to the PS
  (ReportLocalUpdate), which adds it and advances the version by W.
  The W steps are a Python loop of one local step per minibatch, which
  stands in for the reference's `lax.scan`; a task's ragged tail is
  synced when the task ends.
  Syncs chain on background threads, up to `EDL_SYNC_DEPTH` windows in
  flight (`overlap_sync="off"`: depth 0, each sync blocks). The delta
  rides the wire as float32, a bf16 cast (`transport_dtype`), or
  compressed with error feedback (`sync_dtype` bfloat16/int8,
  `sync_compress="topk:<ratio>"`, top-k over bf16 or int8 values): the
  compression error stays on the device as a residual folded into the
  next delta. When another worker synced in between, the PS hands back
  the merged model, and the worker shifts its trajectory (and its
  younger in-flight bases) by merged - base. A task's ReportTaskResult
  waits for the sync that covers its last step, so a worker killed
  before that sync leaves its task to be requeued; `request_drain`
  (SIGTERM) exits at a task boundary with every window synced and
  every report delivered. Windows never straddle tasks (a task ends
  with a sync, and a failed task's unsynced steps are dropped), so each
  window's report key is `f"{spec_key}.w{i}"`: the task's dispatch key
  and the window's index within it. A task replayed after its worker
  died derives the same keys, and the PS absorbs the windows that had
  already landed.

Lazy PS init: the first worker initializes the model on the host,
offers it with ReportVariable (first writer wins) and pulls whatever
won.

The model's parameters live in ONE float32 device buffer (`_flat`, the
wire's flat vector in the reference's leaf order); every module
parameter is a view into it, so absorbing a pulled model is one copy
into that buffer and every update is in place on it.

The worker computes on `device` ("cuda" by default) and raises if that
device is absent; the CPU runs only when the caller asks for it.

Not ported yet: the local-steps ladder, the adaptive wire plane, the
background model page-in, speculative backup tasks, the embedding
window and the sharded PS.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import uuid
import warnings
from collections import Counter, deque
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from elasticdl_tpu_torch.api.model_spec import ModelSpec
from elasticdl_tpu_torch.common import codec
from elasticdl_tpu_torch.common.constants import (
    DEFAULT_SYNC_DEPTH,
    ENV_OVERLAP_SYNC,
    ENV_SYNC_DEPTH,
    MAX_MINIBATCH_RETRY_NUM,
    Mode,
)
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


def _wire_array(t: torch.Tensor):
    """The wire form of a CPU tensor: numpy, or `BF16Bits` for bf16."""
    if t.dtype == torch.bfloat16:
        return codec.BF16Bits(t.view(torch.int16).numpy().view(np.uint16))
    return t.numpy()


def _parse_sync_compress(spec) -> float:
    """"topk:<ratio>" -> the ratio (0 < r <= 1); "" / "none" -> 0.0 (off).
    Anything else raises at worker construction."""
    spec = (spec or "").strip().lower()
    if not spec or spec == "none":
        return 0.0
    if spec.startswith("topk:"):
        try:
            ratio = float(spec.split(":", 1)[1])
        except ValueError:
            ratio = float("nan")
        if 0.0 < ratio <= 1.0:
            return ratio
    raise ValueError(f"unsupported sync_compress {spec!r} (topk:<ratio in (0, 1]>)")


def _sync_depth(overlap_sync: Optional[str]) -> int:
    """Windows that may be in flight: EDL_SYNC_DEPTH (default 2; a
    malformed value falls back to 2), 0 when the overlap plane is off."""
    if overlap_sync is None:
        overlap_sync = os.environ.get(ENV_OVERLAP_SYNC, "") or "on"
    overlap_sync = str(overlap_sync).strip().lower()
    if overlap_sync in ("off", "0", "false"):
        return 0
    if overlap_sync not in ("", "on", "1", "true"):
        raise ValueError(f"unsupported overlap_sync {overlap_sync!r} (on|off)")
    try:
        return max(0, int(os.environ.get(ENV_SYNC_DEPTH, str(DEFAULT_SYNC_DEPTH)).strip()))
    except ValueError:
        logger.warning("ignoring malformed %s; using %d", ENV_SYNC_DEPTH, DEFAULT_SYNC_DEPTH)
        return DEFAULT_SYNC_DEPTH


class Worker:
    def __init__(
        self,
        worker_id: int,
        master,  # object with .call(method, request) -> dict
        model_spec: ModelSpec,
        minibatch_size: int,
        device="cuda",
        seed: int = 0,
        local_updates: int = 0,
        transport_dtype: str = "float32",
        sync_dtype: Optional[str] = None,
        sync_compress: Optional[str] = None,
        overlap_sync: Optional[str] = None,
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
        # of the per-step path
        self.step_log: list = []
        # (time.perf_counter() when it landed, steps, last step's loss) of
        # every window sync
        self.window_log: list = []
        # forward + backward passes run, stale recomputes included
        self.steps_computed = 0
        # wall-clock seconds per phase of the main thread: "compute"
        # (per-step: forward + backward and the gradient's trip to the
        # host; window mode: enqueueing the steps), "report" (the
        # ReportGradient round and the model absorb), "sync_wait" (window
        # mode: joins of the sync chain and its backpressure)
        self.phase_seconds: Counter = Counter()
        # window mode's sync seconds: "quantize" (main thread, enqueueing
        # the delta and its compression), "encode" (sync thread: the wait
        # for the window's device work, the copy to the host and the wire
        # object), "rpc" (the ReportLocalUpdate round), "absorb" (main
        # thread, folding a merged model in)
        self.sync_seconds: Counter = Counter()
        self.merged_back = 0  # merged models absorbed
        self.deduped_windows = 0  # window syncs the PS had already applied
        self.drained = False  # the run loop exited on request_drain

        # -- the sync plane
        if transport_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported transport_dtype {transport_dtype!r}")
        sync_dtype = sync_dtype or "float32"
        sync_dtype = {"bf16": "bfloat16", "f32": "float32"}.get(sync_dtype, sync_dtype)
        if sync_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(
                f"unsupported sync_dtype {sync_dtype!r} (float32|bfloat16|bf16|int8)"
            )
        self._sync_dtype = sync_dtype
        self._topk_ratio = _parse_sync_compress(sync_compress)
        self._transport_dtype = transport_dtype
        if self._lossy_sync() and transport_dtype == "bfloat16":
            # error feedback needs the full-precision delta as its input;
            # the model still comes back in bf16 (_model_wire_dtype)
            logger.info("lossy sync plane (%s) supersedes transport_dtype=bfloat16",
                        self._sync_dtype)
            self._transport_dtype = "float32"
        self._ef_residual: Optional[torch.Tensor] = None  # window-delta EF
        self._ef_grad_residual: Optional[torch.Tensor] = None  # per-step EF

        # -- window mode
        self._local_updates = local_updates
        self._tx = model_spec.optimizer()
        self._opt_state = None  # on-device optimizer state over _flat
        self._base_flat: Optional[torch.Tensor] = None  # params at the last sync
        self._pending_steps = 0  # local steps not yet in a spawned sync
        self._pending_losses: list = []  # (task_id, device loss) per task
        self._latest_step_loss = None  # device scalar of the newest step
        self._max_inflight_syncs = _sync_depth(overlap_sync)
        self._sync_thread: Optional[threading.Thread] = None  # chain tail
        self._sync_inflight: deque = deque()
        self._copy_stream = None  # CUDA stream of the sync threads' copies
        self._sync_seq = 0  # spawn counter: tags merged-back results
        self._synced_seq = 0  # highest seq whose delta landed on the PS
        self._sync_epoch = 0  # bumped on reset: voids spawned syncs
        self._sync_error = None  # raised by a sync thread, surfaced here
        # (seq, params_flat, aux, version) of a merged-back response
        self._sync_result = None
        self._base_snapshots: dict = {}  # seq -> local params at its spawn
        # Delta lineage: a delta's base_version names the model state it
        # was computed from, the last state folded into the local
        # trajectory (a pull, or a sync that landed unmerged, or an
        # absorb) plus this worker's own steps spawned since. Captured at
        # spawn, so a delta computed before an absorb keeps its older base.
        self._lineage_version = -1
        self._own_steps_abs = 0  # steps spawned over the worker's life
        self._lineage_anchor_abs = 0  # _own_steps_abs at the last fold
        self._spawn_abs: dict = {}  # seq -> _own_steps_abs after its spawn
        self._deferred_reports: list = []  # (task_id, err, covering seq)
        self._flushed_report_ids: set = set()  # reported by a flush
        self._report_lock = threading.Lock()  # main + sync threads
        self._stats_lock = threading.Lock()  # sync_seconds, window_log
        self._drain_requested = threading.Event()
        # the current task's dispatch key and its next window's index:
        # window report keys are f"{spec_key}.w{index}"
        self._cur_spec_key = ""
        self._cur_window_idx = 0

    @contextlib.contextmanager
    def _phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phase_seconds[name] += time.perf_counter() - t0

    def _add_sync_seconds(self, name: str, seconds: float):
        with self._stats_lock:
            self.sync_seconds[name] += seconds

    @property
    def steps_accepted(self) -> int:
        """Steps the PS applied from this worker: accepted per-step
        reports plus the steps of every window sync that landed."""
        with self._stats_lock:
            return len(self.step_log) + sum(steps for _t, steps, _l in self.window_log)

    def _lossy_sync(self) -> bool:
        """Whether the window's sync plane compresses (and so keeps an
        error-feedback residual): bf16 or int8, or top-k."""
        return self._sync_dtype in ("bfloat16", "int8") or self._topk_ratio > 0

    def _model_wire_dtype(self) -> Optional[str]:
        """Dtype asked for the piggybacked model: bf16 whenever any lossy
        knob is on. The model is not a delta, so it never comes back
        int8."""
        if self._transport_dtype == "bfloat16" or self._lossy_sync():
            return "bfloat16"
        return None

    # ------------------------------------------------------------------ RPCs

    def get_task(self):
        resp = self._master.call("GetTask", {"worker_id": self._id})
        self._job_failed = resp.get("failed", False)
        return Task.from_wire(resp["task"]), resp.get("finished", False)

    def pull_model(self) -> bool:
        """MINIMUM pull of anything newer than the local model; False if
        the PS holds no model yet."""
        with self._report_lock:
            version = self._version
        req = {
            "version": version,
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
        with self._report_lock:
            self._version = resp["version"]
            self._fresh = True
            self._lineage_version = self._version
            self._lineage_anchor_abs = self._own_steps_abs
        return True

    def report_variable(self, params):
        self._master.call("ReportVariable", {"params": params, "aux": None})

    def report_gradient(self, grad_wire, loss: float):
        """One ReportGradient round with a host-side wire gradient."""
        req = {
            "worker_id": self._id,
            "version": self._version,
            "gradient_flat": grad_wire,
            "loss": loss,
            "return_model": True,
        }
        md = self._model_wire_dtype()
        if md:
            req["model_dtype"] = md
        return self._master.call("ReportGradient", req)

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
        """Copy a wire model (f32 or bf16) into the flat buffer, in place:
        the module's parameters are views into it."""
        self._flat.copy_(_host_tensor(codec.as_f32(vec)))

    def _lazy_init_model(self):
        """Init on the host, offer it to the PS (SETNX: first worker
        wins), then pull whatever won."""
        params = self._model.init_params(self._seed + self._id)
        self._init_flat_from_tree(params)
        self.report_variable(params)
        self.pull_model()

    # ------------------------------------------------- per-step training

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

    def _grad_to_wire(self, grad: torch.Tensor):
        """The per-step gradient's wire form on the host: EF-compressed
        under a bf16/int8 `sync_dtype`, a bf16 cast under
        `transport_dtype`, else float32."""
        if self._sync_dtype in ("bfloat16", "int8"):
            if self._ef_grad_residual is None:
                self._ef_grad_residual = torch.zeros_like(grad)
            meta, arrays, self._ef_grad_residual = self._ef_compress(
                grad + self._ef_grad_residual, topk=False
            )
            return self._materialize_wire_delta(
                meta, [_wire_array(a.cpu()) for a in arrays]
            )
        if self._transport_dtype == "bfloat16":
            return _wire_array(grad.to(torch.bfloat16).cpu())
        return grad.cpu().numpy()

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
                grad_wire = self._grad_to_wire(grad)
                loss_h = float(loss)
            self.steps_computed += 1
            with self._phase("report"):
                resp = self.report_gradient(grad_wire, loss_h)
                self._absorb_report_response(resp)
            if resp["accepted"]:
                self.step_log.append((time.perf_counter(), loss_h))
                return loss_h
        raise RuntimeError("worker stuck: minibatch retries exhausted")

    # ---------------------------------------------- error-feedback compression
    #
    # The wire carries compress(x + residual) and the worker keeps
    # residual' = (x + residual) - decompress(compress(x + residual)) on the
    # device, so the sum the PS applies tracks the float32 sum within one
    # compression quantum of the running total. The math runs on the
    # device at spawn; the sync thread only copies the payload to the host
    # and builds the codec object (_materialize_wire_delta).

    @staticmethod
    def _int8_quantize_dev(comp: torch.Tensor):
        """Per-chunk int8 quantization on the tensor's device, bit for
        bit `codec.quantize_int8`: scale = max|v| / 127 in float32 (1.0
        for an all-zero chunk), a true division, round half to even,
        clip. Returns (q [n] int8, scale [nchunks] f32, dequantized [n])."""
        chunk = codec.DEFAULT_INT8_CHUNK
        n = comp.shape[0]
        pad = (-n) % chunk
        blocks = (F.pad(comp, (0, pad)) if pad else comp).view(-1, chunk)
        # divide by a device tensor: torch's CUDA division by a Python
        # scalar multiplies by its reciprocal, which is not bit for bit
        scale = blocks.abs().amax(dim=1) / torch.full(
            (), 127.0, dtype=torch.float32, device=comp.device
        )
        scale = torch.where(scale > 0, scale, torch.ones_like(scale))
        q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127).to(torch.int8)
        deq = (q.to(torch.float32) * scale[:, None]).view(-1)[:n]
        return q.view(-1)[:n], scale, deq

    def _ef_compress(self, comp: torch.Tensor, topk: bool, dtype=None, ratio=None):
        """Compress `comp` (delta or gradient + residual, f32, consumed)
        by the configured knobs or by `dtype` / `ratio`. Returns (meta,
        device payload tensors, new residual); meta tells
        _materialize_wire_delta how to build the wire object."""
        dtype = self._sync_dtype if dtype is None else dtype
        if topk:
            ratio = self._topk_ratio if ratio is None else ratio
            n = int(comp.shape[0])
            k = min(n, max(1, int(round(ratio * n))))
            idx = torch.topk(comp.abs(), k).indices
            idx = torch.sort(idx).values  # sorted: a PS-shard slice is a range
            vals = comp[idx]
            wire_idx = idx.to(torch.int32)  # as jax.lax.top_k gives them
            if dtype == "int8":
                q, scale, sent = self._int8_quantize_dev(vals)
                comp[idx] = vals - sent
                return ("topk_int8", n, codec.DEFAULT_INT8_CHUNK), (wire_idx, q, scale), comp
            if dtype == "bfloat16":
                qv = vals.to(torch.bfloat16)
                comp[idx] = vals - qv.to(torch.float32)
                return ("topk", n, "bfloat16"), (wire_idx, qv), comp
            # exact values: the only error mass is the dropped tail
            comp[idx] = 0.0
            return ("topk", n, "float32"), (wire_idx, vals), comp
        if dtype == "int8":
            q, scale, deq = self._int8_quantize_dev(comp)
            return ("int8", codec.DEFAULT_INT8_CHUNK), (q, scale), comp.sub_(deq)
        q = comp.to(torch.bfloat16)
        return ("dense",), (q,), comp.sub_(q.to(torch.float32))

    @staticmethod
    def _materialize_wire_delta(meta, arrays_h):
        """Host side of _ef_compress: the codec wire object from the
        payload arrays copied to the host."""
        kind = meta[0]
        if kind == "dense":
            return arrays_h[0]
        if kind == "int8":
            q, scale = arrays_h
            return codec.QuantizedDelta(q=q, scale=scale, chunk=meta[1])
        if kind == "topk":
            idx, vals = arrays_h
            return codec.SparseDelta(indices=idx, values=vals, n=meta[1])
        if kind == "topk_int8":
            idx, q, scale = arrays_h
            return codec.SparseDelta(
                indices=idx,
                values=codec.QuantizedDelta(q=q, scale=scale, chunk=meta[2]),
                n=meta[1],
            )
        raise ValueError(f"unknown wire-delta meta {meta!r}")

    def _ef_quantize_delta(self, delta: torch.Tensor):
        """Window-delta EF at spawn, on the main thread: spawns are
        sequential, so each one consumes the residual the previous one
        left, even with windows in flight. Returns (meta, payload)."""
        if self._ef_residual is None or self._ef_residual.shape != delta.shape:
            self._ef_residual = torch.zeros_like(delta)
        meta, arrays, self._ef_residual = self._ef_compress(
            delta + self._ef_residual, topk=self._topk_ratio > 0
        )
        return meta, arrays

    # ---------------------------------------------------------- window mode

    def _local_step(self, features, labels) -> torch.Tensor:
        """The one local update that the window and the per-step-local
        path share (the reference's `_local_step_core`): forward and
        backward, then clip + Adam in place on the flat buffer. Returns
        the loss as a device scalar."""
        loss, grad = self._train_step(features, labels)
        (update,) = self._tx.update([grad], self._opt_state)
        self._flat.add_(update)
        self.steps_computed += 1
        return loss

    def _ensure_local_ready(self, task: Task):
        """Window-boundary preamble: surface sync errors and absorb a
        landed merged model, (re)pull or lazily init the model when it is
        not fresh, and (re)start the on-device optimizer state."""
        if self._pending_steps == 0:
            self._check_sync_error()
            self._absorb_sync_result()
        with self._report_lock:
            fresh, version = self._fresh, self._version
        if self._pending_steps == 0 and (not fresh or version < task.model_version):
            with self._phase("sync_wait"):
                self._join_sync()  # a model swap settles the chain first
            with self._report_lock:
                fresh, version = self._fresh, self._version
            if not fresh or version < task.model_version:
                if not self.pull_model():
                    self._lazy_init_model()
                self._opt_state = None  # params swapped: restart the state
        if self._opt_state is None:
            self._opt_state = self._tx.init([self._flat])
            self._base_flat = self._flat.clone()

    def _local_minibatch(self, features, labels, task: Task):
        """One local step; the W-th since the last sync spawns the next."""
        self._ensure_local_ready(task)
        with self._phase("compute"):
            loss = self._local_step(features, labels)
        self._pending_steps += 1
        self._latest_step_loss = loss
        if self._pending_steps >= self._local_updates:
            self._sync_local_updates(blocking=False)
        return loss

    def _to_host(self, tensors, event):
        """Wire arrays of device tensors, from a sync thread: the copies
        run on their own stream after `event` (recorded at spawn), into
        pinned buffers, so they wait for the window they belong to and
        not for later work on the compute stream."""
        if self._device.type != "cuda":
            return [_wire_array(t) for t in tensors]
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self._device)
        stream = self._copy_stream
        with torch.cuda.stream(stream):
            stream.wait_event(event)
            outs = [
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
                for t in tensors
            ]
        stream.synchronize()
        return [_wire_array(o) for o in outs]

    def _sync_local_updates(self, blocking: bool = True):
        """Push the cumulative delta: one copy to the host and one RPC
        per window. With blocking=False the sync runs on a thread that
        joins its predecessor first, so deltas land in spawn order while
        the main thread trains on; at most `_max_inflight_syncs` run at
        once. Task reports wait for their covering sync (_defer_report)."""
        if blocking:
            self._join_sync()
        else:
            self._check_sync_error()
            self._absorb_sync_result()
        if not self._pending_steps:
            # covered deferred reports whose sync landed before they were
            # deferred: no later sync would flush them
            self._flush_deferred_reports()
            return
        t0 = time.perf_counter()
        delta = self._flat - self._base_flat  # its own tensor
        wire_meta = None
        if self._lossy_sync():
            wire_meta, arrays = self._ef_quantize_delta(delta)
        elif self._transport_dtype == "bfloat16":
            arrays = (delta.to(torch.bfloat16),)
        else:
            arrays = (delta,)
        steps = self._pending_steps
        # the same key for the same window of the same task dispatch, so
        # a replay is absorbed; a fresh one when the task has no key
        if self._cur_spec_key:
            report_key = f"{self._cur_spec_key}.w{self._cur_window_idx}"
            self._cur_window_idx += 1
        else:
            report_key = uuid.uuid4().hex
        losses, self._pending_losses = self._pending_losses, []
        # the tasks' losses and the window's newest step loss, one copy
        loss_dev = torch.stack([l for _, l in losses] + [self._latest_step_loss])
        self._base_flat.copy_(self._flat)
        snapshot = self._flat.clone()
        event = None
        if self._device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        self._pending_steps = 0
        prev = self._sync_thread
        with self._report_lock:
            self._sync_seq += 1
            seq, epoch = self._sync_seq, self._sync_epoch
            # the local params this delta brings the PS up to: the anchor
            # for absorbing this sync's merged model
            self._base_snapshots[seq] = snapshot
            # a model was pulled before the first step, so the lineage is set
            spawn_base_version = (
                self._lineage_version + self._own_steps_abs - self._lineage_anchor_abs
            )
            self._own_steps_abs += steps
            self._spawn_abs[seq] = self._own_steps_abs
        self._add_sync_seconds("quantize", time.perf_counter() - t0)

        def do_sync():
            if prev is not None:
                prev.join()
            with self._report_lock:
                if self._sync_error is not None or epoch != self._sync_epoch:
                    # a predecessor failed, or the main thread reset: this
                    # delta's base never reached the PS, so it is not sent
                    return
            t1 = time.perf_counter()
            *payload, loss_h = self._to_host([*arrays, loss_dev], event)
            wire = (
                self._materialize_wire_delta(wire_meta, payload)
                if wire_meta is not None
                else payload[0]
            )
            req = {
                "delta_flat": wire,
                "steps": steps,
                "base_version": spawn_base_version,
                "aux_state": None,
                "report_key": report_key,
                "loss": float(loss_h[-1]),
            }
            md = self._model_wire_dtype()
            if md:
                req["model_dtype"] = md
            t2 = time.perf_counter()
            resp = self._master.call("ReportLocalUpdate", req)
            t3 = time.perf_counter()
            self._add_sync_seconds("encode", t2 - t1)
            self._add_sync_seconds("rpc", t3 - t2)
            with self._report_lock:
                if epoch != self._sync_epoch:
                    return  # a reset raced the RPC: the response is void
                duplicate = bool(resp.get("duplicate"))
                self._synced_seq = max(self._synced_seq, seq)
                self._version = resp["version"]
                self._fresh = True
                if resp.get("params_flat") is not None:
                    # another worker advanced the PS, or this window had
                    # landed before (a replay, answered with the model that
                    # holds it): the main thread folds the merged model in
                    # (_absorb_sync_result), and the lineage advances there
                    self._sync_result = (
                        seq, resp["params_flat"], resp.get("aux"), resp["version"]
                    )
                else:
                    # nobody else advanced: the local trajectory is the PS
                    self._lineage_version = resp["version"]
                    self._lineage_anchor_abs = self._spawn_abs.get(seq, self._own_steps_abs)
                for k in [k for k in self._spawn_abs if k < seq]:
                    del self._spawn_abs[k]
                pending = self._sync_result[0] if self._sync_result is not None else None
                for k in [k for k in self._base_snapshots if k <= seq and k != pending]:
                    del self._base_snapshots[k]
            with self._stats_lock:
                if duplicate:
                    self.deduped_windows += 1
                else:
                    self.window_log.append((time.perf_counter(), steps, float(loss_h[-1])))
            self._record_synced_losses(losses, loss_h[:-1], resp["version"])
            self._flush_deferred_reports()

        if blocking:
            try:
                do_sync()
            except Exception as e:
                # the window never reached the PS: its tasks are requeued
                self._flush_deferred_reports(err=f"sync failed: {e}")
                self._reset_local_state()
                raise
            self._absorb_sync_result()
            return

        def thread_main():
            try:
                do_sync()
            except Exception as e:  # surfaced by _check_sync_error
                with self._report_lock:
                    self._sync_error = e

        t = threading.Thread(target=thread_main, daemon=True)
        self._sync_thread = t
        self._sync_inflight.append(t)
        t.start()
        # backpressure: bound the windows in flight
        while len(self._sync_inflight) > self._max_inflight_syncs:
            with self._phase("sync_wait"):
                self._sync_inflight.popleft().join()

    def _record_synced_losses(self, losses, loss_h, version):
        """Task losses resolve with the window's copy to the host, so the
        main thread never waits on a device scalar."""
        for (task_id, _), v in zip(losses, loss_h):
            self.task_losses.append(float(v))
            logger.info(
                "Worker %d task %d done (last loss %.4f, v%d)",
                self._id, task_id, float(v), version,
            )

    def _check_sync_error(self):
        """Surface a failed chained sync: every deferred report flushes
        (uncovered ones as failures, so their tasks are requeued) and the
        local state resets. Read-and-clear under the lock."""
        with self._report_lock:
            err, self._sync_error = self._sync_error, None
        if err is not None:
            self._flush_deferred_reports(err=f"sync failed: {err}")
            self._reset_local_state()
            raise RuntimeError(f"local-update sync failed: {err}") from err

    def _join_sync(self):
        """Wait for the whole sync chain and absorb its results."""
        if self._sync_thread is not None:
            self._sync_thread.join()  # the tail joins all before it
            self._sync_thread = None
        self._sync_inflight.clear()
        self._check_sync_error()
        self._absorb_sync_result()

    def _reset_local_state(self):
        """After a failed sync the local params carry a delta the PS never
        received: drop the local trajectory and force a full re-pull
        (version -1 defeats `only_if_newer`); the epoch bump voids every
        sync already spawned. The EF residuals belong to the discarded
        trajectory too."""
        with self._report_lock:
            self._sync_epoch += 1
            self._fresh = False
            self._version = -1
            self._sync_result = None
            self._base_snapshots.clear()
            self._lineage_version = -1
            self._spawn_abs.clear()
            self._lineage_anchor_abs = self._own_steps_abs
        self._opt_state = None
        self._pending_steps = 0
        self._pending_losses = []
        self._ef_residual = None
        self._ef_grad_residual = None

    def _absorb_sync_result(self):
        """Fold a merged model into the local trajectory (main thread).

        The merged model of sync i is the PS after delta i but without
        this worker's younger deltas still in flight, so it cannot
        replace the local params: they shift by merged_i - snapshot_i,
        which keeps every in-flight and future delta's content. The
        younger snapshots shift too, or the next absorb would apply the
        other workers' progress twice."""
        # a racy read, re-checked under the lock
        if self._sync_result is None:
            return
        t0 = time.perf_counter()
        with self._report_lock:
            res = self._sync_result
            if res is None:
                return
            seq, params_flat, _aux, new_version = res
            self._sync_result = None
            snap = self._base_snapshots.get(seq)
            for k in [k for k in self._base_snapshots if k <= seq]:
                del self._base_snapshots[k]
            if snap is None:
                return  # a reset raced the response
            # deltas spawned from here on are computed from new_version
            self._lineage_version = new_version
            self._lineage_anchor_abs = self._spawn_abs.get(seq, self._own_steps_abs)
            for k in [k for k in self._spawn_abs if k <= seq]:
                del self._spawn_abs[k]
            shift = _host_tensor(codec.as_f32(params_flat)).to(self._device) - snap
            for younger in self._base_snapshots.values():
                younger.add_(shift)
        self._flat.add_(shift)
        self._base_flat.add_(shift)
        self.merged_back += 1
        self._add_sync_seconds("absorb", time.perf_counter() - t0)

    def _defer_report(self, task_id: int, err: str):
        """Queue the task's result behind its covering sync: the last one
        spawned if the task ended on a window boundary, else the tail sync
        about to be spawned."""
        with self._report_lock:
            cover = self._sync_seq + (1 if self._pending_steps else 0)
            self._deferred_reports.append((task_id, err, cover))

    def _flush_deferred_reports(self, err: Optional[str] = None):
        """Report the deferred results whose covering sync has landed.
        With `err` (the chain broke) every entry flushes: covered ones
        with their own result, uncovered ones as failures, so that no
        task reports success while its tail delta is still in flight.
        Flushed ids are recorded so `run` does not report them again."""
        while True:
            with self._report_lock:
                entry = None
                for i, (task_id, own_err, cover) in enumerate(self._deferred_reports):
                    covered = cover <= self._synced_seq
                    if covered or err is not None:
                        entry = (task_id, own_err, covered)
                        del self._deferred_reports[i]
                        break
                if entry is None:
                    return
                task_id, own_err, covered = entry
                self._flushed_report_ids.add(task_id)
            self.report_task_result(task_id, own_err if covered else (err or own_err))

    def _finalize_local_updates(self):
        """Before exit: join the sync chain, push any unsynced steps,
        resolve the losses whose sync already ran, flush the reports."""
        if not self._local_updates:
            return
        self._join_sync()
        if self._pending_steps:
            self._sync_local_updates(blocking=True)
        if self._pending_losses:
            losses, self._pending_losses = self._pending_losses, []
            loss_h = torch.stack([l for _, l in losses]).cpu().numpy()
            self._record_synced_losses(losses, loss_h, self._version)
        self._flush_deferred_reports()

    def _drop_pending_steps(self):
        """A failed task's steps not yet in a sync are dropped, so they
        never ride the next task's window: its records are trained again
        after the requeue. The optimizer state restarts, as after a pull."""
        if self._pending_steps:
            self._flat.copy_(self._base_flat)
            self._pending_steps = 0
            self._opt_state = None

    def request_drain(self):
        """Ask the run loop to exit at the next task boundary (a signal
        handler calls this; it never blocks)."""
        self._drain_requested.set()

    # ------------------------------------------------------------- the loop

    def _process_training_task(self, task: Task) -> bool:
        """Train on the task's records. Returns True when its result
        report was deferred behind the covering sync (window mode)."""
        reader = self._readers.get(task.shard_file_name)
        records = list(reader.read_range(task.start, task.end))
        batches = (
            self._spec.dataset_fn(chunk, Mode.TRAINING)
            for chunk in iter_minibatches(records, self._minibatch_size)
        )
        # window report keys derive from this dispatch of the task
        self._cur_spec_key = task.spec_key
        self._cur_window_idx = 0
        loss = None
        try:
            for features, labels in batches:
                if self._local_updates:
                    loss = self._local_minibatch(features, labels, task)
                else:
                    loss = self._process_minibatch(features, labels, task)
        except Exception:
            if self._local_updates:
                self._drop_pending_steps()
            raise
        if self._local_updates:
            # the report waits for the sync covering the task's last step:
            # a worker killed before it lands leaves the task requeueable
            if loss is not None:
                self._pending_losses.append((task.task_id, loss))
            self._defer_report(task.task_id, "")
            self._sync_local_updates(blocking=False)  # the ragged tail
            return True
        if loss is not None:
            self.task_losses.append(loss)
            logger.info(
                "Worker %d task %d done (last loss %.4f, v%d)",
                self._id, task.task_id, loss, self._version,
            )
        return False

    def run(self) -> bool:
        """Task loop over TRAINING tasks (the port's dispatcher makes no
        other kind yet). Returns True on clean completion or a drain,
        False when the master reported the job finished with dropped
        tasks. A failure inside a task is reported to the master, which
        requeues the task (and drops it after its retry budget), and the
        loop goes on."""
        while True:
            if self._drain_requested.is_set():
                # exit at a task boundary with every window synced and
                # every deferred report delivered: nothing to requeue
                with self._phase("sync_wait"):
                    self._finalize_local_updates()
                logger.info("Worker %d: drain requested, exiting at task boundary", self._id)
                self.drained = True
                return True
            task, finished = self.get_task()
            if task.type == TaskType.WAIT:
                if finished:
                    with self._phase("sync_wait"):
                        self._finalize_local_updates()
                    return not self._job_failed
                # the master may be waiting on our deferred reports: a
                # failed sync reports their tasks failed, so they requeue
                try:
                    self._check_sync_error()
                except RuntimeError:
                    logger.exception("Worker %d: window sync failed", self._id)
                time.sleep(0.05)
                continue
            err = ""
            reported = False
            with self._report_lock:
                self._flushed_report_ids.clear()
            try:
                reported = self._process_training_task(task)
            except Exception as e:
                logger.exception("Worker %d task %d failed", self._id, task.task_id)
                err = f"{type(e).__name__}: {e}"
            with self._report_lock:
                flushed = task.task_id in self._flushed_report_ids
                self._flushed_report_ids.discard(task.task_id)
            if not reported and not flushed:
                self.report_task_result(task.task_id, err)

    def close(self):
        try:
            self._finalize_local_updates()
        finally:
            self._readers.close()

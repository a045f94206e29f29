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
  With `step_pipeline` = k > 0 (the master forwards 4 under async by
  default) the report runs on a thread while the next batches compute:
  up to k reports in flight, each carrying the version it was computed
  at, absorbed in dispatch order on the main thread; a rejected one's
  batch is trained again through the serial loop, and a task's result
  waits for all of its reports.
- **Window mode** (`local_updates=W > 0`): the optimizer (the spec's
  `ClipAdam`, in place) runs on the device over the flat buffer for W
  minibatches; then one cumulative delta (flat - base) goes to the PS
  (ReportLocalUpdate), which adds it and advances the version by W.
  The W steps are a Python loop of one local step per minibatch, which
  stands in for the reference's `lax.scan`; a task's ragged tail is
  synced when the task ends.
  Syncs chain on background threads, up to `EDL_SYNC_DEPTH` windows in
  flight, and when the local model is stale at a task's start (after a
  reset or a standby's pre-warm) a background thread pages the model
  in, folded in at a window boundary once the chain is idle
  (`overlap_sync="off"`: depth 0, each sync blocks, no page-in, no BET
  prefetch). With the local-steps ladder (`sync_local_steps` = k) one
  push covers k windows under one report key. The delta rides the wire
  as float32, a bf16 cast (`transport_dtype`), or compressed with error
  feedback (`sync_dtype` bfloat16/int8, `sync_compress="topk:<ratio>"`,
  top-k over bf16 or int8 values, or `sync_adaptive="on"`: each round's
  form picked by `common/sync_policy.decide` from the pushes' own
  timings, `common/linkprobe.LinkWeather`): the compression error stays
  on the device as a residual folded into the next delta. When another
  worker synced in between, the PS hands back
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

Evaluation and prediction tasks (the reference's
`_process_evaluation_task` and `_process_prediction_task`): an
EVALUATION task pulls its pinned version FIXED into the model's buffers,
runs the forward under `torch.inference_mode()` with `train=False`
(BatchNorm normalizes with the running statistics in aux), and reports
each minibatch's `eval_metrics_fn` (scalars, or mergeable states,
`validate_eval_metrics`) with ReportEvaluationMetrics; then the
buffers get the training model back. The eval pull leaves the training
counters and lineage as they were, and window mode's base, on-card
optimizer state and error-feedback residuals are not touched, so the
next training report goes out at the version and base it would have had
without the eval. A PREDICTION task pulls the latest model and hands
each minibatch's outputs to the spec's `PredictionOutputsProcessor`.

Warm standby (the reference's `_standby_prewarm`): while GetTask answers
WAIT with `standby: True`, the worker pre-warms once and then polls. The
port has no compile step to run ahead, so the pre-warm pulls the model
(or lazily initializes it), fetches a minibatch of raw records
(GetSampleBatch) and runs one training forward and backward on the
device on it (in window mode the window's first step, with the
optimizer on a throwaway state), which brings up the CUDA context,
cuDNN's algorithm choice and the caching allocator; then it throws the
results away. The flat buffer (so the parameters), aux, optimizer state,
error-feedback residuals, version, lineage, the RNG and the step and
phase counters stay as they were (the attention kernels' launch counts
include the pre-warm's launches); only the model is marked stale, so the
first task after a promotion pulls the PS's latest parameters and aux
rather than training on the model of the pre-warm. A failed pre-warm
leaves the standby cold; `standby_prewarmed` and `standby_prewarm_failed`
say which, and the log has one line for each, for a promotion, and for
the worker's first accepted step.

Lazy PS init: the first worker initializes the model on the host,
offers it with ReportVariable (first writer wins) and pulls whatever
won.

The model's parameters live in ONE float32 device buffer (`_flat`, the
wire's flat vector in the reference's leaf order); every module
parameter is a view into it, so absorbing a pulled model is one copy
into that buffer and every update is in place on it.

Non-trainable state (aux, e.g. BatchNorm's `batch_stats`) lives the same
way in `_aux_flat`, its module buffers views into it, as the reference
carries it: a train-mode step computes the new state (`_train_step`);
per-step it rides the ReportGradient as `aux_state` and the local state
changes only when a piggybacked or pulled model brings the PS's; in
window mode every local step keeps it (the reference's
`_local_step_core`), each sync carries the state at its spawn, and a
merged model brings the PS's back. The first worker's ReportVariable
offers the model's `init_aux()`. Images stay uint8 to the device: only
signed integer arrays (token ids, labels) widen to int64.

The sparse plane (a model with `embedding_specs`, the reference's
embedding plane): per minibatch the worker fetches each table's unique
rows on the host (`lookup_embedding`: straight from the KV shards when
GetPSConfig named them, else EmbeddingLookup on the master; unseen ids
are drawn from `np.random.default_rng(seed + worker_id)`, written with
a SETNX, whose one winner every worker then reads back), pads them into
a BET (`api/layers.prepare_batch_embedding`) and hands the model its
device tensors (`forward(features, embeddings)`). Each BET is a leaf
that takes a gradient, sliced back to the real rows as IndexedRows
(`extract_indexed_grads`): per-step they ride the ReportGradient as
`edl_gradient`; in window mode each step's BET gradients stay on the
device until the window's sync copies them to the host with the delta,
and go as one `merge_indexed_rows(..., dedup=True)` per table (a
window's repeated ids summed before the wire). In window mode batch
N+1's lookups run on one background thread while batch N computes (BET
prefetch: single and ordered, so the lazy-init draws keep their order),
unless `EDL_BET_PREFETCH=0` or the sync depth is 0. Evaluation and
prediction look rows up the same way; a standby's pre-warm runs on zero
rows and touches no table.

On the card, float32 convolutions and matmuls run in full float32:
TF32 is switched off when a worker is built for a CUDA device.

The worker computes on `device` ("cuda" by default) and raises if that
device is absent; the CPU runs only when the caller asks for it.

The sharded PS (`ps_endpoints`, from GetPSConfig: the reference's
`_ensure_ps`): the dense model lives on N PS shards and the worker talks
to them through a `ShardedPS` (`rpc/ps_client.py`), built once the flat
size is known. Its boot pull asks the master for the template's shapes
only (GetModel `shapes`) and takes the values from the shards; every
pull assembles the model from the shards, each skipping its slice when
it is not newer than the worker's entry in `_shard_versions` (the aux
state comes from GetAux). Per-step, the gradient fans out as PSPushGrad
slices (async or a staleness window: strict sync is refused with
shards) and the updated slices come back; in window mode the delta fans
out as PSPushDelta slices under the window's report key, each with its
shard's own base (`_shard_lineage` plus the worker's own steps since),
and only the shards that ran ahead send a merged slice back, which the
absorb splices over the window's snapshot (the shift is zero on every
other slice). Each push's metadata (shard versions, loss, aux state,
the `edl_gradient` rows) goes to the master with ReportWindowMeta,
which drives the cadence and the sparse apply. `_version` is then the
lowest shard version.

`_fresh`, `_version` and `_shard_versions` are written by the sync
threads and read by the main thread, always under `_report_lock`, in
pairs where they are read together.

Shard recovery (the reference's rung 6, `master/recovery.py`): the shard
clients stamp each request with the shard's fencing generation, from
GetPSConfig. The worker keeps a restore snapshot, each PS shard's slice
at the version it stands at (`_restore_snap`): from every sharded pull,
every push response that carries slices back (a merged window, a
duplicate, the per-step model), and, in window mode, every window that
landed unmerged on a shard, whose slice is then the snapshot's plus the
window's decoded delta slice, the same float32 add the shard made. A
task that fails on a dead or fenced shard (`_is_shard_outage_exc`) is
reported failed, so it is requeued, and the worker waits out the
recovery (`_await_shard_recovery`): while GetPSConfig lists a PS shard
under `recovering`, it uploads its slice of the snapshot
(PSRestoreFromWorker); once the lists clear, the PS and KV clients move
to the advertised endpoints and generations, and the local state resets
(a requeued window task replays its windows under their keys: the
shards that applied one absorb it). A per-step push torn by the death is
replayed under its pinned report key after the recovery, with the local
state kept: the shards that applied it absorb the replay, the restored
shard applies it. `shard_recoveries_observed` and `restore_uploads`
count them.

Not ported yet: speculative backup tasks, master failover, and with the
sharded PS the aggregation tree and bucketed pushes.
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

from elasticdl_tpu_torch.api.layers import (
    EmbeddingInput,
    extract_indexed_grads,
    prepare_batch_embedding,
)
from elasticdl_tpu_torch.api.metrics import is_mergeable_state
from elasticdl_tpu_torch.api.model_spec import (
    ModelSpec,
    aux_buffer,
    init_aux,
    new_aux_values,
    takes_train_kwarg,
)
from elasticdl_tpu_torch.common import codec, sync_policy
from elasticdl_tpu_torch.common.constants import (
    DEFAULT_SYNC_DEPTH,
    ENV_BET_PREFETCH,
    ENV_OVERLAP_SYNC,
    ENV_SYNC_ADAPTIVE,
    ENV_SYNC_DEPTH,
    ENV_SYNC_LOCAL_STEPS,
    MAX_MINIBATCH_RETRY_NUM,
    Mode,
)
from elasticdl_tpu_torch.common.linkprobe import LinkWeather
from elasticdl_tpu_torch.common.log_util import get_logger
from elasticdl_tpu_torch.common.messages import MethodType, Task, TaskType
from elasticdl_tpu_torch.rpc.fencing import is_shard_outage_chain
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


def validate_eval_metrics(raw: dict):
    """Only dicts that are mergeable states (`api/metrics.py`) may ride
    the eval wire as states: the evaluation service would sum any other
    dict key by key into garbage, so it is refused here, by name."""
    for k, v in raw.items():
        if isinstance(v, dict) and not is_mergeable_state(v):
            raise TypeError(
                f"eval metric {k!r} returned a dict that is not a mergeable "
                "metric state (missing the 'kind' field, see api/metrics.py): "
                "return a scalar or a metrics-API state"
            )


def _host_value(v):
    """A tensor (float32 for bf16, which numpy lacks) or array-like as
    a host numpy array; a tuple (an MoE model's (logits, aux)) as a tuple
    of them."""
    if isinstance(v, tuple):
        return tuple(_host_value(x) for x in v)
    if isinstance(v, torch.Tensor):
        v = v.detach()
        return (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
    return np.asarray(v)


def _rows_nbytes(edl_grads: dict) -> int:
    """Payload bytes of {table: IndexedRows}: values and ids."""
    return sum(int(r.values.nbytes + r.indices.nbytes) for r in edl_grads.values())


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


def _sync_depth(overlap_sync: Optional[str]) -> tuple:
    """(overlap plane on, windows that may be in flight): the gate from
    `overlap_sync` or EDL_OVERLAP_SYNC (on by default), the depth from
    EDL_SYNC_DEPTH (default 2; a malformed value falls back to 2), 0
    when the plane is off."""
    if overlap_sync is None:
        overlap_sync = os.environ.get(ENV_OVERLAP_SYNC, "") or "on"
    overlap_sync = str(overlap_sync).strip().lower()
    if overlap_sync in ("off", "0", "false"):
        return False, 0
    if overlap_sync not in ("", "on", "1", "true"):
        raise ValueError(f"unsupported overlap_sync {overlap_sync!r} (on|off)")
    try:
        return True, max(0, int(os.environ.get(ENV_SYNC_DEPTH, str(DEFAULT_SYNC_DEPTH)).strip()))
    except ValueError:
        logger.warning("ignoring malformed %s; using %d", ENV_SYNC_DEPTH, DEFAULT_SYNC_DEPTH)
        return True, DEFAULT_SYNC_DEPTH


def _sync_local_steps(k) -> int:
    """Windows a push (the ladder): `k`, else EDL_SYNC_LOCAL_STEPS, else
    1; anything but an int >= 1 raises at worker construction."""
    if k is None:
        k = os.environ.get(ENV_SYNC_LOCAL_STEPS, "") or 1
    try:
        k = int(k)
    except (TypeError, ValueError):
        k = 0
    if k < 1:
        raise ValueError(f"unsupported sync_local_steps {k!r} (int >= 1)")
    return k


def _sync_adaptive(flag) -> bool:
    """The adaptive wire plane's gate: `flag`, else EDL_SYNC_ADAPTIVE,
    else off."""
    if flag is None:
        flag = os.environ.get(ENV_SYNC_ADAPTIVE, "") or "off"
    flag = str(flag).strip().lower()
    if flag in ("", "off", "0", "false"):
        return False
    if flag in ("on", "1", "true"):
        return True
    raise ValueError(f"unsupported sync_adaptive {flag!r} (on|off)")


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
        kv_endpoints=None,
        ps_endpoints=None,
        step_pipeline: int = 0,
        sync_local_steps: Optional[int] = None,
        sync_adaptive: Optional[str] = None,
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
        self._is_standby = False  # the master holds this worker in reserve
        self._standby_warmed = False  # pre-warm tried (done or failed)
        self.standby_prewarmed = False
        self.standby_prewarm_failed = False
        self.standby_prewarm_seconds = 0.0
        self.was_standby = False
        # time.perf_counter() of the first task after standing by
        self.promoted_at: Optional[float] = None
        self._first_accepted_logged = False
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
        # mode: joins of the sync chain and its backpressure), "eval" and
        # "predict" (whole evaluation and prediction tasks)
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
        # evaluation and prediction tasks done, and the minibatches of
        # the evaluation ones
        self.eval_tasks = 0
        self.eval_minibatches = 0
        self.prediction_tasks = 0
        # aux trees taken from the PS, by the RPC whose response carried them
        self.aux_absorbed: Counter = Counter()
        # non-trainable state: host template, leaf paths, device buffer
        self._aux_template = None
        self._aux_paths: list = []
        self._aux_flat: Optional[torch.Tensor] = None
        self._takes_train = takes_train_kwarg(self._model)
        if self._device.type == "cuda":
            # float32 products in full float32, as the reference computes them
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

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
        # the adaptive wire plane (before the supersede below: it counts
        # as lossy, so it too needs the full-precision delta)
        self._sync_adaptive = _sync_adaptive(sync_adaptive)
        self._transport_dtype = transport_dtype
        if self._lossy_sync() and transport_dtype == "bfloat16":
            # error feedback needs the full-precision delta as its input;
            # the model still comes back in bf16 (_model_wire_dtype)
            logger.info("lossy sync plane (%s) supersedes transport_dtype=bfloat16",
                        self._sync_dtype)
            self._transport_dtype = "float32"
        self._ef_residual: Optional[torch.Tensor] = None  # window-delta EF
        self._ef_grad_residual: Optional[torch.Tensor] = None  # per-step EF

        # -- the sparse plane
        self._emb_specs = {s.name: s for s in model_spec.embedding_specs}
        # the lazy-init draws: numpy on the host, per-worker deterministic
        self._emb_init_rng = np.random.default_rng(seed + worker_id)
        self._emb_prefetch_pool = None  # the BET prefetch thread, lazily
        # (BatchEmbeddings, {table: device BET gradient}) of each unsynced
        # window step: device refs, copied to the host by the window's sync
        self._pending_edl: list = []
        self._kv = None  # the KV shards' client, when the tables live there
        if kv_endpoints:
            from elasticdl_tpu_torch.rpc.kv_client import ShardedEmbeddingStore

            self._kv = ShardedEmbeddingStore(kv_endpoints)
        self.lazy_init_rows = 0  # rows this worker drew and offered (SETNX)
        self.edl_gradient_bytes = 0  # IndexedRows payload sent (values + ids)

        # -- the sharded PS
        self._ps_endpoints = list(ps_endpoints) if ps_endpoints else None
        self._ps = None  # its ShardedPS, once the flat size is known
        self._shard_versions: Optional[list] = None  # each shard's version
        # each shard's version at the last fold (the window lineage)
        self._shard_lineage: Optional[list] = None
        # the restore source of a recovering PS shard: per shard, None or
        # (version, float32 slice at it); slices are replaced, never
        # written in place, under _report_lock
        self._restore_snap: Optional[list] = None
        self.shard_recoveries_observed = 0  # shard recoveries waited out
        self.restore_uploads = 0  # restore slices the master accepted

        # -- window mode
        self._local_updates = local_updates
        self._tx = model_spec.optimizer()
        self._opt_state = None  # on-device optimizer state over _flat
        self._base_flat: Optional[torch.Tensor] = None  # params at the last sync
        self._pending_steps = 0  # local steps not yet in a spawned sync
        self._pending_losses: list = []  # (task_id, device loss) per task
        self._latest_step_loss = None  # device scalar of the newest step
        self._overlap_sync, self._max_inflight_syncs = _sync_depth(overlap_sync)
        # the local-steps ladder: k windows a push, one report key; the
        # delta is cumulative, so k only raises the spawn threshold
        self._sync_local_steps = _sync_local_steps(sync_local_steps)
        self._link_weather = LinkWeather()
        # per round of the adaptive plane, appended at spawn: {round,
        # form, link_mbps, delta_bytes, steps}
        self._sync_decisions: list = []
        # {form: {"bytes_sent", "rounds"}} of the pushes of each form
        self.wire_forms: dict = {}
        # the background model page-in: a pull on a thread of its own,
        # staged as (shard versions or None, version, model, aux) under
        # _report_lock and folded in at a window boundary
        self._absorb_staged = None
        self._bg_pull_thread: Optional[threading.Thread] = None
        self.bg_pulls = 0  # background pulls started
        self.staged_applied = 0  # staged models folded in
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
        self._stats_lock = threading.Lock()  # sync_seconds, window_log, edl_gradient_bytes
        self._drain_requested = threading.Event()
        # the current task's dispatch key and its next window's index:
        # window report keys are f"{spec_key}.w{index}"
        self._cur_spec_key = ""
        self._cur_window_idx = 0

        # -- the per-step pipeline: up to `step_pipeline` reports in
        # flight on threads, (thread, box, features, labels) in dispatch
        # order
        self._step_pipeline = max(0, int(step_pipeline))
        self._step_inflight: deque = deque()
        self._last_step_loss: Optional[float] = None  # newest joined loss
        self.step_reports_joined = 0  # pipelined reports joined
        self.step_retrained = 0  # batches trained again after a rejection
        # serializes shard-recovery waits (reporter threads may hit one
        # outage together)
        self._recovery_lock = threading.Lock()

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
    def kv_tiers(self) -> list:
        """The transport tier of each KV shard link ([] without shards)."""
        return self._kv.tiers if self._kv is not None else []

    @property
    def ps_tiers(self) -> list:
        """The transport tier of each PS shard link ([] on the single PS)."""
        return self._ps.tiers if self._ps is not None else []

    def ps_rpc_seconds(self) -> dict:
        """The PS shard links' seconds per method, summed over the links."""
        return self._ps.rpc_seconds() if self._ps is not None else {}

    @property
    def shard_versions(self) -> Optional[list]:
        """Each PS shard's version as this worker last saw it."""
        with self._report_lock:
            return list(self._shard_versions) if self._shard_versions else None

    @property
    def steps_accepted(self) -> int:
        """Steps the PS applied from this worker: accepted per-step
        reports plus the steps of every window sync that landed."""
        with self._stats_lock:
            return len(self.step_log) + sum(steps for _t, steps, _l in self.window_log)

    def _lossy_sync(self) -> bool:
        """Whether the window's sync plane compresses (and so keeps an
        error-feedback residual): bf16 or int8, top-k, or the adaptive
        plane (any round may pick a lossy form)."""
        return (
            self._sync_adaptive
            or self._sync_dtype in ("bfloat16", "int8")
            or self._topk_ratio > 0
        )

    @property
    def sync_decisions(self) -> list:
        """A copy of the adaptive plane's per-round decision log (empty
        unless it is on)."""
        return [dict(d) for d in self._sync_decisions]

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
        self._is_standby = resp.get("standby", False)
        return Task.from_wire(resp["task"]), resp.get("finished", False)

    def pull_model(self, version: int = -1, method: str = MethodType.MINIMUM) -> bool:
        """MINIMUM: pull anything newer than the local model (`version`
        is not read); False if the PS holds no model yet. FIXED: load
        exactly `version` (an evaluation task's pinned model) into the
        model's buffers, leaving the training counters and lineage as
        they are."""
        if method == MethodType.FIXED:
            resp = self._master.call("GetModel", {
                "version": version, "method": MethodType.FIXED,
                "flat": self._template is not None,
            })
            if resp.get("params_flat") is not None:
                self._set_flat(resp["params_flat"])
            else:
                self._init_flat_from_tree(resp["params"])
            self._set_aux(resp.get("aux"), "GetModelFixed")
            return True
        if self._ps_endpoints:
            return self._pull_sharded()
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
        self._set_aux(resp.get("aux"), "GetModel")
        with self._report_lock:
            self._version = resp["version"]
            self._fresh = True
            self._lineage_version = self._version
            self._shard_lineage = None
            self._lineage_anchor_abs = self._own_steps_abs
        return True

    def _ensure_ps(self):
        """The sharded PS's client, built once the flat size is known
        (None on the single PS). It stamps each request with its shard's
        fencing generation, from GetPSConfig."""
        if self._ps is None and self._ps_endpoints and self._flat is not None:
            from elasticdl_tpu_torch.rpc.ps_client import ShardedPS

            try:
                cfg = self._master.call("GetPSConfig", {})
            except Exception:
                cfg = {}  # unfenced: epoch -1 always passes
            gens = cfg.get("ps_generations") or None
            if cfg.get("endpoints") and gens:
                # the master's view is the current one (a relaunched
                # shard moves its endpoint with its generation)
                self._ps_endpoints = list(cfg["endpoints"])
            self._ps = ShardedPS(self._ps_endpoints, int(self._flat.numel()), generations=gens)
        return self._ps

    def _pull_sharded(self) -> bool:
        """The model from the shards (False when the PS holds none yet).
        The boot pull learns the template's shapes from the master first;
        a shard not newer than this worker's entry for it sends no slice,
        and when none is newer nothing is copied."""
        if self._template is None:
            resp = self._master.call("GetModel", {"method": MethodType.MINIMUM, "shapes": True})
            if resp["version"] < 0:
                return False
            self._init_flat_from_shapes(resp["shapes"])
            self._set_aux(resp.get("aux"), "GetModel")
        ps = self._ensure_ps()
        with self._report_lock:
            known = self._shard_versions
        versions, vec = ps.pull(versions=known, model_dtype=self._model_wire_dtype())
        if any(v < 0 for v in versions):
            return False
        if vec is not None:
            self._set_flat(vec)
            if self._aux_flat is not None:
                # the shards hold the dense vector only: the matching aux
                self._set_aux(self._master.call("GetAux", {}).get("aux"), "GetAux")
            self._keep_restore_slices(versions, self._split_slices(vec))
        with self._report_lock:
            self._shard_versions = list(versions)
            self._version = min(versions)
            self._fresh = True
            self._lineage_version = self._version
            self._shard_lineage = list(versions)
            self._lineage_anchor_abs = self._own_steps_abs
        return True

    def report_variable(self, params, aux=None):
        self._master.call("ReportVariable", {"params": params, "aux": aux or None})

    def report_gradient(self, grad_wire, loss: float, aux_state=None, edl_grads=None,
                        version: Optional[int] = None, shard_base: Optional[list] = None):
        """One ReportGradient round with a host-side wire gradient, the
        step's new aux tree (None for a model without aux) and its BET
        gradients ({table: IndexedRows}, for a model with tables).
        `version` and `shard_base` are the version and the shard versions
        the gradient was computed at, when the pipelined path captured
        them at dispatch (the live ones by default): an absorb between
        compute and send must not make an older gradient claim a newer
        version."""
        if self._ensure_ps() is not None:
            return self._push_grad_sharded(grad_wire, loss, aux_state, edl_grads,
                                           version, shard_base)
        if version is None:
            with self._report_lock:
                version = self._version
        req = {
            "worker_id": self._id,
            "version": version,
            "gradient_flat": grad_wire,
            "aux_state": aux_state,
            "loss": loss,
            "return_model": True,
        }
        if edl_grads:
            req["edl_gradient"] = edl_grads
            with self._stats_lock:
                self.edl_gradient_bytes += _rows_nbytes(edl_grads)
        md = self._model_wire_dtype()
        if md:
            req["model_dtype"] = md
        return self._master.call("ReportGradient", req)

    def _push_grad_sharded(self, grad_wire, loss: float, aux_state, edl_grads,
                           version: Optional[int] = None, shard_base: Optional[list] = None):
        """The per-step report with shards: the gradient's slices to the
        shards (each at this worker's version of it, or at `shard_base`),
        the updated slices back, and the metadata to the master
        (ReportWindowMeta). Answers like a ReportGradient; a model that
        comes back carries the aux this report wrote."""
        n = self._ps.num_shards
        if shard_base is not None:
            base = list(shard_base)
        else:
            with self._report_lock:
                if self._shard_versions:
                    base = list(self._shard_versions)
                else:
                    base = [self._version if version is None else version] * n
        # the key is pinned here, so that a push torn by a shard's death
        # is replayed under it once the shard is recovered: the shards
        # that applied it absorb the replay, the restored one applies it
        push_key = uuid.uuid4().hex

        def push():
            return self._ps.push_grad(grad_wire, base, model_dtype=self._model_wire_dtype(),
                                      return_model=True, report_key=push_key)

        try:
            versions, vec = push()
        except Exception as e:
            if not self._is_shard_outage_exc(e) or not self._await_shard_recovery(reset=False):
                raise  # the task fails and is requeued
            versions, vec = push()
        if vec is not None:
            self._keep_restore_slices(versions, self._split_slices(vec))
        meta = {"worker_id": self._id, "versions": versions, "aux_state": aux_state,
                "loss": loss}
        if edl_grads:
            meta["edl_gradient"] = edl_grads
            with self._stats_lock:
                self.edl_gradient_bytes += _rows_nbytes(edl_grads)
        self._master.call("ReportWindowMeta", meta)
        with self._report_lock:
            # element-wise max: a shard's version never goes back
            cur = self._shard_versions
            self._shard_versions = (
                list(versions) if cur is None else [max(a, b) for a, b in zip(cur, versions)]
            )
        resp = {"accepted": True, "version": min(versions)}
        if vec is not None:
            resp["params_flat"] = vec
            resp["aux"] = aux_state
        return resp

    def report_task_result(self, task_id: int, err: str = ""):
        self._master.call(
            "ReportTaskResult",
            {"task_id": task_id, "err_message": err, "worker_id": self._id},
        )

    # ------------------------------------------------------- embedding plane

    def _emb_lookup(self, layer: str, ids):
        """Row fetch: from the KV shards when the job runs them, else
        through the master."""
        if self._kv is not None:
            return self._kv.lookup(layer, ids)
        resp = self._master.call("EmbeddingLookup", {"layer": layer, "ids": ids})
        return resp["values"], resp["unknown_index"]

    def _emb_update(self, layer: str, ids, values, set_if_not_exist=False):
        if self._kv is not None:
            self._kv.update(layer, ids, values, set_if_not_exist=set_if_not_exist)
            return
        self._master.call("EmbeddingUpdate", {
            "layer": layer, "ids": ids, "values": values,
            "set_if_not_exist": set_if_not_exist,
        })

    def lookup_embedding(self, spec, ids: np.ndarray) -> np.ndarray:
        """The rows of `ids`, lazily initializing the unseen ones: drawn
        uniformly in (-init_scale, init_scale) from the worker's numpy
        generator, offered with a SETNX (the first writer wins across
        workers), then read back."""
        values, unknown = self._emb_lookup(spec.name, ids)
        if values.shape[1] == 0:
            values = np.zeros((len(ids), spec.dim), dtype=np.float32)
        else:
            values = np.array(values)  # decoded buffers are read-only views
        if len(unknown):
            init = self._emb_init_rng.uniform(
                -spec.init_scale, spec.init_scale, size=(len(unknown), spec.dim)
            ).astype(np.float32)
            unknown_ids = np.asarray(ids)[np.asarray(unknown)]
            self._emb_update(spec.name, unknown_ids, init, set_if_not_exist=True)
            self.lazy_init_rows += len(unknown)
            values2, unknown2 = self._emb_lookup(spec.name, unknown_ids)
            if len(unknown2):
                raise RuntimeError("embedding rows missing after lazy init")
            values[np.asarray(unknown)] = values2
        return values

    def _prepare_embeddings(self, features, lookup=None) -> dict:
        """{table: BatchEmbedding} of one minibatch's features."""
        lookup = lookup or self.lookup_embedding
        return {
            name: prepare_batch_embedding(spec, features[spec.input_key], lookup)
            for name, spec in self._emb_specs.items()
        }

    def _device_embeddings(self, embs, requires_grad: bool = False) -> dict:
        """{table: EmbeddingInput} on the device; with `requires_grad`
        each BET is a leaf that takes a gradient."""
        out = {}
        for name, b in embs.items():
            bet = self._to_device(b.bet)
            if requires_grad:
                bet.requires_grad_(True)
            out[name] = EmbeddingInput(bet, self._to_device(b.inverse), self._to_device(b.mask))
        return out

    def _emb_pool(self):
        """The BET prefetch thread: one, so lookups (and the lazy-init
        draws) stay in order."""
        if self._emb_prefetch_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._emb_prefetch_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="bet-prefetch"
            )
        return self._emb_prefetch_pool

    def _prefetch_on(self) -> bool:
        """BET prefetch: window mode with syncs in flight (depth 0 is the
        serialized mode, where every flush lands before the next lookup)
        unless EDL_BET_PREFETCH=0."""
        return (
            self._max_inflight_syncs > 0
            and os.environ.get(ENV_BET_PREFETCH, "1") != "0"
        )

    def _with_embeddings(self, batches):
        """(features, labels, embs) of each window-mode minibatch: batch
        N+1's rows are fetched on the prefetch thread while batch N
        computes; without prefetch, right before it. The exposed wait
        counts as the "lookup" phase."""
        if not self._prefetch_on():
            for features, labels in batches:
                with self._phase("lookup"):
                    embs = self._prepare_embeddings(features)
                yield features, labels, embs
            return
        pool = self._emb_pool()
        batch = next(batches, None)
        fut = pool.submit(self._prepare_embeddings, batch[0]) if batch is not None else None
        while batch is not None:
            nxt = next(batches, None)
            nxt_fut = pool.submit(self._prepare_embeddings, nxt[0]) if nxt is not None else None
            with self._phase("lookup"):
                embs = fut.result()
            yield batch[0], batch[1], embs
            batch, fut = nxt, nxt_fut

    def _window_edl(self, pending_edl, grads_h) -> dict:
        """A window's BET gradients (host copies, in `pending_edl`'s
        order) as one deduped IndexedRows a table."""
        per_table: dict = {}
        it = iter(grads_h)
        for embs, gbets in pending_edl:
            for name in gbets:
                per_table.setdefault(name, []).append(
                    extract_indexed_grads(self._emb_specs[name], next(it), embs[name])
                )
        return {
            name: codec.merge_indexed_rows(slices, dedup=True)
            for name, slices in per_table.items()
        }

    # ------------------------------------------------------ flat param buffer

    def _init_flat_from_tree(self, params):
        """Learn the model's structure from a host tree, copy it into one
        device buffer and make every module parameter a view into it."""
        self._template = codec.tree_map(np.asarray, params)
        self._bind_flat(_host_tensor(codec.ravel_np(self._template)).to(self._device))

    def _init_flat_from_shapes(self, shapes):
        """The same from a tree of leaf shapes (int64 arrays: the sharded
        boot's template), over an uninitialized buffer the pull fills."""
        self._template = codec.tree_map(
            lambda s: np.empty(tuple(int(d) for d in s), np.float32), shapes
        )
        _, sizes, _ = codec.template_meta(self._template)
        self._bind_flat(torch.empty(sum(sizes), dtype=torch.float32, device=self._device))

    def _bind_flat(self, flat: torch.Tensor):
        """Make every module parameter a view into `flat`, in the
        template's leaf order, and set up the aux buffer."""
        shapes, sizes, _ = codec.template_meta(self._template)
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
        self._init_aux(init_aux(self._model))

    def _init_aux(self, aux):
        """One device buffer for the non-trainable state, the model's
        buffers views into it, from the host tree `aux` (the model's
        init: the PS's, when it has one, arrives with the pull)."""
        if not aux:
            return
        self._aux_template = codec.tree_map(np.asarray, aux)
        self._aux_paths = codec.tree_paths(self._aux_template)
        flat = _host_tensor(codec.ravel_np(self._aux_template)).to(self._device)
        off = 0
        for path, leaf in zip(self._aux_paths, codec.tree_leaves(self._aux_template)):
            module, name = aux_buffer(self._model, path)
            buf = module.get_buffer(name)
            if tuple(buf.shape) != leaf.shape:
                raise ValueError(
                    f"aux {'/'.join(path)}: model shape {tuple(buf.shape)} != {leaf.shape}"
                )
            buf.data = flat[off : off + leaf.size].view(leaf.shape)
            off += leaf.size
        self._aux_flat = flat

    def _set_aux(self, aux, rpc: str):
        """Absorb the PS's aux tree from the response of `rpc` into the
        device buffer (a None or empty tree leaves the local state as it
        is, as the reference's `_set_flat` does)."""
        if aux and self._aux_flat is not None:
            self._aux_flat.copy_(_host_tensor(codec.ravel_np(aux)))
            self.aux_absorbed[rpc] += 1

    def _aux_tree(self, flat_h) -> Optional[dict]:
        """The host aux tree over a flat host copy (None without aux)."""
        if self._aux_template is None:
            return None
        return codec.make_unraveler(self._aux_template)(flat_h)

    def _set_flat(self, vec):
        """Copy a wire model (f32 or bf16) into the flat buffer, in place:
        the module's parameters are views into it."""
        self._flat.copy_(_host_tensor(codec.as_f32(vec)))

    def _lazy_init_model(self):
        """Init on the host, offer it with its aux to the PS (SETNX: first
        worker wins), then pull whatever won."""
        params = self._model.init_params(self._seed + self._id)
        self._init_flat_from_tree(params)
        self.report_variable(params, self._aux_template)
        self.pull_model()

    # ------------------------------------------------- per-step training

    def _ensure_step_ready(self, task: Task):
        with self._report_lock:
            fresh, version = self._fresh, self._version
        if not fresh or version < task.model_version:
            if not self.pull_model():
                self._lazy_init_model()

    def _to_device(self, a) -> torch.Tensor:
        """Signed integers (token ids, labels) widen to int64, as torch
        indexes with; unsigned ones (uint8 images) cross as they are and
        the model normalizes them on the device."""
        if isinstance(a, dict):  # a model's dict of feature arrays
            return {k: self._to_device(v) for k, v in a.items()}
        a = np.asarray(a)
        if a.dtype.kind == "i":
            a = a.astype(np.int64)
        return _host_tensor(a).to(self._device)

    def _forward(self, x, embeddings, train: bool):
        """The model's outputs; a model with tables also takes its
        {table: EmbeddingInput}."""
        args = (x,) if embeddings is None else (x, embeddings)
        return self._model(*args, train=train) if self._takes_train else self._model(*args)

    def _train_step(self, features, labels, embs=None):
        """(loss, flat gradient, new aux flat or None, {table: BET
        gradient}) on the device, from the current model and the
        minibatch's BatchEmbeddings (a model with tables); the model's
        buffers are left as they were."""
        x = self._to_device(features)
        embeddings = self._device_embeddings(embs, requires_grad=True) if embs else None
        bets = [e.bet for e in embeddings.values()] if embeddings else []
        outputs = self._forward(x, embeddings, train=True)
        loss = self._spec.loss(outputs, self._to_device(labels))
        grads = torch.autograd.grad(loss, self._params + bets)
        n = len(self._params)
        gbets = dict(zip(embeddings, grads[n:])) if embeddings else {}
        new_aux = None
        if self._aux_paths:
            new_aux = torch.cat(
                [v.reshape(-1) for v in new_aux_values(self._model, self._aux_paths)]
            )
        return loss.detach(), torch.cat([g.reshape(-1) for g in grads[:n]]), new_aux, gbets

    def _grad_wire_parts(self, grad: torch.Tensor):
        """(meta or None, device payload tensors) of the per-step
        gradient's wire form: EF-compressed under a bf16/int8
        `sync_dtype` (the residual is consumed here, on the main thread,
        so pipelined reports take it in dispatch order), a bf16 cast
        under `transport_dtype`, else float32."""
        if self._sync_dtype in ("bfloat16", "int8"):
            if self._ef_grad_residual is None:
                self._ef_grad_residual = torch.zeros_like(grad)
            meta, arrays, self._ef_grad_residual = self._ef_compress(
                grad + self._ef_grad_residual, topk=False
            )
            return meta, list(arrays)
        if self._transport_dtype == "bfloat16":
            return None, [grad.to(torch.bfloat16)]
        return None, [grad]

    def _wire_from_host(self, meta, arrays_h):
        """The wire gradient from its payload's host copies."""
        return self._materialize_wire_delta(meta, arrays_h) if meta is not None else arrays_h[0]

    def _grad_to_wire(self, grad: torch.Tensor):
        """The per-step gradient's wire form on the host."""
        meta, arrays = self._grad_wire_parts(grad)
        return self._wire_from_host(meta, [_wire_array(a.cpu()) for a in arrays])

    def _absorb_report_response(self, resp):
        """Track freshness and absorb a piggybacked model. Monotonic: an
        older response never rolls the local model back."""
        v = resp["version"]
        with self._report_lock:
            if resp.get("params_flat") is not None and v > self._version:
                self._set_flat(resp["params_flat"])
                self._set_aux(resp.get("aux"), "ReportGradient")
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
            embs = None
            if self._emb_specs:
                with self._phase("lookup"):
                    embs = self._prepare_embeddings(features)
            with self._phase("compute"):
                loss, grad, new_aux, gbets = self._train_step(features, labels, embs)
                grad_wire = self._grad_to_wire(grad)
                aux_h = self._aux_tree(new_aux.cpu().numpy()) if new_aux is not None else None
                edl = {
                    name: extract_indexed_grads(self._emb_specs[name], g.cpu().numpy(), embs[name])
                    for name, g in gbets.items()
                }
                loss_h = float(loss)
            self.steps_computed += 1
            with self._phase("report"):
                resp = self.report_gradient(grad_wire, loss_h, aux_h, edl)
                self._absorb_report_response(resp)
            if resp["accepted"]:
                self.step_log.append((time.perf_counter(), loss_h))
                self._note_accepted()
                return loss_h
        raise RuntimeError("worker stuck: minibatch retries exhausted")

    # ------------------------------------------------ the per-step pipeline
    #
    # With `step_pipeline` = k > 0, up to k gradient reports ride the link
    # on threads while later batches compute on the device: a step costs
    # max(compute, report / k) instead of compute + report. Legal where
    # the PS takes k-stale gradients (async, or a staleness window >= k;
    # the master resolves the depth, `common/args.resolve_step_pipeline`).
    # Each report carries the version (and shard versions) its gradient
    # was computed at, and responses, which may complete out of order,
    # are absorbed on the main thread in dispatch order through the
    # monotonic guard of `_absorb_report_response`.

    def _step_pipeline_on(self) -> bool:
        """The pipeline runs on the per-step path of a model without
        tables, once the model's structure is known: the job's first
        batch, which pulls or initializes the model, goes through the
        serial loop."""
        return bool(
            self._step_pipeline
            and self._template is not None
            and not self._emb_specs
            and not self._local_updates
        )

    def _pipelined_minibatch(self, features, labels, task: Task):
        """Compute this batch's gradient on the device, send its report on
        a thread, and block only while more than `step_pipeline` reports
        are in flight. The gradient's copy to the host runs on the
        thread too (on the copy stream, after the step's event)."""
        with self._report_lock:
            fresh, version = self._fresh, self._version
        if not fresh or version < task.model_version:
            self._join_step_pipeline(task)  # an in-flight response may bring it
        self._ensure_step_ready(task)
        with self._phase("compute"):
            loss, grad, new_aux, _gbets = self._train_step(features, labels)
            meta, arrays = self._grad_wire_parts(grad)
            tensors = [*arrays, loss.reshape(1)] + ([new_aux] if new_aux is not None else [])
            event = None
            if self._device.type == "cuda":
                if self._copy_stream is None:
                    self._copy_stream = torch.cuda.Stream(self._device)
                event = torch.cuda.Event()
                event.record()
        self.steps_computed += 1
        with self._report_lock:
            compute_version = self._version
            shard_base = list(self._shard_versions) if self._shard_versions else None
        box: dict = {}

        def report_main():
            try:
                host = self._to_host(tensors, event)
                n = len(arrays)
                loss_h = float(host[n][0])
                aux_h = self._aux_tree(host[n + 1]) if new_aux is not None else None
                box["loss"] = loss_h
                box["resp"] = self.report_gradient(
                    self._wire_from_host(meta, host[:n]), loss_h, aux_h,
                    version=compute_version, shard_base=shard_base,
                )
                box["at"] = time.perf_counter()
            except Exception as e:  # raised at its join
                box["err"] = e

        t = threading.Thread(target=report_main, daemon=True)
        self._step_inflight.append((t, box, features, labels))
        t.start()
        while len(self._step_inflight) > self._step_pipeline:
            self._join_one_step(task)

    def _join_one_step(self, task: Task):
        """Join the oldest report in flight, absorb its response here, and
        train its batch again through the serial loop when the PS
        rejected it (staleness outran the window). On an error the
        younger reports are joined and discarded, so none leaks into the
        next task."""
        t, box, features, labels = self._step_inflight.popleft()
        try:
            with self._phase("sync_wait"):
                t.join()
            self.step_reports_joined += 1
            if "err" in box:
                raise box["err"]
            resp = box["resp"]
            with self._phase("report"):
                self._absorb_report_response(resp)
            self._last_step_loss = box["loss"]
            if resp["accepted"]:
                self.step_log.append((box["at"], box["loss"]))
                self._note_accepted()
            else:
                self.step_retrained += 1
                self._last_step_loss = self._process_minibatch(features, labels, task)
        except Exception:
            self._discard_step_pipeline()
            raise

    def _join_step_pipeline(self, task: Task):
        """Join every report in flight, oldest first."""
        while self._step_inflight:
            self._join_one_step(task)

    def _discard_step_pipeline(self):
        """Join the reports in flight and drop their results (a failed
        task: it is requeued whole)."""
        while self._step_inflight:
            self._step_inflight.popleft()[0].join()

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

    def _ef_quantize_delta(self, delta: torch.Tensor, form: Optional[str] = None):
        """Window-delta EF at spawn, on the main thread: spawns are
        sequential, so each one consumes the residual the previous one
        left, even with windows in flight. `form` is the adaptive plane's
        pick for this round (`sync_policy.WIRE_FORMS`); None keeps the
        configured knobs. An adaptive "f32" round sends the corrected
        delta exactly and clears the residual; "topk" keeps the
        configured ratio, else 0.1. Returns (meta, payload)."""
        if self._ef_residual is None or self._ef_residual.shape != delta.shape:
            self._ef_residual = torch.zeros_like(delta)
        comp = delta + self._ef_residual
        if form is None:
            meta, arrays, self._ef_residual = self._ef_compress(comp, topk=self._topk_ratio > 0)
        elif form == "f32":
            meta, arrays, self._ef_residual = ("dense",), (comp,), torch.zeros_like(comp)
        elif form in ("bf16", "int8"):
            meta, arrays, self._ef_residual = self._ef_compress(
                comp, topk=False, dtype={"bf16": "bfloat16"}.get(form, form)
            )
        elif form == "topk":
            meta, arrays, self._ef_residual = self._ef_compress(
                comp, topk=True, dtype="float32", ratio=self._topk_ratio or 0.1
            )
        else:
            raise ValueError(f"unknown adaptive wire form {form!r}")
        return meta, arrays

    # ---------------------------------------------------------- window mode

    def _local_step(self, features, labels, embs=None) -> torch.Tensor:
        """The one local update that the window and the per-step-local
        path share (the reference's `_local_step_core`): forward and
        backward, then the spec's optimizer in place on the flat buffer;
        the new aux is kept, and the BET gradients wait on the device for
        the window's sync. Returns the loss as a device scalar."""
        loss, grad, new_aux, gbets = self._train_step(features, labels, embs)
        (update,) = self._tx.update([grad], self._opt_state, [self._flat])
        self._flat.add_(update)
        if new_aux is not None:
            self._aux_flat.copy_(new_aux)
        if gbets:
            self._pending_edl.append((embs, gbets))
        self.steps_computed += 1
        return loss

    def _ensure_local_ready(self, task: Task):
        """Window-boundary preamble: surface sync errors and absorb a
        landed merged model, (re)pull or lazily init the model when it is
        not fresh, and (re)start the on-device optimizer state."""
        if self._pending_steps == 0:
            self._check_sync_error()
            self._absorb_sync_result()
            self._apply_staged_model()  # a paged-in model, when one is staged
        with self._report_lock:
            fresh, version = self._fresh, self._version
        if self._pending_steps == 0 and (not fresh or version < task.model_version):
            with self._phase("sync_wait"):
                self._join_sync()  # a model swap settles the chain first
            with self._report_lock:
                fresh, version = self._fresh, self._version
            if not fresh or version < task.model_version:
                # the background pull started at the task's start may
                # bring the model: ride it rather than pull again
                with self._phase("sync_wait"):
                    self._join_bg_pull()
                if self._apply_staged_model():
                    with self._report_lock:
                        fresh, version = self._fresh, self._version
            if not fresh or version < task.model_version:
                if not self.pull_model():
                    self._lazy_init_model()
                self._opt_state = None  # params swapped: restart the state
        if self._opt_state is None:
            self._opt_state = self._tx.init([self._flat])
            self._base_flat = self._flat.clone()

    def _local_minibatch(self, features, labels, task: Task, embs=None):
        """One local step; the W-th since the last sync spawns the next."""
        self._ensure_local_ready(task)
        if self._emb_specs and embs is None:
            with self._phase("lookup"):
                embs = self._prepare_embeddings(features)
        with self._phase("compute"):
            loss = self._local_step(features, labels, embs)
        self._pending_steps += 1
        self._latest_step_loss = loss
        # with the ladder, k windows grow one cumulative delta on the
        # device, and one push covers them
        if self._pending_steps >= self._local_updates * self._sync_local_steps:
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
        wire_form = None
        if self._sync_adaptive:
            # this round's wire form from the passive link estimate,
            # decided at spawn like the EF residual's hand-off (spawns
            # are sequential, so the log needs no lock)
            link_mbps = self._link_weather.mbps()
            delta_f32_bytes = int(delta.numel()) * 4
            wire_form = sync_policy.decide(link_mbps, delta_f32_bytes, self._sync_decisions)
        if self._lossy_sync():
            wire_meta, arrays = self._ef_quantize_delta(delta, form=wire_form)
        elif self._transport_dtype == "bfloat16":
            arrays = (delta.to(torch.bfloat16),)
        else:
            arrays = (delta,)
        steps = self._pending_steps
        if wire_form is not None:
            self._sync_decisions.append({
                "round": len(self._sync_decisions), "form": wire_form,
                "link_mbps": link_mbps, "delta_bytes": delta_f32_bytes, "steps": steps,
            })
        # the same key for the same window of the same task dispatch, so
        # a replay is absorbed; a fresh one when the task has no key
        if self._cur_spec_key:
            report_key = f"{self._cur_spec_key}.w{self._cur_window_idx}"
            self._cur_window_idx += 1
        else:
            report_key = uuid.uuid4().hex
        losses, self._pending_losses = self._pending_losses, []
        # the window's BET gradients ride the same copy to the host
        pending_edl, self._pending_edl = self._pending_edl, []
        edl_dev = [g for _embs, gbets in pending_edl for g in gbets.values()]
        # the tasks' losses and the window's newest step loss, one copy
        loss_dev = torch.stack([l for _, l in losses] + [self._latest_step_loss])
        self._base_flat.copy_(self._flat)
        snapshot = self._flat.clone()
        # the non-trainable state at spawn rides with the delta
        aux_dev = [self._aux_flat.clone()] if self._aux_flat is not None else []
        event = None
        if self._device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        self._pending_steps = 0
        ps = self._ps  # the shards' client, when the PS is sharded
        prev = self._sync_thread
        with self._report_lock:
            self._sync_seq += 1
            seq, epoch = self._sync_seq, self._sync_epoch
            # the local params this delta brings the PS up to: the anchor
            # for absorbing this sync's merged model
            self._base_snapshots[seq] = snapshot
            # a model was pulled before the first step, so the lineage is set
            own_ahead = self._own_steps_abs - self._lineage_anchor_abs
            spawn_base_version = self._lineage_version + own_ahead
            # with shards, each shard's base the same way
            spawn_shard_bases = (
                [v + own_ahead for v in self._shard_lineage] if self._shard_lineage else None
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
            host = self._to_host([*arrays, loss_dev, *aux_dev, *edl_dev], event)
            payload, loss_h = host[: len(arrays)], host[len(arrays)]
            aux_h = self._aux_tree(host[len(arrays) + 1]) if aux_dev else None
            edl_h = host[len(arrays) + 1 + len(aux_dev):]
            wire = (
                self._materialize_wire_delta(wire_meta, payload)
                if wire_meta is not None
                else payload[0]
            )
            req = {
                "delta_flat": wire,
                "steps": steps,
                "base_version": spawn_base_version,
                "aux_state": aux_h,
                "report_key": report_key,
                "loss": float(loss_h[-1]),
            }
            md = self._model_wire_dtype()
            if md:
                req["model_dtype"] = md
            if pending_edl:
                ts = time.perf_counter()
                req["edl_gradient"] = self._window_edl(pending_edl, edl_h)
                self._add_sync_seconds("sparse", time.perf_counter() - ts)
                with self._stats_lock:
                    self.edl_gradient_bytes += _rows_nbytes(req["edl_gradient"])
            t2 = time.perf_counter()
            versions = None
            if ps is not None:
                versions, resp = self._push_delta_sharded(ps, req, spawn_shard_bases, wire_form)
            else:
                resp = self._master.call("ReportLocalUpdate", req)
                self._observe_push(wire, time.perf_counter() - t2, wire_form)
            t3 = time.perf_counter()
            self._add_sync_seconds("encode", t2 - t1)
            self._add_sync_seconds("rpc", t3 - t2)
            with self._report_lock:
                if epoch != self._sync_epoch:
                    return  # a reset raced the RPC: the response is void
                duplicate = bool(resp.get("duplicate"))
                self._synced_seq = max(self._synced_seq, seq)
                self._version = resp["version"]
                if versions is not None:
                    self._shard_versions = list(versions)
                self._fresh = True
                if resp.get("params_flat") is not None:
                    # another worker advanced the PS, or this window had
                    # landed before (a replay, answered with the model that
                    # holds it): the main thread folds the merged model in
                    # (_absorb_sync_result), and the lineage advances there
                    self._sync_result = (
                        seq, resp["params_flat"], resp.get("aux"), resp["version"], versions
                    )
                else:
                    # nobody else advanced: the local trajectory is the PS
                    self._lineage_version = resp["version"]
                    self._shard_lineage = list(versions) if versions is not None else None
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
                    self._note_accepted()
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

    def _observe_push(self, wire, seconds: float, wire_form: Optional[str]):
        """After a window push (sync thread): its wire bytes over its
        seconds feed the link estimate, and an adaptive round's bytes go
        to its form's row of `wire_forms`."""
        nbytes = codec.delta_nbytes(wire)
        self._link_weather.observe(nbytes, seconds)
        if wire_form is not None:
            with self._stats_lock:
                row = self.wire_forms.setdefault(wire_form, {"bytes_sent": 0, "rounds": 0})
                row["bytes_sent"] += nbytes
                row["rounds"] += 1

    def _push_delta_sharded(self, ps, req: dict, shard_bases, wire_form=None):
        """A window sync with shards: the delta's slices to the shards
        under the window's report key, each at its shard's base, then the
        metadata to the master (ReportWindowMeta). Returns (shard
        versions, a ReportLocalUpdate-like response whose `params_flat`
        is {shard index: merged slice} when any shard ran ahead)."""
        n = ps.num_shards
        bases = shard_bases if shard_bases is not None else [req["base_version"]] * n
        dup: list = []
        t0 = time.perf_counter()
        versions, merged = ps.push_delta(
            req["delta_flat"], req["steps"], bases, model_dtype=req.get("model_dtype"),
            report_key=req["report_key"], duplicates=dup,
        )
        self._observe_push(req["delta_flat"], time.perf_counter() - t0, wire_form)
        self._keep_window_restore_slices(ps, versions, merged, req["delta_flat"], bases)
        meta = {"worker_id": self._id, "versions": versions, "steps": req["steps"],
                "aux_state": req["aux_state"], "loss": req["loss"], "want_aux": bool(merged)}
        if req.get("edl_gradient"):
            meta["edl_gradient"] = req["edl_gradient"]
        meta_resp = self._master.call("ReportWindowMeta", meta)
        resp = {"version": min(versions), "duplicate": all(dup)}
        if merged:
            resp["params_flat"] = merged
            resp["aux"] = meta_resp.get("aux")
        return versions, resp

    # ------------------------------------------------ shard recovery

    def _split_slices(self, vec) -> dict:
        """{shard: float32 copy of its slice} of a whole flat model."""
        f32 = codec.as_f32(vec)
        return {i: np.array(f32[s:e], dtype=np.float32)
                for i, (s, e) in enumerate(self._ps.bounds)}

    def _keep_restore_slices(self, versions, slices: dict):
        """Keep each slice as the restore snapshot's entry for its shard
        (at versions[shard]), unless the entry is newer."""
        with self._report_lock:
            snap = list(self._restore_snap or [None] * self._ps.num_shards)
            for i, sl in slices.items():
                if snap[i] is None or int(versions[i]) >= snap[i][0]:
                    snap[i] = (int(versions[i]), sl)
            self._restore_snap = snap

    def _keep_window_restore_slices(self, ps, versions, merged: dict, delta, bases):
        """A landed window's slices for the restore snapshot: the shard's
        slice where it sent one back (merged, or a replay), else, where
        the snapshot held the shard at the window's base, that slice plus
        the window's delta slice, decoded as the shard decodes it: the
        shard's own float32 add (the window landed unmerged, so at full
        weight)."""
        with self._report_lock:
            snap = self._restore_snap
        slices = {i: np.array(codec.as_f32(sl), dtype=np.float32) for i, sl in merged.items()}
        for i, (s, e) in enumerate(ps.bounds):
            if i in slices or snap is None or snap[i] is None or snap[i][0] != bases[i]:
                continue
            slices[i] = snap[i][1] + codec.delta_to_f32(codec.slice_delta(delta, s, e))
        if slices:
            self._keep_restore_slices(versions, slices)

    def _is_shard_outage_exc(self, exc) -> bool:
        """Did this failure bottom out in a dead or fenced shard? (The
        shard's error arrives wrapped by the fan-out or the sync chain.)"""
        if self._ps is None and self._kv is None:
            return False
        return is_shard_outage_chain(exc)

    def _await_shard_recovery(self, deadline: float = 120.0, reset: bool = True) -> bool:
        """Wait out a PS or KV shard's recovery. Polls GetPSConfig; while
        it lists recovering PS shards, uploads this worker's snapshot
        slices of them. Once the lists clear, moves the shard clients to
        the advertised endpoints and generations and, unless `reset` is
        False (the per-step push's replay, which keeps its base), drops
        the local training state (the failed window never landed).
        Returns False when no recovery completed within `deadline`, or
        when a drain was requested (the job is being torn down).

        An outage seen here may precede the master's seeing the death, so
        success needs the recovery seen in progress, or endpoints or
        generations other than the clients', or a probe pull that the
        shards answer at the clients' generations."""
        if self._ps is None and self._kv is None:
            return False
        with self._recovery_lock:
            return self._await_shard_recovery_locked(deadline, reset)

    def _await_shard_recovery_locked(self, deadline: float, reset: bool) -> bool:
        start = time.monotonic()
        observed = False
        offered: dict = {}  # shard -> the snapshot version the master took
        logger.warning("Worker %d: shard outage, waiting for the recovery plane", self._id)
        while time.monotonic() - start < deadline and not self._drain_requested.is_set():
            try:
                cfg = self._master.call("GetPSConfig", {})
            except Exception:
                time.sleep(0.5)
                continue
            rec = cfg.get("recovering") or {}
            if rec.get("ps") or rec.get("kv"):
                observed = True
                self._offer_restore_snapshot(rec.get("ps") or [], offered)
                time.sleep(0.25)
                continue
            eps, gens = cfg.get("endpoints") or [], cfg.get("ps_generations") or None
            kv_eps, kv_gens = cfg.get("kv_endpoints") or [], cfg.get("kv_generations") or None
            changed = False
            if self._ps is not None and eps:
                changed |= eps != self._ps.endpoints or (
                    gens is not None and gens != (self._ps.generations or []))
            if self._kv is not None and kv_eps:
                changed |= kv_eps != self._kv.endpoints or (
                    kv_gens is not None and kv_gens != (self._kv.generations or []))
            if not (observed or changed):
                if self._ps is None:
                    time.sleep(0.25)
                    continue
                try:
                    # answers unfenced only at current generations, and a
                    # dead shard refuses the connection
                    self._ps.pull(versions=[1 << 60] * self._ps.num_shards)
                except Exception:
                    time.sleep(0.25)
                    continue
            if self._ps is not None and eps:
                self._ps.update_endpoints(eps, gens)
                self._ps_endpoints = list(eps)
            if self._kv is not None and kv_eps:
                self._kv.update_endpoints(kv_eps, kv_gens)
            if reset:
                self._settle_sync_chain()
                self._reset_local_state()
            self.shard_recoveries_observed += 1
            logger.info("Worker %d: shard recovery complete, resuming against %s",
                        self._id, eps or kv_eps)
            return True
        logger.error("Worker %d: shard recovery did not complete (drain requested: %s)",
                     self._id, self._drain_requested.is_set())
        return False

    def _settle_sync_chain(self):
        """Let the window syncs in flight finish before a reset voids
        them: one that lands (its report's sparse apply rode out a KV
        recovery on the master) is counted and flushes its tasks'
        reports; a failed one flushes them as failures."""
        if self._sync_thread is not None:
            self._sync_thread.join()
            self._sync_thread = None
        self._sync_inflight.clear()
        try:
            self._check_sync_error()
        except RuntimeError:
            logger.info("Worker %d: a window sync failed with the outage", self._id)

    def _offer_restore_snapshot(self, ps_recovering, offered: dict):
        """Upload this worker's snapshot slice of each recovering PS
        shard, once a version (`offered`: shard -> the version the master
        took). Best effort and idempotent: the plane keeps the highest
        version offered, and a failed upload is offered again at the next
        poll."""
        if self._ps is None or not ps_recovering:
            return
        with self._report_lock:
            snap = self._restore_snap
        if snap is None:
            return
        for sid in ps_recovering:
            sid = int(sid)
            if sid >= len(snap) or snap[sid] is None:
                continue
            version, sl = snap[sid]
            if offered.get(sid) == version:
                continue
            try:
                resp = self._master.call("PSRestoreFromWorker", {
                    "worker_id": self._id, "shard_id": sid, "vec": sl, "version": version,
                })
            except Exception:
                continue
            if resp.get("accepted"):
                offered[sid] = version
                self.restore_uploads += 1

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
            # the shards' only_if_newer pull keys off these: a reset must
            # pull every slice again, whether the shards advanced or not
            self._shard_versions = None
            self._shard_lineage = None
            self._spawn_abs.clear()
            self._lineage_anchor_abs = self._own_steps_abs
            self._absorb_staged = None  # a staged page-in predates the reset
        self._opt_state = None
        self._pending_steps = 0
        self._pending_losses = []
        self._pending_edl = []
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
            seq, params_flat, aux, new_version, new_shard_versions = res
            self._sync_result = None
            snap = self._base_snapshots.get(seq)
            for k in [k for k in self._base_snapshots if k <= seq]:
                del self._base_snapshots[k]
            if snap is None:
                return  # a reset raced the response
            # deltas spawned from here on are computed from new_version
            self._lineage_version = new_version
            self._shard_lineage = (
                list(new_shard_versions) if new_shard_versions is not None else None
            )
            self._lineage_anchor_abs = self._spawn_abs.get(seq, self._own_steps_abs)
            for k in [k for k in self._spawn_abs if k <= seq]:
                del self._spawn_abs[k]
            if isinstance(params_flat, dict):
                # shards: merged slices from the shards that ran ahead
                # only; the shift is zero on every other slice
                ranges = [(self._ps.bounds[i], sl) for i, sl in sorted(params_flat.items())]
            else:
                ranges = [((0, self._flat.numel()), params_flat)]
            shifts = []
            for (a, b), sl in ranges:
                shift = _host_tensor(codec.as_f32(sl)).to(self._device) - snap[a:b]
                for younger in self._base_snapshots.values():
                    younger[a:b].add_(shift)
                shifts.append((a, b, shift))
        for a, b, shift in shifts:
            self._flat[a:b].add_(shift)
            self._base_flat[a:b].add_(shift)
        self._set_aux(aux, "ReportLocalUpdate")
        self.merged_back += 1
        self._add_sync_seconds("absorb", time.perf_counter() - t0)

    # ------------------------------------------- the background page-in
    #
    # Window mode with the overlap plane on: when the local model is
    # stale at a task's start (not fresh after a reset or a standby's
    # pre-warm, or older than the version the task announces), a thread
    # pulls the model (over shards `ShardedPS.pull_async`) while the
    # worker reads its records, and stages it. The main thread folds it in at a window boundary
    # when the sync chain is idle and no merged model waits to be
    # absorbed, under the same monotonic guard as every absorb; a reset
    # (the sync epoch) voids it.

    def _join_bg_pull(self):
        """Settle the background pull in flight (main thread)."""
        t = self._bg_pull_thread
        if t is not None:
            t.join()
            self._bg_pull_thread = None

    def _maybe_start_bg_pull(self, min_version: int):
        """Start a background pull of the model when the local one is
        older than `min_version` (the task's), unless the overlap plane
        is off, a pull is in flight, or a model is already staged."""
        if not self._overlap_sync:
            return
        t = self._bg_pull_thread
        if t is not None and t.is_alive():
            return
        ps = self._ensure_ps()
        with self._report_lock:
            if self._absorb_staged is not None:
                return
            fresh, cur_version = self._fresh, self._version
            known = list(self._shard_versions) if self._shard_versions else None
            epoch = self._sync_epoch
        if fresh and cur_version >= min_version:
            return  # current: nothing to page in
        if cur_version < 0 and ps is None:
            return  # no model yet: the blocking path makes first contact
        t = threading.Thread(
            target=self._bg_pull_once,
            args=(ps, known, cur_version, self._aux_flat is not None, epoch),
            daemon=True,
        )
        self._bg_pull_thread = t
        self.bg_pulls += 1
        t.start()

    def _bg_pull_once(self, ps, known_versions, cur_version: int, want_aux: bool, epoch: int):
        """The background pull: fetch and stage only (the device buffers
        and the version bookkeeping are the main thread's). A failure
        costs nothing, the blocking pull stays, so it is logged and
        dropped."""
        try:
            staged = None
            if ps is not None:
                fut = ps.pull_async(versions=known_versions, model_dtype=self._model_wire_dtype())
                aux = self._master.call("GetAux", {}).get("aux") if want_aux else None
                versions, vec = fut.result()
                if all(v >= 0 for v in versions) and vec is not None:
                    staged = (list(versions), min(versions), vec, aux)
            else:
                resp = self._master.call("GetModel", {
                    "version": cur_version, "method": MethodType.MINIMUM,
                    "only_if_newer": True, "flat": True,
                })
                if resp.get("version", -1) >= 0 and resp.get("params_flat") is not None:
                    staged = (None, resp["version"], resp["params_flat"], resp.get("aux"))
            if staged is not None:
                with self._report_lock:
                    if epoch == self._sync_epoch and staged[1] > self._version:
                        self._absorb_staged = staged
        except Exception as e:
            logger.debug("Worker %d: background model pull failed (the blocking pull "
                         "remains): %s", self._id, e)

    def _apply_staged_model(self) -> bool:
        """Fold a staged model in at a window boundary (main thread, no
        pending steps). Deferred while the sync chain runs or a merged
        model waits: a whole model replaces the flat buffer, which would
        orphan the base snapshots of syncs in flight. Over shards the
        shard versions, the lineage and the restore snapshot are reset
        to it. Returns True when a model was folded in."""
        if not self._overlap_sync or self._absorb_staged is None:  # racy, re-read below
            return False
        t = self._sync_thread
        if t is not None and t.is_alive():
            return False  # the chain is busy: a later boundary folds it
        with self._report_lock:
            staged = self._absorb_staged
            if staged is None or self._sync_result is not None:
                return False  # an unabsorbed merged model goes first
            versions, version, vec, aux = staged
            self._absorb_staged = None
            if version <= self._version:
                return False  # stale on arrival
        self._set_flat(vec)
        self._set_aux(aux, "GetModel" if versions is None else "GetAux")
        slices = self._split_slices(vec) if versions is not None else None
        with self._report_lock:
            self._version = version
            self._lineage_version = version
            self._lineage_anchor_abs = self._own_steps_abs
            if versions is not None:
                self._shard_versions = list(versions)
                self._shard_lineage = list(versions)
                self._restore_snap = [(int(v), slices[i]) for i, v in enumerate(versions)]
            else:
                self._shard_lineage = None
            self._fresh = True
        self._opt_state = None  # params swapped: the boundary rebases
        self.staged_applied += 1
        return True

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
        self._join_bg_pull()
        self._join_sync()
        if self._pending_steps:
            self._sync_local_updates(blocking=True)
        if self._pending_losses:
            losses, self._pending_losses = self._pending_losses, []
            loss_h = torch.stack([l for _, l in losses]).cpu().numpy()
            with self._report_lock:
                version = self._version
            self._record_synced_losses(losses, loss_h, version)
        self._flush_deferred_reports()

    def _drop_pending_steps(self):
        """A failed task's steps not yet in a sync are dropped, so they
        never ride the next task's window: its records are trained again
        after the requeue. The optimizer state restarts, as after a pull."""
        if self._pending_steps:
            self._flat.copy_(self._base_flat)
            self._pending_steps = 0
            self._pending_edl = []
            self._opt_state = None

    def request_drain(self):
        """Ask the run loop to exit at the next task boundary (a signal
        handler calls this; it never blocks)."""
        self._drain_requested.set()

    # ------------------------------------------------------- warm standby

    def _standby_prewarm(self):
        """Pull the model and run one throwaway training step on a
        master-served sample batch (see the module docstring). Any
        failure leaves the standby cold: it still trains correctly once
        promoted, only slower to start."""
        t0 = time.perf_counter()
        try:
            records = self._master.call(
                "GetSampleBatch", {"n": self._minibatch_size}
            ).get("records")
            if not records:
                logger.info("Worker %d: no sample batch to pre-warm on", self._id)
                return
            features, labels = self._spec.dataset_fn(records, Mode.TRAINING)
            if self._flat is None and not self.pull_model():
                self._lazy_init_model()
            self._prewarm_step(features, labels)
            self.standby_prewarmed = True
            self.standby_prewarm_seconds = time.perf_counter() - t0
            logger.info("Worker %d: standby pre-warm complete in %.2f s",
                        self._id, self.standby_prewarm_seconds)
        except Exception:
            self.standby_prewarm_failed = True
            logger.exception("Worker %d: standby pre-warm failed (it warms on "
                             "promotion instead)", self._id)
        finally:
            self._standby_warmed = True  # a hard failure is not retried
            # the PS moves on while the standby waits: its first task
            # after promotion pulls the latest model and aux
            with self._report_lock:
                self._fresh = False

    def _prewarm_step(self, features, labels):
        """One training step on the device whose results are thrown away:
        the flat buffer, aux and RNG are restored, no counter moves, and
        window mode's optimizer update runs on a state of its own."""
        saved_flat = self._flat.clone()
        saved_aux = self._aux_flat.clone() if self._aux_flat is not None else None
        rng = torch.random.get_rng_state()
        cuda_rng = torch.cuda.get_rng_state(self._device) if self._device.type == "cuda" else None
        try:
            embs = None
            if self._emb_specs:
                # zero rows: the pre-warm needs the shapes, and must not
                # touch the tables or the lazy-init draws
                embs = self._prepare_embeddings(
                    features, lambda spec, ids: np.zeros((len(ids), spec.dim), np.float32)
                )
            loss, grad, new_aux, _gbets = self._train_step(features, labels, embs)
            if self._local_updates:
                (update,) = self._tx.update([grad], self._tx.init([self._flat]), [self._flat])
                self._flat.add_(update)
                if new_aux is not None:
                    self._aux_flat.copy_(new_aux)
            float(loss)  # waits for the device
        finally:
            self._flat.copy_(saved_flat)
            if saved_aux is not None:
                self._aux_flat.copy_(saved_aux)
            torch.random.set_rng_state(rng)
            if cuda_rng is not None:
                torch.cuda.set_rng_state(cuda_rng, self._device)

    def _note_accepted(self):
        """Log the worker's first accepted step, once: its time is when a
        replacement (or a promoted standby) restored capacity."""
        if not self._first_accepted_logged:
            self._first_accepted_logged = True
            logger.info("Worker %d: first step accepted at %.6f", self._id, time.perf_counter())

    # ------------------------------------------------------------- the loop

    def _eval_forward(self, features):
        """The model's outputs in inference mode (the caller holds
        `torch.inference_mode()`): no autograd graph, and `train=False`
        for a model that takes it."""
        x = self._to_device(features)
        embeddings = None
        if self._emb_specs:
            embeddings = self._device_embeddings(self._prepare_embeddings(features))
        return self._forward(x, embeddings, train=False)

    def _task_batches(self, task: Task, mode: str):
        reader = self._readers.get(task.shard_file_name)
        records = list(reader.read_range(task.start, task.end))
        for chunk in iter_minibatches(records, self._minibatch_size):
            yield self._spec.dataset_fn(chunk, mode)

    def _process_evaluation_task(self, task: Task):
        """Evaluate the task's records at its pinned version and report
        each minibatch's metrics; the model's buffers get the training
        model back afterwards."""
        if self._spec.eval_metrics_fn is None:
            raise ValueError("an evaluation task needs the spec's eval_metrics_fn")
        saved = None
        if self._flat is not None:
            saved = (
                self._flat.clone(),
                self._aux_flat.clone() if self._aux_flat is not None else None,
            )
        try:
            self.pull_model(task.model_version, MethodType.FIXED)
            for features, labels in self._task_batches(task, Mode.EVALUATION):
                with torch.inference_mode():
                    outputs = self._eval_forward(features)
                    raw = self._spec.eval_metrics_fn(outputs, self._to_device(labels))
                    validate_eval_metrics(raw)
                    metrics = {
                        k: {sk: sv if isinstance(sv, str) else _host_value(sv)
                            for sk, sv in v.items()}
                        if isinstance(v, dict) else float(v)
                        for k, v in raw.items()
                    }
                self._master.call("ReportEvaluationMetrics", {
                    "model_version": task.model_version,
                    "metrics": metrics,
                    "num_examples": int(codec.tree_leaves(features)[0].shape[0]),
                })
                self.eval_minibatches += 1
            self.eval_tasks += 1
        finally:
            if saved is not None:
                self._flat.copy_(saved[0])
                if saved[1] is not None:
                    self._aux_flat.copy_(saved[1])

    def _process_prediction_task(self, task: Task):
        """Run the latest model over the task's records; each
        minibatch's outputs go to the spec's PredictionOutputsProcessor."""
        if not self.pull_model():
            raise RuntimeError("a prediction task needs an initialized model")
        proc = self._spec.prediction_outputs_processor
        for features, _labels in self._task_batches(task, Mode.PREDICTION):
            with torch.inference_mode():
                outputs = self._eval_forward(features)
            if proc is not None:
                proc.process(_host_value(outputs), self._id)
        self.prediction_tasks += 1

    def _process_training_task(self, task: Task) -> bool:
        """Train on the task's records. Returns True when its result
        report was deferred behind the covering sync (window mode)."""
        # window report keys derive from this dispatch of the task
        self._cur_spec_key = task.spec_key
        self._cur_window_idx = 0
        if self._local_updates:
            # a newer model announced: page it in while the records are
            # read and the first steps train
            self._maybe_start_bg_pull(task.model_version)
        batches = self._task_batches(task, Mode.TRAINING)
        loss = None
        if self._local_updates and self._emb_specs:
            batches = self._with_embeddings(batches)
        else:
            batches = ((features, labels, None) for features, labels in batches)
        pipelined = False
        try:
            for features, labels, embs in batches:
                if self._local_updates:
                    loss = self._local_minibatch(features, labels, task, embs)
                elif self._step_pipeline_on():
                    self._pipelined_minibatch(features, labels, task)
                    pipelined = True
                else:
                    loss = self._process_minibatch(features, labels, task)
            if pipelined:
                # every gradient of the task reaches the PS before its
                # result is reported
                self._join_step_pipeline(task)
                loss = self._last_step_loss
        except Exception:
            if self._local_updates:
                self._drop_pending_steps()
            self._discard_step_pipeline()
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
            with self._report_lock:
                version = self._version
            logger.info(
                "Worker %d task %d done (last loss %.4f, v%d)",
                self._id, task.task_id, loss, version,
            )
        return False

    def run(self) -> bool:
        """Task loop over TRAINING, EVALUATION and PREDICTION tasks.
        Returns True on clean completion or a drain,
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
                if self._is_standby:
                    if not self.was_standby:
                        self.was_standby = True
                        logger.info("Worker %d: held as a standby", self._id)
                    if not self._standby_warmed:
                        self._standby_prewarm()
                # the master may be waiting on our deferred reports: a
                # failed sync reports their tasks failed, so they requeue
                try:
                    self._check_sync_error()
                except RuntimeError as e:
                    logger.exception("Worker %d: window sync failed", self._id)
                    if self._is_shard_outage_exc(e):
                        self._await_shard_recovery()
                time.sleep(0.05)
                continue
            if self.was_standby and self.promoted_at is None:
                self.promoted_at = time.perf_counter()
                logger.info("Worker %d: promoted from standby at %.6f",
                            self._id, self.promoted_at)
            err = ""
            reported = False
            shard_outage = False
            with self._report_lock:
                self._flushed_report_ids.clear()
            try:
                if task.type == TaskType.TRAINING:
                    reported = self._process_training_task(task)
                elif task.type == TaskType.EVALUATION:
                    with self._phase("eval"):
                        self._process_evaluation_task(task)
                elif task.type == TaskType.PREDICTION:
                    with self._phase("predict"):
                        self._process_prediction_task(task)
                else:
                    err = f"unknown task type {task.type}"
            except Exception as e:
                logger.exception("Worker %d task %d failed", self._id, task.task_id)
                err = f"{type(e).__name__}: {e}"
                shard_outage = self._is_shard_outage_exc(e)
            with self._report_lock:
                flushed = task.task_id in self._flushed_report_ids
                self._flushed_report_ids.discard(task.task_id)
            if not reported and not flushed:
                self.report_task_result(task.task_id, err)
            if shard_outage:
                # a dead or fenced shard, not a bad task: the failure
                # report requeued it; wait out the recovery and go on
                # against the recovered shards
                self._await_shard_recovery()

    def close(self):
        try:
            self._discard_step_pipeline()
            self._finalize_local_updates()
        finally:
            if self._emb_prefetch_pool is not None:
                self._emb_prefetch_pool.shutdown(wait=True)
            if self._kv is not None:
                self._kv.close()
            if self._ps is not None:
                self._ps.close()
            self._readers.close()

"""The master servicer: task front-end + parameter server.

The reference's `MasterServicer` on the single PS: the master holds the
model as a numpy tree + version counter, serves tasks and model pulls,
and takes two kinds of update.

- Per-step (ReportGradient): one flat gradient per report.
  - Sync (the default): a report is accepted when its version is at
    most `staleness_window` behind the PS's (0: only the current
    version); on the `grads_to_wait`-th accepted report the gradients
    are averaged in float32 numpy, the optimizer runs and the version
    bumps.
  - Async (`use_async`): every report is applied at once, whatever its
    staleness; under `lr_staleness_modulation` a report `s > 1` versions
    behind has its *gradient* scaled by 1/s (the reference's rule: the
    scale is on the gradient, not the learning rate, so an adaptive
    optimizer such as Adam mostly cancels it).
  A rejected report, and an accepted one that saw the version move,
  carry the fresh model back (`return_model`), so a steady-state step is
  one RPC.
- Window mode (ReportLocalUpdate): the worker ran `steps` optimizer
  updates on its device and sends one cumulative delta, in any wire
  form (`codec.delta_to_f32`). The PS adds it in float32, down-weighted
  by `staleness_window / staleness` when its base is more than
  `staleness_window` versions behind (0: always full weight), the
  version advances by `steps`, and the merged model goes back when
  another worker synced in between. A repeated `report_key` is
  absorbed.

Either response piggybacks the model in the worker's `model_dtype`
(bfloat16 halves the bytes).

Non-trainable state (aux: BatchNorm's `batch_stats`, a tree of float32
arrays) rides beside the model, as the reference carries it: the first
ReportVariable's `aux` (or `init_aux`) seeds it; every report's
`aux_state` replaces it, last writer wins (under `grads_to_wait > 1`
the latest pending one lands with the step); GetModel, GetAux and every
response that carries a model carry a copy of it.

Job services: each applied version is snapshotted under the lock when
it crosses the checkpoint cadence (params, aux and the optimizer's
state), and `_on_version_bump` then fires outside the lock (the
evaluation service calls back into `get_params_copy`): the checkpoint
save and the evaluation step trigger. GetModel(FIXED) serves an exact
version: the live model while it still is that version, else the
evaluation snapshot or a durable checkpoint. ReportEvaluationMetrics
feeds the evaluation service; the train-loss hook gets each report's
loss. GetTask keeps workers waiting while an evaluation job is pending.

Standby workers: with `set_standby_fn` (the worker manager's
`is_standby`), GetTask answers a standby WAIT with `standby: True`, and
GetSampleBatch serves the raw records it pre-warms on
(`set_sample_batch_fn`).

The sparse plane (a model with `embedding_specs`): the tables live in an
embedding store (in the master, or behind KV shards, `kv_group`, whose
endpoints GetPSConfig advertises so workers look rows up directly).
EmbeddingLookup and EmbeddingUpdate serve a worker's row fetches and its
lazy-init SETNX. Each report's `edl_gradient` ({table: IndexedRows})
goes to the sparse optimizer: per-step under `grads_to_wait > 1` the
reports' rows are concatenated and applied with the step (duplicates
are summed by the optimizer's dedup), async at once, and a window
sync's rows with its delta. The sparse apply runs after the model lock
is released, under its own lock, before the response and before the
version-bump hooks (so a cadence checkpoint's embedding snapshot holds
the step's rows); its seconds accumulate in `sparse_apply_seconds`.

The sharded PS (`ps_group`, `--num_ps`): the dense model lives behind
N shard endpoints (`master/ps_shard.py`) and workers push and pull
slices there; the master keeps the tree only as the template (structure
and shapes), the control plane and a version mirror. ReportVariable
seeds the shards from the first tree; ReportGradient and
ReportLocalUpdate are refused (pushes go to the shards); workers send
each push's metadata with ReportWindowMeta instead: the shard versions
(the mirror advances to their minimum, and the advance counts as
applied steps), the loss, the aux state and the window's `edl_gradient`,
which drive the checkpoint and evaluation cadence, the metrics sink and
the sparse apply. GetModel assembles the model from the shards, or, with
`shapes`, answers the template's shapes only (a worker's boot: the
values come from the shards); FIXED pulls come from snapshots only;
checkpoints carry each shard's optimizer state (`{"kind": "sharded",
"shards": [...]}`); GetPSConfig advertises the endpoints and the model's
size.

The shard recovery plane (`master/recovery.py`, `set_recovery_plane`):
GetPSConfig also advertises each shard's fencing generation and the
shards being recovered (`recovering`); PSRestoreFromWorker hands a
worker's restore slice to the plane (refused without one);
ReportWindowMeta keeps each PS shard's highest reported version, the
plane's restore floor (`shard_version_floor`); and a sparse apply that
hits a KV shard's outage waits out the KV recovery and applies again,
since the report's dense slices already landed on the PS shards and a
failure would requeue them.

The observability plane (`obs/`): GetTrace answers the master process's
spans and GetMetrics its metrics registry plus each shard process's
(`collect_shard_metrics` of the groups, under `shards`);
ReportPhaseStats hands a worker's cumulative phase timers to the sink
that `set_phase_stats_sink` names (the master's `PhaseStatsAggregator`;
without one the report is acknowledged and dropped). A window delta's
lock wait and apply is retro-recorded as a `master.apply` span under
the ReportLocalUpdate server span.

Exactness block: `version == init_version + applied_update_steps` holds
under the lock at every instant.

A request's arrays may be views over the transport's buffer, which the
shm tier reuses for the connection's next request: whatever a handler
keeps past its return (the aux trees, evaluation metric states, the
pending reports' gradient rows) is copied first.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Optional

import numpy as np

from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.common import codec
from elasticdl_tpu_torch.common.log_util import get_logger
from elasticdl_tpu_torch.common.messages import MethodType, Task, TaskType
from elasticdl_tpu_torch.master.ps_optimizer import PSOptimizer
from elasticdl_tpu_torch.obs import metrics as obs_metrics
from elasticdl_tpu_torch.obs import trace as obs_trace
from elasticdl_tpu_torch.rpc.fencing import is_shard_outage_chain

logger = get_logger(__name__)

# window syncs remembered for dedup (the reference's cap)
LOCAL_UPDATE_DEDUP_CAP = 1024


def _to_f32(tree):
    return codec.tree_map(
        lambda a: codec.as_f32(a).copy()
        if isinstance(a, codec.BF16Bits) or np.asarray(a).dtype.kind == "f"
        else np.asarray(a),
        tree,
    )


def _copy(tree):
    return codec.tree_map(
        lambda a: codec.BF16Bits(a.bits.copy()) if isinstance(a, codec.BF16Bits) else np.copy(a),
        tree,
    )


def _own(tree):
    """`tree` with its arrays copied out of the request's buffer (other
    leaves as they are); None stays None."""
    if tree is None:
        return None

    def own(a):
        if isinstance(a, codec.BF16Bits):
            return codec.BF16Bits(a.bits.copy())
        if isinstance(a, codec.IndexedRows):
            return codec.IndexedRows(values=np.copy(a.values), indices=np.copy(a.indices))
        return np.copy(a) if isinstance(a, np.ndarray) else a

    return codec.tree_map(own, tree)


class MasterServicer:
    def __init__(
        self,
        grads_to_wait: int,
        optimizer: Optional[PSOptimizer] = None,
        task_dispatcher=None,
        evaluation_service=None,
        checkpoint_service=None,
        init_params: Any = None,
        init_aux: Any = None,
        init_version: int = 0,
        use_async: bool = False,
        lr_staleness_modulation: bool = False,
        staleness_window: int = 0,
        embedding_store=None,
        sparse_optimizer=None,
        kv_group=None,
        ps_group=None,
    ):
        self._lock = threading.Lock()
        # the PS shards holding the dense model, when it is sharded
        self.ps_group = ps_group
        self._embedding_store = embedding_store
        self._sparse_opt = sparse_optimizer
        # the KV shards behind the store, when the tables live there
        self.kv_group = kv_group
        self._phase_stats_sink = None  # ReportPhaseStats' (set_phase_stats_sink)
        self._sparse_lock = threading.Lock()
        self._edl_grads: Dict[str, list] = {}  # pending reports' rows by table
        self.sparse_apply_seconds = 0.0
        self._grads_to_wait = grads_to_wait
        self._opt = optimizer
        self._task_d = task_dispatcher
        self._evaluation_service = evaluation_service
        self._checkpoint_service = checkpoint_service
        self._use_async = use_async
        self._lr_staleness_modulation = lr_staleness_modulation
        self._staleness_window = staleness_window
        self._train_loss_hook = None
        # the metrics sink whose hooks are wired here (master main sets
        # it; its owner tears it down)
        self.tb_service = None
        self._params = _to_f32(init_params) if init_params is not None else None
        self._aux = init_aux
        self._pending_aux = None  # latest aux_state of the pending reports
        self._version = init_version
        self._init_version = init_version
        self._applied_update_steps = 0
        self._grad_sum = None  # flat f32 accumulator
        self._grad_n = 0
        self._unraveler = None
        # report_keys of applied window syncs, oldest first
        self._seen_local_updates: "OrderedDict[str, bool]" = OrderedDict()
        self.duplicate_local_updates = 0
        self._standby_fn = None  # fn(worker_id) -> bool
        self._sample_batch_fn = None  # fn(n) -> list of records
        self._recovery_plane = None
        # each PS shard's highest version reported by ReportWindowMeta
        self._shard_version_max: Optional[list] = None

    def handlers(self) -> Dict[str, Any]:
        return {
            "GetTask": self.get_task,
            "ReportTaskResult": self.report_task_result,
            "GetModel": self.get_model,
            "GetAux": self.get_aux,
            "ReportVariable": self.report_variable,
            "ReportGradient": self.report_gradient,
            "ReportLocalUpdate": self.report_local_update,
            "ReportEvaluationMetrics": self.report_evaluation_metrics,
            "GetPSConfig": self.get_ps_config,
            "GetSampleBatch": self.get_sample_batch,
            "ReportWindowMeta": self.report_window_meta,
            "EmbeddingLookup": self.embedding_lookup,
            "EmbeddingUpdate": self.embedding_update,
            "PSRestoreFromWorker": self.ps_restore_from_worker,
            "ReportPhaseStats": self.report_phase_stats,
            "GetTrace": obs.get_trace,
            "GetMetrics": self.get_metrics,
        }

    # -- the observability plane ----------------------------------------------

    def get_metrics(self, req: dict) -> dict:
        """The master's MetricsRegistry snapshot (inproc shards' collectors
        included) plus one best-effort GetMetrics poll of every shard
        process, keyed ps<i> / kv<i>."""
        shards = {}
        if self.ps_group is not None:
            shards.update(self.ps_group.collect_shard_metrics())
        if self.kv_group is not None:
            shards.update(self.kv_group.collect_shard_metrics())
        return {"metrics": obs_metrics.get_registry().snapshot(), "shards": shards}

    def set_phase_stats_sink(self, fn):
        """fn(worker_id, phases): the ReportPhaseStats sink
        (`sched/telemetry.PhaseStatsAggregator.ingest`)."""
        self._phase_stats_sink = fn

    def report_phase_stats(self, req: dict) -> dict:
        """A worker's cumulative PhaseTimers snapshot. Last write wins per
        worker, so a resend or a reordering is harmless (idempotent)."""
        sink = self._phase_stats_sink
        if sink is not None:
            sink(int(req.get("worker_id", -1)), req.get("phases"))
        return {}

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

    def sparse_summary(self) -> Optional[dict]:
        """The sparse plane's state (None without tables): the store
        that served (the KV shards' stores each), its rows, and the
        sparse apply's seconds."""
        store = self._embedding_store
        if store is None:
            return None
        with self._sparse_lock:
            apply_seconds = self.sparse_apply_seconds
        if self.kv_group is not None:
            shards = store.shard_lens()
            return {"store": [s["store"] for s in shards], "rows": [s["n"] for s in shards],
                    "apply_seconds": apply_seconds}
        return {"store": type(store).__name__, "rows": len(store),
                "apply_seconds": apply_seconds}

    def model_initialized(self) -> bool:
        with self._lock:
            return self._params is not None

    def ps_summary(self) -> Optional[list]:
        """Each PS shard's counters (None without shards)."""
        return self.ps_group.stats() if self.ps_group is not None else None

    def _n_params(self) -> int:  # edl-lint: disable=lock-discipline -- caller holds self._lock
        return sum(int(np.asarray(p).size) for p in codec.tree_leaves(self._params))

    def get_params_copy(self):
        """(params, aux, version). Sharded: the model assembled from the
        shards at the lowest shard version (the slices may straddle a
        step); before the shards are seeded, the template is the model."""
        if self.ps_group is not None and self.ps_group.initialized:
            versions, vec = self.ps_group.assemble()
            if vec is not None:
                with self._lock:
                    aux = _copy(self._aux)
                    params = self._unravel(vec)
                return params, aux, min(versions)
        with self._lock:
            return (
                _copy(self._params) if self._params is not None else None,
                _copy(self._aux),
                self._version,
            )

    def save_latest_checkpoint(self, output_path: str):
        """The model now, with the optimizer's state and the embedding
        tables, as `--output`."""
        from elasticdl_tpu_torch.master.checkpoint import save_model_file

        emb = self._embedding_store.snapshot() if self._embedding_store is not None else None
        if self.ps_group is not None:
            params, aux, version = self.get_params_copy()
            save_model_file(output_path, params, version, aux=aux, embeddings=emb,
                            opt_state=self._sharded_opt_state())
            return
        with self._lock:
            save_model_file(output_path, self._params, self._version, aux=self._aux,
                            embeddings=emb, opt_state=self._opt_state_snapshot())

    def set_evaluation_service(self, evaluation_service):
        """Late wiring: the evaluation service needs `get_params_copy`
        and the servicer needs the service's hooks."""
        self._evaluation_service = evaluation_service

    def set_train_loss_hook(self, hook):
        """hook(version, loss), fed each applied report's loss (the
        metrics sink's `write_train_loss`)."""
        self._train_loss_hook = hook

    def set_standby_fn(self, fn):
        """fn(worker_id) -> bool; wired to WorkerManager.is_standby."""
        self._standby_fn = fn

    def set_sample_batch_fn(self, fn):
        """fn(n) -> list of raw records, served for standby pre-warming."""
        self._sample_batch_fn = fn

    def get_sample_batch(self, req: dict) -> dict:
        fn = self._sample_batch_fn
        if fn is None:
            return {"records": None}
        return {"records": fn(int(req.get("n", 1)))}

    # -- RPC: tasks ---------------------------------------------------------

    def _job_finished(self) -> bool:
        """No task left, and no evaluation job pending (its tasks may not
        exist yet)."""
        finished = self._task_d.finished()
        if finished and self._evaluation_service is not None:
            finished = not self._evaluation_service.has_pending()
        return finished

    def get_task(self, req: dict) -> dict:
        """The next shard, or WAIT; `finished` tells workers to exit. A
        standby gets WAIT with `standby: True`, which tells it to
        pre-warm."""
        if self._standby_fn is not None and self._standby_fn(req["worker_id"]):
            return {
                "task": Task(type=TaskType.WAIT).to_wire(),
                "finished": self._job_finished(),
                "standby": True,
            }
        task = self._task_d.get(req["worker_id"])
        if task is None:
            finished = self._job_finished()
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
        """Shard discovery for a booting or recovering worker: the PS
        shards' endpoints and generations and the model's size (none, and
        -1, on the single PS), the KV shards' endpoints and generations
        when the embedding tables live there, and the recovery plane's
        `recovering` lists: a worker that sees a PS shard listed offers
        its restore snapshot (PSRestoreFromWorker) and waits to
        re-resolve until the lists clear."""
        kv = list(self.kv_group.endpoints) if self.kv_group is not None else []
        kv_gens = list(self.kv_group.generations) if self.kv_group is not None else []
        plane = self._recovery_plane
        recovering = plane.status() if plane is not None else {"ps": [], "kv": []}
        resp = {"endpoints": [], "n_params": -1, "kv_endpoints": kv, "ps_generations": [],
                "kv_generations": kv_gens, "recovering": recovering}
        if self.ps_group is None:
            return resp
        with self._lock:
            n = self._n_params() if self._params is not None else -1
        resp.update(endpoints=list(self.ps_group.endpoints), n_params=n,
                    ps_generations=list(self.ps_group.generations))
        return resp

    # -- the recovery plane --------------------------------------------------

    def set_recovery_plane(self, plane):
        """Attach the RecoveryPlane: GetPSConfig advertises its fenced
        shards, and PSRestoreFromWorker's uploads go to it."""
        self._recovery_plane = plane

    def shard_version_floor(self, shard_id: int) -> int:
        """The highest version PS shard `shard_id` was reported at: the
        recovery plane's restore fence (-1 before any report)."""
        with self._lock:
            vm = self._shard_version_max
            i = int(shard_id)
            if vm is None or i >= len(vm):
                return -1
            return vm[i]

    def ps_restore_from_worker(self, req: dict) -> dict:
        """A worker's restore slice for a recovering PS shard. `accepted`
        is False without a plane or when the shard is not recovering (a
        late upload); a re-sent one is absorbed (the plane keeps the
        highest version)."""
        plane = self._recovery_plane
        if plane is None:
            return {"accepted": False}
        return {"accepted": plane.offer_upload(
            int(req.get("worker_id", -1)), int(req["shard_id"]), req["vec"], int(req["version"])
        )}

    # -- RPC: the embedding plane -------------------------------------------

    def embedding_lookup(self, req: dict) -> dict:
        values, unknown = self._embedding_store.lookup(req["layer"], req["ids"])
        return {"values": values, "unknown_index": unknown}

    def embedding_update(self, req: dict) -> dict:
        """A batch write (both stores copy the rows in)."""
        self._embedding_store.update(
            req["layer"], req["ids"], req["values"],
            set_if_not_exist=req.get("set_if_not_exist", False),
        )
        return {}

    def _apply_sparse(self, edl_grads):
        """Apply {table: IndexedRows} to the store; callers run it after
        releasing the model lock and before responding.

        With a recovery plane, a KV shard's outage does not fail the
        report (its dense part already applied, and a failure would
        requeue and apply it twice): under the sparse lock (later reports
        queue behind the outage) the apply waits until the plane has no
        KV shard recovering, then runs again, over the restored rows (the
        mirror's bounded staleness)."""
        if not edl_grads or self._sparse_opt is None:
            return
        t0 = time.perf_counter()
        with self._sparse_lock:
            try:
                self._sparse_opt.apply_gradients(edl_grads)
            except Exception as exc:
                if self._recovery_plane is None or not is_shard_outage_chain(exc):
                    raise
                logger.warning("sparse apply hit a KV shard outage, riding through its "
                               "recovery: %s", exc)
                self._ride_through_kv_recovery(edl_grads)
            self.sparse_apply_seconds += time.perf_counter() - t0

    def _ride_through_kv_recovery(self, edl_grads, deadline_seconds: float = 90.0):  # edl-lint: disable=lock-discipline -- caller holds self._sparse_lock: no sparse apply proceeds mid-recovery
        deadline = time.monotonic() + deadline_seconds
        while True:
            time.sleep(0.5)
            if self._recovery_plane.status().get("kv"):
                if time.monotonic() > deadline:
                    raise RuntimeError("KV recovery did not complete within the sparse "
                                       "apply's ride-through deadline")
                continue
            try:
                self._sparse_opt.apply_gradients(edl_grads)
                return
            except Exception as exc:
                if time.monotonic() > deadline or not is_shard_outage_chain(exc):
                    raise

    # -- RPC: model ---------------------------------------------------------

    def get_model(self, req: dict) -> dict:
        """MINIMUM: the latest model. FIXED: exactly `version`, from the
        live model while it still is that version, else the evaluation
        snapshot or a durable checkpoint. Tree form, or flat on `flat`."""
        if req.get("method", MethodType.MINIMUM) == MethodType.FIXED:
            return self._get_fixed_model(int(req.get("version", 0)), req.get("flat"))
        if self.ps_group is not None:
            return self._get_sharded_model(req)
        with self._lock:
            if self._params is None:
                return {"version": -1, "params": None, "aux": None}
            if req.get("only_if_newer") and self._version <= req.get("version", 0):
                return {"version": self._version, "params": None, "aux": None}
            if req.get("flat"):
                return {
                    "version": self._version,
                    "params_flat": codec.ravel_np(self._params),
                    "aux": _copy(self._aux),
                }
            return {
                "version": self._version,
                "params": _copy(self._params),
                "aux": _copy(self._aux),
            }

    def _get_sharded_model(self, req: dict) -> dict:
        """MINIMUM in sharded mode: `shapes` answers the template's leaf
        shapes (int64 arrays in the tree) and aux at the mirror's version;
        else the model assembled from the shards."""
        with self._lock:
            if self._params is None or not self.ps_group.initialized:
                return {"version": -1, "params": None, "aux": None}
            aux = _copy(self._aux)
            if req.get("shapes"):
                shapes = codec.tree_map(lambda a: np.asarray(np.shape(a), np.int64), self._params)
                return {"version": self._version, "shapes": shapes, "aux": aux}
        versions, vec = self.ps_group.assemble()
        if vec is None:  # a shard not seeded yet
            return {"version": -1, "params": None, "aux": None}
        if req.get("flat"):
            return {"version": min(versions), "params_flat": vec, "aux": aux}
        with self._lock:
            params = self._unravel(vec)
        return {"version": min(versions), "params": params, "aux": aux}

    def _get_fixed_model(self, version: int, flat) -> dict:
        with self._lock:
            # sharded: the template is no model; exact versions come from
            # the snapshots
            if (self.ps_group is None and version == self._version
                    and self._params is not None):
                params, aux = _copy(self._params), _copy(self._aux)
            else:
                params = None
        if params is None:
            if self._checkpoint_service is None:
                raise ValueError("FIXED model pull requires a checkpoint service")
            model = self._checkpoint_service.get_eval_model(version)
            if model is None:
                model = self._checkpoint_service.load_version(version)
            if model is None:
                raise ValueError(f"no snapshot for model version {version}")
            params, aux = model.params, model.aux
        if flat:
            return {"version": version, "params_flat": codec.ravel_np(params), "aux": aux}
        return {"version": version, "params": params, "aux": aux}

    def get_aux(self, req: dict) -> dict:
        """The non-trainable state and its version."""
        with self._lock:
            return {"aux": _copy(self._aux), "version": self._version}

    def report_variable(self, req: dict) -> dict:
        """Lazy model init from the first worker (SETNX: first wins).
        Sharded: the tree becomes the template, and the shards are seeded
        from it (their SETNX makes racing seeds harmless)."""
        seed = None
        with self._lock:
            if self._params is None:
                self._params = _to_f32(req["params"])
                if req.get("aux") is not None:
                    self._aux = _own(req["aux"])
                if self.ps_group is not None:
                    seed = codec.ravel_np(self._params)
            version = self._version
        if seed is not None:
            self.ps_group.ensure_init(seed, version)
        return {}

    def report_window_meta(self, req: dict) -> dict:  # edl-lint: disable=exactness-lineage -- metadata mirror of pushes the shards already applied under their report keys: the mirror moves to the max of the shards' minimum, so a resend re-reports the same version and changes nothing
        """Sharded mode's report of a push that went to the shards: the
        version mirror advances to the lowest shard version (the advance
        counts as applied steps), the aux state replaces the master's
        (last writer wins), the window's `edl_gradient` goes to the sparse
        optimizer, and the loss to the metrics sink; a crossed checkpoint
        cadence saves the model assembled from the shards with their
        optimizer state. `want_aux` asks for the aux state back (the
        pusher absorbed merged slices)."""
        versions = [int(v) for v in req.get("versions") or []]
        version = min(versions) if versions else -1
        resp = {}
        with self._lock:
            prev = self._version
            advanced = version > prev
            if advanced:
                self._version = version
                self._applied_update_steps += version - prev
            if versions:
                # each shard's maximum: the recovery plane's restore fence
                vm = self._shard_version_max
                if vm is None or len(vm) != len(versions):
                    vm = self._shard_version_max = [-1] * len(versions)
                for i, v in enumerate(versions):
                    vm[i] = max(vm[i], v)
            if req.get("aux_state") is not None:
                self._aux = _own(req["aux_state"])
            if req.get("want_aux"):
                resp["aux"] = _copy(self._aux)
        self._apply_sparse(req.get("edl_gradient") or {})
        if advanced:
            ckpt_snapshot = None
            ckpt = self._checkpoint_service
            if ckpt is not None and ckpt.crossed(prev, version):
                params, aux, v = self.get_params_copy()
                ckpt_snapshot = (params, aux, self._sharded_opt_state())
                version = max(version, v)
            self._on_version_bump(version, ckpt_snapshot, prev)
        self._report_train_loss(max(version, prev), req.get("loss"))
        return resp

    # -- RPC: gradients (the hot path) --------------------------------------

    def report_gradient(self, req: dict) -> dict:
        """Returns {accepted, version[, params_flat, aux]}."""
        if self.ps_group is not None:
            raise ValueError(
                "sharded PS: gradients go to the shard endpoints (PSPushGrad), not the master"
            )
        report_version = req.get("version", -1)
        aux_state = _own(req.get("aux_state"))
        edl_grads = req.get("edl_gradient") or {}
        applied_version = -1
        ckpt_snapshot = None
        sparse_to_apply = None
        with self._lock:
            if self._params is None:
                raise ValueError("gradient reported before model init")
            if req.get("gradient_flat") is None:
                raise ValueError("ReportGradient carries no gradient_flat")
            n_params = sum(
                int(np.asarray(p).size) for p in codec.tree_leaves(self._params)
            )
            grad = codec.delta_to_f32(req["gradient_flat"], n_params)
            staleness = self._version - report_version
            if not self._use_async and staleness > self._staleness_window:
                # stale: reject AND piggyback the fresh model so the
                # worker's retry needs no separate pull
                resp = {"accepted": False, "version": self._version}
                if req.get("return_model"):
                    resp["params_flat"] = self._flat_model(req.get("model_dtype"))
                    resp["aux"] = _copy(self._aux)
                return resp
            if report_version > self._version:
                raise ValueError(
                    f"future gradient version {report_version} > {self._version}"
                )
            if self._use_async:
                scale = 1.0
                if self._lr_staleness_modulation and staleness > 1:
                    scale = 1.0 / float(staleness)
                self._apply(grad, dense_scale=scale, aux_state=aux_state)
                applied_version = self._version
                sparse_to_apply = edl_grads
            else:
                if self._grad_sum is None:
                    self._grad_sum = np.array(grad, dtype=np.float32)
                else:
                    self._grad_sum += grad
                if aux_state is not None:
                    self._pending_aux = aux_state
                for layer, rows in edl_grads.items():
                    # kept past the handler: copied out of the request
                    self._edl_grads.setdefault(layer, []).append(_own(rows))
                self._grad_n += 1
                if self._grad_n >= self._grads_to_wait:
                    avg = self._grad_sum / np.float32(self._grad_n)
                    merged = {
                        layer: codec.merge_indexed_rows(rows)
                        for layer, rows in self._edl_grads.items()
                    }
                    # clear BEFORE apply: a failed apply raises to the
                    # reporter, and leftovers would double-count its retry
                    aux_pending, self._pending_aux = self._pending_aux, None
                    self._grad_sum = None
                    self._grad_n = 0
                    self._edl_grads = {}
                    self._apply(avg, aux_state=aux_pending)
                    applied_version = self._version
                    sparse_to_apply = merged
            resp = {"accepted": True, "version": self._version}
            if req.get("return_model") and self._version != report_version:
                resp["params_flat"] = self._flat_model(req.get("model_dtype"))
                resp["aux"] = _copy(self._aux)
            if applied_version >= 0:
                ckpt_snapshot = self._checkpoint_snapshot(applied_version - 1, applied_version)
        self._apply_sparse(sparse_to_apply)
        if applied_version >= 0:
            self._on_version_bump(applied_version, ckpt_snapshot, applied_version - 1)
            self._report_train_loss(applied_version, req.get("loss"))
        return resp

    def report_local_update(self, req: dict) -> dict:
        """Window mode: add one cumulative delta in float32, advance the
        version by its `steps`, and hand back the merged model (and aux)
        when the worker's base fell behind (`base_version + steps !=
        version`: another worker synced in between) or it asks for it.
        A `report_key` seen before (a resend) changes nothing and
        answers `duplicate: True` with the merged model."""
        if self.ps_group is not None:
            raise ValueError(
                "sharded PS: deltas go to the shard endpoints (PSPushDelta), not the master"
            )
        steps = int(req["steps"])
        base_version = int(req["base_version"])
        report_key = req.get("report_key") or ""
        t_apply = time.time()
        with self._lock:
            if self._params is None:
                raise ValueError("local update reported before model init")
            if report_key and report_key in self._seen_local_updates:
                self.duplicate_local_updates += 1
                return {
                    "version": self._version,
                    "params_flat": self._flat_model(req.get("model_dtype")),
                    "aux": _copy(self._aux),
                    "duplicate": True,
                }
            prev_version = self._version
            # a base more than the window behind is down-weighted, never
            # rejected (deltas have no reject-and-retry protocol)
            scale = 1.0
            if self._staleness_window:
                staleness = self._version - base_version
                if staleness > self._staleness_window:
                    scale = self._staleness_window / float(staleness)
            if self._unraveler is None:
                self._unraveler = codec.make_unraveler(self._params)
            delta = self._unraveler(codec.delta_to_f32(req["delta_flat"]))
            if scale == 1.0:
                self._params = codec.tree_map(lambda p, d: p + d, self._params, delta)
            else:
                self._params = codec.tree_map(lambda p, d: p + scale * d, self._params, delta)
            if req.get("aux_state") is not None:
                self._aux = _own(req["aux_state"])
            self._version += steps
            self._applied_update_steps += steps
            applied_version = self._version
            ckpt_snapshot = self._checkpoint_snapshot(prev_version, applied_version)
            if report_key:
                # registered only after the apply succeeded
                self._seen_local_updates[report_key] = True
                while len(self._seen_local_updates) > LOCAL_UPDATE_DEDUP_CAP:
                    self._seen_local_updates.popitem(last=False)
            resp = {"version": self._version}
            if base_version + steps != self._version or req.get("want_model"):
                resp["params_flat"] = self._flat_model(req.get("model_dtype"))
                resp["aux"] = _copy(self._aux)
        # the lock wait and the apply, retro-recorded under the server
        # span (a duplicate's early return above skips it)
        obs_trace.record_event("master.apply", t_apply, time.time(), cat="ps",
                               args={"kind": "local_update"})
        # the window's rows, at full weight like the per-step path
        self._apply_sparse(req.get("edl_gradient") or {})
        self._on_version_bump(applied_version, ckpt_snapshot, prev_version)
        self._report_train_loss(applied_version, req.get("loss"))
        return resp

    def report_evaluation_metrics(self, req: dict) -> dict:
        """One evaluation minibatch's metrics."""
        if self._evaluation_service is not None:
            self._evaluation_service.report_metrics(
                req.get("model_version", -1),
                _own(req.get("metrics", {})),
                req.get("num_examples", 1),
            )
        return {}

    def _flat_model(self, model_dtype=None):  # caller holds self._lock
        """The raveled params, narrowed to the worker's wire dtype when
        it asks for bfloat16 (the worker widens it again)."""
        return codec.narrow(codec.ravel_np(self._params), model_dtype)

    def _apply(self, flat_grad: np.ndarray, dense_scale: float = 1.0, aux_state=None):  # caller holds self._lock
        if aux_state is not None:
            self._aux = aux_state
        if self._unraveler is None:
            self._unraveler = codec.make_unraveler(self._params)
        if self._opt is not None:
            if dense_scale != 1.0:
                flat_grad = flat_grad * dense_scale
            self._params = self._opt.step(self._params, self._unraveler(flat_grad))
        self._version += 1
        self._applied_update_steps += 1

    # -- job-service hooks --------------------------------------------------

    def _unravel(self, vec):  # edl-lint: disable=lock-discipline -- caller holds self._lock
        """A flat vector as a tree of the template's structure."""
        if self._unraveler is None:
            self._unraveler = codec.make_unraveler(self._params)
        return self._unraveler(vec)

    def _sharded_opt_state(self):
        """Each shard's optimizer-state leaves, for a checkpoint."""
        shards = self.ps_group.export_opt()
        return {"kind": "sharded", "shards": shards} if shards is not None else None

    def _opt_state_snapshot(self):  # caller holds self._lock
        """The dense optimizer's state leaves for exact resume (None
        before the first apply)."""
        if self._opt is None or not self._opt.initialized:
            return None
        return {"kind": "single", "leaves": self._opt.state_snapshot()}

    def _checkpoint_snapshot(self, prev_version: int, version: int):  # caller holds self._lock
        """(params, aux, opt_state) copied at exactly `version` when the
        bump from `prev_version` crossed the checkpoint cadence, else
        None: a concurrent report cannot skip a cadence point."""
        ckpt = self._checkpoint_service
        if ckpt is None or not ckpt.crossed(prev_version, version):
            return None
        return _copy(self._params), _copy(self._aux), self._opt_state_snapshot()

    def _on_version_bump(self, version: int, ckpt_snapshot=None, prev_version=None):
        """The checkpoint save and the evaluation step trigger for an
        applied version. Called without the lock: the evaluation service
        calls back into get_params_copy."""
        if ckpt_snapshot is not None:
            params, aux, opt_state = ckpt_snapshot
            self._checkpoint_service.save(params, version, aux=aux, opt_state=opt_state)
        if self._evaluation_service is not None:
            self._evaluation_service.add_evaluation_task_if_needed(version, prev_version)

    def _report_train_loss(self, version: int, loss):
        hook = self._train_loss_hook
        if hook is not None and loss is not None:
            try:
                hook(version, float(loss))
            except Exception:
                # a metrics sink must never fail training
                logger.exception("train-loss hook failed")

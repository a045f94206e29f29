"""The sharded parameter server: the dense model split across N endpoints.

The reference's `elasticdl_tpu/master/ps_shard.py` (its core). The flat
float32 model vector (the codec's leaf order) is cut into `num_shards`
contiguous slices (`slice_boundaries`), each held by a `PSShardServicer`
behind its own RPC endpoint, with its own lock and its own optimizer.
Workers push gradient or delta slices to every shard at once, so PS
bandwidth and apply CPU grow with the shard count instead of queuing at
one lock. The control plane (tasks, evaluation, checkpoints, the
embedding tables) stays on the master.

Consistency, by protocol:

- window deltas (`PSPushDelta`) are added and never rejected, so the
  per-shard applies commute: one worker gets exactly the single PS's
  math, several workers local-SGD merges, slice by slice; a base more
  than `staleness_window` behind is down-weighted by each shard against
  its own version;
- async per-step gradients (`PSPushGrad`, `use_async`) apply at once on
  each shard, scaled by 1/staleness under `lr_staleness_modulation`;
  windowed sync averages `grads_to_wait` reports and down-weights one
  beyond the window. The shard runs the zoo's whole optimizer over its
  slice, so an elementwise optimizer applies as it would to the whole
  vector, and a global-norm clip clips by the SLICE's norm (the
  reference's behaviour, kept on purpose: with a clip and `num_shards >
  1`, a sharded job is not the single-PS job);
- strict per-step sync (a rejection by version) is not offered: a
  report accepted by one shard and refused by another would be torn.
  `common.args.validate_ps_args` refuses it at boot.

Shard versions advance on their own; they agree on the number of applied
steps of each worker's stream.

Pushes carry a `report_key`; a key already applied is answered as a
duplicate and applied no second time (the dedup ring, capped), which is
what makes the client's retries safe. Applies change the slice in place
under the lock, so every read that leaves the lock (a pull, a merged
slice in a push's response) is a copy taken under it; the narrowing to
the response's `model_dtype` (bfloat16 halves the bytes) happens after
the lock is released. `stats()` counts applied and duplicate pushes, the
seconds spent applying under the lock and waiting for it, and the pulls.

Fencing (`rpc/fencing.py`): the servicer carries its slot's
`generation`, which the group bumps on every relaunch (a relaunch builds
a new servicer) and `PSRefence` moves in place (the master-migration
cutover). Every handler but `UNFENCED_HANDLERS` rejects a request whose
`epoch` names another generation (FAILED_PRECONDITION on the wire,
never re-sent). A relaunched shard boots empty; the recovery plane
(`master/recovery.py`) seeds it through PSInit and PSOptRestore.

Observability (`obs/`): each push's lock wait and apply is a `ps.apply`
span, the child of the push's server span when the pusher traces;
GetTrace and GetMetrics answer for the hosting process and skip the
epoch check, so a fenced-out shard can still be asked what happened;
`register_metrics` feeds `stats()` to the process's metrics registry
(`edl_ps_*`).

Not ported yet: bucketed and combined pushes and the fan-in buffers, the
pull prepack cache and the shm broadcast publisher.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.common import codec
from elasticdl_tpu_torch.common.log_util import get_logger
from elasticdl_tpu_torch.obs import metrics as obs_metrics
from elasticdl_tpu_torch.obs import trace as obs_trace
from elasticdl_tpu_torch.rpc.fencing import EpochFencedError, check_epoch

logger = get_logger(__name__)

#: dedup ring capacity of a servicer built without one (the group sizes
#: it by the job's workers: `ps_group.PSShardGroup.dedup_cap_for`)
DEFAULT_DEDUP_CAP = 512


def slice_boundaries(n_params: int, num_shards: int) -> List[Tuple[int, int]]:
    """Near-equal contiguous split of [0, n_params): the same edges on
    master and workers from (n_params, num_shards) alone."""
    if num_shards <= 0:
        raise ValueError(f"num_shards must be > 0, got {num_shards}")
    edges = np.linspace(0, n_params, num_shards + 1).astype(np.int64)
    return [(int(edges[i]), int(edges[i + 1])) for i in range(num_shards)]


class PSShardServicer:
    """One shard: a contiguous slice of the flat model and its optimizer
    state, with the master's gradient and window semantics on it."""

    def __init__(
        self,
        shard_id: int,
        num_shards: int,
        optimizer=None,  # master.ps_optimizer.PSOptimizer, or None: plain SGD
        grads_to_wait: int = 1,
        use_async: bool = False,
        lr_staleness_modulation: bool = False,
        staleness_window: int = 0,
        generation: int = 0,
        dedup_cap: Optional[int] = None,
    ):
        self.shard_id = shard_id
        self.num_shards = num_shards
        # the slot's fencing epoch: written under self._lock (PSRefence),
        # read bare by _check_epoch (one int: a request racing the bump
        # is rejected either way)
        self.generation = int(generation)
        self._opt = optimizer
        self._grads_to_wait = grads_to_wait
        self._use_async = use_async
        self._lr_staleness_modulation = lr_staleness_modulation
        self._staleness_window = staleness_window
        self._lock = threading.Lock()
        self._vec: Optional[np.ndarray] = None  # f32 [slice length]
        self._version = 0
        self._grad_sum: Optional[np.ndarray] = None
        self._grad_n = 0
        # report_key -> None, oldest first: the keys of applied pushes
        self._seen_reports: "OrderedDict[str, None]" = OrderedDict()
        self._seen_cap = max(64, int(dedup_cap)) if dedup_cap else DEFAULT_DEDUP_CAP
        self._applied_pushes = 0
        self._first_apply_at: Optional[float] = None  # time.time() of the first
        self._duplicate_pushes = 0
        self._pulls = 0
        self._apply_seconds = 0.0
        self._lock_wait_seconds = 0.0

    #: Handlers that skip the epoch check: the stats, trace and metrics
    #: reads answer for the process (what a postmortem wants from a
    #: fenced shard), and PSRefence is the fence mover: it carries the
    #: NEW generation, and its own monotonicity check is its fence.
    UNFENCED_HANDLERS = frozenset({"PSStats", "PSRefence", "GetTrace", "GetMetrics"})

    def handlers(self) -> Dict[str, Any]:
        return {
            "PSInit": self.init_slice,
            "PSPull": self.pull,
            "PSPushGrad": self.push_grad,
            "PSPushDelta": self.push_delta,
            "PSOptState": self.opt_state,
            "PSOptRestore": self.opt_restore,
            "PSRefence": self.refence,
            "PSStats": lambda req: self.stats(),
            "GetTrace": obs.get_trace,
            "GetMetrics": obs.get_metrics,
        }

    def _check_epoch(self, req: dict):  # edl-lint: disable=lock-discipline -- bare read of the one int epoch word: a request racing the refence is rejected either way
        check_epoch(req, self.generation, "ps", self.shard_id)

    def register_metrics(self, registry=None) -> None:
        """Feed this shard's counters into the process's
        MetricsRegistry as a pull collector (the group, or the shard
        process's main, calls it). Weakly referenced: a servicer that a
        relaunch replaced stops reporting once it is collected."""
        reg = registry if registry is not None else obs_metrics.get_registry()
        ref = weakref.ref(self)
        shard = str(self.shard_id)

        def collector(sink):
            s = ref()
            if s is None:
                return
            st = s.stats()
            sink.counter("edl_ps_applied_pushes_total", st["applied_pushes"], shard=shard)
            sink.counter("edl_ps_duplicate_pushes_total", st["duplicate_pushes"], shard=shard)
            sink.gauge("edl_ps_version", st["version"], shard=shard)
            sink.gauge("edl_ps_generation", st["generation"], shard=shard)

        reg.register_collector(collector)

    def refence(self, req: dict) -> dict:
        """Move the generation in place under the live slice (the
        master-migration cutover): state survives, and every client
        still stamping the old generation bounces from then on.
        Monotonic and idempotent by target: the current generation
        answers ok (a re-sent bump), an older one is fenced."""
        target = int(req.get("generation", -1))
        with self._lock:
            if target < self.generation:
                raise EpochFencedError("ps", self.shard_id, self.generation, target)
            if target > self.generation:
                logger.info("PS shard %d refenced: generation %d -> %d",
                            self.shard_id, self.generation, target)
                self.generation = target
            return {"generation": self.generation}

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    # -- RPCs ----------------------------------------------------------------

    def init_slice(self, req: dict) -> dict:
        """SETNX: the first initializer wins; later ones get the version."""
        self._check_epoch(req)
        with self._lock:
            if self._vec is None:
                self._vec = np.array(req["vec"], dtype=np.float32)
                self._version = int(req.get("version", 0))
                logger.info("PS shard %d/%d initialized: %d params at v%d", self.shard_id,
                            self.num_shards, self._vec.size, self._version)
            return {"version": self._version, "size": int(self._vec.size)}

    def pull(self, req: dict) -> dict:
        """The slice and its version; None for the slice when the shard
        holds none yet (version -1) or, under `only_if_newer`, when it is
        not newer than the caller's `version`."""
        self._check_epoch(req)
        with self._lock:
            if self._vec is None:
                return {"version": -1, "vec": None}
            version = self._version
            if req.get("only_if_newer") and version <= req.get("version", -1):
                return {"version": version, "vec": None}
            vec = self._vec.copy()
            self._pulls += 1
        return {"version": version, "vec": codec.narrow(vec, req.get("model_dtype"))}

    def push_grad(self, req: dict) -> dict:
        """A per-step gradient slice: applied at once (async), or summed
        until `grads_to_wait` reports (windowed sync)."""
        self._check_epoch(req)
        grad = codec.delta_to_f32(req["grad"])  # decoded outside the lock
        # the span covers the lock wait and the apply: on a contended
        # shard the wait is the interesting part of the sync path
        with obs_trace.span("ps.apply", cat="ps", args={"shard": self.shard_id, "kind": "grad"}):
            t0 = time.perf_counter()
            with self._lock:
                t1 = time.perf_counter()
                try:
                    resp = self._push_grad_locked(req, grad)
                finally:
                    self._count_lock_seconds(t0, t1)
        return self._narrowed(resp, req)

    def _push_grad_locked(self, req: dict, grad: np.ndarray) -> dict:  # edl-lint: disable=lock-discipline -- caller holds self._lock
        if self._vec is None:
            raise ValueError("gradient pushed before shard init")
        if self._is_duplicate(req):
            resp = {"accepted": True, "version": self._version, "duplicate": True}
            if req.get("return_model"):
                resp["vec"] = self._vec.copy()
            return resp
        if grad.shape != self._vec.shape:
            raise ValueError(f"grad slice shape {grad.shape} != {self._vec.shape}")
        report_version = int(req.get("version", -1))
        staleness = self._version - report_version
        if self._use_async:
            scale = 1.0
            if self._lr_staleness_modulation and staleness > 1:
                scale = 1.0 / float(staleness)
            self._apply(grad * scale if scale != 1.0 else grad)
        else:
            # a report beyond the window is down-weighted, never
            # rejected: a rejection could not be atomic across shards
            if self._staleness_window and staleness > self._staleness_window:
                grad = grad * (self._staleness_window / float(staleness))
            if self._grad_sum is None:
                self._grad_sum = grad.copy()
            else:
                self._grad_sum += grad
            self._grad_n += 1
            if self._grad_n >= self._grads_to_wait:
                self._apply(self._grad_sum / self._grad_n)
                self._grad_sum = None
                self._grad_n = 0
        self._record_applied(req)
        resp = {"accepted": True, "version": self._version}
        if req.get("return_model") and self._version != report_version:
            resp["vec"] = self._vec.copy()
        return resp

    def push_delta(self, req: dict) -> dict:
        """A window delta slice: added, the version advances by `steps`,
        and the merged slice goes back when the pusher's base fell behind
        (another worker synced in between) or it asks for it."""
        self._check_epoch(req)
        delta = codec.delta_to_f32(req["delta"])  # decoded outside the lock
        with obs_trace.span("ps.apply", cat="ps", args={"shard": self.shard_id, "kind": "delta"}):
            t0 = time.perf_counter()
            with self._lock:
                t1 = time.perf_counter()
                try:
                    resp = self._push_delta_locked(req, delta)
                finally:
                    self._count_lock_seconds(t0, t1)
        return self._narrowed(resp, req)

    def _push_delta_locked(self, req: dict, delta: np.ndarray) -> dict:  # edl-lint: disable=lock-discipline -- caller holds self._lock
        if self._vec is None:
            raise ValueError("delta pushed before shard init")
        if self._is_duplicate(req):
            # applied before: answered like a merge, so the retrying
            # worker rebases onto the slice that holds it
            return {"version": self._version, "vec": self._vec.copy(), "duplicate": True}
        steps = int(req["steps"])
        base_version = int(req["base_version"])
        if delta.shape != self._vec.shape:
            raise ValueError(f"delta slice shape {delta.shape} != {self._vec.shape}")
        scale = 1.0
        if self._staleness_window:
            staleness = self._version - base_version
            if staleness > self._staleness_window:
                scale = self._staleness_window / float(staleness)
        self._vec += scale * delta if scale != 1.0 else delta
        self._version += steps
        self._record_applied(req)
        resp = {"version": self._version}
        if base_version + steps != self._version or req.get("want_model"):
            resp["vec"] = self._vec.copy()
        return resp

    def opt_state(self, req: dict) -> dict:
        """The slice's optimizer-state leaves (None before the first apply)."""
        self._check_epoch(req)
        with self._lock:
            leaves = (
                self._opt.state_snapshot()
                if self._opt is not None and self._opt.initialized
                else None
            )
        return {"leaves": leaves}

    def opt_restore(self, req: dict) -> dict:
        """Adopt a checkpoint's (or the recovery plane's mirrored)
        optimizer-state leaves for this slice."""
        self._check_epoch(req)
        with self._lock:
            if self._vec is None:
                raise ValueError("opt restore before slice init")
            if self._opt is not None and req.get("leaves") is not None:
                self._opt.restore_state(self._vec, req["leaves"])
        return {}

    def stats(self) -> dict:
        """Push accounting (applied + duplicate = pushes received), the
        generation, the version, the slice length, the pulls served, the seconds the
        pushes spent applying under the lock and waiting for it, the wall
        clock of the first applied push (a relaunched shard's first one
        closes its recovery's timeline), and the hosting process's pid."""
        with self._lock:
            return {
                "shard_id": self.shard_id,
                "generation": self.generation,
                "pid": os.getpid(),
                "version": self._version,
                "size": int(self._vec.size) if self._vec is not None else 0,
                "applied_pushes": self._applied_pushes,
                "first_apply_at": self._first_apply_at,
                "duplicate_pushes": self._duplicate_pushes,
                "pulls": self._pulls,
                "apply_seconds": self._apply_seconds,
                "lock_wait_seconds": self._lock_wait_seconds,
            }

    # -- internals -----------------------------------------------------------

    def _count_lock_seconds(self, t0: float, t1: float):  # edl-lint: disable=lock-discipline -- caller holds self._lock
        """A push's wait for the lock (t0 to t1) and its hold (t1 to now)."""
        self._lock_wait_seconds += t1 - t0
        self._apply_seconds += time.perf_counter() - t1

    @staticmethod
    def _narrowed(resp: dict, req: dict) -> dict:
        if resp.get("vec") is not None:
            resp["vec"] = codec.narrow(resp["vec"], req.get("model_dtype"))
        return resp

    def _is_duplicate(self, req: dict) -> bool:  # edl-lint: disable=lock-discipline -- caller holds self._lock
        """True when req's report_key was applied before. A key is
        registered only after its apply succeeded, so a push that failed
        midway gets a real second attempt; keyless pushes never dedup."""
        key = req.get("report_key")
        if key and key in self._seen_reports:
            self._duplicate_pushes += 1
            return True
        return False

    def _record_applied(self, req: dict):  # edl-lint: disable=lock-discipline -- caller holds self._lock
        self._applied_pushes += 1
        if self._first_apply_at is None:
            self._first_apply_at = time.time()
        key = req.get("report_key")
        if not key:
            return
        self._seen_reports[key] = None
        while len(self._seen_reports) > self._seen_cap:
            self._seen_reports.popitem(last=False)

    def _apply(self, grad: np.ndarray):  # edl-lint: disable=lock-discipline -- caller holds self._lock
        """One optimizer step on the slice (a new array), or plain SGD."""
        if self._opt is not None:
            self._vec = np.asarray(self._opt.step(self._vec, grad), dtype=np.float32)
        else:
            self._vec = self._vec - grad
        self._version += 1


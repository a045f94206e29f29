"""Client of the sharded parameter server (workers and master).

The reference's `elasticdl_tpu/rpc/ps_client.py` (its core) over the
port's own `RpcClient`. `ShardedPS` is one logical PS over the N shard
endpoints of `master/ps_shard.py`: every operation fans out to all
shards on a thread pool, one connection a shard, and the slices follow
`slice_boundaries`, computed here from (n_params, num_shards). An error
from any shard reaches the caller (`_map` re-raises the first one).

There is no transaction across shards: when one shard's push fails for
good after others applied theirs, the report is torn, and the worker
resets and retrains the covered tasks. A transient failure does not
tear: every PS method is re-sent under the `RetryPolicy`
(`rpc/policy.py`), since reads and the SETNX init are idempotent and a
push carries a `report_key` that the shard's dedup ring absorbs. The
ring only holds that promise while it still remembers the key, so the
group sizes it by the keys that can be in flight (num_workers x syncs
in flight a worker, with headroom: `PSShardGroup.dedup_cap_for`).

Fencing (`rpc/fencing.py`): with `generations`, every shard request
carries its shard's generation as its `epoch` (`_stamp_epoch`), so a
relaunched or zombie shard refuses a client that holds another
(FAILED_PRECONDITION, never re-sent). After a shard's recovery,
`update_endpoints` swaps in the endpoints and generations that the
master advertises; the shard count is fixed for the job, so the slices
stand. A push's `report_key` may be pinned by the caller: one key spans
the whole fan-out, so a push torn by a shard's death is replayed under
it after the recovery, the shards that applied it absorb the replay and
the restored shard applies it, and each slice gets it exactly once.

`pull_async` is `pull` on a pool thread of its own (one): the worker's
background model page-in calls it while the step loop and the sync
chain's fan-outs go on; the links take concurrent calls.

Pool threads do not inherit the caller's trace context, so every
submit carries it (`_traced`): each shard's `rpc.client.*` span chains
under the caller's window, pull or page-in span (`obs/trace.py`).

Not ported yet: the aggregation-tree route and bucketed pushes.
"""

from __future__ import annotations

import time
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from elasticdl_tpu_torch.common import codec
from elasticdl_tpu_torch.master.ps_shard import slice_boundaries
from elasticdl_tpu_torch.obs import trace as obs_trace
from elasticdl_tpu_torch.rpc.client import RpcClient
from elasticdl_tpu_torch.rpc.policy import PolicyRpcError, StatusCode


class ShardedPS:
    """Fan-out client over the PS shard endpoints."""

    def __init__(self, endpoints: List[str], n_params: int,
                 generations: Optional[List[int]] = None):
        if not endpoints:
            raise ValueError("ShardedPS needs at least one endpoint")
        self.endpoints = list(endpoints)
        self.n_params = int(n_params)
        self.bounds = slice_boundaries(self.n_params, len(self.endpoints))
        # each shard's fencing epoch (None: unfenced)
        self.generations = list(generations) if generations else None
        self._clients = [RpcClient(ep) for ep in self.endpoints]
        # the links of earlier endpoints, closed with this client: a
        # fan-out thread may still be in a call on one
        self._retired: list = []
        self._pool = ThreadPoolExecutor(
            max_workers=len(self.endpoints), thread_name_prefix="ps-shard"
        )
        self._async_pool: Optional[ThreadPoolExecutor] = None  # pull_async's, lazily

    @property
    def num_shards(self) -> int:
        return len(self.endpoints)

    @property
    def tiers(self) -> List[str]:
        """The transport tier of each shard's link."""
        return [c.tier for c in self._clients]

    def _stamp_epoch(self, req: dict, i: int) -> dict:
        if self.generations is not None:
            req["epoch"] = self.generations[i]
        return req

    def update_endpoints(self, endpoints: List[str], generations: Optional[List[int]] = None):
        """Re-resolution after a shard's relaunch: the new endpoints and
        generations (the same shard count: slices do not re-split)."""
        if len(endpoints) != len(self.endpoints):
            raise ValueError(
                f"re-resolution changed the shard count {len(self.endpoints)} -> {len(endpoints)}"
            )
        self._retired.extend(self._clients)
        self._clients = [RpcClient(ep) for ep in endpoints]
        self.endpoints = list(endpoints)
        self.generations = list(generations) if generations else None

    def rpc_seconds(self) -> Dict[str, float]:
        """Seconds per method summed over the shard links (the calls run
        at once, so this exceeds the fan-out's wall clock)."""
        out: Dict[str, float] = {}
        for c in self._retired + self._clients:
            for method, s in c.seconds.items():
                out[method] = out.get(method, 0.0) + s
        return out

    @staticmethod
    def _traced(fn):
        """fn run under the calling thread's trace context, restored
        after."""
        tctx = obs_trace.current()
        if tctx is None:
            return fn

        def run(*args, **kwargs):
            prev = obs_trace.bind(tctx)
            try:
                return fn(*args, **kwargs)
            finally:
                obs_trace.bind(prev)

        return run

    def _map(self, fn):
        """fn(client, shard index) on every shard at once; the results in
        shard order, the first failure re-raised."""
        run = self._traced(fn)
        futs = [self._pool.submit(run, c, i) for i, c in enumerate(self._clients)]
        return [f.result() for f in futs]

    def wait_ready(self, timeout: float = 30.0):
        """One deadline shared by every shard; the waits run at once."""
        deadline = time.monotonic() + timeout

        def wait(c, i):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise PolicyRpcError(StatusCode.DEADLINE_EXCEEDED, "PS shards not ready")
            c.wait_ready(remaining)

        self._map(wait)

    # -- operations ----------------------------------------------------------

    def init_model(self, vec: np.ndarray, version: int = 0) -> List[int]:
        """Each shard's initial slice (SETNX); returns the shard versions."""
        vec = np.asarray(vec, dtype=np.float32)
        if vec.size != self.n_params:
            raise ValueError(f"init vec size {vec.size} != {self.n_params}")

        def do(c, i):
            s, e = self.bounds[i]
            req = {"vec": vec[s:e], "version": version}
            return c.call("PSInit", self._stamp_epoch(req, i))["version"]

        return self._map(do)

    def pull(
        self, versions: Optional[List[int]] = None, model_dtype: Optional[str] = None
    ) -> Tuple[List[int], Optional[np.ndarray]]:
        """(shard versions, the assembled flat model or None). With
        `versions`, a shard not newer than its entry sends no slice; when
        any shard is newer, the others' slices are pulled too, so the
        model comes back whole. None when nothing advanced or a shard
        holds no slice yet (its version is -1)."""
        only_if_newer = versions is not None

        def do(c, i):
            req = {"only_if_newer": only_if_newer}
            if only_if_newer:
                req["version"] = versions[i]
            if model_dtype:
                req["model_dtype"] = model_dtype
            return c.call("PSPull", self._stamp_epoch(req, i))

        resps = self._map(do)
        new_versions = [r["version"] for r in resps]
        if any(v < 0 for v in new_versions):
            return new_versions, None
        if only_if_newer and all(r.get("vec") is None for r in resps):
            return new_versions, None
        missing = [i for i, r in enumerate(resps) if r.get("vec") is None]
        if missing:
            def refill(c, i):
                req = {"model_dtype": model_dtype} if model_dtype else {}
                return c.call("PSPull", self._stamp_epoch(req, i))

            run = self._traced(refill)
            futs = [(i, self._pool.submit(run, self._clients[i], i)) for i in missing]
            for i, f in futs:
                resps[i] = f.result()
                new_versions[i] = resps[i]["version"]
        return new_versions, self._assemble([r["vec"] for r in resps])

    def pull_async(
        self, versions: Optional[List[int]] = None, model_dtype: Optional[str] = None
    ) -> Future:
        """`pull` without blocking: a Future of the same (shard versions,
        model or None), run on one pool thread of its own."""
        if self._async_pool is None:
            self._async_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ps-pull-async")
        return self._async_pool.submit(self._traced(self.pull), versions=versions,
                                       model_dtype=model_dtype)

    def push_delta(
        self,
        delta,
        steps: int,
        base_versions: List[int],
        model_dtype: Optional[str] = None,
        want_model: bool = False,
        report_key: Optional[str] = None,
        duplicates: Optional[list] = None,
    ) -> Tuple[List[int], Dict[int, object]]:
        """A window delta (any wire form: each shard gets its slice in the
        same form) to every shard. Returns (shard versions, {shard index:
        merged slice}): a merged slice only from the shards whose version
        ran past base + steps (or all of them under `want_model`).
        `report_key` names the push across retries and replays (a fresh
        one when None); a list given as `duplicates` gets each shard's
        flag of a push it had applied before."""
        if not isinstance(delta, (codec.QuantizedDelta, codec.SparseDelta, codec.BF16Bits)):
            delta = np.asarray(delta)
        size = codec.delta_length(delta)
        if size != self.n_params:
            raise ValueError(f"delta size {size} != {self.n_params}")
        report_key = report_key or uuid.uuid4().hex

        def do(c, i):
            s, e = self.bounds[i]
            req = {
                "delta": codec.slice_delta(delta, s, e),
                "steps": steps,
                "base_version": base_versions[i],
                "want_model": want_model,
                "report_key": report_key,
            }
            if model_dtype:
                req["model_dtype"] = model_dtype
            return c.call("PSPushDelta", self._stamp_epoch(req, i))

        resps = self._map(do)
        if duplicates is not None:
            duplicates.extend(bool(r.get("duplicate")) for r in resps)
        merged = {i: r["vec"] for i, r in enumerate(resps) if r.get("vec") is not None}
        return [r["version"] for r in resps], merged

    def push_grad(
        self,
        grad,
        versions: List[int],
        model_dtype: Optional[str] = None,
        return_model: bool = False,
        report_key: Optional[str] = None,
    ) -> Tuple[List[int], Optional[np.ndarray]]:
        """A per-step gradient (any wire form) to every shard. Returns
        (shard versions, the assembled model or None): the model only
        under `return_model` and when every shard sent its slice back."""
        if not isinstance(grad, (codec.QuantizedDelta, codec.SparseDelta, codec.BF16Bits)):
            grad = np.asarray(grad)
        size = codec.delta_length(grad)
        if size != self.n_params:
            raise ValueError(f"grad size {size} != {self.n_params}")
        report_key = report_key or uuid.uuid4().hex

        def do(c, i):
            s, e = self.bounds[i]
            req = {
                "grad": codec.slice_delta(grad, s, e),
                "version": versions[i],
                "return_model": return_model,
                "report_key": report_key,
            }
            if model_dtype:
                req["model_dtype"] = model_dtype
            return c.call("PSPushGrad", self._stamp_epoch(req, i))

        resps = self._map(do)
        new_versions = [r["version"] for r in resps]
        vec = None
        if return_model and all(r.get("vec") is not None for r in resps):
            vec = self._assemble([r["vec"] for r in resps])
        return new_versions, vec

    def export_opt(self) -> List[Optional[list]]:
        """Each shard's optimizer-state leaves (exact resume)."""
        return [
            r["leaves"]
            for r in self._map(lambda c, i: c.call("PSOptState", self._stamp_epoch({}, i)))
        ]

    def export_opt_shard(self, i: int) -> Optional[list]:
        """One shard's optimizer-state leaves (the recovery plane's
        mirror reads the shards one by one)."""
        return self._clients[i].call("PSOptState", self._stamp_epoch({}, i))["leaves"]

    def restore_opt(self, shards: List[Optional[list]]):
        if len(shards) != self.num_shards:
            raise ValueError(
                f"opt state has {len(shards)} shards, the group has {self.num_shards}: "
                "exact resume needs the same --num_ps as the checkpointing job"
            )
        self._map(
            lambda c, i: c.call("PSOptRestore", self._stamp_epoch({"leaves": shards[i]}, i))
        )

    def stats(self) -> List[Optional[dict]]:
        """Each shard's `PSShardServicer.stats()`; None for a shard that
        does not answer (a dead one)."""
        def one(c, i):
            try:
                return c.call("PSStats", {})
            except PolicyRpcError:
                return None

        return self._map(one)

    def _assemble(self, slices) -> np.ndarray:
        """One flat vector from the slices, in their wire dtype (a bf16
        slice stays bf16)."""
        if isinstance(slices[0], codec.BF16Bits):
            out = np.empty(self.n_params, dtype=np.uint16)
            for (s, e), sl in zip(self.bounds, slices):
                out[s:e] = sl.bits
            return codec.BF16Bits(out)
        out = np.empty(self.n_params, dtype=np.float32)
        for (s, e), sl in zip(self.bounds, slices):
            out[s:e] = sl
        return out

    def close(self):
        # in-flight calls finish before the connections close
        if self._async_pool is not None:
            self._async_pool.shutdown(wait=True)
        self._pool.shutdown(wait=True)
        for c in self._retired + self._clients:
            c.close()
        self._retired = []

"""Deterministic fault injection (chaos) for the RPC plane.

The reference's `elasticdl_tpu/rpc/chaos.py`, without grpc. The
recovery machinery (RetryPolicy, report_key dedup, task requeue, worker
relaunch, shard recovery) is only proven when something can produce
the failures it exists for; this module injects them, deterministically,
at the transport layer, so production code paths run unchanged under
fault.

A `FaultPlan` is a seeded list of fault entries:

- ``latency``: sleep `latency_ms` before the call goes out;
- ``error``: raise UNAVAILABLE or DEADLINE_EXCEEDED *instead of* running
  the call (client side: before the request is sent, so the server
  never sees it);
- ``drop``: run the call to completion (the server APPLIES it), then
  discard the response and raise UNAVAILABLE: the failure shape that
  report_key dedup exists for;
- ``crash``: `os._exit(CHAOS_CRASH_EXIT_CODE)` on the Nth matching call,
  before or after the call runs; `once_file` (created O_CREAT|O_EXCL)
  makes the crash one-shot across processes, so a relaunched
  replacement does not crash again.

Entries select traffic by method name, side (client, server or both),
process role and target id, and, with ``armed_file``, by a
cross-process arming window: the entry fires only while that latch file
exists, and while it does not the entry's counters do not advance.
`EDL_CHAOS_SPEC` (inline JSON or ``@/path/to/file.json``) is inherited
by every subprocess the cluster spawns, and each is tagged with
`EDL_CHAOS_ROLE` (worker/ps/kv/master) and `EDL_CHAOS_TARGET_ID` by its
spawner (`chaos_env_for`: `cluster/pod_backend.py`,
`master/shard_host.py`). `RpcClient` and `RpcServer` read the
environment when they are built, so chaos reaches every plane with no
change at the call sites.

Firing is deterministic: a probabilistic entry hashes (seed, entry
index, method, match count) with sha256, as the reference does, so one
spec and one call sequence fire the same faults in both packages.

**Deviation by design.** The port has no gRPC, so it has no interceptor
classes. Every tier takes the two halves that the reference's non-gRPC
tiers take: `transport_faults_before` ahead of the call and
`transport_faults_after` once it has completed, on the client
(`rpc/transport.py`'s tcp, uds, shm and inproc transports) and around
the handler on the server (`ServerDispatcher`).

Spec shape::

    {"seed": 7, "faults": [
      {"kind": "latency", "methods": ["PSPull"], "roles": ["worker"],
       "side": "client", "prob": 0.5, "latency_ms": 20},
      {"kind": "error", "code": "UNAVAILABLE", "methods": ["PSPushGrad"],
       "side": "client", "every": 5, "max_fires": 3},
      {"kind": "drop", "methods": ["PSPushDelta"], "side": "client",
       "nth": 2},
      {"kind": "crash", "methods": ["GetTask"], "roles": ["worker"],
       "side": "client", "nth": 2, "when": "after",
       "once_file": "/tmp/job/crash.once"}
    ]}
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from elasticdl_tpu_torch.common.constants import (
    ENV_CHAOS_ROLE,
    ENV_CHAOS_SPEC,
    ENV_CHAOS_TARGET_ID,
)
from elasticdl_tpu_torch.common.log_util import get_logger
from elasticdl_tpu_torch.obs import flight as obs_flight
from elasticdl_tpu_torch.obs import metrics as obs_metrics
from elasticdl_tpu_torch.rpc.policy import PolicyRpcError, StatusCode

logger = get_logger(__name__)

#: exit code of `crash` faults: distinct from clean exits (0), crashes
#: (1), EXIT_CODE_JOB_FAILED (2) and EXIT_CODE_MASTER_UNREACHABLE (3), so
#: logs attribute the death to chaos, and relaunch-eligible in the
#: WorkerManager (any exit but 0 and 2 is).
CHAOS_CRASH_EXIT_CODE = 117

_CODES = {
    "UNAVAILABLE": StatusCode.UNAVAILABLE,
    "DEADLINE_EXCEEDED": StatusCode.DEADLINE_EXCEEDED,
}


class InjectedRpcError(PolicyRpcError):
    """An injected failure (its details carry the 'chaos:' tag)."""


@dataclass
class Fault:
    kind: str  # latency | error | drop | crash
    methods: Tuple[str, ...] = ()  # empty = every method
    roles: Tuple[str, ...] = ()  # empty = every role
    targets: Tuple[str, ...] = ()  # empty = every target id
    side: str = "client"  # client | server | both
    prob: float = 1.0
    every: int = 0  # fire on every Nth matching call
    nth: int = 0  # fire exactly on the Nth matching call
    max_fires: int = 0  # 0 = unlimited
    latency_ms: float = 0.0
    code: str = "UNAVAILABLE"
    when: str = "before"  # crash: before | after the call runs
    once_file: str = ""  # cross-process one-shot latch
    # cross-process arming window: the entry fires only while this file
    # exists; while it does not, the entry is scoped out entirely (its
    # match counter does not advance), so nth and every count armed
    # traffic only
    armed_file: str = ""
    # runtime state (not part of the spec)
    _count: int = field(default=0, repr=False)
    _fires: int = field(default=0, repr=False)

    @classmethod
    def from_dict(cls, d: dict) -> "Fault":
        kind = d.get("kind")
        if kind not in ("latency", "error", "drop", "crash"):
            raise ValueError(f"unknown fault kind {kind!r}")
        if kind == "error" and d.get("code", "UNAVAILABLE") not in _CODES:
            raise ValueError(f"uninjectable status code {d['code']!r}")
        return cls(
            kind=kind,
            methods=tuple(d.get("methods") or ()),
            roles=tuple(d.get("roles") or ()),
            targets=tuple(str(t) for t in (d.get("targets") or ())),
            side=d.get("side", "client"),
            prob=float(d.get("prob", 1.0)),
            every=int(d.get("every", 0)),
            nth=int(d.get("nth", 0)),
            max_fires=int(d.get("max_fires", 0)),
            latency_ms=float(d.get("latency_ms", 0.0)),
            code=d.get("code", "UNAVAILABLE"),
            when=d.get("when", "before"),
            once_file=d.get("once_file", ""),
            armed_file=d.get("armed_file", ""),
        )


class FaultPlan:
    """A parsed chaos spec bound to this process's role and target."""

    def __init__(
        self,
        faults: Sequence[Fault],
        seed: int = 0,
        role: str = "",
        target_id: str = "",
    ):
        self.faults = list(faults)
        self.seed = seed
        self.role = role
        self.target_id = target_id
        self._lock = threading.Lock()

    @classmethod
    def from_spec(cls, spec: dict, role: str = "", target_id: str = "") -> "FaultPlan":
        return cls(
            faults=[Fault.from_dict(f) for f in spec.get("faults", [])],
            seed=int(spec.get("seed", 0)),
            role=role,
            target_id=target_id,
        )

    @classmethod
    def from_env(cls, env=None) -> Optional["FaultPlan"]:
        """The environment's plan, or None when chaos is off."""
        env = os.environ if env is None else env
        raw = env.get(ENV_CHAOS_SPEC, "").strip()
        if not raw:
            return None
        try:
            if raw.startswith("@"):
                with open(raw[1:]) as f:
                    raw = f.read()
            spec = json.loads(raw)
            return cls.from_spec(
                spec,
                role=env.get(ENV_CHAOS_ROLE, ""),
                target_id=env.get(ENV_CHAOS_TARGET_ID, ""),
            )
        except Exception:
            # a malformed spec must never take down a training process:
            # chaos off beats a chaos-made outage
            logger.exception("ignoring malformed %s", ENV_CHAOS_SPEC)
            return None

    def _det_unit(self, fault_index: int, method: str, count: int) -> float:
        h = hashlib.sha256(f"{self.seed}:{fault_index}:{method}:{count}".encode()).digest()
        return int.from_bytes(h[:8], "big") / 2**64  # [0, 1)

    def actions_for(self, method: str, side: str) -> List[Fault]:
        """The faults that fire on this call (advances the matching
        entries' counters)."""
        fired: List[Fault] = []
        with self._lock:
            for idx, f in enumerate(self.faults):
                if f.side != "both" and f.side != side:
                    continue
                if f.methods and method not in f.methods:
                    continue
                if f.roles and self.role not in f.roles:
                    continue
                if f.targets and self.target_id not in f.targets:
                    continue
                if f.armed_file and not os.path.exists(f.armed_file):
                    continue
                f._count += 1
                if f.max_fires and f._fires >= f.max_fires:
                    continue
                if f.nth:
                    fire = f._count == f.nth
                elif f.every:
                    fire = f._count % f.every == 0
                else:
                    fire = f.prob >= 1.0 or self._det_unit(idx, method, f._count) < f.prob
                if fire and f.once_file:
                    fire = _claim_once(f.once_file)
                if fire:
                    f._fires += 1
                    fired.append(f)
        # every injection path (both halves, on every tier and side)
        # funnels through here, so this is the one place the flight
        # recorder and the metrics see chaos: outside the plan lock
        for f in fired:
            obs_flight.record(
                "chaos_fault",
                fault=f.kind,
                method=method,
                side=side,
                role=self.role,
                target=self.target_id,
            )
            obs_metrics.get_registry().inc("edl_chaos_injected_total", kind=f.kind)
        return fired


def _claim_once(path: str) -> bool:
    """Cross-process one-shot latch: True for exactly one claimant."""
    try:
        os.close(os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
        return True
    except FileExistsError:
        return False
    except OSError:
        logger.exception("chaos once_file %s unusable; not firing", path)
        return False


def _crash(method: str, when: str):
    logger.error("chaos: crashing process (%s %s)", when, method)
    # os._exit skips every excepthook, so the flight recorder dumps
    # itself here, or the postmortem dies with the process
    obs_flight.record("chaos_crash", method=method, when=when)
    obs_flight.dump_on_crash(reason="chaos_crash")
    # no atexit, no finally, on purpose: a SIGKILLed process cleans nothing up
    os._exit(CHAOS_CRASH_EXIT_CODE)


def transport_faults_before(plan: Optional[FaultPlan], method: str, side: str) -> List[Fault]:
    """The half before the call: latency sleeps, a crash before exits,
    an error raises InjectedRpcError with its status code. Returns the
    deferred drop and crash-after faults; the caller MUST run the call to
    completion and then pass them to `transport_faults_after`: skipping
    that half silently weakens a drop into an error before the call (the
    easy failure shape)."""
    if plan is None:
        return []
    fired = plan.actions_for(method, side)
    after: List[Fault] = []
    for f in fired:
        if f.kind == "latency":
            logger.info("chaos: +%.0fms latency on %s", f.latency_ms, method)
            time.sleep(f.latency_ms / 1000.0)
        elif f.kind == "crash" and f.when == "before":
            _crash(method, "before")
        elif f.kind == "error":
            logger.info("chaos: injecting %s on %s", f.code, method)
            raise InjectedRpcError(_CODES[f.code], f"chaos: {method}")
        elif f.kind in ("drop", "crash"):
            after.append(f)
    return after


def transport_faults_after(after: List[Fault], method: str) -> None:
    """The half after the call: the call COMPLETED (its state applied);
    a crash after exits, a drop withholds the response as UNAVAILABLE."""
    for f in after:
        if f.kind == "crash":
            _crash(method, "after")
    if after:
        logger.info("chaos: dropping response of %s", method)
        raise InjectedRpcError(StatusCode.UNAVAILABLE, f"chaos drop: {method}")


def chaos_env_for(role: str, target_id: Optional[object] = None) -> Dict[str, str]:
    """The tags a spawner stamps on a child process, so the inherited
    EDL_CHAOS_SPEC applies with the right role and target scoping. They
    are inert when no spec is set."""
    env = {ENV_CHAOS_ROLE: role}
    if target_id is not None:
        env[ENV_CHAOS_TARGET_ID] = str(target_id)
    return env

"""Generation fencing for the shard recovery plane.

The reference's `elasticdl_tpu/rpc/fencing.py`, without grpc. Every PS
and KV shard servicer carries a `generation` (bumped on every relaunch
of its slot), and every shard request carries an `epoch`: the
generation the client believes it talks to. A mismatch is either a
zombie shard (the old process outlived the master's verdict, and a
client with a stale endpoint is about to write to state the job no
longer trusts) or a stale client (the shard was relaunched, and the
client pushes against a lineage it never absorbed).

Either way the answer is a hard rejection that is never re-sent: the
server maps `EpochFencedError` to FAILED_PRECONDITION
(`rpc/transport.ServerDispatcher`), which is not in
`policy.RETRYABLE_CODES`, so the write falls through to the caller's
outage handler, which re-resolves endpoints and generations from the
master and requeues the covered work. An endpoint whose circuit
breaker is open (`policy.CircuitBreaker`) counts as an outage too.

`epoch == UNFENCED` (-1), or no epoch at all, skips the check.
"""

from __future__ import annotations

from elasticdl_tpu_torch.rpc.policy import StatusCode

#: Request epoch meaning "don't check".
UNFENCED = -1


class EpochFencedError(Exception):
    """A request's fencing epoch does not match the shard's generation."""

    def __init__(self, kind: str, shard_id: int, generation: int, epoch: int):
        self.kind = kind
        self.shard_id = shard_id
        self.generation = generation
        self.epoch = epoch
        super().__init__(
            f"{kind} shard {shard_id} is at generation {generation}, "
            f"request carries epoch {epoch}"
        )


def check_epoch(req: dict, generation: int, kind: str, shard_id: int):
    """Raise EpochFencedError when the request names another
    generation. Requests without an epoch (or UNFENCED) pass."""
    epoch = req.get("epoch", UNFENCED)
    if epoch is None or epoch == UNFENCED:
        return
    if int(epoch) != int(generation):
        raise EpochFencedError(kind, shard_id, generation, int(epoch))


def _code(e):
    fn = getattr(e, "code", None)
    return fn() if callable(fn) else None


def is_fenced_error(e: Exception) -> bool:
    """Did this RPC bounce off the fence? True for the exception itself
    and for the client-side error a fenced handler produces: code
    FAILED_PRECONDITION with the exception's name in its details."""
    if isinstance(e, EpochFencedError):
        return True
    if _code(e) is not StatusCode.FAILED_PRECONDITION:
        return False
    details = getattr(e, "details", lambda: "")() or ""
    return "EpochFencedError" in details


def is_shard_outage(e: Exception) -> bool:
    """Does this failure mean "stop re-sending to this endpoint and
    re-resolve through the master"? Fenced (the generation moved on),
    UNAVAILABLE or DEADLINE_EXCEEDED past the retry budget, or an open
    circuit (`policy.CircuitOpenError`, whose code is UNAVAILABLE): all
    route to the recovery plane's re-resolution."""
    if is_fenced_error(e):
        return True
    return _code(e) in (StatusCode.UNAVAILABLE, StatusCode.DEADLINE_EXCEEDED)


def is_shard_outage_chain(exc) -> bool:
    """Walk the cause and context chain for a shard-outage signature:
    fan-out pools and sync threads re-raise RPC errors under their own
    types, so the RPC error may sit a few links deep."""
    hops = 0
    while exc is not None and hops < 8:
        if is_shard_outage(exc):
            return True
        exc = exc.__cause__ or exc.__context__
        hops += 1
    return False

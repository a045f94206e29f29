"""The adaptive sync plane's per-round wire-form policy.

The reference's `elasticdl_tpu/common/sync_policy.py`, kept as the
port's own copy. `decide()` maps (link weather, delta size, decision
history) to one of the wire forms the PS already decodes per push, so
mixed rounds are legal: every push carries its own form, and the
worker's shared float32 error-feedback residual carries whatever a
round's compression dropped into the next round.

The policy is a ladder over the projected float32 push time
``t = delta_bytes * 8 / (link_mbps * 1e6)``:

    ==============================  ======  ==========================
    projected f32 push time t       form    rationale
    ==============================  ======  ==========================
    t <= 0.25 s                     f32     link affords exactness
    0.25 s < t <= 1.0 s             bf16    2x cut, negligible loss
    1.0 s  < t <= 4.0 s             int8    4x cut, EF-corrected
    t > 4.0 s                       topk    max cut for storm weather
    (no estimate yet: cold start)   bf16    mild lossy default
    ==============================  ======  ==========================

Hysteresis: when the projection lands within 20% of the boundary to
an adjacent rung, the previous round's form is kept, so the ladder does
not flap on every sample; a jump of more than one rung moves at once.
The function is pure (no clock, no global, no I/O): replayable from a
worker's decision log.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

# rungs from most to least wire bytes: the names of the worker's
# decision log and its `wire_forms` byte split
WIRE_FORMS = ("f32", "bf16", "int8", "topk")

# projected f32 push time (seconds) at the boundaries between rungs
_BOUNDARIES = (0.25, 1.0, 4.0)

# the previous rung holds while the projection is within this factor of
# the boundary it would cross
_HYSTERESIS = 0.20

# the form before any link estimate exists
COLD_START_FORM = "bf16"


def _last_form(history: Optional[Sequence[Any]]) -> Optional[str]:
    """The previous round's form: the last entry, a form string or a
    decision-log dict with a "form" key; None for junk."""
    if not history:
        return None
    last = history[-1]
    form = last.get("form") if isinstance(last, dict) else last
    return form if form in WIRE_FORMS else None


def projected_push_seconds(link_mbps: float, delta_bytes: int) -> float:
    """Seconds a float32 push of `delta_bytes` takes at `link_mbps`."""
    if link_mbps <= 0:
        raise ValueError(f"link_mbps must be positive, got {link_mbps!r}")
    return delta_bytes * 8.0 / (link_mbps * 1e6)


def decide(
    link_mbps: Optional[float],
    delta_bytes: int,
    history: Optional[Sequence[Any]] = None,
) -> str:
    """This round's wire form (the table above); `history` (newest
    last) supplies the previous form for the hysteresis."""
    if link_mbps is None:
        return _last_form(history) or COLD_START_FORM
    t = projected_push_seconds(link_mbps, delta_bytes)
    rung = sum(1 for b in _BOUNDARIES if t > b)
    prev = _last_form(history)
    if prev is not None:
        prev_rung = WIRE_FORMS.index(prev)
        if abs(rung - prev_rung) == 1:
            boundary = _BOUNDARIES[min(rung, prev_rung)]
            if boundary * (1.0 - _HYSTERESIS) <= t <= boundary * (1.0 + _HYSTERESIS):
                return prev
    return WIRE_FORMS[rung]

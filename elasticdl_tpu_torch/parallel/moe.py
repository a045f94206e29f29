"""Mixture-of-Experts FFN, single device (the reference's
`parallel/moe.py`: `_route` and `moe_ffn_local`).

GShard/Switch-style top-1 routing with capacity-bounded dense dispatch:

  tokens --(dispatch product)--> [E, C, d] --expert FFNs--> [E, C, d]
  --(combine product)--> tokens

Tokens beyond an expert's capacity C = max(1, ceil(T * capacity_factor
/ E)) are dropped (they combine to zero); `_route` also returns the
Switch load-balancing auxiliary loss. Numerics follow the reference:
the router product runs in the activations' dtype and is cast to
float32; the softmax, gate, argmax and aux run in float32 (aux is cast
back to x's dtype); the one-hot and the cumsum that assign slots are
integer, since a bf16 cumsum loses exactness above 256 tokens; dispatch
and combine are dense [T, E, C] tensors in x's dtype. On ties
`torch.argmax`, like `jnp.argmax`, takes the first expert.

The four contractions are the reference's einsums `tec,td->ecd`,
`ecd,edf->ecf`, `ecf,efd->ecd` and `tec,ecd->td`, written as products
that keep the reference's batch dims: dispatch and combine as 2-D
`x @ w` (`aten.mm`), the expert FFNs batched over e (`aten.bmm`). So
under the transformer's "dots" remat policy (it saves `aten.mm`
outputs) a layer saves the router logits and the dispatch and combine
products and recomputes the expert FFNs, as
`dots_with_no_batch_dims_saveable` does in the reference.

The expert-parallel `moe_ffn` (an all-to-all over the expert axis of a
mesh) is not ported yet: it comes with the parallel planes.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


def _route(
    x: torch.Tensor, router_w: torch.Tensor, num_experts: int, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-1 capacity-bounded routing; x: [T, d], router_w: [d, E].
    -> (dispatch [T, E, C], combine [T, E, C], scalar Switch aux loss)."""
    logits = (x @ router_w).to(torch.float32)  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate = torch.amax(probs, dim=-1)  # [T] f32
    expert = torch.argmax(probs, dim=-1)  # [T], the first index on ties
    onehot = F.one_hot(expert, num_experts)  # [T, E] integer

    # Switch aux loss: E * sum_e (token fraction) * (mean router prob)
    frac = torch.mean(onehot.to(torch.float32), dim=0)
    mean_prob = torch.mean(probs, dim=0)
    aux = (num_experts * torch.sum(frac * mean_prob)).to(x.dtype)

    # position of each token within its expert's buffer, -1 if not routed;
    # the running count goes along the last dim of the [E, T] transpose
    # (torch's CUDA scan along the outer dim of a [T, E] tensor with few
    # columns runs nearly serially: 1.24 ms against 0.02 at T = 8192,
    # E = 8 on an NVIDIA H100 80GB HBM3 at 700 W,
    # scripts/torch_moe_route_costs.py), and comes back [T, E]-contiguous,
    # or dispatch and combine would inherit the transposed layout and
    # every product would copy them
    count = torch.cumsum(onehot.t().contiguous(), dim=1).t().contiguous()
    pos = count * onehot - 1  # [T, E]
    keep = (pos >= 0) & (pos < capacity)
    slot = torch.sum(torch.where(keep, pos, 0), dim=-1)  # [T]
    slot_onehot = F.one_hot(slot, capacity).to(x.dtype)  # [T, C]
    # keep (routed and under capacity) gates the whole row: a dropped
    # token dispatches nowhere and combines to zero
    dispatch = keep.to(x.dtype)[:, :, None] * slot_onehot[:, None, :]
    combine = dispatch * gate.to(x.dtype)[:, None, None]
    return dispatch, combine, aux


def moe_ffn_local(
    x: torch.Tensor,
    router_w: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    capacity_factor: float = 2.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every expert local: x [T, d], router_w [d, E], w1 [E, d, f],
    w2 [E, f, d]. -> ([T, d] output, scalar Switch aux loss)."""
    e, d, _f = w1.shape
    t = x.shape[0]
    capacity = max(1, math.ceil(t * capacity_factor / e))
    dispatch, combine, aux = _route(x, router_w, e, capacity)
    xe = (dispatch.reshape(t, e * capacity).t() @ x).reshape(e, capacity, d)  # tec,td->ecd
    h = F.gelu(torch.bmm(xe, w1), approximate="tanh")  # ecd,edf->ecf
    ye = torch.bmm(h, w2)  # ecf,efd->ecd
    out = combine.reshape(t, e * capacity) @ ye.reshape(e * capacity, d)  # tec,ecd->td
    return out, aux

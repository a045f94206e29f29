"""Host-side dense optimizer for the parameter server.

The PS keeps the model as a numpy tree and applies each averaged
gradient on the host. The reference runs that update as an optax
transformation on the CPU backend, by design: PS math needs determinism
and cheap serialization, not accelerator FLOPs. The port runs the same
math in torch on the CPU for the same reason.

The zoo's optax transformations, each written out in optax's order of
operations and float32 rounding:

- `ClipAdam`: `optax.chain(clip_by_global_norm(max_norm),
  adam(learning_rate, b1, b2, eps))`, Adam with eps_root 0 and bias
  correction from count + 1; state leaves `[count, *mu, *nu]`; with
  `max_norm=None` it is `optax.adam` alone (`adam(learning_rate)`), whose
  state has the same leaves;
- `Chain(*ops)`: `optax.chain` of
  - `ClipByGlobalNorm(max_norm)` (`where(norm < max_norm, g, g / norm *
    max_norm)`; no state),
  - `AddDecayedWeights(weight_decay)` (g + weight_decay * p; no state),
  - `Sgd(learning_rate, momentum)` (`optax.sgd`: trace = g + momentum *
    trace, update = -lr * trace, no Nesterov; state `[*trace]`, plus
    `count` after it when `learning_rate` is a schedule, which is read
    before it advances),
  - `WarmupCosineDecay` (`optax.warmup_cosine_decay_schedule`, a
    schedule for `Sgd`).

Each op's `state_leaves` come out in optax's order, so a snapshot lines
up with the reference's `state_snapshot()` leaf for leaf.

`update(grads, state, params)` works in place over preallocated state
and scratch, with no host sync, so the same code is the PS's host apply
and window mode's on-device optimizer over the worker's flat buffer (as
the reference runs `tx.update` over its flat vector).

A PS shard (`master/ps_shard.py`) runs `PSOptimizer.step` over its 1-D
slice as one leaf, as the reference's shard does: an elementwise
optimizer applies as over the whole vector, and `ClipByGlobalNorm` (or
`ClipAdam`'s clip) clips the slice by its own norm.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

from elasticdl_tpu_torch.common import codec


def _device_of(leaves: List[torch.Tensor]) -> torch.device:
    return leaves[0].device if leaves else torch.device("cpu")


def _clip_by_global_norm(grads: List[torch.Tensor], max_norm: float):
    """In place, as optax: g if norm < max_norm, else g / norm * max_norm.
    Dividing by 1 and multiplying by 1 are exact, so the unclipped
    branch is g bit for bit."""
    sq = torch.stack([torch.dot(g.reshape(-1), g.reshape(-1)) for g in grads]).sum()
    g_norm = torch.sqrt(sq)
    keep = g_norm < max_norm
    div = torch.where(keep, 1.0, g_norm)
    mul = torch.where(keep, 1.0, torch.full_like(g_norm, max_norm))
    for g in grads:
        g.div_(div).mul_(mul)


@dataclasses.dataclass(frozen=True)
class ClipAdam:
    max_norm: Optional[float] = 1.0
    learning_rate: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, leaves: List[torch.Tensor]) -> dict:
        """State on the leaves' device: optax's count, mu and nu, plus
        one scratch buffer per leaf that `update` reuses every step."""
        return {
            "count": torch.zeros((), dtype=torch.int32, device=_device_of(leaves)),
            "mu": [torch.zeros_like(p) for p in leaves],
            "nu": [torch.zeros_like(p) for p in leaves],
            "scratch": [torch.empty_like(p) for p in leaves],
        }

    @staticmethod
    def state_leaves(state: dict) -> List[torch.Tensor]:
        return [state["count"], *state["mu"], *state["nu"]]

    def update(self, grads: List[torch.Tensor], state: dict, params=None) -> List[torch.Tensor]:
        """One step in place, on whatever device the tensors live on,
        with no host sync: `state` advances, and each of `grads` (owned
        by the caller, float32) is overwritten with its update, which is
        returned. The same operations, in the same order, as optax."""
        if self.max_norm is not None:
            _clip_by_global_norm(grads, self.max_norm)
        state["count"].add_(1)
        c = state["count"].to(torch.float32)
        bc1 = 1 - torch.pow(self.b1, c)
        bc2 = 1 - torch.pow(self.b2, c)
        for g, m, v, s in zip(grads, state["mu"], state["nu"], state["scratch"]):
            # mu = (1 - b1) * g + b1 * mu; nu = (1 - b2) * g^2 + b2 * nu
            m.mul_(self.b1).add_(torch.mul(g, 1 - self.b1, out=s))
            torch.mul(g, g, out=s)
            v.mul_(self.b2).add_(s.mul_(1 - self.b2))
            # update = (mu / bc1) / (sqrt(nu / bc2) + eps) * -lr
            torch.div(v, bc2, out=s).sqrt_().add_(self.eps)
            torch.div(m, bc1, out=g).div_(s).mul_(-self.learning_rate)
        return grads


def adam(learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> ClipAdam:
    """`optax.adam`: ClipAdam without the clip."""
    return ClipAdam(max_norm=None, learning_rate=learning_rate, b1=b1, b2=b2, eps=eps)


@dataclasses.dataclass(frozen=True)
class ClipByGlobalNorm:
    max_norm: float = 1.0

    def init(self, leaves) -> dict:
        return {}

    @staticmethod
    def state_leaves(state: dict) -> List[torch.Tensor]:
        return []

    def update(self, grads, state, params=None):
        _clip_by_global_norm(grads, self.max_norm)
        return grads


@dataclasses.dataclass(frozen=True)
class AddDecayedWeights:
    weight_decay: float = 1e-4

    def init(self, leaves) -> dict:
        return {"scratch": [torch.empty_like(p) for p in leaves]}

    @staticmethod
    def state_leaves(state: dict) -> List[torch.Tensor]:
        return []

    def update(self, grads, state, params=None):
        """g + weight_decay * p, the product rounded on its own."""
        if params is None:
            raise ValueError("AddDecayedWeights needs the parameters")
        for g, p, s in zip(grads, params, state["scratch"]):
            g.add_(torch.mul(p, self.weight_decay, out=s))
        return grads


@dataclasses.dataclass(frozen=True)
class WarmupCosineDecay:
    """`optax.warmup_cosine_decay_schedule`: linear from `init_value` to
    `peak_value` over `warmup_steps`, then a cosine from the peak to
    `end_value` over `decay_steps - warmup_steps`; float32 on the count's
    device, each step in optax's order."""

    init_value: float
    peak_value: float
    warmup_steps: int
    decay_steps: int
    end_value: float = 0.0
    exponent: float = 1.0

    def __call__(self, count: torch.Tensor) -> torch.Tensor:
        f32 = torch.float32

        def const(x):
            # divisions by a tensor: on the card, dividing by a Python
            # scalar multiplies by its reciprocal
            return torch.full((), float(x), dtype=f32, device=count.device)

        # linear_schedule: clip(count, 0, T); frac = 1 - count / T
        frac = 1 - torch.clamp(count, 0, self.warmup_steps).to(f32) / const(self.warmup_steps)
        linear = frac * (self.init_value - self.peak_value) + self.peak_value
        # cosine_decay_schedule at count - warmup, alpha = end / peak
        steps = const(self.decay_steps - self.warmup_steps)
        alpha = 0.0 if self.peak_value == 0.0 else self.end_value / self.peak_value
        c = torch.minimum((count - self.warmup_steps).to(f32), steps)
        cos = 0.5 * (1 + torch.cos(math.pi * c / steps))
        decayed = (1 - alpha) * cos**self.exponent + alpha
        return torch.where(count < self.warmup_steps, linear, self.peak_value * decayed)


@dataclasses.dataclass(frozen=True)
class Sgd:
    learning_rate: Union[float, WarmupCosineDecay] = 0.1
    momentum: float = 0.9

    def init(self, leaves) -> dict:
        state = {"trace": [torch.zeros_like(p) for p in leaves]}
        if callable(self.learning_rate):
            state["count"] = torch.zeros((), dtype=torch.int32, device=_device_of(leaves))
        return state

    @staticmethod
    def state_leaves(state: dict) -> List[torch.Tensor]:
        return [*state["trace"], *([state["count"]] if "count" in state else [])]

    def update(self, grads, state, params=None):
        """trace = g + momentum * trace; update = -lr * trace, with lr
        the schedule's value at the count before it advances."""
        if callable(self.learning_rate):
            step = -self.learning_rate(state["count"])
            state["count"].add_(1)
        else:
            step = -self.learning_rate
        for g, t in zip(grads, state["trace"]):
            t.mul_(self.momentum).add_(g)
            torch.mul(t, step, out=g)
        return grads


@dataclasses.dataclass(frozen=True)
class Chain:
    """`optax.chain(*ops)`: each op's update feeds the next; the state
    leaves are each op's in turn."""

    ops: Tuple[Any, ...]

    def __init__(self, *ops):
        object.__setattr__(self, "ops", tuple(ops))

    def init(self, leaves) -> list:
        return [op.init(leaves) for op in self.ops]

    def state_leaves(self, state: list) -> List[torch.Tensor]:
        return [t for op, s in zip(self.ops, state) for t in op.state_leaves(s)]

    def update(self, grads, state, params=None):
        for op, s in zip(self.ops, state):
            grads = op.update(grads, s, params)
        return grads


class PSOptimizer:
    """Owns the optimizer state for the dense parameter tree: float32
    tensors on the host, allocated once, updated in place."""

    def __init__(self, optimizer):
        self._tx = optimizer
        self._state: Optional[dict] = None
        self._grads: List[torch.Tensor] = []  # per-leaf gradient scratch

    @staticmethod
    def _zeros(tree) -> List[torch.Tensor]:
        return [
            torch.zeros(np.shape(leaf), dtype=torch.float32)
            for leaf in codec.tree_leaves(tree)
        ]

    def initialize(self, params: Any):
        leaves = self._zeros(params)
        self._state = self._tx.init(leaves)
        self._grads = leaves

    @property
    def initialized(self) -> bool:
        return self._state is not None

    def warmup(self, params: Any):
        """Initialize state ahead of the hot path; torch runs eagerly,
        so there is nothing to compile."""
        if self._state is None:
            self.initialize(params)

    def step(self, params: Any, grads: Any) -> Any:
        """Apply averaged gradients; returns the new params tree (fresh
        numpy arrays). Neither `params` nor `grads` is modified: the
        gradients are copied into scratch, and the transformation runs in
        place over it and the preallocated state."""
        if self._state is None:
            self.initialize(params)
        p_leaves, treedef = codec.tree_flatten(params)
        g_leaves, g_def = codec.tree_flatten(grads)
        if g_def != treedef:
            raise ValueError("gradient tree does not match the params tree")
        for buf, g in zip(self._grads, g_leaves):
            buf.copy_(_host_tensor(g))
        p_host = [_host_tensor(p) for p in p_leaves]
        updates = self._tx.update(self._grads, self._state, p_host)
        new = [torch.add(p, u).numpy() for p, u in zip(p_host, updates)]
        return codec.tree_unflatten(treedef, new)

    def state_snapshot(self) -> Optional[list]:
        """The state's leaves in optax's order, as numpy (None if never
        run): copies, which later steps leave as they are."""
        if self._state is None:
            return None
        return [t.cpu().numpy().copy() for t in self._tx.state_leaves(self._state)]

    def restore_state(self, params: Any, leaves: list):
        """Adopt a state snapshot taken by `state_snapshot` (or the
        reference's, leaf for leaf)."""
        self.initialize(params)
        dst = self._tx.state_leaves(self._state)
        if len(leaves) != len(dst):
            raise ValueError(
                f"optimizer state mismatch: snapshot has {len(leaves)} "
                f"leaves, the optimizer needs {len(dst)}"
            )
        for d, src in zip(dst, leaves):
            d.copy_(torch.from_numpy(np.array(src, dtype=np.float32 if d.is_floating_point() else np.int32)))


def _host_tensor(a) -> torch.Tensor:
    """A float32 CPU tensor over `a` (no copy when `a` already is
    float32). Read-only arrays (decoded frames) are only ever read
    here, so torch's warning about them is moot."""
    a = np.asarray(a, dtype=np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(a)

"""Host-side dense optimizer for the parameter server.

The PS keeps the model as a numpy tree and applies each averaged
gradient on the host. The reference runs that update as an optax
transformation on the CPU backend, by design: PS math needs determinism
and cheap serialization, not accelerator FLOPs. The port runs the same
math in torch on the CPU for the same reason.

`ClipAdam` is `optax.chain(clip_by_global_norm(max_norm),
adam(learning_rate, b1, b2, eps))` written out: the global-norm clip as
optax does it (`where(norm < max_norm, g, g / norm * max_norm)`), then
Adam with eps_root 0 and bias correction from count + 1 in float32.
Its state leaves come out in optax's order, `[count, *mu, *nu]`, so a
snapshot lines up with the reference's `state_snapshot()` leaf for leaf.

`ClipAdam.update` works in place over preallocated state and scratch,
with no host sync, so the same code is the PS's host apply and window
mode's on-device optimizer over the worker's flat buffer (as the
reference runs `tx.update` over its flat vector).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, List, Optional

import numpy as np
import torch

from elasticdl_tpu_torch.common import codec


@dataclasses.dataclass(frozen=True)
class ClipAdam:
    max_norm: float = 1.0
    learning_rate: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, leaves: List[torch.Tensor]) -> dict:
        """State on the leaves' device: optax's count, mu and nu, plus
        one scratch buffer per leaf that `update` reuses every step."""
        dev = leaves[0].device if leaves else torch.device("cpu")
        return {
            "count": torch.zeros((), dtype=torch.int32, device=dev),
            "mu": [torch.zeros_like(p) for p in leaves],
            "nu": [torch.zeros_like(p) for p in leaves],
            "scratch": [torch.empty_like(p) for p in leaves],
        }

    def update(self, grads: List[torch.Tensor], state: dict) -> List[torch.Tensor]:
        """One step in place, on whatever device the tensors live on,
        with no host sync: `state` advances, and each of `grads` (owned
        by the caller, float32) is overwritten with its update, which is
        returned. The same operations, in the same order, as optax."""
        # global-norm clip: g if norm < max_norm, else g / norm * max_norm.
        # Dividing by 1 and multiplying by 1 are exact, so the unclipped
        # branch is g bit for bit.
        sq = torch.stack([torch.dot(g.reshape(-1), g.reshape(-1)) for g in grads]).sum()
        g_norm = torch.sqrt(sq)
        keep = g_norm < self.max_norm
        div = torch.where(keep, 1.0, g_norm)
        mul = torch.where(keep, 1.0, torch.full_like(g_norm, self.max_norm))
        state["count"].add_(1)
        c = state["count"].to(torch.float32)
        bc1 = 1 - torch.pow(self.b1, c)
        bc2 = 1 - torch.pow(self.b2, c)
        for g, m, v, s in zip(grads, state["mu"], state["nu"], state["scratch"]):
            g.div_(div).mul_(mul)
            # mu = (1 - b1) * g + b1 * mu; nu = (1 - b2) * g^2 + b2 * nu
            m.mul_(self.b1).add_(torch.mul(g, 1 - self.b1, out=s))
            torch.mul(g, g, out=s)
            v.mul_(self.b2).add_(s.mul_(1 - self.b2))
            # update = (mu / bc1) / (sqrt(nu / bc2) + eps) * -lr
            torch.div(v, bc2, out=s).sqrt_().add_(self.eps)
            torch.div(m, bc1, out=g).div_(s).mul_(-self.learning_rate)
        return grads


class PSOptimizer:
    """Owns the optimizer state for the dense parameter tree: float32
    tensors on the host, allocated once, updated in place."""

    def __init__(self, optimizer: ClipAdam):
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
        gradients are copied into scratch, and clip + Adam run in place
        over it and the preallocated state."""
        if self._state is None:
            self.initialize(params)
        p_leaves, treedef = codec.tree_flatten(params)
        g_leaves, g_def = codec.tree_flatten(grads)
        if g_def != treedef:
            raise ValueError("gradient tree does not match the params tree")
        for buf, g in zip(self._grads, g_leaves):
            buf.copy_(_host_tensor(g))
        updates = self._tx.update(self._grads, self._state)
        new = [
            torch.add(_host_tensor(p), u).numpy() for p, u in zip(p_leaves, updates)
        ]
        return codec.tree_unflatten(treedef, new)

    def state_snapshot(self) -> Optional[list]:
        """Flat numpy leaves `[count, *mu, *nu]` (None if never run):
        copies, which later steps leave as they are."""
        if self._state is None:
            return None
        s = self._state
        return [t.cpu().numpy().copy() for t in [s["count"], *s["mu"], *s["nu"]]]

    def restore_state(self, params: Any, leaves: list):
        """Adopt a state snapshot taken by `state_snapshot`."""
        n = len(codec.tree_leaves(params))
        if len(leaves) != 1 + 2 * n:
            raise ValueError(
                f"optimizer state mismatch: snapshot has {len(leaves)} "
                f"leaves, the optimizer needs {1 + 2 * n}"
            )
        self.initialize(params)
        s = self._state
        s["count"].fill_(int(np.asarray(leaves[0])))
        for dst, src in zip(s["mu"] + s["nu"], leaves[1:]):
            dst.copy_(_host_tensor(src))


def _host_tensor(a) -> torch.Tensor:
    """A float32 CPU tensor over `a` (no copy when `a` already is
    float32). Read-only arrays (decoded frames) are only ever read
    here, so torch's warning about them is moot."""
    a = np.asarray(a, dtype=np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(a)

"""Host-side dense optimizer for the parameter server.

The PS keeps the model as a numpy tree and applies each averaged
gradient on the host. The reference runs that update as an optax
transformation on the CPU backend, by design: PS math needs determinism
and cheap serialization, not accelerator FLOPs. The port runs the same
math in torch on the CPU for the same reason.

`ClipAdam` is `optax.chain(clip_by_global_norm(max_norm),
adam(learning_rate, b1, b2, eps))` written out: the global-norm clip as
optax does it (`where(norm < max_norm, g, g / norm * max_norm)`), then
Adam with eps_root 0 and bias correction from count + 1. Its state
leaves come out in optax's order, `[count, *mu, *nu]`, so a snapshot
lines up with the reference's `state_snapshot()` leaf for leaf.
"""

from __future__ import annotations

import dataclasses
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
        return {
            "count": torch.zeros((), dtype=torch.int32),
            "mu": [torch.zeros_like(p) for p in leaves],
            "nu": [torch.zeros_like(p) for p in leaves],
        }

    def update(self, grads: List[torch.Tensor], state: dict):
        """-> (updates, new_state); all tensors float32 on the CPU."""
        sq = torch.zeros((), dtype=torch.float32)
        for g in grads:
            sq = sq + torch.sum(g * g)
        g_norm = torch.sqrt(sq)
        if not bool(g_norm < self.max_norm):
            grads = [(g / g_norm) * self.max_norm for g in grads]
        mu = [(1 - self.b1) * g + self.b1 * m for g, m in zip(grads, state["mu"])]
        nu = [
            (1 - self.b2) * (g * g) + self.b2 * v
            for g, v in zip(grads, state["nu"])
        ]
        count = state["count"] + 1
        c = count.to(torch.float32)
        bc1 = 1 - torch.tensor(self.b1, dtype=torch.float32) ** c
        bc2 = 1 - torch.tensor(self.b2, dtype=torch.float32) ** c
        updates = [
            (m / bc1) / (torch.sqrt(v / bc2) + self.eps) * (-self.learning_rate)
            for m, v in zip(mu, nu)
        ]
        return updates, {"count": count, "mu": mu, "nu": nu}


class PSOptimizer:
    """Owns the optimizer state for the dense parameter tree."""

    def __init__(self, optimizer: ClipAdam):
        self._tx = optimizer
        self._state: Optional[dict] = None

    @staticmethod
    def _leaves(tree) -> List[torch.Tensor]:
        return [
            torch.from_numpy(np.array(leaf, dtype=np.float32))
            for leaf in codec.tree_leaves(tree)
        ]

    def initialize(self, params: Any):
        self._state = self._tx.init(self._leaves(params))

    @property
    def initialized(self) -> bool:
        return self._state is not None

    def warmup(self, params: Any):
        """Initialize state ahead of the hot path; torch runs eagerly,
        so there is nothing to compile."""
        if self._state is None:
            self.initialize(params)

    def step(self, params: Any, grads: Any) -> Any:
        """Apply averaged gradients; returns the new params tree (numpy)."""
        if self._state is None:
            self.initialize(params)
        p_leaves, treedef = codec.tree_flatten(params)
        g_leaves, g_def = codec.tree_flatten(grads)
        if g_def != treedef:
            raise ValueError("gradient tree does not match the params tree")
        updates, self._state = self._tx.update(self._leaves(grads), self._state)
        new = [
            (torch.from_numpy(np.asarray(p, dtype=np.float32)) + u).numpy()
            for p, u in zip(p_leaves, updates)
        ]
        return codec.tree_unflatten(treedef, new)

    def state_snapshot(self) -> Optional[list]:
        """Flat numpy leaves `[count, *mu, *nu]` (None if never run)."""
        if self._state is None:
            return None
        s = self._state
        return [s["count"].numpy()] + [t.numpy() for t in s["mu"] + s["nu"]]

    def restore_state(self, params: Any, leaves: list):
        """Adopt a state snapshot taken by `state_snapshot`."""
        n = len(codec.tree_leaves(params))
        if len(leaves) != 1 + 2 * n:
            raise ValueError(
                f"optimizer state mismatch: snapshot has {len(leaves)} "
                f"leaves, the optimizer needs {1 + 2 * n}"
            )
        t = [torch.from_numpy(np.array(x)) for x in leaves]
        self._state = {
            "count": t[0].to(torch.int32),
            "mu": [x.to(torch.float32) for x in t[1 : 1 + n]],
            "nu": [x.to(torch.float32) for x in t[1 + n :]],
        }

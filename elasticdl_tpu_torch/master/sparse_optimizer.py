"""Sparse optimizer for the PS-resident embedding tables.

The reference's `elasticdl_tpu/master/sparse_optimizer.py`, the same
numpy operations in the same order, so rows and slots equal its bit for
bit: embedding rows and their optimizer slots live in the store (slots
under `layer/slot/<name>`); each `apply_gradients` dedups the gradient
ids (summing repeats), fetches rows and slots (unknown slot rows start
at zero), runs the update on the gathered [n, dim] matrices and writes
rows and slots back. Kinds: sgd, momentum (with nesterov), adam and
amsgrad. Adam's bias correction counts `apply_gradients` calls with one
`_step` shared by every layer: one a step per-step, one a window flush
in window mode (not the PS's version).

The math runs in numpy on the master's host: the batch is one step's
unique ids, and determinism matters more than FLOPs.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from elasticdl_tpu_torch.common.codec import IndexedRows
from elasticdl_tpu_torch.master.embedding_store import EmbeddingStore

_SLOT_SETS = {
    "sgd": [],
    "momentum": ["momentum"],
    "adam": ["m", "v"],
    "amsgrad": ["m", "v", "v_hat"],
}


def slot_layer_name(layer: str, slot: str) -> str:
    """The layer name a slot's rows live under."""
    return f"{layer}/slot/{slot}"


def dedup_indexed_rows(g: IndexedRows) -> IndexedRows:
    """Sum the rows of repeated ids (an `np.add.at` scatter)."""
    uniq, inverse = np.unique(g.indices, return_inverse=True)
    summed = np.zeros((len(uniq),) + g.values.shape[1:], dtype=np.float32)
    np.add.at(summed, inverse, np.asarray(g.values, dtype=np.float32))
    return IndexedRows(values=summed, indices=uniq)


class SparseOptimizer:
    def __init__(
        self,
        store: EmbeddingStore,
        kind: str = "sgd",
        learning_rate: float = 0.1,
        momentum: float = 0.9,
        nesterov: bool = False,
        beta1: float = 0.9,
        beta2: float = 0.999,
        eps: float = 1e-8,
    ):
        if kind not in _SLOT_SETS:
            raise ValueError(f"unsupported sparse optimizer: {kind}")
        self._store = store
        self._kind = kind
        self._lr = learning_rate
        self._momentum = momentum
        self._nesterov = nesterov
        self._b1, self._b2, self._eps = beta1, beta2, eps
        self._step = 0  # adam's bias-correction counter, shared by every layer

    @property
    def slot_names(self) -> List[str]:
        return list(_SLOT_SETS[self._kind])

    def _fetch_slots(
        self, layer: str, ids: np.ndarray, dim: int
    ) -> Dict[str, np.ndarray]:
        """The slot rows of `ids`; unknown ones start at zero."""
        slots = {}
        for slot in self.slot_names:
            values, unknown = self._store.lookup(slot_layer_name(layer, slot), ids)
            if values.shape[1] == 0:
                values = np.zeros((len(ids), dim), dtype=np.float32)
            elif len(unknown):
                values[unknown] = 0.0
            slots[slot] = values
        return slots

    def apply_gradients(self, grads: Dict[str, IndexedRows]):
        """One step of sparse updates for each embedding layer."""
        self._step += 1
        for layer, g in grads.items():
            g = dedup_indexed_rows(g)
            ids = g.indices
            rows, unknown = self._store.lookup(layer, ids)
            if rows.shape[1] == 0 or len(unknown):
                raise ValueError(
                    f"gradient for uninitialized embedding rows of layer "
                    f"{layer!r}: {unknown[:8]!r}"
                )
            dim = rows.shape[1]
            slots = self._fetch_slots(layer, ids, dim)
            new_rows, new_slots = self._update(g.values, rows, slots)
            self._store.update(layer, ids, new_rows)
            for slot, vals in new_slots.items():
                self._store.update(slot_layer_name(layer, slot), ids, vals)

    def _update(
        self, grad: np.ndarray, rows: np.ndarray, slots: Dict[str, np.ndarray]
    ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        grad = np.asarray(grad, dtype=np.float32)
        lr = self._lr
        if self._kind == "sgd":
            return rows - lr * grad, {}
        if self._kind == "momentum":
            buf = self._momentum * slots["momentum"] + grad
            if self._nesterov:
                step = grad + self._momentum * buf
            else:
                step = buf
            return rows - lr * step, {"momentum": buf}
        # adam / amsgrad
        m = self._b1 * slots["m"] + (1 - self._b1) * grad
        v = self._b2 * slots["v"] + (1 - self._b2) * grad * grad
        m_hat = m / (1 - self._b1**self._step)
        if self._kind == "amsgrad":
            v_hat_slot = np.maximum(slots["v_hat"], v)
            v_hat = v_hat_slot / (1 - self._b2**self._step)
            new_slots = {"m": m, "v": v, "v_hat": v_hat_slot}
        else:
            v_hat = v / (1 - self._b2**self._step)
            new_slots = {"m": m, "v": v}
        return rows - lr * m_hat / (np.sqrt(v_hat) + self._eps), new_slots

"""Weight conversion from the reference package.

Both packages keep the same trees (nested dicts of arrays in the same
layout), so a reference tree, handed over as numpy arrays, converts by
copy. A reference `variables` tree (flax's `{"params": ..., "batch_stats":
...}`) splits into the port's params tree and aux (the non-trainable
collections, each leaf a module buffer at the leaf's path without its
collection), which `load_variables` copies into a model. The sparse
plane's tables convert the same way: an embedding store's snapshot,
`{layer: {id: row}}` (the optimizer's slot tables included), becomes a
tree of float32 copies that any store of the port `restore`s
(`embeddings_from_jax`); deepfm's dense parameters are an ordinary
`params` tree.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from elasticdl_tpu_torch.common import codec


def params_from_jax(tree) -> Dict:
    """A reference parameter tree of numpy arrays -> the same tree of
    float32 CPU tensors (copies)."""
    return codec.tree_map(
        lambda a: torch.from_numpy(np.array(a, dtype=np.float32)), tree
    )


def variables_from_jax(variables) -> Tuple[Dict, Dict]:
    """A reference `variables` tree -> (params, aux) as float32 numpy
    trees (copies): `params`, and every other collection."""
    as_np = lambda a: np.array(a, dtype=np.float32)  # noqa: E731
    params = codec.tree_map(as_np, dict(variables["params"]))
    aux = {k: codec.tree_map(as_np, dict(v)) for k, v in variables.items() if k != "params"}
    return params, aux


def embeddings_from_jax(snapshot) -> Dict[str, Dict[int, np.ndarray]]:
    """A reference embedding snapshot ({layer: {id: row}}, numpy) -> the
    same tables as float32 copies with int ids, for `store.restore`."""
    return {
        layer: {int(i): np.array(row, dtype=np.float32) for i, row in rows.items()}
        for layer, rows in snapshot.items()
    }


def load_variables(model: torch.nn.Module, params, aux=None):
    """Copy a params tree and an aux tree (numpy or tensors) into the
    model's parameters and buffers, in place."""
    with torch.no_grad():
        for path, leaf in zip(codec.tree_paths(params), codec.tree_leaves(params)):
            model.get_parameter(".".join(path)).copy_(torch.as_tensor(np.asarray(leaf)))
        for path, leaf in zip(codec.tree_paths(aux or {}), codec.tree_leaves(aux or {})):
            model.get_buffer(".".join(path[1:])).copy_(torch.as_tensor(np.asarray(leaf)))

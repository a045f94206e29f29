"""Weight conversion from the reference package.

Both packages keep the same parameter tree (nested dicts of arrays in
the same layout), so a reference tree, handed over as numpy arrays,
converts by copy.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from elasticdl_tpu_torch.common import codec


def params_from_jax(tree) -> Dict:
    """A reference parameter tree of numpy arrays -> the same tree of
    float32 CPU tensors (copies)."""
    return codec.tree_map(
        lambda a: torch.from_numpy(np.array(a, dtype=np.float32)), tree
    )

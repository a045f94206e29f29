"""The final model file (`--output`).

The reference's `save_model_file` / `load_model_file`
(`elasticdl_tpu/master/checkpoint.py`) for the final model only: the
payload `{"version", "params", "aux"}` in the port's codec frame, written
to a temporary file and then renamed into place, so a reader never sees
a partial file.

Not ported yet: `CheckpointService` (periodic, rotated checkpoints),
evaluation snapshots, optimizer state and resume.
"""

from __future__ import annotations

import os
from typing import Any

from elasticdl_tpu_torch.common import codec
from elasticdl_tpu_torch.common.messages import Model


def save_model_file(path: str, params: Any, version: int, aux: Any = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(codec.dumps({"version": version, "params": params, "aux": aux}))
    os.replace(tmp, path)


def load_model_file(path: str) -> Model:
    with open(path, "rb") as f:
        d = codec.loads(f.read())
    return Model(version=d["version"], params=d["params"], aux=d.get("aux"))

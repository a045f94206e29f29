"""Wire messages for the master<->worker protocol.

The reference's request/response dicts and its `Task`/`Model`
dataclasses, serialized through this package's codec. The port speaks
GetTask, ReportTaskResult, GetModel, ReportVariable, ReportGradient and
GetPSConfig.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from elasticdl_tpu_torch.common import codec


class TaskType(object):
    TRAINING = "training"
    EVALUATION = "evaluation"
    PREDICTION = "prediction"
    WAIT = "wait"


class MethodType(object):
    """Model-pull semantics. MINIMUM: any model with version >= the
    requested one. FIXED: exactly the requested version."""

    MINIMUM = "minimum"
    FIXED = "fixed"


@dataclasses.dataclass
class Task:
    """A dynamic data shard: records [start, end) of one file."""

    task_id: int = -1
    shard_file_name: str = ""
    start: int = 0
    end: int = 0
    type: str = TaskType.WAIT
    model_version: int = -1
    # attempt key, fixed at first dispatch and kept across requeues
    spec_key: str = ""

    def to_wire(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_wire(cls, d: dict) -> "Task":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclasses.dataclass
class Model:
    """Versioned parameter pytree; `aux` carries non-trainable state."""

    version: int = 0
    params: Any = None
    aux: Any = None

    def to_wire(self) -> dict:
        return {"version": self.version, "params": self.params, "aux": self.aux}

    @classmethod
    def from_wire(cls, d: dict) -> "Model":
        return cls(version=d["version"], params=d["params"], aux=d.get("aux"))


def pack(obj: Any) -> bytes:
    return codec.dumps(obj)


def unpack(data: bytes) -> Any:
    return codec.loads(data)

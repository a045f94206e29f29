"""Model-zoo contract loader.

A model-zoo module exports:

- ``custom_model(**params)`` -> an ``nn.Module`` whose ``init_params(seed)``
  returns the host-side initial parameter tree (nested dict of float32
  numpy arrays, the tree the PS holds) and whose ``forward(features)``
  returns the model outputs;
- ``dataset_fn(records, mode)`` -> ``(features, labels)`` numpy batch
  parsed from a list of raw record payloads;
- ``loss(outputs, labels)`` -> scalar torch tensor;
- ``optimizer()`` -> the PS optimizer's factory: a zero-argument
  callable returning a ``master.ps_optimizer.PSOptimizer``.

Module-level names are the reference's, so ``--model_def`` strings
carry over unchanged.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib.util
import os
from typing import Any, Callable, Dict, Optional


@dataclasses.dataclass
class ModelSpec:
    model: Any
    dataset_fn: Callable
    loss: Callable
    optimizer: Callable
    eval_metrics_fn: Optional[Callable] = None
    module: Any = None


def load_module(module_file: str):
    """Dynamic import of a model-zoo file."""
    spec = importlib.util.spec_from_file_location(module_file, module_file)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def parse_model_params(model_params: str) -> Dict[str, Any]:
    """Parse ``"k=v,k2=v2"`` constructor params (literals, else strings)."""
    out: Dict[str, Any] = {}
    if not model_params:
        return out
    for kv in model_params.split(","):
        if not kv.strip():
            continue
        k, v = kv.split("=", 1)
        try:
            out[k.strip()] = ast.literal_eval(v.strip())
        except (ValueError, SyntaxError):
            out[k.strip()] = v.strip()
    return out


def get_model_spec(
    model_zoo: str,
    model_def: str,
    model_params: str = "",
    dataset_fn: str = "dataset_fn",
    loss: str = "loss",
    optimizer: str = "optimizer",
    eval_metrics_fn: str = "eval_metrics_fn",
) -> ModelSpec:
    """Resolve the named spec functions from a model-zoo module.
    ``model_def`` is ``"pkg.file.symbol"`` relative to ``model_zoo``."""
    *module_parts, symbol = model_def.split(".")
    module_file = os.path.join(model_zoo, *module_parts) + ".py"
    if not os.path.exists(module_file):
        raise FileNotFoundError(f"model_def module not found: {module_file}")
    module = load_module(module_file)

    model_factory = getattr(module, symbol)
    params = parse_model_params(model_params)
    model = model_factory(**params) if callable(model_factory) else model_factory

    def resolve(name, required=True):
        fn = getattr(module, name, None)
        if fn is None and required:
            raise ValueError(f"model module must define {name!r}")
        return fn

    return ModelSpec(
        model=model,
        dataset_fn=resolve(dataset_fn),
        loss=resolve(loss),
        optimizer=resolve(optimizer),
        eval_metrics_fn=resolve(eval_metrics_fn, required=False),
        module=module,
    )

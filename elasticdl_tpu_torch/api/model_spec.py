"""Model-zoo contract loader.

A model-zoo module exports:

- ``custom_model(**params)`` -> an ``nn.Module`` whose ``init_params(seed)``
  returns the host-side initial parameter tree (nested dict of float32
  numpy arrays, the tree the PS holds) and whose ``forward(features)``
  returns the model outputs. A model with non-trainable state (the
  reference's flax collections other than ``params``, e.g. BatchNorm's
  ``batch_stats``) also has ``init_aux()`` -> ``{collection: tree}``
  (``{}`` or absent for a model without them); each aux leaf at
  ``(collection, *path)`` is the module buffer ``".".join(path)``. Its
  ``forward(features, train=...)`` takes ``train`` (found by signature,
  as the reference finds it); in train mode the forward leaves each
  buffer's new value in its module's ``aux_out[name]`` and the buffers
  as they were, and the caller decides what to keep (the reference's
  ``mutable`` collections);
- ``dataset_fn(records, mode)`` -> ``(features, labels)`` numpy batch
  parsed from a list of raw record payloads;
- ``loss(outputs, labels)`` -> scalar torch tensor;
- ``optimizer()`` -> the PS optimizer's factory: a zero-argument
  callable returning a ``master.ps_optimizer.PSOptimizer``;
- optionally ``eval_metrics_fn(outputs, labels)`` -> ``{name: scalar
  tensor or mergeable state}`` (``api/metrics.py``) for evaluation
  tasks, and a ``PredictionOutputsProcessor`` class whose instance's
  ``process(outputs, worker_id)`` takes each prediction minibatch's
  outputs (numpy);
- optionally ``embedding_specs`` -> list of ``api.layers.EmbeddingSpec``
  declaring PS-resident tables, and ``sparse_optimizer`` -> the PS's
  sparse optimizer settings (``dict(kind=..., learning_rate=...)``). A
  model with tables takes ``forward(features, embeddings)``, where
  ``embeddings`` maps each table's name to its ``EmbeddingInput``.

Module-level names are the reference's, so ``--model_def`` strings
carry over unchanged.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib.util
import inspect
import os
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class ModelSpec:
    model: Any
    dataset_fn: Callable
    loss: Callable
    optimizer: Callable
    eval_metrics_fn: Optional[Callable] = None
    embedding_specs: List[Any] = dataclasses.field(default_factory=list)
    sparse_optimizer: Dict[str, Any] = dataclasses.field(default_factory=dict)
    prediction_outputs_processor: Any = None
    module: Any = None


def takes_train_kwarg(model) -> bool:
    """Whether the model's forward takes `train` (the reference's
    `_takes_train_kwarg`, by signature)."""
    try:
        return "train" in inspect.signature(model.forward).parameters
    except (TypeError, ValueError, AttributeError):
        return False


def init_aux(model) -> Dict:
    """The model's initial non-trainable collections, {} without any."""
    fn = getattr(model, "init_aux", None)
    return fn() if fn is not None else {}


def aux_buffer(model, path: Tuple[str, ...]):
    """(module, buffer name) of the aux leaf at `path` = (collection, *path)."""
    *mods, name = path[1:]
    return model.get_submodule(".".join(mods)), name


def new_aux_values(model, paths: List[Tuple[str, ...]]) -> List:
    """The new value of each aux leaf after a train-mode forward."""
    return [module.aux_out[name] for module, name in (aux_buffer(model, p) for p in paths)]


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
    prediction_outputs_processor: str = "PredictionOutputsProcessor",
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

    processor_cls = getattr(module, prediction_outputs_processor, None)
    return ModelSpec(
        model=model,
        dataset_fn=resolve(dataset_fn),
        loss=resolve(loss),
        optimizer=resolve(optimizer),
        eval_metrics_fn=resolve(eval_metrics_fn, required=False),
        embedding_specs=list(getattr(module, "embedding_specs", []) or []),
        sparse_optimizer=dict(getattr(module, "sparse_optimizer", {}) or {}),
        prediction_outputs_processor=processor_cls() if processor_cls else None,
        module=module,
    )

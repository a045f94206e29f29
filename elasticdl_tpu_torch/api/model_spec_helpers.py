"""Spec construction helpers shared by the loader and tests."""

from __future__ import annotations

from elasticdl_tpu_torch.api.model_spec import ModelSpec


def spec_from_module(module, **overrides) -> ModelSpec:
    """Build a ModelSpec from an already-imported model-zoo module
    (same contract as get_model_spec, without the dynamic file load)."""
    processor_cls = getattr(module, "PredictionOutputsProcessor", None)
    kwargs = dict(
        model=module.custom_model(),
        dataset_fn=module.dataset_fn,
        loss=module.loss,
        optimizer=module.optimizer,
        eval_metrics_fn=getattr(module, "eval_metrics_fn", None),
        embedding_specs=list(getattr(module, "embedding_specs", []) or []),
        sparse_optimizer=dict(getattr(module, "sparse_optimizer", {}) or {}),
        prediction_outputs_processor=processor_cls() if processor_cls else None,
        module=module,
    )
    kwargs.update(overrides)
    return ModelSpec(**kwargs)

"""Model-zoo entry for the flagship transformer LM.

The reference's `transformer_lm_zoo` contract in PyTorch: the worker
builds the model with `custom_model(**model_params)`, initializes it on
the host with `init_params(seed)` (the reference's draws for the same
seed), and trains it through the elastic PS loop on token RecordIO
shards; `eval_metrics_fn` scores its evaluation tasks (cross entropy,
accuracy, perplexity = exp(cross entropy)).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.master.ps_optimizer import ClipAdam
from elasticdl_tpu_torch.models.record_codec import decode_token_records
from elasticdl_tpu_torch.models.transformer_lm import (
    TransformerConfig,
    init_params,
    param_shapes,
    plain_forward,
    token_cross_entropy,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class TransformerLM(nn.Module):
    """Parameters are registered in the reference's tree layout
    (`layers` is a ParameterDict of stacked [n_layers, ...] tensors, the
    expert leaves of an MoE config included); `forward` is
    `plain_forward` over them."""

    def __init__(self, **cfg_kwargs):
        super().__init__()
        dtype = cfg_kwargs.get("dtype", torch.float32)
        if isinstance(dtype, str):
            cfg_kwargs["dtype"] = _DTYPES[dtype]
        self.cfg = TransformerConfig(**cfg_kwargs)
        shapes = param_shapes(self.cfg)
        self.embed = nn.Parameter(torch.empty(shapes["embed"]))
        self.head = nn.Parameter(torch.empty(shapes["head"]))
        self.ln_f = nn.Parameter(torch.empty(shapes["ln_f"]))
        self.layers = nn.ParameterDict(
            {k: nn.Parameter(torch.empty(s)) for k, s in shapes["layers"].items()}
        )

    def init_params(self, seed: int) -> Dict:
        """Host-side initial parameter tree (nested dict of numpy f32)."""
        return init_params(np.random.default_rng(seed), self.cfg)

    def params_tree(self) -> Dict:
        return {
            "embed": self.embed,
            "head": self.head,
            "ln_f": self.ln_f,
            "layers": dict(self.layers.items()),
        }

    def forward(self, tokens: torch.Tensor):
        """Logits; an MoE config returns (logits, aux_weight * aux), so the
        Switch load-balance term reaches `loss` (the reference's `apply`)."""
        logits, aux = plain_forward(self.cfg, self.params_tree(), tokens)
        if self.cfg.n_experts:
            return logits, self.cfg.aux_weight * aux
        return logits


def custom_model(**model_params):
    # sized so CPU tests train it in seconds; override via model_params
    # (e.g. "d_model=512,n_layers=8,vocab=8192,dtype=bfloat16")
    defaults = dict(vocab=128, d_model=64, n_heads=4, d_ff=128, n_layers=2)
    defaults.update(model_params)
    return TransformerLM(**defaults)


def dataset_fn(records, mode):
    tokens = decode_token_records(records)  # [B, T+1] int32
    return tokens[:, :-1], tokens[:, 1:].astype(np.int32)


def _split_outputs(outputs):
    """(logits, weighted aux) for MoE configs, (logits, 0) for dense."""
    if isinstance(outputs, tuple):
        return outputs
    return outputs, torch.zeros((), dtype=torch.float32, device=outputs.device)


def loss(outputs, labels):
    logits, aux = _split_outputs(outputs)
    return token_cross_entropy(logits, labels) + aux.to(torch.float32)


def optimizer():
    return ClipAdam(max_norm=1.0, learning_rate=1e-3)


def eval_metrics_fn(predictions, labels):
    logits, _aux = _split_outputs(predictions)
    labels = torch.as_tensor(labels, device=logits.device)
    ce = token_cross_entropy(logits, labels)
    acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
    return {"cross_entropy": ce, "accuracy": acc, "perplexity": torch.exp(ce)}

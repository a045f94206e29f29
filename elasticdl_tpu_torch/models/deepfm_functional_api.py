"""DeepFM with in-model embedding tables: the dense-path variant
(`elasticdl_tpu/models/deepfm_functional_api.py`).

The two tables (`fm_second` 5,500 x 8 and `fm_first` 5,500 x 1, the
frappe id space) are ordinary parameters on the PS, so their gradients
ride the dense path; the rest is `deepfm_edl_embedding`'s model. Init
draws flax's `nn.Embed` default (a normal of variance 1 / dim) and
lecun_normal kernels with numpy, biases zeros.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.models.deepfm_edl_embedding import (  # noqa: F401 (the zoo's names)
    EMB_DIM,
    NUM_FIELDS,
    dataset_fn,
    eval_metrics_fn,
    fm_logits,
    loss,
    optimizer,
)
from elasticdl_tpu_torch.models.image_layers import Dense

VOCAB = 5500  # the frappe feature-id space


class Embed(nn.Module):
    """`nn.Embed(num_embeddings, features)`: `embedding[ids]`."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num_embeddings, features))

    def init_leaves(self, rng) -> dict:
        n, d = self.embedding.shape
        return {"embedding": (rng.standard_normal((n, d)) * math.sqrt(1.0 / d)).astype(np.float32)}

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids.long()]


class DeepFM(nn.Module):
    def __init__(self, vocab: int = VOCAB, dim: int = EMB_DIM):
        super().__init__()
        self.fm_second = Embed(vocab, dim)
        self.fm_first = Embed(vocab, 1)
        self.Dense_0 = Dense(NUM_FIELDS * dim, 64)
        self.Dense_1 = Dense(64, 32)
        self.Dense_2 = Dense(32, 1)
        self.bias = nn.Parameter(torch.zeros(()))

    def init_params(self, seed: int = 0) -> dict:
        rng = np.random.default_rng(seed)
        return {
            "fm_second": self.fm_second.init_leaves(rng),
            "fm_first": self.fm_first.init_leaves(rng),
            "Dense_0": self.Dense_0.init_leaves(rng),
            "Dense_1": self.Dense_1.init_leaves(rng),
            "Dense_2": self.Dense_2.init_leaves(rng),
            "bias": np.zeros((), np.float32),
        }

    def forward(self, features):
        ids = features["ids"]
        v = self.fm_second(ids)  # [B, F, K]
        first = self.fm_first(ids)[..., 0].sum(dim=1)
        return fm_logits(v, first, (self.Dense_0, self.Dense_1, self.Dense_2), self.bias)


def custom_model():
    return DeepFM()

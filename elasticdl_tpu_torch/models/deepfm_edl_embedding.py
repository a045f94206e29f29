"""DeepFM over PS-resident elastic embedding tables: the sparse plane's
model (`elasticdl_tpu/models/deepfm_edl_embedding.py`).

10 categorical fields, two tables with no vocabulary size (the rows live
in the embedding store and grow with the ids that arrive; id 0 is
padding, `mask_zero`): `fm_second` (dim 8) and `fm_first` (dim 1, summed
over the fields). The logit is the FM's first- and second-order terms
plus an MLP (80 -> 64 -> 32 -> 1, relu) over the fields' rows plus a
scalar bias. The tables train by the PS's sparse Adam (1e-3), the dense
parameters by Adam (1e-3); `eval_metrics_fn` gives accuracy and the
job-exact AUC state (`api.metrics.auc_state`).

Parameters are flax's tree (`Dense_0`, `Dense_1`, `Dense_2`, `bias`),
kernels [in, out]; init draws lecun_normal with numpy, biases zeros.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.api.layers import EmbeddingSpec, embedding_forward
from elasticdl_tpu_torch.api.metrics import auc_state
from elasticdl_tpu_torch.master.ps_optimizer import adam
from elasticdl_tpu_torch.models.image_layers import Dense
from elasticdl_tpu_torch.models.record_codec import decode_tabular_records

NUM_FIELDS = 10
EMB_DIM = 8

embedding_specs = [
    EmbeddingSpec(name="fm_second", dim=EMB_DIM, input_key="ids", mask_zero=True),
    EmbeddingSpec(name="fm_first", dim=1, input_key="ids", mask_zero=True),
]

sparse_optimizer = {"kind": "adam", "learning_rate": 1e-3}


def fm_logits(v: torch.Tensor, first: torch.Tensor, mlp, bias: torch.Tensor) -> torch.Tensor:
    """first + the FM's second-order term + the MLP over the flattened
    field rows + bias, from the fields' rows `v` [B, F, K] and the
    first-order sums `first` [B]."""
    s = v.sum(dim=1)
    second = 0.5 * (s * s - (v * v).sum(dim=1)).sum(dim=-1)
    h = v.reshape(v.shape[0], -1)
    h = F.relu(mlp[0](h))
    h = F.relu(mlp[1](h))
    deep = mlp[2](h)[:, 0]
    return first + second + deep + bias


class DeepFMEdl(nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = Dense(NUM_FIELDS * EMB_DIM, 64)
        self.Dense_1 = Dense(64, 32)
        self.Dense_2 = Dense(32, 1)
        self.bias = nn.Parameter(torch.zeros(()))

    def init_params(self, seed: int = 0) -> dict:
        rng = np.random.default_rng(seed)
        return {
            "Dense_0": self.Dense_0.init_leaves(rng),
            "Dense_1": self.Dense_1.init_leaves(rng),
            "Dense_2": self.Dense_2.init_leaves(rng),
            "bias": np.zeros((), np.float32),
        }

    def forward(self, features, embeddings):
        e2, e1 = embeddings["fm_second"], embeddings["fm_first"]
        v = embedding_forward(e2.bet, e2.inverse, e2.mask)  # [B, F, K]
        first = embedding_forward(e1.bet, e1.inverse, e1.mask, combiner="sum")[:, 0]
        return fm_logits(v, first, (self.Dense_0, self.Dense_1, self.Dense_2), self.bias)


def custom_model():
    return DeepFMEdl()


def dataset_fn(records, mode):
    ids, labels = decode_tabular_records(records, NUM_FIELDS)
    return {"ids": ids.astype("int32")}, labels


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's form: -labels log sigmoid(x) - (1 - labels) log sigmoid(-x)."""
    labels = labels.to(logits.dtype)
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def loss(outputs, labels):
    return sigmoid_binary_cross_entropy(outputs, labels).mean()


def optimizer():
    return adam(1e-3)


def eval_metrics_fn(predictions, labels):
    labels = torch.as_tensor(labels, device=predictions.device)
    return {
        "accuracy": ((predictions > 0) == (labels > 0.5)).to(torch.float32).mean(),
        "auc": auc_state(predictions, labels),
    }

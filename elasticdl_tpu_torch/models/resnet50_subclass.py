"""ResNet-50, the north-star model (`elasticdl_tpu/models/resnet50_subclass.py`).

A 7x7/2 stem conv + BatchNorm + relu and a 3x3/2 "SAME" max pool, then
bottleneck blocks (1x1 -> 3x3 -> 1x1, a projection shortcut where the
shape changes, the last BatchNorm's scale initialized to zero) in
`stage_sizes` stages, a global average pool and Dense(num_classes).
BatchNorm momentum 0.9, epsilon 1e-5. `compute_dtype=torch.bfloat16`
(`custom_model(bfloat16=True)`) computes convs and BatchNorm outputs in
bfloat16 over float32 parameters and float32 BatchNorm statistics, as
flax does with `dtype=bfloat16`; the head runs in float32. L2 is the
optimizer's decoupled weight decay (1e-4) before sgd(0.1, momentum 0.9).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.master.ps_optimizer import AddDecayedWeights, Chain, Sgd
from elasticdl_tpu_torch.models.image_layers import (
    BatchNorm,
    Conv,
    Dense,
    ImageModel,
    accuracy,
    max_pool,
    softmax_cross_entropy,
    to_nchw,
)
from elasticdl_tpu_torch.models.record_codec import decode_image_records, normalize_on_device

IMAGE_SHAPE = (64, 64, 3)  # the synthetic default; ImageNet uses 224
NUM_CLASSES = 10

BN_MOMENTUM = 0.9
BN_EPSILON = 1e-5


def _bn(features, compute_dtype, scale_init_zero=False):
    return BatchNorm(features, BN_MOMENTUM, BN_EPSILON, compute_dtype, scale_init_zero)


class Bottleneck(nn.Module):
    """Names as flax's compact creation order gives them: the main path's
    Conv_0..2 / BatchNorm_0..2, the projection's Conv_3 / BatchNorm_3."""

    def __init__(self, in_features: int, features: int, strides=(1, 1),
                 compute_dtype=torch.float32):
        super().__init__()
        dt = compute_dtype
        self.Conv_0 = Conv(in_features, features, (1, 1), use_bias=False, compute_dtype=dt)
        self.BatchNorm_0 = _bn(features, dt)
        self.Conv_1 = Conv(features, features, (3, 3), strides, use_bias=False, compute_dtype=dt)
        self.BatchNorm_1 = _bn(features, dt)
        self.Conv_2 = Conv(features, features * 4, (1, 1), use_bias=False, compute_dtype=dt)
        self.BatchNorm_2 = _bn(features * 4, dt, scale_init_zero=True)
        self.project = in_features != features * 4 or tuple(strides) != (1, 1)
        if self.project:
            self.Conv_3 = Conv(in_features, features * 4, (1, 1), strides, use_bias=False,
                               compute_dtype=dt)
            self.BatchNorm_3 = _bn(features * 4, dt)

    def forward(self, x, train: bool = False):
        residual = x
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        if self.project:
            residual = self.BatchNorm_3(self.Conv_3(residual), train)
        return F.relu(y + residual)


class ResNet50(ImageModel):
    def __init__(self, num_classes: int = NUM_CLASSES,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3), compute_dtype=torch.float32):
        super().__init__()
        self.num_classes, self.stage_sizes = num_classes, tuple(stage_sizes)
        self.compute_dtype = compute_dtype
        self.Conv_0 = Conv(3, 64, (7, 7), (2, 2), use_bias=False, compute_dtype=compute_dtype)
        self.BatchNorm_0 = _bn(64, compute_dtype)
        blocks, cin = [], 64
        for i, block_count in enumerate(self.stage_sizes):
            features = 64 * 2**i
            for j in range(block_count):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                blocks.append(Bottleneck(cin, features, strides, compute_dtype))
                cin = features * 4
        for k, block in enumerate(blocks):
            self.add_module(f"Bottleneck_{k}", block)
        self.n_blocks = len(blocks)
        self.Dense_0 = Dense(cin, num_classes, compute_dtype=torch.float32)

    def forward(self, x, train: bool = False):
        x = to_nchw(normalize_on_device(x)).to(self.compute_dtype)
        x = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        x = max_pool(x, (3, 3), (2, 2), padding="SAME")
        for k in range(self.n_blocks):
            x = getattr(self, f"Bottleneck_{k}")(x, train)
        x = x.mean((2, 3))  # global average pool
        return self.Dense_0(x)


def custom_model(num_classes: int = NUM_CLASSES, bfloat16: bool = False):
    return ResNet50(num_classes=num_classes,
                    compute_dtype=torch.bfloat16 if bfloat16 else torch.float32)


def dataset_fn(records, mode):
    return decode_image_records(records, IMAGE_SHAPE, scale=False)


def loss(outputs, labels):
    return softmax_cross_entropy(outputs, labels)


def optimizer():
    # decoupled weight decay stands in for the reference's per-kernel L2
    return Chain(AddDecayedWeights(1e-4), Sgd(0.1, momentum=0.9))


def eval_metrics_fn(predictions, labels):
    return accuracy(predictions, labels)

"""CIFAR-10 VGG-style conv-net with BatchNorm, functional style: the
reference's headline model (`elasticdl_tpu/models/cifar10_functional_api.py`).

Three blocks of two 3x3 convs (no bias) + BatchNorm (momentum 0.99) +
relu and a 2x2 max pool, then Dense(256) + relu and Dense(10): 814,570
parameters. Its BatchNorm statistics are the non-trainable `batch_stats`
collection that rides the PS protocol as aux state. Images cross to the
device as uint8 and are normalized there.
"""

from __future__ import annotations

import torch.nn.functional as F

from elasticdl_tpu_torch.master.ps_optimizer import (
    Chain,
    ClipByGlobalNorm,
    Sgd,
    WarmupCosineDecay,
)
from elasticdl_tpu_torch.models.image_layers import (
    BatchNorm,
    Conv,
    Dense,
    ImageModel,
    accuracy,
    flatten_nhwc,
    max_pool,
    softmax_cross_entropy,
    to_nchw,
)
from elasticdl_tpu_torch.models.record_codec import decode_image_records, normalize_on_device
from torch import nn

IMAGE_SHAPE = (32, 32, 3)
NUM_CLASSES = 10


class VGGBlock(nn.Module):
    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, (3, 3), use_bias=False)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = Conv(features, features, (3, 3), use_bias=False)
        self.BatchNorm_1 = BatchNorm(features)

    def forward(self, x, train: bool = False):
        x = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        x = F.relu(self.BatchNorm_1(self.Conv_1(x), train))
        return max_pool(x, (2, 2), (2, 2))


class Cifar10Model(ImageModel):
    def __init__(self):
        super().__init__()
        self.VGGBlock_0 = VGGBlock(3, 32)
        self.VGGBlock_1 = VGGBlock(32, 64)
        self.VGGBlock_2 = VGGBlock(64, 128)
        self.Dense_0 = Dense(4 * 4 * 128, 256)
        self.Dense_1 = Dense(256, NUM_CLASSES)

    def forward(self, x, train: bool = False):
        x = to_nchw(normalize_on_device(x))
        for block in (self.VGGBlock_0, self.VGGBlock_1, self.VGGBlock_2):
            x = block(x, train)
        x = F.relu(self.Dense_0(flatten_nhwc(x)))
        return self.Dense_1(x)


def custom_model():
    return Cifar10Model()


def dataset_fn(records, mode):
    # uint8 to the device (a quarter of float32's bytes); the model normalizes
    return decode_image_records(records, IMAGE_SHAPE, scale=False)


def loss(outputs, labels):
    return softmax_cross_entropy(outputs, labels)


def optimizer():
    # bare sgd(0.1, momentum=0.9) diverges on this net; warmup and the
    # global-norm clip stabilize it (the reference's choice)
    schedule = WarmupCosineDecay(
        init_value=0.0, peak_value=0.05, warmup_steps=200, decay_steps=4000, end_value=0.005
    )
    return Chain(ClipByGlobalNorm(1.0), Sgd(schedule, momentum=0.9))


def eval_metrics_fn(predictions, labels):
    return accuracy(predictions, labels)

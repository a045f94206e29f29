"""CIFAR-10 conv-net, module-subclass style
(`elasticdl_tpu/models/cifar10_subclass.py`): the functional variant's
topology with the layers named as the reference's `setup` names them
(`convs_i`, `bns_i`, `dense1`, `dense2`), and plain sgd(0.1, momentum
0.9) on the PS.
"""

from __future__ import annotations

import torch.nn.functional as F

from elasticdl_tpu_torch.master.ps_optimizer import Sgd
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

IMAGE_SHAPE = (32, 32, 3)
NUM_CLASSES = 10
WIDTHS = (32, 32, 64, 64, 128, 128)


class Cifar10Subclass(ImageModel):
    def __init__(self):
        super().__init__()
        for i, (cin, cout) in enumerate(zip((3,) + WIDTHS[:-1], WIDTHS)):
            self.add_module(f"convs_{i}", Conv(cin, cout, (3, 3), use_bias=False))
            self.add_module(f"bns_{i}", BatchNorm(cout))
        self.dense1 = Dense(4 * 4 * 128, 256)
        self.dense2 = Dense(256, NUM_CLASSES)

    def forward(self, x, train: bool = False):
        x = to_nchw(normalize_on_device(x))
        for i in range(len(WIDTHS)):
            conv, bn = getattr(self, f"convs_{i}"), getattr(self, f"bns_{i}")
            x = F.relu(bn(conv(x), train))
            if i % 2 == 1:
                x = max_pool(x, (2, 2), (2, 2))
        x = F.relu(self.dense1(flatten_nhwc(x)))
        return self.dense2(x)


def custom_model():
    return Cifar10Subclass()


def dataset_fn(records, mode):
    return decode_image_records(records, IMAGE_SHAPE, scale=False)


def loss(outputs, labels):
    return softmax_cross_entropy(outputs, labels)


def optimizer():
    return Sgd(0.1, momentum=0.9)


def eval_metrics_fn(predictions, labels):
    return accuracy(predictions, labels)

"""MNIST conv-net, module-subclass style
(`elasticdl_tpu/models/mnist_subclass.py`): the functional variant's
math with the reference's `setup` names (`conv1`, `conv2`, `dense1`,
`dense2`).
"""

from __future__ import annotations

import torch.nn.functional as F

from elasticdl_tpu_torch.master.ps_optimizer import Sgd
from elasticdl_tpu_torch.models.image_layers import (
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

IMAGE_SHAPE = (28, 28, 1)
NUM_CLASSES = 10


class MnistModel(ImageModel):
    def __init__(self):
        super().__init__()
        self.conv1 = Conv(1, 32, (3, 3))
        self.conv2 = Conv(32, 64, (3, 3))
        self.dense1 = Dense(14 * 14 * 64, 128)
        self.dense2 = Dense(128, NUM_CLASSES)

    def forward(self, x):
        x = to_nchw(normalize_on_device(x))
        x = F.relu(self.conv1(x))
        x = F.relu(self.conv2(x))
        x = flatten_nhwc(max_pool(x, (2, 2), (2, 2)))
        x = F.relu(self.dense1(x))
        return self.dense2(x)


def custom_model():
    return MnistModel()


def dataset_fn(records, mode):
    return decode_image_records(records, IMAGE_SHAPE, scale=False)


def loss(outputs, labels):
    return softmax_cross_entropy(outputs, labels)


def optimizer():
    return Sgd(0.1, momentum=0.9)


def eval_metrics_fn(predictions, labels):
    return accuracy(predictions, labels)

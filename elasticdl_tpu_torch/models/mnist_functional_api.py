"""MNIST conv-net, functional-composition style: the CI workhorse
(`elasticdl_tpu/models/mnist_functional_api.py`). The reference composes
an `nn.Sequential`, whose layers are named by their index in it
(`layers_0`, `layers_2`, `layers_6`, `layers_8`); the port keeps those
names. Two 3x3 "SAME" convs with bias + relu, a 2x2 max pool,
Dense(128) + relu, Dense(10): 1,625,866 parameters, sgd(0.1, momentum
0.9) on the PS. Images cross to the device as uint8 (the reference
decodes them to float32 on the host; the model's first step divides by
255 on the device, which gives the same values).
"""

from __future__ import annotations

import numpy as np
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


class MnistSequential(ImageModel):
    def __init__(self):
        super().__init__()
        self.layers_0 = Conv(1, 32, (3, 3))
        self.layers_2 = Conv(32, 64, (3, 3))
        self.layers_6 = Dense(14 * 14 * 64, 128)
        self.layers_8 = Dense(128, NUM_CLASSES)

    def forward(self, x):
        x = to_nchw(normalize_on_device(x))
        x = F.relu(self.layers_0(x))
        x = F.relu(self.layers_2(x))
        x = flatten_nhwc(max_pool(x, (2, 2), (2, 2)))
        x = F.relu(self.layers_6(x))
        return self.layers_8(x)


def custom_model():
    return MnistSequential()


def dataset_fn(records, mode):
    return decode_image_records(records, IMAGE_SHAPE, scale=False)


def loss(outputs, labels):
    return softmax_cross_entropy(outputs, labels)


def optimizer():
    return Sgd(0.1, momentum=0.9)


def eval_metrics_fn(predictions, labels):
    return accuracy(predictions, labels)


class PredictionOutputsProcessor:
    """Sink for prediction outputs: (worker id, argmax class) per batch."""

    def __init__(self):
        self.outputs = []

    def process(self, predictions, worker_id):
        self.outputs.append((worker_id, np.argmax(np.asarray(predictions), axis=-1)))

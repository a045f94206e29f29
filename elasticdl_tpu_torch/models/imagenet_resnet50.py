"""ImageNet -> RecordIO data prep for ResNet-50
(`elasticdl_tpu/models/imagenet_resnet50.py`): the
`prepare_data_for_a_single_file(file_object, filename)` hook of the
reference's conversion driver. It reads a tar whose members are `.npy`
arrays (HWC uint8) named `<label>/<anything>.npy` and returns the
encoded image records, the same bytes as the reference's for the same
tar. The model is `resnet50_subclass`'s.
"""

from __future__ import annotations

import io
import tarfile

import numpy as np

from elasticdl_tpu_torch.models.record_codec import encode_image_record
from elasticdl_tpu_torch.models.resnet50_subclass import (  # noqa: F401 (the model's entry points)
    custom_model,
    dataset_fn,
    eval_metrics_fn,
    loss,
    optimizer,
)


def prepare_data_for_a_single_file(file_object, filename: str):
    """One input tar -> list of encoded image records."""
    records = []
    with tarfile.open(fileobj=file_object, mode="r:*") as tar:
        for member in tar.getmembers():
            if not member.isfile() or not member.name.endswith(".npy"):
                continue
            label = int(member.name.split("/", 1)[0])
            image = np.load(io.BytesIO(tar.extractfile(member).read()))
            records.append(encode_image_record(image.astype(np.uint8), label))
    return records

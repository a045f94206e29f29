"""Record payload codecs shared by the model zoo.

Fixed-layout numpy byte records, the reference's own
(`elasticdl_tpu/models/record_codec.py`), byte for byte:

- image records: int64 label | uint8[prod(shape)] pixels;
- token records: int32[seq_len + 1] token ids (LM input is [:-1],
  target [1:]);
- tabular records: int64[num_fields] categorical ids | float32 label
  (frappe-style rows: the deepfm zoo's input).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from elasticdl_tpu_torch.data.recordio import RecordIOWriter

# ----------------------------------------------------------- image records


def encode_image_record(image: np.ndarray, label: int) -> bytes:
    image = np.ascontiguousarray(image, dtype=np.uint8)
    return np.int64(label).tobytes() + image.tobytes()


def decode_image_records(
    records: Sequence[bytes], shape: Tuple[int, ...], scale: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (images [B, *shape], labels int64 [B]). scale=True: float32 in
    [0, 1]; scale=False: the raw uint8, which crosses to the device at a
    quarter of the bytes and is normalized there (`normalize_on_device`)."""
    labels = np.empty(len(records), dtype=np.int64)
    dtype = np.float32 if scale else np.uint8
    images = np.empty((len(records),) + tuple(shape), dtype=dtype)
    for i, r in enumerate(records):
        labels[i] = np.frombuffer(r, dtype=np.int64, count=1)[0]
        img = np.frombuffer(r, dtype=np.uint8, offset=8).reshape(shape)
        images[i] = img.astype(np.float32) if scale else img
    if scale:
        images /= 255.0
    return images, labels


def normalize_on_device(x: torch.Tensor) -> torch.Tensor:
    """uint8 (or any integer) images -> float32 in [0, 1] on their device;
    float input passes through. A true division by a float32 tensor: on
    the card, dividing by a Python scalar multiplies by its reciprocal,
    which is not the host's x / 255.0 bit for bit."""
    if x.dtype.is_floating_point:
        return x
    return x.to(torch.float32) / torch.full((), 255.0, dtype=torch.float32, device=x.device)


def write_synthetic_image_records(
    path: str, n: int, shape: Tuple[int, ...], num_classes: int, seed: int = 0
):
    """Images whose mean depends on the class, so small models can learn
    (the reference's writer: the same draws and bytes for one seed)."""
    rng = np.random.default_rng(seed)
    with RecordIOWriter(path) as w:
        for _ in range(n):
            label = int(rng.integers(num_classes))
            img = np.clip(
                rng.normal(40.0 + 15.0 * label, 25.0, size=shape), 0, 255
            ).astype(np.uint8)
            w.write(encode_image_record(img, label))


# --------------------------------------------------------- tabular records


def encode_tabular_record(ids: np.ndarray, label: float) -> bytes:
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    return ids.tobytes() + np.float32(label).tobytes()


def decode_tabular_records(
    records: Sequence[bytes], num_fields: int
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (ids int64 [B, num_fields], labels float32 [B])."""
    ids = np.empty((len(records), num_fields), dtype=np.int64)
    labels = np.empty(len(records), dtype=np.float32)
    for i, r in enumerate(records):
        ids[i] = np.frombuffer(r, dtype=np.int64, count=num_fields)
        labels[i] = np.frombuffer(r, dtype=np.float32, offset=8 * num_fields)[0]
    return ids, labels


def write_synthetic_tabular_records(
    path: str, n: int, num_fields: int, vocab: int, seed: int = 0
):
    """Rows of ids in [1, vocab) with a parity label (the sum of the ids
    mod 2); the reference's writer: the same draws and bytes for one
    seed."""
    rng = np.random.default_rng(seed)
    with RecordIOWriter(path) as w:
        for _ in range(n):
            ids = rng.integers(1, vocab, size=num_fields)
            w.write(encode_tabular_record(ids, float(ids.sum() % 2)))


# ----------------------------------------------------------- token records


def encode_token_record(tokens: np.ndarray) -> bytes:
    return np.ascontiguousarray(tokens, dtype=np.int32).tobytes()


def decode_token_records(records: Sequence[bytes]) -> np.ndarray:
    return np.stack([np.frombuffer(r, dtype=np.int32) for r in records])


def write_learnable_token_records(
    path: str, n: int, seq_len: int, vocab: int, seed: int = 0
):
    """Arithmetic token sequences mod vocab (stride in {1,2,3}): the
    next token is a deterministic function of the previous one and the
    in-context stride, so an attention LM's loss must fall well below
    ln(vocab). Same draws as the reference's writer for one seed."""
    rng = np.random.default_rng(seed)
    with RecordIOWriter(path) as w:
        for _ in range(n):
            start = int(rng.integers(vocab))
            stride = int(rng.integers(1, 4))
            toks = (start + stride * np.arange(seq_len + 1)) % vocab
            w.write(encode_token_record(toks))

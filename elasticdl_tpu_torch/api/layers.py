"""Elastic embedding: PS-resident tables through the Batch Embedding Tensor.

The reference's `elasticdl_tpu/api/layers.py`. A model declares its
tables (`EmbeddingSpec`: no vocabulary size, the rows live in the
embedding store and grow with the ids that arrive). Per minibatch the
worker, on the host:

1. dedups each table's ids and fetches their rows, lazily initializing
   unseen ids (`prepare_batch_embedding`);
2. pads the unique rows to a power-of-two bucket: the BET, `[bucket,
   dim]`, with each id's position in it (`inverse`) and the padding
   mask (`BatchEmbedding`).

On the device the model re-expands the BET (`embedding_forward`,
`bet[inverse]`, masked, optionally combined over a bag), and the BET is
a leaf that takes a gradient: `d loss / d bet` is exactly the per-row
gradient, which `extract_indexed_grads` slices back to the real rows
(dropping id 0's row under `mask_zero`) as IndexedRows for the PS's
sparse optimizer. The padded rows get no gradient. On CUDA the backward
of `bet[inverse]` is a scatter with atomic adds, whose order is not
fixed, so its sums may differ from the CPU's in the last bits.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from elasticdl_tpu_torch.common.codec import IndexedRows


@dataclasses.dataclass
class EmbeddingSpec:
    """One PS-resident table of a model: `input_key` names the integer id
    feature ([B] or [B, L]); `combiner` (None, "sum", "mean", "sqrtn")
    and `mask_zero` are the reference layer's options; rows initialize
    uniformly in (-init_scale, init_scale)."""

    name: str
    dim: int
    input_key: str
    combiner: Optional[str] = None
    mask_zero: bool = False
    init_scale: float = 0.05


def bucket_size(n: int, minimum: int = 8) -> int:
    """The power-of-two bucket (at least `minimum`) that n unique rows pad to."""
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class BatchEmbedding:
    """One table's host-side inputs for one minibatch.

    bet:      [bucket, dim] float32, the padded unique rows
    inverse:  [B, L] int32, each id's row in `bet`
    mask:     [B, L] bool, False where the id is masked padding
    ids:      [n_unique] int64, the unique ids (for the gradient report)
    """

    bet: np.ndarray
    inverse: np.ndarray
    mask: np.ndarray
    ids: np.ndarray


class EmbeddingInput(NamedTuple):
    """One table's device tensors, as a model's forward takes them."""

    bet: torch.Tensor
    inverse: torch.Tensor
    mask: torch.Tensor


def prepare_batch_embedding(spec: EmbeddingSpec, ids: np.ndarray, lookup_fn) -> BatchEmbedding:
    """Dedup the ids, fetch their rows (`lookup_fn(spec, unique_ids) ->
    [n, dim]`, lazy init included) and pad them to a bucket."""
    ids = np.asarray(ids)
    if ids.ndim == 1:
        ids = ids[:, None]
    flat = ids.reshape(-1).astype(np.int64)
    uniq, inverse = np.unique(flat, return_inverse=True)
    rows = lookup_fn(spec, uniq)
    bet = np.zeros((bucket_size(len(uniq)), spec.dim), dtype=np.float32)
    bet[: len(uniq)] = rows
    mask = ids != 0 if spec.mask_zero else np.ones_like(ids, dtype=bool)
    return BatchEmbedding(
        bet=bet, inverse=inverse.reshape(ids.shape).astype(np.int32), mask=mask, ids=uniq
    )


def embedding_forward(
    bet: torch.Tensor,
    inverse: torch.Tensor,
    mask: torch.Tensor,
    combiner: Optional[str] = None,
) -> torch.Tensor:
    """The BET re-expanded on the device: [B, L, dim] with masked rows
    zeroed, or with a combiner, sum / mean / sqrtn over L -> [B, dim]
    (a bag's count is at least 1)."""
    m = mask[..., None].to(bet.dtype)
    gathered = bet[inverse.long()] * m
    if combiner is None:
        return gathered
    s = gathered.sum(dim=1)
    if combiner == "sum":
        return s
    counts = torch.clamp(mask.to(bet.dtype).sum(dim=1, keepdim=True), min=1.0)
    if combiner == "mean":
        return s / counts
    if combiner == "sqrtn":
        return s / torch.sqrt(counts)
    raise ValueError(f"unknown combiner {combiner!r}")


def extract_indexed_grads(spec: EmbeddingSpec, bet_grad: np.ndarray, batch: BatchEmbedding) -> IndexedRows:
    """The padded BET gradient sliced back to the real rows, as
    IndexedRows; id 0's row is dropped under `mask_zero` (padding never
    learns)."""
    n = len(batch.ids)
    values = np.asarray(bet_grad[:n], dtype=np.float32)
    ids = batch.ids
    if spec.mask_zero:
        keep = ids != 0
        values, ids = values[keep], ids[keep]
    return IndexedRows(values=values, indices=ids)

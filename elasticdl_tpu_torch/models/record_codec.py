"""Token-record codec shared by the model zoo.

layout: int32[seq_len + 1] token ids (LM input is [:-1], target [1:])
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from elasticdl_tpu_torch.data.recordio import RecordIOWriter


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

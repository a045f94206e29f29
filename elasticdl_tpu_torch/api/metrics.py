"""Mergeable evaluation-metric states (`elasticdl_tpu/api/metrics.py`).

A metric may return mergeable STATE instead of a scalar: a dict tagged
with a `kind`, which workers report per minibatch, the evaluation
service reduces by summation (`merge_metric_states`), and
`finalize_metric_state` turns into the exact job-level scalar at
completion. An average of per-batch AUCs is not the job's AUC; summed
threshold-bin counts finalize to it.

Kinds:
- ``auc_bins`` (`auc_state`): positive/negative counts bucketed over
  score-threshold bins of sigmoid(score); finalization is the
  rank/trapezoid form with in-bin ties counted half, exact up to bin
  collisions.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

DEFAULT_NUM_THRESHOLDS = 512


def is_mergeable_state(value: Any) -> bool:
    return isinstance(value, dict) and "kind" in value


def auc_state(scores, labels, num_thresholds: int = DEFAULT_NUM_THRESHOLDS) -> Dict:
    """One minibatch's mergeable AUC state on the tensors' device: each
    score (a logit) goes to bin floor(sigmoid(score) * T), clipped to
    [0, T - 1], in float32; `pos` and `neg` count the positive (label >
    0.5) and negative labels of each bin."""
    scores = torch.as_tensor(scores).reshape(-1)
    labels = torch.as_tensor(labels, device=scores.device).reshape(-1)
    p = torch.sigmoid(scores.to(torch.float32))
    idx = torch.clamp((p * num_thresholds).to(torch.int32), 0, num_thresholds - 1).long()
    pos = (labels > 0.5).to(torch.float32)
    zeros = torch.zeros(num_thresholds, dtype=torch.float32, device=scores.device)
    return {
        "kind": "auc_bins",
        "pos": zeros.index_add(0, idx, pos),
        "neg": zeros.index_add(0, idx, 1.0 - pos),
    }


def merge_metric_states(acc: Dict, state: Dict) -> Dict:
    """Elementwise-sum merge of two same-kind states (host side)."""
    if acc.get("kind") != state.get("kind"):
        raise ValueError(
            f"cannot merge metric kinds {acc.get('kind')!r} and "
            f"{state.get('kind')!r}"
        )
    out = {"kind": acc["kind"]}
    for k, v in acc.items():
        if k == "kind":
            continue
        out[k] = np.asarray(v, dtype=np.float64) + np.asarray(state[k], dtype=np.float64)
    return out


def finalize_metric_state(state: Dict) -> float:
    """Exact job-level scalar from an accumulated state."""
    kind = state.get("kind")
    if kind == "auc_bins":
        pos = np.asarray(state["pos"], dtype=np.float64)
        neg = np.asarray(state["neg"], dtype=np.float64)
        n_pos, n_neg = pos.sum(), neg.sum()
        if n_pos == 0 or n_neg == 0:
            return 0.5
        # P(score_pos > score_neg) + 0.5 P(tie), ties = same bin: each
        # bin's positives rank above the negatives of every lower bin
        # and tie with their own bin's negatives
        cum_neg_below = np.concatenate(([0.0], np.cumsum(neg)[:-1]))
        u = np.sum(pos * (cum_neg_below + 0.5 * neg))
        return float(u / (n_pos * n_neg))
    raise ValueError(f"unknown mergeable metric kind: {kind!r}")

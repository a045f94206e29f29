"""Mergeable evaluation-metric states (`elasticdl_tpu/api/metrics.py`).

A metric may return mergeable STATE instead of a scalar: a dict tagged
with a `kind`, which workers report per minibatch, the evaluation
service reduces by summation (`merge_metric_states`), and
`finalize_metric_state` turns into the exact job-level scalar at
completion. An average of per-batch AUCs is not the job's AUC; summed
threshold-bin counts finalize to it.

Kinds:
- ``auc_bins``: positive/negative counts bucketed over score-threshold
  bins; finalization is the rank/trapezoid form with in-bin ties counted
  half.

The per-batch state builder (`auc_state`) comes with the models that use
it (the deepfm zoo).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def is_mergeable_state(value: Any) -> bool:
    return isinstance(value, dict) and "kind" in value


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

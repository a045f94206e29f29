"""Layer helpers (the port's subset of the reference's tp_layers)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the feature dim, in x's dtype, as the reference
    computes it: x * rsqrt(mean(x^2) + eps) * w."""
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * weight

"""The image zoo's layers: the `flax.linen` layers that the reference's
image models use (`nn.Conv`, `nn.Dense`, `nn.BatchNorm`, `nn.max_pool`),
in plain torch ops.

Parameters keep the reference's tree, names and layouts, so the PS state
and the flat vector's leaf order equal the reference's: conv kernels are
HWIO, dense kernels [in, out], BatchNorm's `scale` and `bias` are
parameters and its `mean` and `var` are non-trainable state (buffers,
the reference's `batch_stats` collection). Each module permutes to
torch's layouts where it computes. Activations run NCHW between layers;
a model flattens in NHWC order (`flatten_nhwc`) before its dense layers,
as the reference's `x.reshape((B, -1))` does.

flax's semantics kept here:
- "SAME" padding is `lax.padtype_to_pads`: total = max((out - 1) *
  stride + window - size, 0), low = total // 2, high = the rest, so a
  stride-2 layer pads asymmetrically (`F.pad`, not `padding=`); max
  pooling pads with -inf;
- BatchNorm (`flax.linen.BatchNorm`, flax 0.12): in train mode it
  normalizes with the batch's statistics, computed in float32 whatever
  the compute dtype, the variance as E[x^2] - E[x]^2 clamped at 0
  (`use_fast_variance`), biased; the running statistics move by
  `momentum * running + (1 - momentum) * batch`. The new running
  statistics are not written into the buffers: the forward leaves them
  in `aux_out` and the caller decides (the reference's `mutable`
  collections). In eval mode it normalizes with the buffers;
- `compute_dtype` (flax's `dtype`): inputs and kernels are cast to it
  and the layer's output has it; parameters stay float32.

Init draws flax's distributions with numpy (jax.random's streams cannot
be reproduced): kernels `lecun_normal` (a normal truncated to +-2
standard deviations, scaled to variance 1 / fan_in), biases zeros,
BatchNorm scale ones (or zeros where a model asks for it), bias zeros,
mean zeros, var ones.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# the standard deviation of a standard normal truncated to (-2, 2)
_TRUNC_STD = 0.87962566103423978


def lecun_normal(rng: np.random.Generator, shape, fan_in: int) -> np.ndarray:
    """flax's default kernel init: truncated normal, variance 1 / fan_in."""
    z = rng.standard_normal(shape)
    bad = np.abs(z) >= 2.0
    while bad.any():
        z[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(z) >= 2.0
    return (z * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)).astype(np.float32)


def same_pads(size: int, window: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of flax's "SAME" along one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, window, strides, value: float = 0.0) -> torch.Tensor:
    (lo_h, hi_h), (lo_w, hi_w) = (
        same_pads(x.shape[2], window[0], strides[0]),
        same_pads(x.shape[3], window[1], strides[1]),
    )
    if lo_h or hi_h or lo_w or hi_w:
        x = F.pad(x, (lo_w, hi_w, lo_h, hi_h), value=value)
    return x


class Conv(nn.Module):
    """`nn.Conv(features, kernel_size, strides, padding="SAME")` over NCHW."""

    def __init__(self, in_features: int, features: int, kernel_size=(3, 3),
                 strides=(1, 1), use_bias: bool = True, compute_dtype=None):
        super().__init__()
        self.kernel_size, self.strides = tuple(kernel_size), tuple(strides)
        self.compute_dtype = compute_dtype
        self.kernel = nn.Parameter(torch.zeros(*self.kernel_size, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def init_leaves(self, rng) -> dict:
        kh, kw, cin, cout = self.kernel.shape
        out = {"kernel": lecun_normal(rng, (kh, kw, cin, cout), kh * kw * cin)}
        if self.bias is not None:
            out["bias"] = np.zeros(cout, np.float32)
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype or torch.promote_types(x.dtype, torch.float32)
        x = _pad_same(x.to(dtype), self.kernel_size, self.strides)
        w = self.kernel.to(dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
        y = F.conv2d(x, w, stride=self.strides)
        if self.bias is not None:
            y = y + self.bias.to(dtype)[:, None, None]
        return y


class Dense(nn.Module):
    """`nn.Dense(features)`: x @ kernel + bias, kernel [in, out]."""

    def __init__(self, in_features: int, features: int, compute_dtype=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.kernel = nn.Parameter(torch.zeros(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def init_leaves(self, rng) -> dict:
        cin, cout = self.kernel.shape
        return {"kernel": lecun_normal(rng, (cin, cout), cin),
                "bias": np.zeros(cout, np.float32)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype or torch.promote_types(x.dtype, torch.float32)
        return x.to(dtype) @ self.kernel.to(dtype) + self.bias.to(dtype)


class BatchNorm(nn.Module):
    """`nn.BatchNorm` over NCHW's channel axis; see the module docstring."""

    def __init__(self, features: int, momentum: float = 0.99, epsilon: float = 1e-5,
                 compute_dtype=None, scale_init_zero: bool = False):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.compute_dtype = compute_dtype
        self.scale_init_zero = scale_init_zero
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.aux_out: Optional[dict] = None  # {"mean", "var"} of the last train forward

    def init_leaves(self, rng) -> dict:
        n = self.scale.shape[0]
        scale = np.zeros(n, np.float32) if self.scale_init_zero else np.ones(n, np.float32)
        return {"scale": scale, "bias": np.zeros(n, np.float32)}

    def init_aux_leaves(self) -> dict:
        n = self.scale.shape[0]
        return {"mean": np.zeros(n, np.float32), "var": np.ones(n, np.float32)}

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        # statistics and the normalization in at least float32
        stat_dtype = torch.promote_types(x.dtype, torch.float32)
        if train:
            xf = x.to(stat_dtype)
            axes = (0, 2, 3)
            mean = xf.mean(axes)
            var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
            m = self.momentum
            self.aux_out = {
                "mean": (self.mean * m + mean * (1 - m)).detach(),
                "var": (self.var * m + var * (1 - m)).detach(),
            }
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = (x.to(stat_dtype) - mean[:, None, None]) * mul[:, None, None]
        y = y + self.bias[:, None, None]
        return y.to(self.compute_dtype or stat_dtype)


def max_pool(x: torch.Tensor, window=(2, 2), strides=(2, 2), padding: str = "VALID"):
    """`nn.max_pool` over NCHW; "SAME" pads with -inf."""
    if padding == "SAME":
        x = _pad_same(x, window, strides, value=-math.inf)
    return F.max_pool2d(x, tuple(window), tuple(strides))


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H * W * C] in the reference's NHWC order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC images (the records' layout) -> NCHW."""
    return x.permute(0, 3, 1, 2)


class ImageModel(nn.Module):
    """Base of the zoo's image models: the init and aux trees from the
    layers' own leaves, keyed by module names as flax keys them."""

    def init_params(self, seed: int = 0) -> dict:
        """The host parameter tree (float32 numpy) for `seed`."""
        return _tree(self, np.random.default_rng(seed), "init_leaves")

    def init_aux(self) -> dict:
        """The non-trainable collections: {"batch_stats": tree}, or {}."""
        stats = _tree(self, None, "init_aux_leaves")
        return {"batch_stats": stats} if stats else {}


def _tree(module: nn.Module, rng, method: str) -> dict:
    out = {}
    for name, child in module.named_children():
        if hasattr(child, method):
            leaves = getattr(child, method)(rng) if rng is not None else getattr(child, method)()
        elif hasattr(child, "init_leaves"):
            continue  # a layer without leaves of this kind
        else:
            leaves = _tree(child, rng, method)
        if leaves:
            out[name] = leaves
    return out


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean of `optax.softmax_cross_entropy_with_integer_labels`."""
    return F.cross_entropy(logits.to(torch.float32), labels.long())


def accuracy(predictions, labels) -> dict:
    """The zoo's `eval_metrics_fn`: {"accuracy": share of argmax hits}."""
    predictions, labels = torch.as_tensor(predictions), torch.as_tensor(labels)
    return {"accuracy": (predictions.argmax(-1) == labels).to(torch.float32).mean()}

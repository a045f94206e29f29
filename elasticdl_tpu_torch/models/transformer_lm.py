"""Flagship decoder-only transformer LM, single device.

The reference's `plain_forward` (dense branch) in PyTorch. Parameters
keep the reference's layout, so converting weights is a copy and the
flat vectors of both packages line up position for position:

    {"embed": [V, d], "head": [d, V], "ln_f": [d],
     "layers": {"ln1", "ln2": [n, d], "wq", "wk", "wv": [n, d, H*hd],
                "wo": [n, H*hd, d], "w1": [n, d, ff], "w2": [n, ff, d]}}

Every projection is `x @ w` with `w` as [in, out]. Numerics follow the
reference on purpose, quirks included:

- every parameter is cast to `cfg.dtype` first (embed and norm weights
  too), so logits come out in the compute dtype; only the
  cross-entropy runs in float32;
- RoPE builds its frequencies and positions in the activations' dtype:
  at bfloat16, positions above 256 round (1023 becomes 1024);
- the MLP activation is GELU with the tanh approximation (`jax.nn.gelu`'s
  default).

Rematerialization (`remat=True`) mirrors the reference's `_remat`: each
layer runs under `torch.utils.checkpoint.checkpoint` (non-reentrant), so
its activations are recomputed in the backward pass. `remat_policy=""`
recomputes the whole layer; `"dots"` is a selective-checkpoint policy
that saves the outputs of `aten.mm` (the six `x @ w` projections) and
recomputes everything else, as `jax.checkpoint_policies.
dots_with_no_batch_dims_saveable` saves the dots without batch dims and
recomputes the attention einsums and the Pallas call. The attention
kernels launch through ctypes, which no policy sees, so a recomputed
layer launches its forward kernel again: a step computed with remat
launches the forward kernel twice a layer, dq and dk+dv once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from elasticdl_tpu_torch.ops.flash_attention import attention
from elasticdl_tpu_torch.parallel.tp_layers import rms_norm


REMAT_POLICIES = ("", "dots")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 1024
    d_model: int = 128
    n_heads: int = 8
    d_ff: int = 512
    n_layers: int = 4
    n_experts: int = 0  # 0 = dense FFN; MoE is not ported yet
    n_micro: int = 2  # pipeline microbatches: one device runs no pipeline, so unread
    dtype: torch.dtype = torch.float32  # compute dtype
    remat: bool = False  # recompute each layer's activations in the backward pass
    remat_policy: str = ""  # "" (full) | "dots" (save the x @ w outputs)

    def __post_init__(self):
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(
                f"remat_policy {self.remat_policy!r} is not one of {REMAT_POLICIES}"
            )

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _check_dense(cfg: TransformerConfig):
    if cfg.n_experts:
        raise NotImplementedError(
            "MoE FFN layers (n_experts > 0) come with a later slice of the "
            "port (ROADMAP queue 1: MoE)"
        )


def init_params(rng: np.random.Generator, cfg: TransformerConfig) -> Dict:
    """Host-side init (numpy, float32), the reference's draws in its
    order: for one seed it gives the reference's parameters bit for bit."""
    _check_dense(cfg)

    def norm(*shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2] if len(shape) > 1 else shape[-1])
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    L, d, hd = cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.head_dim
    layers = {
        "ln1": np.ones((L, d), np.float32),
        "wq": norm(L, d, hd),
        "wk": norm(L, d, hd),
        "wv": norm(L, d, hd),
        "wo": norm(L, hd, d),
        "ln2": np.ones((L, d), np.float32),
        "w1": norm(L, d, cfg.d_ff),
        "w2": norm(L, cfg.d_ff, d),
    }
    return {
        "embed": norm(cfg.vocab, d, scale=0.02),
        "layers": layers,
        "ln_f": np.ones((d,), np.float32),
        "head": norm(d, cfg.vocab),
    }


def param_shapes(cfg: TransformerConfig) -> Dict:
    """The parameter tree's shapes (the tree `init_params` fills)."""
    L, d, hd = cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.head_dim
    return {
        "embed": (cfg.vocab, d),
        "head": (d, cfg.vocab),
        "ln_f": (d,),
        "layers": {
            "ln1": (L, d), "ln2": (L, d),
            "wq": (L, d, hd), "wk": (L, d, hd), "wv": (L, d, hd),
            "wo": (L, hd, d), "w1": (L, d, cfg.d_ff), "w2": (L, cfg.d_ff, d),
        },
    }


def _rope(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotary embedding; x: [B, L, H, D], positions: [L] global. The
    frequencies and angles are computed in x's dtype, as the reference
    does."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(half, dtype=x.dtype, device=x.device) / half))
    ang = positions.to(x.dtype)[:, None] * freqs[None, :]  # [L, half]
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _dots_contexts():
    """The "dots" policy's context pair: the outputs of `aten.mm` are
    saved, every other op is recomputed."""
    return create_selective_checkpoint_contexts([torch.ops.aten.mm.default])


def _layer_fn(cfg: TransformerConfig, names, positions):
    """One transformer block as a function of the residual stream h and
    the layer's parameters (in `names` order), so that checkpointing it
    takes the parameters as inputs and their gradients flow."""

    def layer(h, *weights):
        lp = dict(zip(names, weights))
        b, l = h.shape[:2]
        x = rms_norm(h, lp["ln1"])
        q = (x @ lp["wq"]).reshape(b, l, cfg.n_heads, cfg.head_dim)
        k = (x @ lp["wk"]).reshape(b, l, cfg.n_heads, cfg.head_dim)
        v = (x @ lp["wv"]).reshape(b, l, cfg.n_heads, cfg.head_dim)
        q, k = _rope(q, positions), _rope(k, positions)
        attn = attention(q, k, v, causal=True).reshape(b, l, -1)
        h = h + attn @ lp["wo"]
        x = rms_norm(h, lp["ln2"])
        return h + F.gelu(x @ lp["w1"], approximate="tanh") @ lp["w2"]

    return layer


def plain_forward(cfg: TransformerConfig, params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, L] int -> logits [B, L, vocab] in cfg.dtype. Attention
    goes through `ops.flash_attention.attention`: the Hopper kernels for
    CUDA tensors, their plain versions on the CPU. With `cfg.remat` each
    layer is checkpointed under `cfg.remat_policy`."""
    _check_dense(cfg)
    dt = cfg.dtype
    # F.embedding, not embed[tokens]: on the CPU, indexing's backward
    # (index_put_ with accumulate) sums repeated tokens in an order that
    # changes from run to run when torch runs more than one thread
    h = F.embedding(tokens, params["embed"].to(dt))  # [B, L, d]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    names = list(params["layers"])
    layer = _layer_fn(cfg, names, positions)
    remat_kw = {"context_fn": _dots_contexts} if cfg.remat_policy == "dots" else {}
    for weights in zip(*(params["layers"][k].to(dt).unbind(0) for k in names)):
        if cfg.remat:
            h = checkpoint(layer, h, *weights, use_reentrant=False, **remat_kw)
        else:
            h = layer(h, *weights)
    h = rms_norm(h, params["ln_f"].to(dt))
    return h @ params["head"].to(dt)


def token_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE in float32."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return torch.mean(logz - gold)


def reference_forward(cfg: TransformerConfig, params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    """Unfused reference in the params' own dtype: the [L, L] softmax is
    materialized, no cast to cfg.dtype (for equivalence tests)."""
    _check_dense(cfg)
    b, l = tokens.shape
    h = params["embed"][tokens]
    positions = torch.arange(l, device=tokens.device)
    names = list(params["layers"])
    for layer in zip(*(params["layers"][k].unbind(0) for k in names)):
        lp = dict(zip(names, layer))
        x = rms_norm(h, lp["ln1"])
        q = (x @ lp["wq"]).reshape(b, l, cfg.n_heads, cfg.head_dim)
        k = (x @ lp["wk"]).reshape(b, l, cfg.n_heads, cfg.head_dim)
        v = (x @ lp["wv"]).reshape(b, l, cfg.n_heads, cfg.head_dim)
        q, k = _rope(q, positions), _rope(k, positions)
        s = torch.einsum("blhd,bmhd->bhlm", q, k) / math.sqrt(cfg.head_dim)
        mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=s.device))
        s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
        p = torch.softmax(s, dim=-1)
        attn = torch.einsum("bhlm,bmhd->blhd", p, v).reshape(b, l, -1)
        h = h + attn @ lp["wo"]
        x = rms_norm(h, lp["ln2"])
        h = h + F.gelu(x @ lp["w1"], approximate="tanh") @ lp["w2"]
    h = rms_norm(h, params["ln_f"])
    return h @ params["head"]

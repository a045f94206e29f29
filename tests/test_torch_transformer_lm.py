"""The port's transformer (elasticdl_tpu_torch/models/transformer_lm.py)
against the reference's, from the same weights and tokens.

Tolerances: float32 logits and loss 1e-4, flat gradients 1e-5 absolute
(different attention blocking and summation order); bfloat16 compute
5e-2 absolute on logits and gradients relative to their scale, since the
two frameworks round intermediate bf16 results at different places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from elasticdl_tpu.common import codec as jcodec
from elasticdl_tpu.models import transformer_lm as jtlm
from elasticdl_tpu_torch.common import codec as tcodec
from elasticdl_tpu_torch.convert import params_from_jax
from elasticdl_tpu_torch.models import transformer_lm as ttlm
from _torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

SMALL = dict(vocab=64, d_model=64, n_heads=4, d_ff=128, n_layers=2)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfgs(dtype="float32"):
    return (
        jtlm.TransformerConfig(**SMALL, n_micro=1, dtype=JDT[dtype]),
        ttlm.TransformerConfig(**SMALL, dtype=TDT[dtype]),
    )


def _tokens(L, seed=0, b=2):
    return np.random.default_rng(seed).integers(0, SMALL["vocab"], (b, L + 1)).astype(np.int32)


def _jax_step(cfg, params, tokens):
    def loss_fn(p):
        logits, _aux = jtlm.plain_forward(cfg, p, tokens[:, :-1])
        return jtlm.token_cross_entropy(logits, tokens[:, 1:]), logits

    (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params)
    )
    return np.asarray(jnp.asarray(logits, jnp.float32)), float(loss), jcodec.ravel_np(grads)


def _torch_step(cfg, params, tokens):
    tree = params_from_jax(params)
    leaves = tcodec.tree_leaves(tree)
    for t in leaves:
        t.requires_grad_()
    tok = torch.from_numpy(tokens).long()
    logits, _aux = ttlm.plain_forward(cfg, tree, tok[:, :-1])
    loss = ttlm.token_cross_entropy(logits, tok[:, 1:])
    grads = torch.autograd.grad(loss, leaves)
    flat = torch.cat([g.reshape(-1) for g in grads]).numpy()
    return logits, float(loss.detach()), flat


def test_init_params_bit_equal_to_reference():
    jcfg, tcfg = _cfgs()
    want = jtlm.init_params(np.random.default_rng(7), jcfg)
    got = ttlm.init_params(np.random.default_rng(7), tcfg)
    assert tcodec.tree_flatten(got)[1] == tcodec.tree_flatten(want)[1]
    for g, w in zip(tcodec.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    shapes = ttlm.param_shapes(tcfg)
    for path, leaf in zip(tcodec.tree_paths(got), tcodec.tree_leaves(got)):
        node = shapes
        for key in path:
            node = node[key]
        assert tuple(node) == leaf.shape


@pytest.mark.parametrize("L", [128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_loss_grads_match_reference(dtype, L):
    jcfg, tcfg = _cfgs(dtype)
    params = jtlm.init_params(np.random.default_rng(1), jcfg)
    tokens = _tokens(L, seed=L)
    jl, jloss, jg = _jax_step(jcfg, params, tokens)
    tl, tloss, tg = _torch_step(tcfg, params, tokens)
    assert tl.dtype == TDT[dtype]  # params were cast to the compute dtype
    tl = tl.detach().float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
        assert abs(tloss - jloss) < 1e-4
        np.testing.assert_allclose(tg, jg, atol=1e-5, rtol=1e-3)
    else:
        np.testing.assert_allclose(tl, jl, atol=5e-2, rtol=5e-2)
        assert abs(tloss - jloss) < 5e-2
        scale = np.abs(jg).max()
        np.testing.assert_allclose(tg, jg, atol=5e-2 * scale)


def test_reference_forward_matches_reference():
    jcfg, tcfg = _cfgs()
    params = jtlm.init_params(np.random.default_rng(2), jcfg)
    tokens = _tokens(128, seed=2)[:, :-1]
    want = np.asarray(jtlm.reference_forward(jcfg, params, jnp.asarray(tokens)))
    got = ttlm.reference_forward(
        tcfg, params_from_jax(params), torch.from_numpy(tokens).long()
    )
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_hazard_gelu_is_the_tanh_approximation(monkeypatch):
    """jax.nn.gelu defaults to the tanh approximation: the port matches
    the reference, and the exact (erf) GELU would not."""
    jcfg, tcfg = _cfgs()
    params = jtlm.init_params(np.random.default_rng(3), jcfg)
    tokens = _tokens(128, seed=3)
    jl, _, _ = _jax_step(jcfg, params, tokens)
    tl, _, _ = _torch_step(tcfg, params, tokens)
    np.testing.assert_allclose(tl.detach().numpy(), jl, atol=1e-4, rtol=1e-4)
    exact = F.gelu
    monkeypatch.setattr(F, "gelu", lambda x, approximate="none": exact(x))
    el, _, _ = _torch_step(tcfg, params, tokens)
    assert not np.allclose(el.detach().numpy(), jl, atol=1e-4, rtol=1e-4)


def test_hazard_all_params_cast_before_the_forward():
    """plain_forward casts every leaf (embed and norm weights too) to the
    compute dtype: bf16 logits out, only the cross-entropy in f32."""
    _jcfg, tcfg = _cfgs("bfloat16")
    params = params_from_jax(ttlm.init_params(np.random.default_rng(4), tcfg))
    tok = torch.from_numpy(_tokens(128, seed=4)).long()
    logits, aux = ttlm.plain_forward(tcfg, params, tok[:, :-1])
    assert logits.dtype == torch.bfloat16
    assert aux.dtype == torch.bfloat16 and float(aux) == 0.0  # dense: no aux
    assert ttlm.token_cross_entropy(logits, tok[:, 1:]).dtype == torch.float32
    # the same forward from bf16-rounded master weights is identical:
    # nothing reads the f32 masters past the cast
    rounded = tcodec.tree_map(lambda t: t.to(torch.bfloat16).float(), params)
    assert torch.equal(logits, ttlm.plain_forward(tcfg, rounded, tok[:, :-1])[0])


def test_hazard_rope_positions_round_in_bf16():
    """RoPE builds positions and frequencies in x's dtype: at bf16 the
    position 1023 is 1024. The port reproduces the reference's quirk
    (ROADMAP queue 3) instead of fixing it."""
    assert torch.arange(1024).to(torch.bfloat16)[1023].item() == 1024.0
    x = np.random.default_rng(5).standard_normal((1, 1024, 2, 16)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jnp.asarray(jtlm._rope(jx, jnp.arange(1024)), jnp.float32))
    tx = torch.from_numpy(x).to(torch.bfloat16)
    got = ttlm._rope(tx, torch.arange(1024)).float().numpy()
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)
    # exact f32 positions would put late rows far from the reference
    exact = ttlm._rope(torch.from_numpy(x), torch.arange(1024)).numpy()
    assert np.abs(exact[:, 512:] - want[:, 512:]).max() > 0.5


def test_moe_configs_raise_until_ported():
    """MoE configs raised NotImplementedError until the port had MoE; now
    they build the reference's expert leaves in place of w1 and w2, and
    the forward runs (tests/test_torch_moe.py holds it to the reference)."""
    cfg = ttlm.TransformerConfig(**{**SMALL, "n_experts": 2, "d_expert": 32})
    params = ttlm.init_params(np.random.default_rng(0), cfg)
    layers = params["layers"]
    assert "w1" not in layers and "w2" not in layers
    L, d = SMALL["n_layers"], SMALL["d_model"]
    assert layers["router"].shape == (L, d, 2)
    assert layers["ew1"].shape == (L, 2, d, 32) and layers["ew2"].shape == (L, 2, 32, d)
    tok = torch.from_numpy(_tokens(64, seed=5)).long()
    logits, aux = ttlm.plain_forward(cfg, params_from_jax(params), tok[:, :-1])
    assert logits.shape == (2, 64, SMALL["vocab"]) and torch.isfinite(logits).all()
    assert aux.shape == () and 0.0 < float(aux) < L * 2  # E * sum(frac * prob) <= E a layer

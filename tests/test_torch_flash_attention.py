"""The port's attention (elasticdl_tpu_torch/ops/flash_attention.py)
against the reference's Pallas kernels in interpret mode and against the
materializing reference math.

On the CPU the port's wrappers run their plain versions, which compute
the kernels' function block by block with the kernels' rounding points
(p cast to v's dtype, ds to k's/q's). The CUDA kernels themselves are
held against these plain versions on the card by chip_smoke.py.

Tolerances: float32 paths 2e-5 (forward) and 5e-4 (gradients, the
reference test's own bound); bfloat16 operands 2e-2 absolute+relative,
about two bf16 ulps at the outputs' magnitude.
"""

import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.ops import flash_attention as jfa
from elasticdl_tpu_torch.ops import flash_attention as tfa
from _torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = dict(atol=2e-5, rtol=2e-5)
F32_GRAD = dict(atol=5e-4, rtol=5e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(L, dtype, b=2, h=2, d=16, seed=0):
    """q, k, v, do as (jax arrays, torch tensors) from one numpy draw."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, L, h, d)).astype(np.float32) for _ in range(4)]
    jx = [jnp.asarray(a, dtype=jdt) for a in arrs]
    tx = [torch.from_numpy(a).to(tdt) for a in arrs]
    return jx, tx


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _check_plain_forward(causal, L, dtype, d, seed):
    (jq, jk, jv, _), (tq, tk, tv, _) = _inputs(L, dtype, d=d, seed=seed)
    jo, jlse = jfa._flash_forward(jq, jk, jv, causal, interpret=True)
    to, tlse = tfa.plain_forward(tq, tk, tv, causal)
    assert to.dtype == tq.dtype and tlse.dtype == torch.float32
    tol = F32 if dtype == "float32" else BF16
    _close(to, jo, tol)
    # reference lse is [B*H, L, 1]; the port's [B, H, L]
    _close(tlse.reshape(-1, L, 1), jlse, tol)


def _check_plain_backward(causal, L, dtype, d, seed):
    """plain_dq / plain_dkv against the reference's dq and dk+dv
    kernels, fed the same o, lse and cotangent."""
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(L, dtype, d=d, seed=seed)
    jo, jlse = jfa._flash_forward(jq, jk, jv, causal, interpret=True)
    jdq, jdk, jdv = jfa._flash_backward(jq, jk, jv, jo, jlse, jdo, causal, interpret=True)
    _, tdt = DTYPES[dtype]
    to = torch.from_numpy(_np(jo)).to(tdt)
    tlse = torch.from_numpy(_np(jlse)).reshape(2, 2, L)
    delta = tfa.attention_delta(tdo, to)
    tdq = tfa.plain_dq(tq, tk, tv, tdo, tlse, delta, causal)
    tdk, tdv = tfa.plain_dkv(tq, tk, tv, tdo, tlse, delta, causal)
    tol = F32_GRAD if dtype == "float32" else BF16
    for got, want in ((tdq, jdq), (tdk, jdk), (tdv, jdv)):
        assert got.dtype == tdt and got.shape == tq.shape
        _close(got, want, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_forward_matches_pallas_kernel(causal, L, dtype):
    _check_plain_forward(causal, L, dtype, d=16, seed=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_pallas_kernels(causal, L, dtype):
    _check_plain_backward(causal, L, dtype, d=16, seed=1)


# head_dim 64, the only width the CUDA kernels take: the plain versions
# that chip_smoke.py holds the kernels against agree with the reference's
# Pallas kernels at the kernels' own width


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_forward_matches_pallas_kernel_at_kernel_width(causal, dtype):
    _check_plain_forward(causal, 256, dtype, d=tfa.HEAD_DIM, seed=6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_pallas_kernels_at_kernel_width(causal, dtype):
    _check_plain_backward(causal, 256, dtype, d=tfa.HEAD_DIM, seed=7)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_reference_vjp_at_half_empty_tile(causal):
    """plain_dq / plain_dkv against jax.vjp of the reference's
    materializing attention at [1, 192, 3, 64] float32: L a multiple of 64
    but not of 128, so a 128-row kernel tile is half empty, and B*H odd.
    chip_smoke.py holds the CUDA kernels against these plain versions at
    this shape; the Pallas kernels take only L % 128 == 0, so the
    reference's math is the counterpart here, and lse and o come from it
    too."""
    L = 192
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(L, "float32", b=1, h=3, d=64, seed=8)
    jo, vjp = jax.vjp(
        lambda q, k, v: jfa.reference_attention(q, k, v, causal=causal), jq, jk, jv
    )
    s = jnp.einsum("bqhd,bkhd->bhqk", jq, jk) / math.sqrt(64)
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((L, L), dtype=bool)), s, -1e30)
    lse = torch.from_numpy(_np(jax.nn.logsumexp(s, axis=-1)))  # [B, H, L]
    delta = tfa.attention_delta(tdo, torch.from_numpy(_np(jo)))
    got = (tfa.plain_dq(tq, tk, tv, tdo, lse, delta, causal),
           *tfa.plain_dkv(tq, tk, tv, tdo, lse, delta, causal))
    for g, want in zip(got, vjp(jdo)):
        assert g.dtype == torch.float32 and g.shape == tq.shape
        _close(g, want, F32_GRAD)


def test_every_tensor_core_kernel_is_held_to_no_spills():
    """chip_smoke.py fails a run whose tensor-core kernels spill: each
    `__global__ ..._bf16_kernel` of the CUDA source is in its NO_SPILL."""
    import chip_smoke

    with open(os.path.join(REPO, "elasticdl_tpu_torch", "ops", "csrc", "flash_attention.cu")) as f:
        names = re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(", f.read()
        )
    assert {"fa_fwd_kernel", "fa_dq_kernel", "fa_dkv_kernel"} <= set(names)
    tensor_core = {n for n in names if n.endswith("_bf16_kernel")}
    assert "fa_dq_bf16_kernel" in tensor_core
    assert tensor_core <= set(chip_smoke.NO_SPILL)


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_matches_reference_vjp(causal, L=128):
    """flash_attention (autograd Function over the wrappers) against
    jax.vjp of the reference's flash_attention and of the plain math."""
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(L, "float32", seed=2)
    jo, vjp = jax.vjp(
        lambda q, k, v: jfa.flash_attention(q, k, v, causal=causal, interpret=True),
        jq, jk, jv,
    )
    jgrads = vjp(jdo)
    ref_grads = jax.vjp(
        lambda q, k, v: jfa.reference_attention(q, k, v, causal=causal), jq, jk, jv
    )[1](jdo)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    to = tfa.flash_attention(*leaves, causal=causal)
    tgrads = torch.autograd.grad(to, leaves, tdo)
    _close(to, jo, F32)
    for got, want, ref in zip(tgrads, jgrads, ref_grads):
        _close(got, want, F32_GRAD)
        _close(got, ref, F32_GRAD)


def test_multi_block_causality():
    """A query in an earlier block ignores later keys: perturbing the
    last position changes only the last output (4 port blocks deep)."""
    _, (q, k, v, _) = _inputs(256, "float32", seed=3)
    o1 = tfa.attention(q, k, v, causal=True)
    k2, v2 = k.clone(), v.clone()
    k2[:, -1], v2[:, -1] = 100.0, -100.0
    o2 = tfa.attention(q, k2, v2, causal=True)
    np.testing.assert_allclose(_np(o1[:, :-1]), _np(o2[:, :-1]), **F32)
    assert not np.allclose(_np(o1[:, -1]), _np(o2[:, -1]))


def test_attention_matches_reference_math_ragged_length_on_cpu():
    """On the CPU the dispatcher takes any L (the plain versions' last
    block may be short) and matches the materializing math."""
    (jq, jk, jv, _), (tq, tk, tv, _) = _inputs(200, "float32", seed=4)
    _close(tfa.attention(tq, tk, tv), jfa.reference_attention(jq, jk, jv), F32)
    _close(tfa.attention(tq, tk, tv), tfa.reference_attention(tq, tk, tv), F32)


def test_wrappers_use_plain_versions_only_for_cpu_tensors():
    _, (q, k, v, do) = _inputs(128, "float32", seed=5)
    before = (tfa.flash_forward.launches, tfa.flash_dq.launches, tfa.flash_dkv.launches)
    o, lse = tfa.flash_forward(q, k, v, True)
    delta = tfa.attention_delta(do, o)
    tfa.flash_dq(q, k, v, do, lse, delta, True)
    tfa.flash_dkv(q, k, v, do, lse, delta, True)
    # CPU calls launch nothing
    assert (tfa.flash_forward.launches, tfa.flash_dq.launches, tfa.flash_dkv.launches) == before
    # any other device must reach the kernel path, which refuses it
    meta = [x.to("meta") for x in (q, k, v, do)]
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_forward(*meta[:3], True)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_dq(*meta, lse.to("meta"), delta.to("meta"), True)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_dkv(*meta, lse.to("meta"), delta.to("meta"), True)

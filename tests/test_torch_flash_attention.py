"""The port's attention (elasticdl_tpu_torch/ops/flash_attention.py)
against the reference's Pallas kernels in interpret mode and against the
materializing reference math.

On the CPU the port's wrappers run their plain versions, which compute
the kernels' function block by block with the kernels' rounding points
(p cast to v's dtype, ds to k's/q's). The CUDA kernels themselves are
held against these plain versions on the card by chip_smoke.py.

Tolerances: float32 paths 2e-5 (forward) and 5e-4 (gradients, the
reference test's own bound); bfloat16 operands 2e-2 absolute+relative,
about two bf16 ulps at the outputs' magnitude. The same at every head
dim (16, 32, 64, 128).
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


# head_dim 16 and 32: the zoo's default model (d_model 64 / 4 heads) and
# the reference's own kernel tests (tests/test_flash_attention.py)


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_forward_matches_pallas_kernel(causal, L, dtype, d):
    _check_plain_forward(causal, L, dtype, d=d, seed=0)


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_pallas_kernels(causal, L, dtype, d):
    _check_plain_backward(causal, L, dtype, d=d, seed=1)


# head_dim 64 and 128, the widths the CUDA kernels take: the plain
# versions that chip_smoke.py holds the kernels against agree with the
# reference's Pallas kernels at the kernels' own widths


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_forward_matches_pallas_kernel_at_kernel_width(causal, dtype):
    _check_plain_forward(causal, 256, dtype, d=64, seed=6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_pallas_kernels_at_kernel_width(causal, dtype):
    _check_plain_backward(causal, 256, dtype, d=64, seed=7)


# head_dim 128: the large config's width (d_model 1024, 8 heads)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_forward_matches_pallas_kernel_at_head_dim_128(causal, L, dtype):
    _check_plain_forward(causal, L, dtype, d=128, seed=9)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_pallas_kernels_at_head_dim_128(causal, L, dtype):
    _check_plain_backward(causal, L, dtype, d=128, seed=10)


def _float64_forward(q, k, v, causal):
    """o of softmax(q k^T / sqrt(D)) v in float64 numpy, [B, L, H, D]."""
    q, k, v = (np.asarray(x, np.float64).transpose(0, 2, 1, 3) for x in (q, k, v))
    s = q @ k.transpose(0, 1, 3, 2) / math.sqrt(q.shape[-1])
    if causal:
        L = s.shape[-1]
        s = np.where(np.tril(np.ones((L, L), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return ((p / p.sum(-1, keepdims=True)) @ v).transpose(0, 2, 1, 3)


def test_each_side_of_the_causal_f32_d16_case_is_near_float64():
    """The case that once failed under load (causal, L = 128, float32,
    D = 16, seed 0: 80 of 8,192 outputs 6.49e-5 apart): each side alone
    against float64 math, so a recurrence names the side that moved.
    Both sit near 4.0e-7 here; the limit, 1e-5, is 25x that and 6x below
    the failure's gap. (The first-order worst case for two correct f32
    evaluations over 128 keys at D = 16 and these inputs is ~2.4e-4,
    so the comparison's 2e-5 holds only because rounding errors cancel.)"""
    (jq, jk, jv, _), (tq, tk, tv, _) = _inputs(128, "float32", d=16, seed=0)
    want = _float64_forward(_np(tq), _np(tk), _np(tv), True)
    jo, _jlse = jfa._flash_forward(jq, jk, jv, True, interpret=True)
    to, _tlse = tfa.plain_forward(tq, tk, tv, True)
    errs = {side: float(np.abs(_np(o).astype(np.float64) - want).max())
            for side, o in (("reference pallas", jo), ("port plain", to))}
    assert max(errs.values()) <= 1e-5, errs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_versions_do_not_depend_on_the_thread_count(dtype):
    """The plain forward and backward give the same bits on 1, 2, 3 and 8
    intra-op threads (so a load that changes the threads torch gets
    cannot move them against the reference's kernels)."""
    (_, _, _, _), (tq, tk, tv, tdo) = _inputs(128, dtype, d=16, seed=0)
    n = torch.get_num_threads()
    outs = []
    try:
        for threads in (1, 2, 3, 8):
            torch.set_num_threads(threads)
            o, lse = tfa.plain_forward(tq, tk, tv, True)
            delta = tfa.attention_delta(tdo, o)
            dq = tfa.plain_dq(tq, tk, tv, tdo, lse, delta, True)
            dk, dv = tfa.plain_dkv(tq, tk, tv, tdo, lse, delta, True)
            outs.append([_np(x).tobytes() for x in (o, lse, dq, dk, dv)])
    finally:
        torch.set_num_threads(n)
    assert all(out == outs[0] for out in outs)


def test_kernel_head_dims_are_the_reference_configs_widths():
    """The CUDA kernels take the head dims of the zoo's default model (64
    / 4 heads), the reference's kernel tests (32), and its base (512 / 8
    heads) and large (1024 / 8 heads) transformer configs; other head dims
    run on the card through the dispatcher's fallback."""
    assert tfa.HEAD_DIMS == (16, 32, 64, 128)
    for d in (64 // 4, 32, 512 // 8, 1024 // 8):
        assert d in tfa.HEAD_DIMS
    for d in tfa.HEAD_DIMS:
        assert tfa.kernels_take((2, 128, 4, d), torch.bfloat16)
    for d in (8, 96, 256):
        assert not tfa.kernels_take((2, 128, 4, d), torch.bfloat16)


@pytest.mark.parametrize("params", [{}, {"dtype": "bfloat16"}])
def test_zoo_default_model_reaches_the_kernels(params, monkeypatch):
    """The zoo's `custom_model()` with no params (and with bf16 compute)
    hands the attention dispatcher q, k, v that the kernels take, at
    b8 x s1024 (chip_smoke.py's zoo path): on the card it runs the kernels
    at head dim 16, not the fallback."""
    from elasticdl_tpu_torch.convert import params_from_jax
    from elasticdl_tpu_torch.models import transformer_lm, transformer_lm_zoo

    model = transformer_lm_zoo.custom_model(**params)
    seen = []

    def recording(q, k, v, causal=True):
        seen.append((tuple(q.shape), q.dtype))
        return tfa.attention(q, k, v, causal)

    monkeypatch.setattr(transformer_lm, "attention", recording)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, model.cfg.vocab, (8, 1024)))
    with torch.no_grad():
        transformer_lm.plain_forward(model.cfg, params_from_jax(model.init_params(0)), tokens)
    assert len(seen) == model.cfg.n_layers
    for shape, dtype in seen:
        assert shape == (8, 1024, 4, 16)
        assert dtype == (torch.bfloat16 if params else torch.float32)
        assert tfa.kernels_take(shape, dtype)


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


def _ptxas_log(instantiations, spill=0):
    """ptxas -v lines, as nvcc prints them, for each (kernel, head dim)."""
    lines = []
    for name, d in instantiations:
        entry = f"_ZN39_GLOBAL__N__0a1b2c3d_18_flash_attention_cu_1{len(name)}{name}ILi{d}EEEvPKf"
        lines += [
            f"ptxas info    : Compiling entry function '{entry}' for 'sm_90a'",
            f"ptxas info    : Function properties for {entry}",
            f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads",
            "ptxas info    : Used 128 registers, used 1 barriers",
        ]
    return "\n".join(lines)


def test_ptxas_check_needs_every_tensor_core_instantiation():
    """chip_smoke.py's check of ptxas's report fails when a tensor-core
    kernel has no instantiation at one of the head dims (16 and 32 as
    well as 64 and 128) or one of them spills."""
    import chip_smoke

    every = [(n, d) for n in chip_smoke.NO_SPILL for d in tfa.HEAD_DIMS]
    regs = chip_smoke.check_ptxas(_ptxas_log(every))
    assert sorted(regs) == sorted(every) and set(regs.values()) == {128}
    for gone in (("fa_dq_bf16_kernel", 16), ("fa_fwd_bf16_kernel", 32)):
        with pytest.raises(AssertionError, match="no registers"):
            chip_smoke.check_ptxas(_ptxas_log([x for x in every if x != gone]))
    with pytest.raises(AssertionError, match="spills"):
        chip_smoke.check_ptxas(_ptxas_log(every[:3]) + "\n"
                               + _ptxas_log([("fa_dkv_bf16_kernel", 16)], spill=8))


def _every_held():
    import chip_smoke

    return [(n, d) for n in chip_smoke.NO_SPILL for d in tfa.HEAD_DIMS]


def test_ptxas_check_fails_on_a_missing_float32_dq_instantiation():
    """chip_smoke.py's check of ptxas's report holds the float32 backward
    kernels too: without `fa_dq_kernel` at D = 32 it fails."""
    import chip_smoke

    assert {"fa_dq_kernel", "fa_dkv_kernel"} <= set(chip_smoke.NO_SPILL)
    chip_smoke.check_ptxas(_ptxas_log(_every_held()))
    with pytest.raises(AssertionError, match=r"no registers for \[\('fa_dq_kernel', 32\)\]"):
        chip_smoke.check_ptxas(_ptxas_log([x for x in _every_held() if x != ("fa_dq_kernel", 32)]))


def test_ptxas_check_fails_on_a_spilling_float32_dkv():
    """A spilling `fa_dkv_kernel` at D = 16 fails the check, wherever in
    the report it stands."""
    import chip_smoke

    log = "\n".join(
        _ptxas_log([x], spill=4 if x == ("fa_dkv_kernel", 16) else 0) for x in _every_held()
    )
    with pytest.raises(AssertionError, match="fa_dkv_kernelILi16E.* spills"):
        chip_smoke.check_ptxas(log)


def test_ptxas_check_fails_on_a_spilling_float32_forward():
    """`fa_fwd_kernel`, the float32 forward, is held to no spills like the
    other kernels: a spilling instantiation at any head dim fails the
    check."""
    import chip_smoke

    assert "fa_fwd_kernel" in chip_smoke.NO_SPILL
    for d in tfa.HEAD_DIMS:
        log = "\n".join(
            _ptxas_log([x], spill=8 if x == ("fa_fwd_kernel", d) else 0) for x in _every_held()
        )
        with pytest.raises(AssertionError, match=f"fa_fwd_kernelILi{d}E.* spills"):
            chip_smoke.check_ptxas(log)


def test_ptxas_check_fails_on_a_missing_float32_forward_instantiation():
    """Without `fa_fwd_kernel` at D = 128 the check fails."""
    import chip_smoke

    with pytest.raises(AssertionError, match=r"no registers for \[\('fa_fwd_kernel', 128\)\]"):
        chip_smoke.check_ptxas(
            _ptxas_log([x for x in _every_held() if x != ("fa_fwd_kernel", 128)]))


def test_bound_counts_the_exponentials():
    """chip_smoke.py's bound per kernel is the largest of three terms:
    the products, the bytes and the exp2s (one per visible (q, k) pair,
    and in the forward one per row and 64-column k tile it visits). At the
    H100 SXM's rate (132 SMs x 16 a clock x 1980 MHz) the exponentials
    bind every kernel at head dim 16 (b8 x s1024, 32 heads); at 64 (8
    heads) the forward stays bound by bytes and the backward by products."""
    import chip_smoke

    # 1 x 1 x 128 causal: 8256 visible pairs; rows 0-63 visit one k tile,
    # rows 64-127 two
    ops, nbytes, exps = chip_smoke.bounds(1, 128, 1, 16)["flash_forward"]
    assert (ops, exps) == (2 * 2 * 16 * 8256, 8256 + 64 + 128)
    assert chip_smoke.bounds(1, 128, 1, 16)["flash_dq"][2] == 8256
    assert chip_smoke.bounds(1, 128, 1, 16, causal=False)["flash_forward"][2] == 128 * 128 + 256
    rate = 132 * chip_smoke.SFU_PER_SM_CLOCK * 1980e6
    binds = {}
    for d, (b, L, h) in ((16, chip_smoke.TIMED_16), (64, (8, 1024, 8))):
        for name, (ops, nbytes, exps) in chip_smoke.bounds(b, L, h, d).items():
            terms = chip_smoke.bound_terms(ops, nbytes, exps, rate)
            binds[name, d] = max(terms, key=terms.get)
    assert binds == {
        ("flash_forward", 16): "exp", ("flash_dq", 16): "exp", ("flash_dkv", 16): "exp",
        ("flash_forward", 64): "bytes", ("flash_dq", 64): "products",
        ("flash_dkv", 64): "products",
    }


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
    before = tfa.launch_counts()
    o, lse = tfa.flash_forward(q, k, v, True)
    delta = tfa.attention_delta(do, o)
    tfa.flash_dq(q, k, v, do, lse, delta, True)
    tfa.flash_dkv(q, k, v, do, lse, delta, True)
    # CPU calls launch nothing
    assert tfa.launch_counts() == before
    # any other device must reach the kernel path, which refuses it
    meta = [x.to("meta") for x in (q, k, v, do)]
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_forward(*meta[:3], True)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_dq(*meta, lse.to("meta"), delta.to("meta"), True)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_dkv(*meta, lse.to("meta"), delta.to("meta"), True)


def test_launch_counts_are_kept_per_kernel_and_head_dim():
    """Each wrapper counts its launches under the head dim it launched
    at; `launch_counts` names them f"{wrapper}_d{head dim}"."""
    tfa.reset_launch_counts()
    names = ("flash_forward", "flash_dq", "flash_dkv")
    assert tfa.launch_counts() == {f"{n}_d{d}": 0 for n in names for d in (16, 32, 64, 128)}
    tfa.flash_dq.launches[128] += 2
    tfa.flash_forward.launches[16] += 3
    tfa.flash_dkv.launches[32] += 1
    counts = tfa.launch_counts()
    assert counts["flash_dq_d128"] == 2 and counts["flash_forward_d16"] == 3
    assert counts["flash_dkv_d32"] == 1 and sum(counts.values()) == 6
    tfa.reset_launch_counts()
    assert not any(tfa.launch_counts().values())

"""Fused causal attention on hand-written Hopper kernels (fwd + bwd).

The hot op of the flagship transformer (models/transformer_lm.py) is
softmax(QK^T)V over [B, L, H, D] tensors. Three CUDA kernels in
`csrc/flash_attention.cu` replace the reference's three Pallas TPU
kernels (elasticdl_tpu/ops/flash_attention.py):

| wrapper         | bfloat16 kernel      | float32 kernel  | replaces                        |
| --------------- | -------------------- | --------------- | ------------------------------- |
| `flash_forward` | `fa_fwd_bf16_kernel` | `fa_fwd_kernel` | `_fa_kernel` (:79), forward     |
| `flash_dq`      | `fa_dq_bf16_kernel`  | `fa_dq_kernel`  | `_dq_kernel` (:161), dq         |
| `flash_dkv`     | `fa_dkv_bf16_kernel` | `fa_dkv_kernel` | `_dkv_kernel` (:204), dk and dv |

The forward keeps the [L, L] scores out of device memory with the
online-softmax accumulator and also writes lse = m + log l; the backward
re-forms p = exp(s - lse) blockwise from O(L D) residuals.

Each wrapper launches its kernel for CUDA tensors (and counts the launch
under the head dim in its `launches` dict; `launch_counts` reads all
three) or raises; for CPU tensors, and only for
them, it runs its plain PyTorch version (`plain_forward`, `plain_dq`,
`plain_dkv`), which computes the same function block by block with the
kernel's rounding points. `flash_attention` is the autograd Function
over the three; `attention` is the dispatcher model code calls: on the
card it sends the shapes the kernels take to them (`kernels_take`) and
every other shape to the materializing `reference_attention`, counting
each such call in `attention.fallbacks`.

Layout: [B, L, H, D] ("blhd"); compute is float32, operands float32 or
bfloat16. The kernels take D in HEAD_DIMS (64 and 128) and L a multiple
of BLOCK. The C entry points pick a kernel by dtype: for bfloat16 all
three run their products on the tensor cores, for float32 all three stay
on the CUDA cores (the tensor cores would round f32 to TF32); each kernel
is a template on D, instantiated for both head dims.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

BLOCK = 64  # rows per kernel tile (q and k)
HEAD_DIMS = (64, 128)  # the kernels' head dims
_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reference_attention(q, k, v, causal: bool = True):
    """Materializing attention in the operands' dtype, [B, L, H, D]."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    if causal:
        L = q.shape[1]
        mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
        s = torch.where(mask[None, None], s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


# ------------------------------------------------------------ plain versions


def _heads(x: torch.Tensor) -> torch.Tensor:
    """[B, L, H, D] -> [B, H, L, D] float32."""
    return x.permute(0, 2, 1, 3).to(torch.float32)


def _unheads(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(dtype).permute(0, 2, 1, 3).contiguous()


def _rounded(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to dtype's precision, back in float32 (the kernels'
    casts of p and ds to the operand dtype)."""
    return x.to(dtype).to(torch.float32)


def _scores(qf, kf_blk, q_pos, k_pos, causal: bool, scale: float):
    s = (qf @ kf_blk.transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(q_pos[:, None] < k_pos[None, :], _NEG_INF)
    return s


def plain_forward(q, k, v, causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise online-softmax forward: (o [B, L, H, D] in q's dtype,
    lse float32 [B, H, L]). Any L; the last block may be short."""
    b, L, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf = _heads(q), _heads(k), _heads(v)
    pos = torch.arange(L, device=q.device)
    m = torch.full((b, h, L, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for c0 in range(0, L, BLOCK):
        c1 = min(c0 + BLOCK, L)
        s = _scores(qf, kf[:, :, c0:c1], pos, pos[c0:c1], causal, scale)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + _rounded(p, v.dtype) @ vf[:, :, c0:c1]
        m = m_new
    return _unheads(acc / l, q.dtype), (m + torch.log(l))[..., 0]


def _backward_blocks(q, k, v, do, lse, delta, causal: bool):
    """Per k block: (c0, c1, p, ds), p and ds float32 [B, H, L, c1-c0]."""
    L, d = q.shape[1], q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = _heads(q), _heads(k), _heads(v), _heads(do)
    pos = torch.arange(L, device=q.device)
    for c0 in range(0, L, BLOCK):
        c1 = min(c0 + BLOCK, L)
        s = _scores(qf, kf[:, :, c0:c1], pos, pos[c0:c1], causal, scale)
        p = torch.exp(s - lse[..., None])
        dp = dof @ vf[:, :, c0:c1].transpose(-1, -2)
        yield c0, c1, p, p * (dp - delta[..., None]) * scale


def plain_dq(q, k, v, do, lse, delta, causal: bool = True) -> torch.Tensor:
    """dq = sum over k blocks of ds @ k, ds rounded to k's dtype."""
    kf = _heads(k)
    dq = torch.zeros_like(_heads(q))
    for c0, c1, _p, ds in _backward_blocks(q, k, v, do, lse, delta, causal):
        dq += _rounded(ds, k.dtype) @ kf[:, :, c0:c1]
    return _unheads(dq, q.dtype)


def plain_dkv(q, k, v, do, lse, delta, causal: bool = True):
    """(dk, dv): dv = p^T @ do with p rounded to do's dtype, dk =
    ds^T @ q with ds rounded to q's dtype, per k block."""
    qf, dof = _heads(q), _heads(do)
    dks, dvs = [], []
    for _c0, _c1, p, ds in _backward_blocks(q, k, v, do, lse, delta, causal):
        dvs.append(_rounded(p, do.dtype).transpose(-1, -2) @ dof)
        dks.append(_rounded(ds, q.dtype).transpose(-1, -2) @ qf)
    return _unheads(torch.cat(dks, dim=2), k.dtype), _unheads(torch.cat(dvs, dim=2), v.dtype)


# ----------------------------------------------------------- CUDA wrappers


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from elasticdl_tpu_torch.ops import build

    lib = build.load("flash_attention")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    shape = [i32, i32, i32, i32, i32, f32, i32, ptr]  # B L H D causal scale dtype stream
    lib.edl_fa_fwd.argtypes = [ptr] * 5 + shape
    lib.edl_fa_dq.argtypes = [ptr] * 7 + shape
    lib.edl_fa_dkv.argtypes = [ptr] * 8 + shape
    lib.edl_fa_blocks_per_sm.argtypes = [i32, i32, i32]  # kernel, D, dtype
    for fn in (lib.edl_fa_fwd, lib.edl_fa_dq, lib.edl_fa_dkv, lib.edl_fa_blocks_per_sm):
        fn.restype = ctypes.c_int
    return lib


def _check_operands(*ts: torch.Tensor):
    """The kernels take CUDA tensors of one float dtype, contiguous
    [B, L, H, D] with D in HEAD_DIMS and L % BLOCK == 0, all of one
    shape, 16-byte-aligned (the bfloat16 kernels copy 16-byte chunks)."""
    q = ts[0]
    if q.device.type != "cuda":
        raise ValueError(f"flash-attention kernels need CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash-attention kernels take float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or q.shape[-1] not in HEAD_DIMS or q.shape[1] % BLOCK:
        raise ValueError(
            f"flash-attention kernels take [B, L, H, D] with D in {HEAD_DIMS} and "
            f"L % {BLOCK} == 0, got {tuple(q.shape)}"
        )
    for t in ts:
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError("q, k, v (and do) must share device, dtype and shape")
        if not t.is_contiguous():
            raise ValueError("flash-attention kernels take contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("flash-attention kernels take 16-byte-aligned tensors")


def _check_rows(q: torch.Tensor, *rows: torch.Tensor):
    b, L, h, _ = q.shape
    for r in rows:
        if r.dtype != torch.float32 or r.shape != (b, h, L) or not r.is_contiguous():
            raise ValueError("lse and delta must be contiguous float32 [B, H, L]")
        if r.device != q.device:
            raise ValueError("lse and delta must lie on q's device")
        if r.data_ptr() % 16:
            raise ValueError("lse and delta must be 16-byte-aligned")


def _launch(fn, what: str, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {rc}")


def _shape_args(q: torch.Tensor, causal: bool):
    b, L, h, d = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return (b, L, h, d, int(causal), 1.0 / math.sqrt(d), _DTYPE_CODE[q.dtype], stream)


def flash_forward(q, k, v, causal: bool = True):
    """(o [B, L, H, D], lse float32 [B, H, L])."""
    if q.device.type == "cpu":
        return plain_forward(q, k, v, causal)
    _check_operands(q, k, v)
    b, L, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, L), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch(
            _lib().edl_fa_fwd, "flash forward",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            *_shape_args(q, causal),
        )
    flash_forward.launches[q.shape[-1]] += 1
    return o, lse


flash_forward.launches = dict.fromkeys(HEAD_DIMS, 0)


def flash_dq(q, k, v, do, lse, delta, causal: bool = True):
    """dq [B, L, H, D] in q's dtype."""
    if q.device.type == "cpu":
        return plain_dq(q, k, v, do, lse, delta, causal)
    _check_operands(q, k, v, do)
    _check_rows(q, lse, delta)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _launch(
            _lib().edl_fa_dq, "flash dq",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *_shape_args(q, causal),
        )
    flash_dq.launches[q.shape[-1]] += 1
    return dq


flash_dq.launches = dict.fromkeys(HEAD_DIMS, 0)


def flash_dkv(q, k, v, do, lse, delta, causal: bool = True):
    """(dk, dv) [B, L, H, D] in k's and v's dtype."""
    if q.device.type == "cpu":
        return plain_dkv(q, k, v, do, lse, delta, causal)
    _check_operands(q, k, v, do)
    _check_rows(q, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        _launch(
            _lib().edl_fa_dkv, "flash dk+dv",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_shape_args(q, causal),
        )
    flash_dkv.launches[q.shape[-1]] += 1
    return dk, dv


flash_dkv.launches = dict.fromkeys(HEAD_DIMS, 0)


def launch_counts() -> dict:
    """{f"{wrapper}_d{head dim}": launches} of the three wrappers."""
    return {
        f"{w.__name__}_d{d}": n
        for w in (flash_forward, flash_dq, flash_dkv)
        for d, n in w.launches.items()
    }


def reset_launch_counts():
    """Every wrapper's launch counts to 0."""
    for w in (flash_forward, flash_dq, flash_dkv):
        w.launches = dict.fromkeys(HEAD_DIMS, 0)


def blocks_per_sm(kernel: str, head_dim: int, dtype) -> int:
    """Blocks of `kernel` ("flash_forward", "flash_dq" or "flash_dkv") at
    `head_dim` and `dtype` that one SM of the current card holds at once,
    by CUDA's occupancy calculator (registers, shared memory, threads)."""
    which = ("flash_forward", "flash_dq", "flash_dkv").index(kernel)
    n = _lib().edl_fa_blocks_per_sm(which, head_dim, _DTYPE_CODE[dtype])
    if n < 0:
        raise RuntimeError(f"occupancy query for {kernel} failed: cudaError_t {-n}")
    return n


def attention_delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(do * o) in float32, [B, H, L] (a plain torch op,
    as the reference leaves it to XLA)."""
    return (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()


class FlashAttention(torch.autograd.Function):
    """Forward kernel; backward = dq kernel + dk/dv kernel from the
    O(L D) residuals (q, k, v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = attention_delta(do, o)
        dq = flash_dq(q, k, v, do, lse, delta, ctx.causal)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = True):
    """Differentiable fused attention, [B, L, H, D] -> [B, L, H, D]."""
    return FlashAttention.apply(q, k, v, causal)


def kernels_take(shape, dtype) -> bool:
    """Whether the CUDA kernels take q, k, v of this shape and dtype:
    [B, L, H, D] with D in HEAD_DIMS and L % BLOCK == 0, float32 or
    bfloat16. By shape and dtype alone, so the choice needs no card."""
    return (
        len(shape) == 4
        and shape[-1] in HEAD_DIMS
        and shape[1] % BLOCK == 0
        and dtype in _DTYPE_CODE
    )


def attention(q, k, v, causal: bool = True):
    """Dispatcher, the single entry point for model code. CPU tensors run
    the kernels' plain versions for any shape. CUDA tensors run the
    Hopper kernels when `kernels_take` their shape; any other shape runs
    `reference_attention` on the card, as the reference's dispatcher
    runs XLA's materializing path for shapes its kernels do not take,
    and counts one fallback in `attention.fallbacks`. The wrappers
    themselves still raise on a shape they do not take, and a build or
    launch failure raises from them."""
    if q.device.type == "cuda" and not kernels_take(tuple(q.shape), q.dtype):
        attention.fallbacks += 1
        return reference_attention(q, k, v, causal)
    return flash_attention(q, k, v, causal)


attention.fallbacks = 0

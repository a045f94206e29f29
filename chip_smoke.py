"""On-card smoke run of the PyTorch/H100 port (`elasticdl_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero on any failure and prints
its result lines only when every phase passed:

1. the card's name and power limit (`nvidia-smi`);
2. builds the attention kernels from `elasticdl_tpu_torch/ops/csrc/`,
   prints ptxas's register, shared-memory and spill lines, and fails if
   an instantiation of a tensor-core kernel spills or is missing at a
   head dim (64, 128);
3. holds each kernel against its plain PyTorch version on the card at
   both head dims (`KERNEL_CHECKS`): at each slice's shape in bfloat16
   (the base transformer's [8, 1024, 8, 64], the large config's
   [16, 1024, 8, 128]) for three input seeds, at a small shape in
   float32, and at [1, 192, 3, D] (L a multiple of 64 but not of 128,
   B*H odd) in both dtypes, causal and not, under a limit per output
   (bf16 gradients may also differ by two rounding flips of a row's
   largest term, `exact_backward`, and must be as close to the float64
   function in root mean square as the plain version, `BF16_RMS_RATIO`);
   each backward check runs once on the plain forward's lse and once on
   the kernel's own lse and o. Times kernel,
   plain version and the library yardsticks at each slice's shape, which
   the port never calls: `F.scaled_dot_product_attention` for the
   forward, and one call of aten's flash-attention backward (dq, dk and
   dv together, checked against the plain versions) for the backward
   pair. Then checks the model's forward and backward against the
   materializing reference;
4. trains the base transformer (vocab 8192, d_model 512, 8 heads,
   d_ff 2048, 8 layers, bfloat16 compute, batch 8 x seq 1024) for 8
   per-step updates through the port's in-process master/PS loop, and
   checks the exactness block, the losses, the kernels' launch counts
   and that the parameters moved; then profiles a short second run for
   the device time by kernel;
5. process mode (`phase_process_job`): the port's `master.main` with two
   `elasticdl_tpu_torch.worker.main` subprocesses on the card, over the
   TCP transport, trains the same model for 16 updates (2 shards of 64
   records); checks the exit code, the `--output` version, that the
   parameters are finite and moved, and each worker's summary line
   (device, accepted steps, and each kernel launched n_layers times per
   step computed);
6. preemption (`phase_preemption`): the same model, 2 workers and 4
   shards, with the master's parts driven directly; worker 0 is
   SIGKILLed once it holds a task, and the job must recover its tasks,
   relaunch a worker with a fresh id, finish without failed tasks and
   keep the exactness block;
7. window mode in-process (`phase_window`): the same model with
   `local_updates=4, sync_dtype="bfloat16"` (on-device clip + Adam, bf16
   error-feedback delta syncs on background threads) for 16 steps;
   checks the exactness block, steps computed = applied, finite losses,
   moved parameters, launches and no attention fallback; prints the
   steady tokens/s (first to last window sync) and the sync seconds
   split into quantize, encode, RPC and absorb; then a profiled second
   run gives the device idle share;
8. error feedback on the card (`phase_ef_card`) over a delta of the
   model's size: the int8 quantizer bit for bit with
   `codec.quantize_int8`, the bf16 cast bit for bit, top-k indices,
   values and residual equal to the CPU's; prints each one's ms;
9. the zoo's default config (head_dim 16) trains one step on the card
   through the attention dispatcher's fallback (`phase_zoo_default`);
   then the reference's large config (`phase_large`: d_model 1024, 8
   heads of 128, 16 layers, remat "dots", bf16, b16 x s1024, 218.1M
   parameters, built from its `--model_params` string): 4 per-step
   updates and 16 window steps in-process; checks the exactness block,
   steps computed = applied, finite losses, moved parameters, 0
   fallbacks and the launches (forward twice a layer a step: the remat
   recompute; dq and dk+dv once); prints steady tokens/s, the
   ReportGradient handler seconds, the window sync split, and the peak
   device memory of one step under remat off / full / dots;
10. window mode in process mode (`phase_window_process_job`): master.main
   with `--local_updates 4 --sync_dtype bfloat16`, 2 workers, 32 steps;
   checks rc, versions (the `--output` version = the workers' applied
   steps), steps computed = applied, launches; prints merged-back
   absorbs per worker;
11. the drain (`phase_window_drain`): SIGTERM to worker 0 mid-window of
   the same job drains it (exit 0, its drain line, nothing requeued,
   every step applied once); SIGKILL in a second job requeues its tasks
   and the job finishes with no failed task and every step applied once
   (the replayed windows deduped by their report keys);
12. prints the kernels' JSON line (one row per kernel and head dim; the
   backward pair's yardstick once per head dim, as `backward_pair`,
   since no single kernel's row matches it; each wrapper counts its
   launches by head dim, and each row carries its own kernel's count at
   its own head dim in each path: `launches` the head dim's main path
   (the base per-step run at 64, the large per-step run at 128),
   `process_launches`, `window_launches`, `window_process_launches`,
   `large_launches`, `large_window_launches`),
   the card line, and the result line.

Float32 products run in full float32: TF32 is switched off for matmuls
and cuDNN.
"""

import contextlib
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# bf16 limits by output. o and the gradients are bf16: one ulp is 0.4-0.8%
# of |x|, so a flipped rounding of p, ds or the output stays under rtol;
# atol covers values near zero. lse is float32 (|lse| <~ 10): the base-2
# softmax against torch's exp and log. PERF.md gives the readings.
BF16_TOL = {
    "o": dict(atol=1e-3, rtol=1e-2),
    "lse": dict(atol=1e-5, rtol=0.0),
    "grad": dict(atol=1e-3, rtol=1e-2),
}
# the spacing of bf16 values relative to their magnitude, at most (7
# stored mantissa bits)
BF16_SPACING = 2.0 ** -7
# bf16 gradients: rms(kernel - float64) / rms(plain - float64), at most.
# Kernel and plain version round p, ds and the output at the same points,
# so it reads 1.000; a kernel that rounds once more or loses a term reads
# 2 or more even where every element stays within the limit
# (scripts/torch_attention_faults.py; PERF.md gives the readings)
BF16_RMS_RATIO = 1.25
# f32: same math, other summation order
F32_TOL = dict(atol=1e-5, rtol=1e-5)
TOLS = {torch.bfloat16: BF16_TOL, torch.float32: dict.fromkeys(BF16_TOL, F32_TOL)}
# the model's f32 logits and grads against the materializing reference
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)

# published H100 SXM peaks (NVIDIA data sheet, 700 W): dense bf16 tensor
# cores and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

SLICE = dict(vocab=8192, d_model=512, n_heads=8, d_ff=2048, n_layers=8)
BATCH, SEQ, STEPS = 8, 1024, 8
# the reference's large config (bench_transformer.py:172-186): 8 heads of
# 128, remat "dots", bf16 compute, b16 x s1024; its --model_params string
LARGE = dict(vocab=8192, d_model=1024, n_heads=8, d_ff=4096, n_layers=16)
LARGE_PARAMS = ("vocab=8192,d_model=1024,n_heads=8,d_ff=4096,n_layers=16,n_micro=1,"
                "dtype=bfloat16,remat=True,remat_policy=dots")
LARGE_BATCH, LARGE_STEPS, LARGE_WINDOW_STEPS = 16, 4, 16
# window mode: W steps a sync, bf16 error-feedback deltas
WINDOW, WINDOW_STEPS = 4, 16
WINDOW_ARGS = ["--local_updates", str(WINDOW), "--sync_dtype", "bfloat16"]
# process mode: shards of 64 records, tasks of 32 (4 minibatches)
SHARD_RECORDS, TASK_RECORDS = 64, 32
ZOO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "elasticdl_tpu_torch", "models")
KERNELS = ("flash_forward", "flash_dq", "flash_dkv")
SOURCE = "elasticdl_tpu_torch/ops/csrc/flash_attention.cu"
# kernels that must not spill (ptxas's report): the tensor-core ones
NO_SPILL = ("fa_fwd_bf16_kernel", "fa_dq_bf16_kernel", "fa_dkv_bf16_kernel")
REPLACES = {
    "flash_forward": "elasticdl_tpu/ops/flash_attention.py:79",
    "flash_dq": "elasticdl_tpu/ops/flash_attention.py:161",
    "flash_dkv": "elasticdl_tpu/ops/flash_attention.py:204",
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, batches: int = 5) -> float:
    """Device time of one call: the median over `batches` of the mean of
    `iters` calls between two CUDA events."""
    for _ in range(3):
        fn()
    means = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / iters)
    return statistics.median(means)


def rounded(c) -> dict:
    return {k: round(v, 3) for k, v in c.items()}


def check_close(name, got, want, tols, failures, allowances=None) -> list:
    """Per tensor (got[i] against want[i] under tols[i]): max |got - want|
    and the largest share of its limit atol + rtol*|want| (+ allowances[i],
    elementwise, where given) that an element uses. A share above 1 or a
    non-finite output is added to `failures`."""
    readings = []
    for i, (g, w, tol) in enumerate(zip(got, want, tols)):
        g, w = g.float(), w.float()
        err = (g - w).abs()
        limit = tol["atol"] + tol["rtol"] * w.abs()
        if allowances is not None:
            limit = limit + allowances[i].float()
        share = (err / limit).max().item()
        readings.append((err.max().item(), share))
        if not torch.isfinite(g).all():
            failures.append(f"{name}: kernel output is not finite")
        elif share > 1:
            failures.append(f"{name}: max |kernel - plain| {err.max().item():.3e}, "
                            f"{share:.2f}x the limit {tol}"
                            + (" + two rounding flips" if allowances is not None else ""))
    return readings


def exact_backward(q, k, v, do, lse, delta, causal):
    """The backward's function in float64 with the kernels' rounding points
    (p and ds rounded to bf16), materialized: (dq, dk, dv), and per output
    the most that two bf16 rounding flips of its largest p or ds term can
    move it (a flip moves p or ds by one bf16 spacing, at most 2^-7 of its
    magnitude), [B, L, H, D] each. Two implementations whose float32
    intermediates differ in the last bits round different p and ds
    elements the other way; the allowance is one such flip in each."""
    d = q.shape[-1]
    qf, kf, vf, dof = (x.double().transpose(1, 2) for x in (q, k, v, do))  # [B, H, L, D]
    s = qf @ kf.transpose(-1, -2) / math.sqrt(d)
    if causal:
        L = q.shape[1]
        s = s.masked_fill(~torch.ones(L, L, dtype=torch.bool, device=q.device).tril(), -1e30)
    p = torch.exp(s - lse.double()[..., None])
    ds = p * (dof @ vf.transpose(-1, -2) - delta.double()[..., None]) / math.sqrt(d)
    del s
    rp, rds = (x.to(q.dtype).double() for x in (p, ds))
    grads = (rds @ kf, rds.transpose(-1, -2) @ qf, rp.transpose(-1, -2) @ dof)
    flip = 2 * BF16_SPACING
    allow = (
        flip * ds.abs().amax(-1)[..., None] * kf.abs().amax(-2)[..., None, :],
        flip * ds.abs().amax(-2)[..., None] * qf.abs().amax(-2)[..., None, :],
        flip * p.abs().amax(-2)[..., None] * dof.abs().amax(-2)[..., None, :],
    )
    return ([g.transpose(1, 2) for g in grads], [a.transpose(1, 2).float() for a in allow])


def reading_text(readings) -> str:
    return ", ".join(f"{err:.3e} ({share:.2f} of its limit)" for err, share in readings)


def attention_inputs(b, L, h, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [
        torch.randn(b, L, h, d, device="cuda", generator=g).to(dtype)
        for _ in range(4)
    ]


def bounds(b, L, h, d, causal=True):
    """Per kernel: (least operations, least bytes). Operations are the
    matrix products' multiply-adds x2 over the visible (q, k) pairs
    (exp and the other elementwise work not counted); bytes read each
    input once and write each output once (bf16 tiles, f32 rows)."""
    pairs = b * h * (L * (L + 1) // 2 if causal else L * L)
    tile = b * L * h * d * 2
    rows = b * h * L * 4
    return {
        "flash_forward": (2 * 2 * d * pairs, 3 * tile + tile + rows),
        "flash_dq": (3 * 2 * d * pairs, 4 * tile + 2 * rows + tile),
        "flash_dkv": (4 * 2 * d * pairs, 4 * tile + 2 * rows + 2 * tile),
    }


def backward_errs(fa, q, k, v, do, lse, delta, causal, tols, tag, failures):
    """flash_dq / flash_dkv against plain_dq / plain_dkv fed the same
    lse and delta; returns their readings (dq; dk, dv). bfloat16
    gradients may also differ by two rounding flips (`exact_backward`),
    and their root mean square distance from the float64 function may be
    at most BF16_RMS_RATIO times the plain version's; the line printed
    says how many elements needed the allowance, how far the kernel is
    from the plain version and each of them from the float64 function
    under the limit alone, and the rms ratios."""
    dq = fa.flash_dq(q, k, v, do, lse, delta, causal)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, causal)
    plain = (fa.plain_dq(q, k, v, do, lse, delta, causal),
             *fa.plain_dkv(q, k, v, do, lse, delta, causal))
    torch.cuda.synchronize()
    grad = tols["grad"]
    allow = None
    if q.dtype == torch.bfloat16:
        exact, allow = exact_backward(q, k, v, do, lse, delta, causal)
        beyond = [int(((g.float() - w.float()).abs()
                       > grad["atol"] + grad["rtol"] * w.float().abs()).sum())
                  for g, w in zip((dq, dk, dv), plain)]
        kernel_plain = check_close("", (dq, dk, dv), plain, (grad,) * 3, [])
        kernel_exact = check_close("", (dq, dk, dv), exact, (grad,) * 3, [])
        plain_exact = check_close("", plain, exact, (grad,) * 3, [])
        rms = [((g.double() - e).pow(2).mean() / (p.double() - e).pow(2).mean()).sqrt().item()
               for g, p, e in zip((dq, dk, dv), plain, exact)]
        for name, ratio in zip(("dq", "dk", "dv"), rms):
            if not ratio <= BF16_RMS_RATIO:
                failures.append(f"{name} {tag}: rms(kernel - float64) is {ratio:.3f}x "
                                f"rms(plain - float64), over {BF16_RMS_RATIO}")
        print(f"  {tag}: (dq, dk, dv) elements beyond the limit alone {beyond} of "
              f"{dq.numel()} each; under the limit alone, kernel vs plain "
              f"{reading_text(kernel_plain)}; kernel vs float64 {reading_text(kernel_exact)}; "
              f"plain vs float64 {reading_text(plain_exact)}; rms(kernel - float64) / "
              f"rms(plain - float64) {[round(r, 3) for r in rms]}")
        del exact
    return {
        "flash_dq": check_close(
            f"flash_dq {tag}", (dq,), plain[:1], (grad,), failures,
            allow[:1] if allow else None,
        ),
        "flash_dkv": check_close(
            f"flash_dkv {tag}", (dk, dv), plain[1:], (grad, grad), failures,
            allow[1:] if allow else None,
        ),
    }


def library_backward(fa, q, k, v, do) -> dict:
    """The backward pair's yardstick: one call of aten's flash-attention
    backward, which computes dq, dk and dv together (the port never calls
    it), on [B, H, L, D] views of the same bf16 inputs, causal. Its
    gradients are held against plain_dq / plain_dkv fed its own lse and o,
    under the kernels' limit and rounding-flip allowance;
    it is timed beside attention_delta + flash_dq + flash_dkv on the same
    lse and o. No single kernel's row carries it: returns both times as
    the kernels line's `backward_pair`."""
    aten = torch.ops.aten
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    out, lse, cum_q, cum_k, max_q, max_k, seed, offset, _ = (
        aten._scaled_dot_product_flash_attention(qt, kt, vt, 0.0, True)
    )

    def call():
        return aten._scaled_dot_product_flash_attention_backward(
            dot, qt, kt, vt, out, lse, cum_q, cum_k, max_q, max_k, 0.0, True, seed, offset
        )

    o = out.transpose(1, 2).contiguous()
    lse = lse[..., : q.shape[1]].contiguous()
    delta = fa.attention_delta(do, o)
    failures = []
    readings = check_close(
        "aten flash backward", [g.transpose(1, 2) for g in call()],
        (fa.plain_dq(q, k, v, do, lse, delta, True), *fa.plain_dkv(q, k, v, do, lse, delta, True)),
        (BF16_TOL["grad"],) * 3, failures, exact_backward(q, k, v, do, lse, delta, True)[1],
    )
    if failures:
        raise AssertionError("the backward yardstick disagrees with the plain versions:\n"
                             + "\n".join(failures))

    def kernels():
        d = fa.attention_delta(do, o)
        fa.flash_dq(q, k, v, do, lse, d, True)
        fa.flash_dkv(q, k, v, do, lse, d, True)

    library_ms, kernels_ms = time_ms(call), time_ms(kernels)
    print(f"library yardstick aten._scaled_dot_product_flash_attention_backward "
          f"(causal) {tuple(qt.shape)} bf16, dq, dk, dv in one call: {library_ms:.4f} ms "
          f"(vs plain (dq, dk, dv) {reading_text(readings)}); kernels attention_delta + "
          f"flash_dq + flash_dkv: {kernels_ms:.4f} ms")
    return {"library_call": "aten._scaled_dot_product_flash_attention_backward",
            "library_ms": library_ms, "kernels_ms": kernels_ms}


# (dtype, (B, L, H), head dim, causal cases, input seeds) of every kernel
# check; the last of each head dim is its slice's shape: the base
# transformer's (8 heads of 64, b8 x s1024) and the large config's (8 of
# 128, b16 x s1024), at three seeds (the bf16 gradients' rounding flips
# vary with the inputs); the first seed's inputs are the ones timed
KERNEL_CHECKS = (
    (torch.float32, (2, 256, 2), 64, (True,), (1,)),
    (torch.float32, (1, 192, 3), 64, (True, False), (1,)),
    (torch.bfloat16, (1, 192, 3), 64, (True, False), (1,)),
    (torch.bfloat16, (BATCH, SEQ, SLICE["n_heads"]), 64, (True,), (1, 2, 3)),
    (torch.float32, (2, 256, 2), 128, (True,), (1,)),
    (torch.float32, (1, 192, 3), 128, (True, False), (1,)),
    (torch.bfloat16, (1, 192, 3), 128, (True, False), (1,)),
    (torch.bfloat16, (LARGE_BATCH, SEQ, LARGE["n_heads"]), 128, (True,), (1, 2, 3)),
)


def kernel_rows(fa, d, q, k, v, do, plse, delta, readings) -> dict:
    """Times each kernel at its slice's bf16 shape (inputs q, k, v, do,
    causal) beside its plain version, its bound and the library
    yardstick; returns one row per kernel at head dim d."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    timings = {
        "flash_forward": (
            time_ms(lambda: fa.flash_forward(q, k, v, True)),
            time_ms(lambda: fa.plain_forward(q, k, v, True), iters=5),
            time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)),
        ),
        "flash_dq": (
            time_ms(lambda: fa.flash_dq(q, k, v, do, plse, delta, True)),
            time_ms(lambda: fa.plain_dq(q, k, v, do, plse, delta, True), iters=5),
            None,
        ),
        "flash_dkv": (
            time_ms(lambda: fa.flash_dkv(q, k, v, do, plse, delta, True)),
            time_ms(lambda: fa.plain_dkv(q, k, v, do, plse, delta, True), iters=5),
            None,
        ),
    }
    print(f"library yardstick F.scaled_dot_product_attention(is_causal=True) "
          f"{tuple(qt.shape)} bf16: forward {timings['flash_forward'][2]:.4f} ms; "
          f"kernel {timings['flash_forward'][0]:.4f} ms")
    rows = {}
    b, L, h, _ = q.shape
    for name, (ops, nbytes) in bounds(b, L, h, d).items():
        ms, plain_ms, library_ms = timings[name]
        ops_ms, bytes_ms = ops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        row = rows[name] = {
            "name": f"{name}_d{d}",
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[name],
            "head_dim": d,
            "shape": list(q.shape),
            "max_abs_err": max(err for err, _share in readings[name]),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": library_ms,
            "bound_share": max(ops_ms, bytes_ms) / ms,
            "blocks_per_sm": fa.blocks_per_sm(name, d, torch.bfloat16),
        }
        print(f"{row['name']} {tuple(q.shape)}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']}, share {row['bound_share']:.3f}, "
              f"{ops / ms / 1e9:.1f} TFLOP/s, {row['blocks_per_sm']} blocks an SM)")
    return rows


def kernel_checks(fa, q, k, v, do, causal, tag, failures):
    """Each kernel against its plain version on inputs q, k, v, do: the
    backward on the plain forward's lse and o, then on the kernel's own;
    prints the readings, adds what is beyond its limit to `failures`, and
    returns (plain o, plain lse, readings by kernel)."""
    tols = TOLS[q.dtype]
    o, lse = fa.flash_forward(q, k, v, causal)
    po, plse = fa.plain_forward(q, k, v, causal)
    torch.cuda.synchronize()
    readings = {"flash_forward": check_close(
        f"flash_forward {tag}", (o, lse), (po, plse), (tols["o"], tols["lse"]), failures
    )}
    readings.update(backward_errs(
        fa, q, k, v, do, plse, fa.attention_delta(do, po), causal, tols, tag, failures
    ))
    own = backward_errs(
        fa, q, k, v, do, lse, fa.attention_delta(do, o), causal, tols, tag + " own lse", failures,
    )
    print(f"kernels vs plain, {tag}: forward (o, lse) "
          f"{reading_text(readings['flash_forward'])}; dq "
          f"{reading_text(readings['flash_dq'])}; dk+dv (dk, dv) "
          f"{reading_text(readings['flash_dkv'])}; on the kernel's lse and o: dq "
          f"{reading_text(own['flash_dq'])}; dk+dv {reading_text(own['flash_dkv'])}")
    return po, plse, readings


def phase_kernels(fa):
    """Kernel vs plain version on the card at every shape of
    KERNEL_CHECKS; returns the per-kernel rows (without launches) at each
    head dim's slice shape, {head dim: row by kernel}, and the backward
    pair's yardstick by head dim. Prints every check's readings (max |err|
    and share of the limit, per output) and raises after the last if any
    was beyond its limit."""
    failures = []
    slice_inputs = {}
    for dtype, shape, d, causals, seeds in KERNEL_CHECKS:
        for seed in seeds:
            q, k, v, do = attention_inputs(*shape, d, dtype, seed=seed)
            for causal in causals:
                tag = f"{dtype} {tuple(q.shape)} causal={causal} seed {seed}"
                po, plse, readings = kernel_checks(fa, q, k, v, do, causal, tag, failures)
            # each head dim's last check is its slice's shape (bf16,
            # causal), timed on its first seed's inputs
            if seed == seeds[0]:
                slice_inputs[d] = (q, k, v, do, plse, fa.attention_delta(do, po), readings)
    if failures:
        raise AssertionError("kernels disagree with their plain versions:\n"
                             + "\n".join(failures))
    rows, pairs = {}, {}
    for d, (q, k, v, do, plse, delta, readings) in slice_inputs.items():
        pairs[d] = library_backward(fa, q, k, v, do)
        rows[d] = kernel_rows(fa, d, q, k, v, do, plse, delta, readings)
    return rows, pairs


def check_ptxas(log: str) -> dict:
    """Prints ptxas's lines per kernel (entry, registers, shared memory,
    spills); raises if an instantiation of a NO_SPILL kernel spills, or if
    one of them is missing at a head dim. Returns {(kernel, head dim):
    registers} of every instantiation."""
    kernel, regs = None, {}
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            kernel = line.split()[-1].strip("'") if "properties" in line else line.split("'")[1]
        if any(w in line for w in ("Compiling entry", "registers", "spill", "smem")):
            print(line.strip())
        if "spill stores" in line and kernel and any(n in kernel for n in NO_SPILL):
            stores, loads = (int(x.split()[0]) for x in line.split(",")[1:3])
            if stores or loads:
                raise AssertionError(f"{kernel} spills: {line.strip()}")
        found = re.search(r"Used (\d+) registers", line)
        name = kernel and re.search(r"(fa_\w+?_kernel)ILi(\d+)E", kernel)
        if found and name:
            regs[(name.group(1), int(name.group(2)))] = int(found.group(1))
    from elasticdl_tpu_torch.ops.flash_attention import HEAD_DIMS

    missing = [(n, d) for n in NO_SPILL for d in HEAD_DIMS if (n, d) not in regs]
    if missing:
        raise AssertionError(f"ptxas reported no registers for {missing}")
    return regs


def phase_model_reference():
    """The model's forward and backward through the kernels against the
    materializing reference, float32, small shape."""
    from elasticdl_tpu_torch.common import codec
    from elasticdl_tpu_torch.convert import params_from_jax
    from elasticdl_tpu_torch.models import transformer_lm as tlm

    cfg = tlm.TransformerConfig(vocab=256, d_model=128, n_heads=2, d_ff=256, n_layers=2)
    host = tlm.init_params(np.random.default_rng(3), cfg)
    params = codec.tree_map(lambda t: t.cuda(), params_from_jax(host))
    tokens = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab, (2, 129))
    ).cuda()
    leaves = codec.tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    results = []
    for forward in (tlm.plain_forward, tlm.reference_forward):
        logits = forward(cfg, params, tokens[:, :-1])
        loss = tlm.token_cross_entropy(logits, tokens[:, 1:])
        results.append((logits, *torch.autograd.grad(loss, leaves)))
    failures = []
    readings = check_close("model logits and grads", results[0], results[1],
                           (MODEL_TOL,) * len(results[0]), failures)
    if failures:
        raise AssertionError("\n".join(failures))
    print(f"model forward+backward (kernels) vs reference, f32 [2, 128]: "
          f"max|err| {max(err for err, _share in readings):.3e}")


def slice_job(path, n_records, task_records=None, **worker_kw):
    """The slice's in-process master/PS and one worker on the card, over
    `n_records` token records in tasks of `task_records` (default half
    of them); `worker_kw` selects window mode."""
    from elasticdl_tpu_torch.api.model_spec_helpers import spec_from_module
    from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
    from elasticdl_tpu_torch.models import transformer_lm_zoo as zoo
    from elasticdl_tpu_torch.models.record_codec import write_learnable_token_records
    from elasticdl_tpu_torch.testing import InProcessMaster, build_job
    from elasticdl_tpu_torch.worker.worker import Worker

    write_learnable_token_records(path, n_records, SEQ, SLICE["vocab"], seed=0)
    dispatcher = TaskDispatcher({path: n_records}, {}, {}, task_records or n_records // 2, 1,
                                shuffle_seed=0)
    model = zoo.custom_model(**SLICE, dtype=torch.bfloat16)
    spec = spec_from_module(zoo, model=model)
    servicer = build_job(spec, dispatcher, grads_to_wait=1)
    master = InProcessMaster(servicer)
    worker = Worker(0, master, spec, minibatch_size=BATCH, device="cuda", seed=0, **worker_kw)
    return dispatcher, servicer, master, worker, model


def reset_counts(fa):
    """Every kernel wrapper's launch counts and the dispatcher's fallback
    count to 0, just before a path is driven."""
    fa.reset_launch_counts()
    fa.attention.fallbacks = 0


def read_counts(fa):
    """({f"{kernel}_d{head dim}": launches}, attention fallbacks), just
    after a path ran; each wrapper counts its launches by head dim."""
    return fa.launch_counts(), fa.attention.fallbacks


def want_launches(d, by_kernel) -> dict:
    """The launch counts of a path that runs head dim d only: by_kernel's
    count at d, 0 at the other head dims."""
    from elasticdl_tpu_torch.ops.flash_attention import HEAD_DIMS

    return {f"{k}_d{e}": by_kernel[k] if e == d else 0 for k in KERNELS for e in HEAD_DIMS}


def phase_train(fa, tmp):
    """The slice's main path: 8 per-step updates on the card."""
    from elasticdl_tpu_torch.common import codec

    dispatcher, servicer, master, worker, model = slice_job(
        os.path.join(tmp, "train.rio"), BATCH * STEPS
    )
    reset_counts(fa)
    t0 = time.perf_counter()
    ok = worker.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, fallbacks = read_counts(fa)
    worker.close()

    ex = servicer.exactness()
    losses = [loss for _t, loss in worker.step_log]
    print(f"trained {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params, "
          f"{len(losses)} steps, exactness {ex}, losses {[round(x, 4) for x in losses]}")
    if not ok or not dispatcher.finished():
        raise AssertionError("the job did not finish cleanly")
    if ex["version"] != ex["init_version"] + STEPS or ex["applied_update_steps"] != STEPS:
        raise AssertionError(f"exactness block broken: {ex}, {STEPS} steps expected")
    if len(losses) != STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses not {STEPS} finite values: {losses}")
    want = want_launches(64, dict.fromkeys(KERNELS, SLICE["n_layers"] * STEPS))
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, {want} expected")
    if fallbacks:
        raise AssertionError(f"{fallbacks} attention calls fell back at full width")
    final, _aux, _v = servicer.get_params_copy()
    if np.array_equal(codec.ravel_np(final), codec.ravel_np(model.init_params(0))):
        raise AssertionError("the parameters did not move")

    times = [t for t, _loss in worker.step_log]
    tokens = BATCH * SEQ
    steady = (len(times) - 1) * tokens / (times[-1] - times[0])
    print(f"slice throughput: {STEPS * tokens / wall:.1f} tokens/s over the whole "
          f"run ({wall:.2f} s incl. model init), {steady:.1f} tokens/s over "
          f"steps 2-{STEPS}")
    print(f"host breakdown (s, whole run): worker {rounded(worker.phase_seconds)}, "
          f"servicer handlers {rounded(master.handler_seconds)}, "
          f"wire codec {rounded(master.codec_seconds)}")
    print(f"host PS apply (ReportGradient handler: f32 average, clip + Adam, model ravel): "
          f"{master.handler_seconds['ReportGradient'] / STEPS:.4f} s a step; "
          f"attention fallbacks {fallbacks}")
    return launches


def phase_profile(tmp):
    """Device time by kernel over a short second run (4 steps) of the
    same job under torch.profiler; not part of the counted main path."""
    from torch.profiler import ProfilerActivity, profile

    *_job, worker, _model = slice_job(os.path.join(tmp, "profile.rio"), BATCH * 4)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        worker.run()
        torch.cuda.synchronize()
    worker.close()
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    total_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    times = [t for t, _loss in worker.step_log]
    step_ms = (times[-1] - times[0]) / (len(times) - 1) * 1e3
    if total_ms == 0:
        print("profile: the profiler recorded no device time (not measured)")
        return
    per_step = total_ms / len(times)
    print(f"profile: device kernel time {per_step:.2f} ms per step of {step_ms:.1f} ms "
          f"between steps under the profiler (device idle share "
          f"{1 - per_step / step_ms:.3f})")
    attn = {}
    for e in kernels:
        found = re.search(r"fa_(fwd|dq|dkv)\w*", e.key)
        if found:
            attn[found.group(0)] = e.self_device_time_total / 1e3 / len(times)
    print(f"profile: attention kernels {sum(attn.values()):.3f} ms per step ("
          + ", ".join(f"{n} {ms:.3f}" for n, ms in attn.items()) + ")")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3 / len(times):8.3f} ms/step "
              f"{e.count // len(times):4d}x  {e.key[:90]}")


def write_shards(data_dir, n_files):
    from elasticdl_tpu_torch.models.record_codec import write_learnable_token_records

    os.makedirs(data_dir)
    for i in range(n_files):
        write_learnable_token_records(os.path.join(data_dir, f"shard-{i}.rio"),
                                      SHARD_RECORDS, SEQ, SLICE["vocab"], seed=i)


def master_argv(data_dir, num_workers, output):
    """The port's master command line for the slice's model on the card."""
    params = ",".join(f"{k}={v}" for k, v in SLICE.items()) + ",dtype=bfloat16"
    return [
        "--model_zoo", ZOO, "--model_def", "transformer_lm_zoo.custom_model",
        "--model_params", params, "--minibatch_size", str(BATCH),
        "--training_data_dir", data_dir, "--records_per_task", str(TASK_RECORDS),
        "--num_epochs", "1", "--grads_to_wait", "1", "--num_workers", str(num_workers),
        "--worker_backend", "process", "--device", "cuda", "--output", output,
    ]


@contextlib.contextmanager
def logs_on_failure(log_dir):
    """On an error, print the end of each worker's log before raising."""
    try:
        yield
    except BaseException:
        for name in sorted(os.listdir(log_dir)) if os.path.isdir(log_dir) else []:
            with open(os.path.join(log_dir, name)) as f:
                print(f"--- {name}, last lines:\n" + "".join(f.readlines()[-25:]))
        raise


def steady_tokens_per_s(summaries) -> float:
    """Tokens/s between the first and the last accepted step of all
    workers (perf_counter is the host's monotonic clock in every process)."""
    times = sorted(t for s in summaries.values() for t in s["accepted_at"])
    return (len(times) - 1) * BATCH * SEQ / (times[-1] - times[0])


def check_params(params, what):
    """Finite, and moved from both workers' lazy inits (seeds 0 and 1)."""
    from elasticdl_tpu_torch.common import codec
    from elasticdl_tpu_torch.models import transformer_lm_zoo as zoo

    flat = codec.ravel_np(params)
    if not np.isfinite(flat).all():
        raise AssertionError(f"{what}: the parameters are not finite")
    model = zoo.custom_model(**SLICE)
    for seed in (0, 1):
        if np.array_equal(flat, codec.ravel_np(model.init_params(seed))):
            raise AssertionError(f"{what}: the parameters did not move from init {seed}")


def summed_launches(summaries) -> dict:
    """The workers' launch counts, {f"{kernel}_d{head dim}": launches},
    summed over the workers' summaries."""
    keys = next(iter(summaries.values()))["launches"]
    return {key: sum(s["launches"][key] for s in summaries.values()) for key in keys}


def phase_process_job(tmp) -> dict:
    """`python -m elasticdl_tpu_torch.master.main ... --worker_backend
    process`, run in this process through `run(argv)`: 2 worker
    processes on the card, 2 shards of 64 records, 16 updates. Returns
    the kernels' launches summed over the workers."""
    from elasticdl_tpu_torch.common.constants import ENV_WORKER_LOG_DIR
    from elasticdl_tpu_torch.master import main as master_main
    from elasticdl_tpu_torch.master.checkpoint import load_model_file
    from elasticdl_tpu_torch.worker.main import read_summaries

    data, log_dir = os.path.join(tmp, "process-data"), os.path.join(tmp, "process-logs")
    with logs_on_failure(log_dir):
        output = os.path.join(tmp, "process.ckpt")
        write_shards(data, 2)
        steps = 2 * SHARD_RECORDS // BATCH
        os.environ[ENV_WORKER_LOG_DIR] = log_dir
        try:
            t0 = time.perf_counter()
            rc, master = master_main.run(master_argv(data, 2, output))
            wall = time.perf_counter() - t0
        finally:
            del os.environ[ENV_WORKER_LOG_DIR]
        if rc != 0:
            raise AssertionError(f"master.main exited {rc}")
        model = load_model_file(output)
        if model.version != steps:
            raise AssertionError(f"--output version {model.version}, {steps} expected")
        check_params(model.params, "process job")
        summaries = read_summaries(log_dir)
        card = torch.cuda.get_device_name(0)
        if sorted(summaries) != [0, 1]:
            raise AssertionError(f"worker summaries of {sorted(summaries)}, of [0, 1] expected")
        accepted = sum(s["steps_accepted"] for s in summaries.values())
        if accepted != steps:
            raise AssertionError(f"the workers' accepted steps sum to {accepted}, not {steps}")
        for wid, s in summaries.items():
            want = want_launches(64, dict.fromkeys(KERNELS,
                                                   SLICE["n_layers"] * s["steps_computed"]))
            if s["device"] != card:
                raise AssertionError(f"worker {wid} ran on {s['device']!r}, not {card!r}")
            if s["launches"] != want:
                raise AssertionError(f"worker {wid} launches {s['launches']}, {want} expected "
                                     f"({s['steps_computed']} steps computed)")
        exactness = {k: master[k] for k in ("version", "init_version", "applied_update_steps")}
        print(f"process job: rc {rc}, version {model.version}, {wall:.2f} s, "
              f"{steps * BATCH * SEQ / wall:.1f} tokens/s over the whole run (worker boot "
              f"included), {steady_tokens_per_s(summaries):.1f} tokens/s between the first "
              f"and last accepted steps; exactness {exactness}")
        for wid, s in summaries.items():
            recomputes = s["steps_computed"] - s["steps_accepted"]
            print(f"process job worker {wid} on {s['device']}: {s['steps_accepted']} steps "
                  f"accepted, {s['steps_computed']} computed ({recomputes} stale recomputes), "
                  f"phase seconds {rounded(s['phase_seconds'])}, client seconds "
                  f"{rounded(s['rpc_seconds'])} (codec {rounded(s['rpc_codec_seconds'])}), "
                  f"launches {s['launches']}")
        server = master["server"]
        print(f"process job master: server handler seconds {rounded(server['handler_seconds'])}, "
              f"codec seconds {rounded(server['codec_seconds'])}, calls {server['calls']}")
        # the socket hop: each method's client wall clock less the client's
        # codec and the server's handler and codec time, over both workers
        hop = {
            m: sum(s["rpc_seconds"].get(m, 0.0) - s["rpc_codec_seconds"].get(m, 0.0)
                   for s in summaries.values())
            - server["handler_seconds"][m] - server["codec_seconds"][m]
            for m in server["calls"]
        }
        print(f"process job socket hop (s, both workers): {rounded(hop)}")
        return summed_launches(summaries)


def window_steady(window_log) -> float:
    """Tokens/s from the first to the last window sync that landed."""
    log = sorted(window_log)
    steps = sum(n for _t, n, _loss in log[1:])
    return steps * BATCH * SEQ / (log[-1][0] - log[0][0])


def phase_window(fa, tmp):
    """Window mode in-process at full width: `--local_updates 4
    --sync_dtype bfloat16`, 16 steps (4 tasks of one window each).
    Returns the kernels' launches."""
    from elasticdl_tpu_torch.common import codec

    steps = WINDOW_STEPS
    dispatcher, servicer, master, worker, model = slice_job(
        os.path.join(tmp, "window.rio"), BATCH * steps, task_records=BATCH * WINDOW,
        local_updates=WINDOW, sync_dtype="bfloat16",
    )
    reset_counts(fa)
    t0 = time.perf_counter()
    ok = worker.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, fallbacks = read_counts(fa)
    worker.close()

    ex = servicer.exactness()
    windows = list(worker.window_log)
    losses = [loss for _t, _n, loss in windows] + list(worker.task_losses)
    print(f"window mode (in-process, W {WINDOW}, bf16 EF deltas): {len(windows)} syncs of "
          f"{[n for _t, n, _l in windows]} steps, exactness {ex}, window losses "
          f"{[round(loss, 4) for _t, _n, loss in windows]}, merged back {worker.merged_back}")
    if not ok or not dispatcher.finished():
        raise AssertionError("the window job did not finish cleanly")
    if ex["version"] != ex["init_version"] + ex["applied_update_steps"] or (
        ex["applied_update_steps"] != steps
    ):
        raise AssertionError(f"exactness block broken: {ex}, {steps} steps expected")
    if worker.steps_computed != steps or worker.steps_accepted != steps:
        raise AssertionError(f"{worker.steps_computed} steps computed, "
                             f"{worker.steps_accepted} accepted, {steps} expected")
    if not losses or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses not finite: {losses}")
    want = want_launches(64, dict.fromkeys(KERNELS, SLICE["n_layers"] * steps))
    if launches != want:
        raise AssertionError(f"window kernel launches {launches}, {want} expected")
    if fallbacks:
        raise AssertionError(f"{fallbacks} attention calls fell back at full width")
    final, _aux, _v = servicer.get_params_copy()
    if np.array_equal(codec.ravel_np(final), codec.ravel_np(model.init_params(0))):
        raise AssertionError("the window job's parameters did not move")
    n_windows = len(windows)
    print(f"window throughput: {steps * BATCH * SEQ / wall:.1f} tokens/s over the whole run "
          f"({wall:.2f} s incl. model init), {window_steady(windows):.1f} tokens/s from the "
          f"first to the last window sync")
    print(f"window sync seconds (whole run, {n_windows} syncs): {rounded(worker.sync_seconds)}; "
          f"per sync: " + ", ".join(f"{k} {v / n_windows:.4f}"
                                    for k, v in sorted(worker.sync_seconds.items())))
    print(f"window host breakdown (s, whole run): worker phases "
          f"{rounded(worker.phase_seconds)}, servicer handlers "
          f"{rounded(master.handler_seconds)}, wire codec {rounded(master.codec_seconds)}; "
          f"PS add a window {master.handler_seconds['ReportLocalUpdate'] / n_windows:.4f} s")
    return launches


def busy_us(intervals, t0, t1) -> float:
    """Microseconds of [t0, t1] that the union of `intervals` covers."""
    busy, reach = 0.0, t0
    for start, end in sorted(intervals):
        start, end = max(start, reach), min(end, t1)
        if end > start:
            busy += end - start
            reach = end
    return busy


def phase_window_profile(tmp):
    """Device idle share of a second window run (16 steps) under
    torch.profiler; not part of the counted main path. Both the busy time
    and the span come from the trace's device clock: the span runs from
    the end of step WINDOW's last attention backward (the first window
    done) to the end of the last step's, and the busy time is the union
    of every kernel and copy on any stream inside it, so overlapping
    streams count once."""
    from torch.profiler import ProfilerActivity, profile

    *_job, worker, _model = slice_job(
        os.path.join(tmp, "window-profile.rio"), BATCH * WINDOW_STEPS,
        task_records=BATCH * WINDOW, local_updates=WINDOW, sync_dtype="bfloat16",
    )
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        worker.run()
        torch.cuda.synchronize()
    worker.close()
    device = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and "Sync" not in e.name
    ]
    # fa_dkv runs once per layer per step, last of a step's attention kernels
    dkv_ends = sorted(e.time_range.end for e in device if re.search(r"\bfa_dkv", e.name))
    per_step_dkv = SLICE["n_layers"]
    if len(dkv_ends) != per_step_dkv * WINDOW_STEPS:
        print(f"window profile: {len(dkv_ends)} fa_dkv kernels in the trace, "
              f"{per_step_dkv * WINDOW_STEPS} expected: idle share not measured")
        return
    t0, t1 = dkv_ends[per_step_dkv * WINDOW - 1], dkv_ends[-1]
    steps = WINDOW_STEPS - WINDOW
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in device], t0, t1)
    span_ms, busy_ms = (t1 - t0) / 1e3, busy / 1e3
    print(f"window profile: device busy {busy_ms / steps:.2f} ms per step (union of kernels "
          f"and copies on all streams) of {span_ms / steps:.1f} ms per step over steps "
          f"{WINDOW + 1}-{WINDOW_STEPS} on the device clock under the profiler (device idle "
          f"share {1 - busy / (t1 - t0):.3f}, {steps * BATCH * SEQ / span_ms * 1e3:.1f} tokens/s)")
    events = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3 / WINDOW_STEPS:8.3f} ms/step "
              f"{e.count:5d}x  {e.key[:90]}")


def slice_param_count() -> int:
    from elasticdl_tpu_torch.models import transformer_lm_zoo as zoo

    return sum(p.numel() for p in zoo.custom_model(**SLICE).parameters())


def phase_ef_card(n):
    """Window mode's error-feedback compression on the card over an
    n-element delta (the base transformer's size), against the host:
    int8 bit for bit with codec.quantize_int8, the bf16 cast bit for bit
    with the codec's rounding, top-k (1%) indices, values and residual
    equal to the same code on the CPU. Prints each one's ms."""
    import types

    from elasticdl_tpu_torch.common import codec
    from elasticdl_tpu_torch.worker.worker import Worker

    chunk = codec.DEFAULT_INT8_CHUNK
    g = torch.Generator(device="cuda").manual_seed(5)
    vec = torch.randn(n, device="cuda", generator=g) * 1e-3
    vec[chunk : 2 * chunk] = 0.0  # an all-zero chunk takes scale 1.0
    host = vec.cpu().numpy()
    failures = []

    q, scale, deq = Worker._int8_quantize_dev(vec)
    t0 = time.perf_counter()
    want = codec.quantize_int8(host)
    host_ms = (time.perf_counter() - t0) * 1e3
    for what, got, exp in (("q", q, want.q), ("scale", scale, want.scale),
                           ("dequantized", deq, want.dequantize())):
        if got.cpu().numpy().tobytes() != exp.tobytes():
            failures.append(f"int8 {what} differs from codec.quantize_int8")
    bits = vec.to(torch.bfloat16).view(torch.int16).cpu().numpy().view(np.uint16)
    if bits.tobytes() != codec.BF16Bits.from_f32(host).bits.tobytes():
        failures.append("the bf16 cast differs from the codec's rounding")
    topk = types.SimpleNamespace(_sync_dtype="float32", _topk_ratio=0.01,
                                 _int8_quantize_dev=Worker._int8_quantize_dev)
    _meta, (idx, vals), res = Worker._ef_compress(topk, vec.clone(), topk=True)
    _cmeta, (cidx, cvals), cres = Worker._ef_compress(topk, torch.from_numpy(host.copy()), True)
    for what, got, exp in (("indices", idx, cidx), ("values", vals, cvals),
                           ("residual", res, cres)):
        if got.cpu().numpy().tobytes() != exp.numpy().tobytes():
            failures.append(f"top-k {what} differ between the card and the CPU")
    times = {
        "int8": time_ms(lambda: Worker._int8_quantize_dev(vec), iters=5),
        "bf16": time_ms(lambda: vec.to(torch.bfloat16), iters=5),
        "topk": time_ms(lambda: Worker._ef_compress(topk, vec.clone(), True), iters=2, batches=3),
    }
    print(f"EF on the card over {n} elements: int8 {times['int8']:.3f} ms (host "
          f"codec.quantize_int8 {host_ms:.1f} ms), bf16 cast {times['bf16']:.3f} ms, top-k 1% "
          f"({idx.numel()} kept) {times['topk']:.3f} ms; int8 and bf16 bit for bit with the "
          f"codec, top-k indices, values and residual equal to the CPU's: {not failures}")
    if failures:
        raise AssertionError("\n".join(failures))


def phase_zoo_default(fa, tmp):
    """The zoo's default config (`custom_model()`, head_dim 16, which the
    kernels do not take) trains one step on the card through the
    dispatcher's fallback."""
    from elasticdl_tpu_torch.api.model_spec_helpers import spec_from_module
    from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
    from elasticdl_tpu_torch.models import transformer_lm_zoo as zoo
    from elasticdl_tpu_torch.models.record_codec import write_learnable_token_records
    from elasticdl_tpu_torch.testing import InProcessMaster, build_job
    from elasticdl_tpu_torch.worker.worker import Worker

    model = zoo.custom_model()
    path = os.path.join(tmp, "zoo-default.rio")
    write_learnable_token_records(path, BATCH, 128, model.cfg.vocab, seed=0)
    dispatcher = TaskDispatcher({path: BATCH}, {}, {}, BATCH, 1, shuffle_seed=0)
    spec = spec_from_module(zoo, model=model)
    servicer = build_job(spec, dispatcher, grads_to_wait=1)
    worker = Worker(0, InProcessMaster(servicer), spec, minibatch_size=BATCH, device="cuda")
    reset_counts(fa)
    ok = worker.run()
    launches, fallbacks = read_counts(fa)
    worker.close()
    ex = servicer.exactness()
    head_dim = model.cfg.d_model // model.cfg.n_heads
    print(f"zoo default config (head_dim {head_dim}) on the card: exactness {ex}, losses "
          f"{[round(x, 4) for _t, x in worker.step_log]}, attention fallbacks {fallbacks}, "
          f"kernel launches {launches}")
    if not ok or ex["applied_update_steps"] != 1 or ex["version"] != 1:
        raise AssertionError(f"the default config did not train one step: {ex}")
    if not all(math.isfinite(x) for _t, x in worker.step_log):
        raise AssertionError("the default config's loss is not finite")
    if fallbacks <= 0:
        raise AssertionError("the default config did not go through the fallback")


def large_job(path, n_records, task_records, **worker_kw):
    """The reference's large config through the zoo's entry point
    (`get_model_spec` with LARGE_PARAMS, as `--model_params` gives it):
    an in-process master/PS and one worker on the card over `n_records`
    token records in tasks of `task_records`."""
    from elasticdl_tpu_torch.api.model_spec import get_model_spec
    from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
    from elasticdl_tpu_torch.models.record_codec import write_learnable_token_records
    from elasticdl_tpu_torch.testing import InProcessMaster, build_job
    from elasticdl_tpu_torch.worker.worker import Worker

    write_learnable_token_records(path, n_records, SEQ, LARGE["vocab"], seed=0)
    dispatcher = TaskDispatcher({path: n_records}, {}, {}, task_records, 1, shuffle_seed=0)
    spec = get_model_spec(ZOO, "transformer_lm_zoo.custom_model", LARGE_PARAMS)
    servicer = build_job(spec, dispatcher, grads_to_wait=1)
    master = InProcessMaster(servicer)
    worker = Worker(0, master, spec, minibatch_size=LARGE_BATCH, device="cuda", seed=0,
                    **worker_kw)
    return dispatcher, servicer, master, worker, spec.model


def check_large_run(what, fa, ok, dispatcher, servicer, worker, model, launches, fallbacks,
                    steps):
    """The large phase's checks of one run: a clean finish, the exactness
    block with every step applied once, steps computed = applied, finite
    losses, moved parameters, no fallback, and the counted launches: a
    step computed under remat launches the forward kernel twice a layer
    (the layer's recompute), dq and dk+dv once."""
    from elasticdl_tpu_torch.common import codec

    ex = servicer.exactness()
    losses = ([loss for _t, loss in worker.step_log]
              + [loss for _t, _n, loss in worker.window_log] + list(worker.task_losses))
    if not ok or not dispatcher.finished():
        raise AssertionError(f"{what}: the job did not finish cleanly")
    if ex != {"version": steps, "init_version": 0, "applied_update_steps": steps}:
        raise AssertionError(f"{what}: exactness {ex}, {steps} steps applied once expected")
    if worker.steps_computed != steps or worker.steps_accepted != steps:
        raise AssertionError(f"{what}: {worker.steps_computed} steps computed, "
                             f"{worker.steps_accepted} applied, {steps} expected")
    if not losses or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{what}: losses not finite: {losses}")
    if fallbacks:
        raise AssertionError(f"{what}: {fallbacks} attention calls fell back at head dim 128")
    n = LARGE["n_layers"] * steps
    want = want_launches(128, {"flash_forward": 2 * n, "flash_dq": n, "flash_dkv": n})
    if launches != want:
        raise AssertionError(f"{what}: kernel launches {launches}, {want} expected")
    final, _aux, _v = servicer.get_params_copy()
    flat = codec.ravel_np(final)
    if not np.isfinite(flat).all() or np.array_equal(flat, codec.ravel_np(model.init_params(0))):
        raise AssertionError(f"{what}: the parameters are not finite or did not move")


def peak_step_memory():
    """Peak device memory (GiB above the parameters, the gradient and the
    batch) of one forward + backward of the large config under each remat
    setting, from the same host init; not part of the counted paths."""
    from elasticdl_tpu_torch.common import codec
    from elasticdl_tpu_torch.models import transformer_lm as tlm

    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, LARGE["vocab"], (LARGE_BATCH, SEQ + 1))
    ).cuda()
    cfg = tlm.TransformerConfig(**LARGE, dtype=torch.bfloat16)
    params = codec.tree_map(lambda a: torch.from_numpy(a).cuda().requires_grad_(),
                            tlm.init_params(np.random.default_rng(0), cfg))
    leaves = codec.tree_leaves(params)
    peaks = {}
    for name, remat, policy in (("off", False, ""), ("full", True, ""), ("dots", True, "dots")):
        run_cfg = tlm.TransformerConfig(**LARGE, dtype=torch.bfloat16, remat=remat,
                                        remat_policy=policy)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        logits = tlm.plain_forward(run_cfg, params, tokens[:, :-1])
        loss = tlm.token_cross_entropy(logits, tokens[:, 1:])
        del logits
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        grad_bytes = sum(g.numel() * g.element_size() for g in grads)
        peaks[name] = (torch.cuda.max_memory_allocated() - base - grad_bytes) / 2**30
        del grads, loss
    print(f"large config peak device memory of one step (forward + backward, GiB beyond "
          f"the f32 parameters, their gradient and the batch): remat off {peaks['off']:.2f}, "
          f"full {peaks['full']:.2f}, dots {peaks['dots']:.2f}")
    return peaks


def phase_large(fa, tmp):
    """The reference's large config (d_model 1024, 8 heads of 128, d_ff
    4096, 16 layers, bf16, remat "dots", b16 x s1024; 218.1M parameters)
    on the card: LARGE_STEPS per-step updates, then LARGE_WINDOW_STEPS
    window steps (`local_updates=4, sync_dtype="bfloat16"`). Returns the
    kernels' launches of each run."""
    steps = LARGE_STEPS
    dispatcher, servicer, master, worker, model = large_job(
        os.path.join(tmp, "large.rio"), LARGE_BATCH * steps, LARGE_BATCH * steps // 2)
    n_params = sum(p.numel() for p in model.parameters())
    reset_counts(fa)
    t0 = time.perf_counter()
    ok = worker.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, fallbacks = read_counts(fa)
    worker.close()
    print(f"large config ({n_params:,} params, {model.cfg.head_dim} head dim, remat "
          f"{model.cfg.remat_policy!r}): {steps} per-step updates, exactness "
          f"{servicer.exactness()}, losses {[round(x, 4) for _t, x in worker.step_log]}, "
          f"launches {launches}, fallbacks {fallbacks}")
    check_large_run("large per-step", fa, ok, dispatcher, servicer, worker, model, launches,
                    fallbacks, steps)
    times = [t for t, _loss in worker.step_log]
    tokens = LARGE_BATCH * SEQ
    print(f"large per-step throughput: {steps * tokens / wall:.1f} tokens/s over the whole run "
          f"({wall:.2f} s incl. model init), {(len(times) - 1) * tokens / (times[-1] - times[0]):.1f}"
          f" tokens/s over steps 2-{steps}; host PS apply (ReportGradient handler) "
          f"{master.handler_seconds['ReportGradient'] / steps:.4f} s a step; worker phases "
          f"{rounded(worker.phase_seconds)}, wire codec {rounded(master.codec_seconds)}")
    del dispatcher, servicer, master, worker, model

    steps = LARGE_WINDOW_STEPS
    dispatcher, servicer, master, worker, model = large_job(
        os.path.join(tmp, "large-window.rio"), LARGE_BATCH * steps, LARGE_BATCH * WINDOW,
        local_updates=WINDOW, sync_dtype="bfloat16")
    reset_counts(fa)
    t0 = time.perf_counter()
    ok = worker.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    window_launches, fallbacks = read_counts(fa)
    worker.close()
    windows = list(worker.window_log)
    print(f"large window mode (W {WINDOW}, bf16 EF deltas): {len(windows)} syncs of "
          f"{[n for _t, n, _l in windows]} steps, exactness {servicer.exactness()}, window "
          f"losses {[round(loss, 4) for _t, _n, loss in windows]}, launches "
          f"{window_launches}, fallbacks {fallbacks}")
    check_large_run("large window", fa, ok, dispatcher, servicer, worker, model,
                    window_launches, fallbacks, steps)
    n_windows = len(windows)
    steady = sum(n for _t, n, _l in windows[1:]) * LARGE_BATCH * SEQ / (
        windows[-1][0] - windows[0][0])
    print(f"large window throughput: {steps * LARGE_BATCH * SEQ / wall:.1f} tokens/s over the "
          f"whole run ({wall:.2f} s incl. model init), {steady:.1f} tokens/s from the first to "
          f"the last window sync; sync seconds per sync: "
          + ", ".join(f"{k} {v / n_windows:.4f}" for k, v in sorted(worker.sync_seconds.items()))
          + f"; PS add a window {master.handler_seconds['ReportLocalUpdate'] / n_windows:.4f} s"
          f"; worker phases {rounded(worker.phase_seconds)}")
    del dispatcher, servicer, master, worker, model
    torch.cuda.empty_cache()
    peak_step_memory()
    torch.cuda.empty_cache()
    return launches, window_launches


def phase_window_process_job(tmp) -> dict:
    """`master.main ... --local_updates 4 --sync_dtype bfloat16
    --worker_backend process` with 2 workers on the card, 4 shards of 64
    records (32 steps). Returns the launches summed over the workers."""
    from elasticdl_tpu_torch.common.constants import ENV_WORKER_LOG_DIR
    from elasticdl_tpu_torch.master import main as master_main
    from elasticdl_tpu_torch.master.checkpoint import load_model_file
    from elasticdl_tpu_torch.worker.main import read_summaries

    data = os.path.join(tmp, "window-process-data")
    log_dir = os.path.join(tmp, "window-process-logs")
    with logs_on_failure(log_dir):
        output = os.path.join(tmp, "window-process.ckpt")
        write_shards(data, 4)
        steps = 4 * SHARD_RECORDS // BATCH
        os.environ[ENV_WORKER_LOG_DIR] = log_dir
        try:
            t0 = time.perf_counter()
            rc, master = master_main.run(master_argv(data, 2, output) + WINDOW_ARGS)
            wall = time.perf_counter() - t0
        finally:
            del os.environ[ENV_WORKER_LOG_DIR]
        if rc != 0:
            raise AssertionError(f"master.main (window mode) exited {rc}")
        model = load_model_file(output)
        summaries = read_summaries(log_dir)
        if sorted(summaries) != [0, 1]:
            raise AssertionError(f"worker summaries of {sorted(summaries)}, of [0, 1] expected")
        accepted = sum(s["steps_accepted"] for s in summaries.values())
        computed = sum(s["steps_computed"] for s in summaries.values())
        exactness = {k: master[k] for k in ("version", "init_version", "applied_update_steps")}
        windows = [w for s in summaries.values() for w in s["windows"]]
        print(f"window process job: rc {rc}, version {model.version}, {wall:.2f} s, "
              f"{steps * BATCH * SEQ / wall:.1f} tokens/s over the whole run (worker boot "
              f"included), {window_steady(windows):.1f} tokens/s from the first to the last "
              f"window sync; exactness {exactness}; steps computed {computed}, accepted "
              f"{accepted}")
        for wid, s in summaries.items():
            n = max(1, len(s["windows"]))
            print(f"window process worker {wid}: {s['steps_accepted']} steps in "
                  f"{len(s['windows'])} syncs, {s['merged_back']} merged-back absorbs, sync "
                  f"seconds per sync {rounded({k: v / n for k, v in s['sync_seconds'].items()})}, "
                  f"phase seconds {rounded(s['phase_seconds'])}, client seconds "
                  f"{rounded(s['rpc_seconds'])}, launches {s['launches']}, fallbacks "
                  f"{s['attention_fallbacks']}")
        server = master["server"]
        print(f"window process master: server handler seconds "
              f"{rounded(server['handler_seconds'])}, calls {server['calls']}")
        if model.version != steps or accepted != steps or exactness["version"] != steps:
            raise AssertionError(f"--output version {model.version}, workers' applied steps "
                                 f"{accepted}, exactness {exactness}: {steps} expected")
        if exactness["version"] != exactness["init_version"] + exactness["applied_update_steps"]:
            raise AssertionError(f"exactness block broken: {exactness}")
        if computed != accepted:
            raise AssertionError(f"{computed} steps computed for {accepted} applied")
        check_params(model.params, "window process job")
        for wid, s in summaries.items():
            want = want_launches(64, dict.fromkeys(KERNELS,
                                                   SLICE["n_layers"] * s["steps_computed"]))
            if s["launches"] != want or s["attention_fallbacks"]:
                raise AssertionError(f"worker {wid} launches {s['launches']}, {want} expected, "
                                     f"fallbacks {s['attention_fallbacks']}")
            if not all(math.isfinite(loss) for _t, _n, loss in s["windows"]):
                raise AssertionError(f"worker {wid}: window losses not finite")
        return summed_launches(summaries)


def job_parts(tmp, name, extra_argv=()):
    """The master's parts for a 2-worker job on the card over 4 shards,
    driven directly as master.main wires them; the dispatcher's
    recover_tasks records what it requeues."""
    from elasticdl_tpu_torch.cluster.pod_backend import ProcessBackend
    from elasticdl_tpu_torch.common.args import master_parser, parse_envs, worker_forward_args
    from elasticdl_tpu_torch.master.main import build_master
    from elasticdl_tpu_torch.master.worker_manager import WorkerManager
    from elasticdl_tpu_torch.rpc.server import RpcServer

    data, log_dir = os.path.join(tmp, f"{name}-data"), os.path.join(tmp, f"{name}-logs")
    write_shards(data, 4)
    args = master_parser().parse_args(master_argv(data, 2, "") + list(extra_argv))
    _spec, dispatcher, servicer = build_master(args)
    requeued = []
    recover = dispatcher.recover_tasks

    def recording_recover(worker_id):
        with dispatcher._lock:
            requeued.extend(t for t, (w, _) in dispatcher._doing.items() if w == worker_id)
        recover(worker_id)

    dispatcher.recover_tasks = recording_recover
    server = RpcServer(servicer.handlers(), port=0)
    server.start()
    addr = f"localhost:{server.port}"
    backend = ProcessBackend(log_dir=log_dir)
    manager = WorkerManager(backend, dispatcher, num_workers=2,
                            worker_argv_fn=lambda wid: worker_forward_args(args, wid, addr),
                            envs=parse_envs(args.envs), max_relaunches=4)
    return dispatcher, servicer, server, backend, manager, requeued, log_dir


def signal_worker0(dispatcher, backend, sig, ready=lambda: True):
    """Once worker 0 holds a task (and `ready()`), send it `sig`; returns
    (pid, tasks held, time sent)."""
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        with dispatcher._lock:
            holds = [t for t, (wid, _) in dispatcher._doing.items() if wid == 0]
        pid = backend.pid_of(0)
        if holds and pid and ready():
            os.kill(pid, sig)
            return pid, holds, time.perf_counter()
        time.sleep(0.01)
    raise AssertionError("worker 0 never held a task when it could be signalled")


def window_landed(servicer):
    """A readiness test for signal_worker0: a window has landed on the
    PS, so worker 0's later windows are in flight."""
    return lambda: servicer.exactness()["applied_update_steps"] > 0


def run_to_end(dispatcher, manager, backend, server) -> float:
    """Wait for the job to finish and the workers to leave, then tear
    down; returns when the dispatcher finished (perf_counter)."""
    try:
        deadline = time.monotonic() + 600
        while not dispatcher.finished() and time.monotonic() < deadline:
            time.sleep(0.1)
        finished_at = time.perf_counter()
        deadline = time.monotonic() + 60
        while not manager.all_exited() and time.monotonic() < deadline:
            time.sleep(0.1)
    finally:
        manager.stop_relaunch_and_remove_workers()
        backend.stop()
        server.stop()
    return finished_at


def phase_preemption(tmp):
    """2 workers on the card over 4 shards (32 minibatches); worker 0 is
    SIGKILLed once it holds a task."""
    from elasticdl_tpu_torch.worker.main import read_summaries

    dispatcher, servicer, server, backend, manager, _requeued, log_dir = job_parts(
        tmp, "preempt")
    with logs_on_failure(log_dir):
        minibatches = 4 * SHARD_RECORDS // BATCH
        t0 = time.perf_counter()
        manager.start_workers()
        try:
            victim, holds, killed_at = signal_worker0(dispatcher, backend, signal.SIGKILL)
        finally:
            finished_at = run_to_end(dispatcher, manager, backend, server)
        wall = finished_at - t0
        finished, failed = dispatcher.finished(), dispatcher.has_failed_tasks()
        relaunches, phases = manager.relaunches(), manager.phases()
        ex = servicer.exactness()
        summaries = read_summaries(log_dir)
        losses = [x for s in summaries.values() for x in s["losses"]]
        replacement = summaries.get(2, {}).get("accepted_at", [])
        print(f"preemption: worker 0 (pid {victim}) SIGKILLed holding task(s) {holds}; "
              f"finished {finished} in {wall:.2f} s, failed tasks {failed}, relaunches "
              f"{relaunches}, phases {phases}, exactness {ex}; replacement's first accepted "
              + (f"step {replacement[0] - killed_at:.2f} s after the kill" if replacement
                 else "step: none (the survivor finished the job)"))
        for wid, s in summaries.items():
            print(f"preemption worker {wid}: {s['steps_accepted']} accepted, "
                  f"{s['steps_computed']} computed, launches {s['launches']}")
        if not finished or failed:
            raise AssertionError(f"the job did not finish cleanly (failed tasks: {failed})")
        if relaunches < 1 or 2 not in phases:
            raise AssertionError(f"no replacement with a fresh id: {relaunches}, {phases}")
        if ex["version"] != ex["init_version"] + ex["applied_update_steps"]:
            raise AssertionError(f"exactness block broken: {ex}")
        if ex["applied_update_steps"] < minibatches:
            raise AssertionError(f"{ex['applied_update_steps']} updates, {minibatches} expected")
        if not losses or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"losses not finite: {losses}")
        check_params(servicer.get_params_copy()[0], "preemption job")


def phase_window_drain(tmp):
    """SIGTERM to a window-mode worker mid-window: it drains (exit 0, its
    drain line), the dispatcher requeues nothing and the versions count
    every record once. Then SIGKILL in a second job: its unsynced tasks
    are requeued and the job finishes with no failed task."""
    from elasticdl_tpu_torch.cluster.pod_backend import PodPhase
    from elasticdl_tpu_torch.worker.main import read_summaries

    steps = 4 * SHARD_RECORDS // BATCH
    dispatcher, servicer, server, backend, manager, requeued, log_dir = job_parts(
        tmp, "drain", WINDOW_ARGS)
    with logs_on_failure(log_dir):
        manager.start_workers()
        exit_at = None
        try:
            pid, holds, sent = signal_worker0(dispatcher, backend, signal.SIGTERM,
                                               window_landed(servicer))
            while backend.pid_of(0) is not None and time.perf_counter() - sent < 120:
                time.sleep(0.01)
            exit_at = time.perf_counter()
        finally:
            run_to_end(dispatcher, manager, backend, server)
        ex = servicer.exactness()
        phases, relaunches = manager.phases(), manager.relaunches()
        with open(os.path.join(log_dir, "worker-0.log")) as f:
            drain_line = "drain requested, exiting at task boundary" in f.read()
        summaries = read_summaries(log_dir)
        print(f"window drain: worker 0 (pid {pid}) sent SIGTERM holding task(s) {holds} with "
              f"{ex['applied_update_steps']} steps applied by the end; exited "
              f"{exit_at - sent:.2f} s later, phase {phases.get(0)}, drain line {drain_line}, "
              f"drained {summaries.get(0, {}).get('drained')}, requeued {requeued}, relaunches "
              f"{relaunches}, exactness {ex}, records completed "
              f"{dispatcher.completed_records()}")
        if phases.get(0) != PodPhase.SUCCEEDED or not drain_line:
            raise AssertionError(f"worker 0 did not drain and exit 0: phase {phases.get(0)}, "
                                 f"drain line {drain_line}")
        if requeued or relaunches:
            raise AssertionError(f"the drain requeued {requeued}, relaunched {relaunches}")
        if not dispatcher.finished() or dispatcher.has_failed_tasks():
            raise AssertionError("the drained job did not finish cleanly")
        if ex != {"version": steps, "init_version": 0, "applied_update_steps": steps}:
            raise AssertionError(f"exactness {ex}: each of {steps} steps applied once expected")
        check_params(servicer.get_params_copy()[0], "window drain job")

    dispatcher, servicer, server, backend, manager, requeued, log_dir = job_parts(
        tmp, "window-kill", WINDOW_ARGS)
    with logs_on_failure(log_dir):
        manager.start_workers()
        try:
            pid, holds, _sent = signal_worker0(dispatcher, backend, signal.SIGKILL,
                                               window_landed(servicer))
        finally:
            run_to_end(dispatcher, manager, backend, server)
        ex = servicer.exactness()
        phases, relaunches = manager.phases(), manager.relaunches()
        deduped = servicer.duplicate_local_updates
        print(f"window SIGKILL: worker 0 (pid {pid}) killed holding task(s) {holds}; requeued "
              f"{requeued}, relaunches {relaunches}, phases {phases}, failed tasks "
              f"{dispatcher.has_failed_tasks()}, exactness {ex}, replayed windows deduped "
              f"{deduped}")
        if not requeued:
            raise AssertionError("the killed worker's tasks were not requeued")
        if not dispatcher.finished() or dispatcher.has_failed_tasks():
            raise AssertionError("the job did not finish cleanly after the SIGKILL")
        if ex != {"version": steps, "init_version": 0, "applied_update_steps": steps}:
            raise AssertionError(f"exactness {ex}: each of {steps} steps applied once expected "
                                 f"(replayed windows deduped by their report keys)")
        check_params(servicer.get_params_copy()[0], "window SIGKILL job")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from elasticdl_tpu_torch.ops import build
    from elasticdl_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    lib = build.library_path("flash_attention")
    if os.path.exists(lib):
        os.remove(lib)  # build from the checkout's source in this run
    t0 = time.perf_counter()
    build.build("flash_attention")
    print(f"built flash_attention.cu in {time.perf_counter() - t0:.2f} s")
    with open(os.path.join(build.BUILD_DIR, "flash_attention.log")) as f:
        registers = check_ptxas(f.read())

    rows, pairs = phase_kernels(fa)
    phase_model_reference()
    with tempfile.TemporaryDirectory() as tmp:
        counts = {}
        counts["launches"] = phase_train(fa, tmp)
        phase_profile(tmp)
        counts["window_launches"] = phase_window(fa, tmp)
        phase_window_profile(tmp)
        phase_ef_card(slice_param_count())
        phase_zoo_default(fa, tmp)
        counts["large_launches"], counts["large_window_launches"] = phase_large(fa, tmp)
        torch.cuda.empty_cache()  # leave the card's memory to the workers
        counts["process_launches"] = phase_process_job(tmp)
        phase_preemption(tmp)
        counts["window_process_launches"] = phase_window_process_job(tmp)
        phase_window_drain(tmp)
    # each row's counts are its own kernel's at its own head dim, per path
    for by_kernel in rows.values():
        for row in by_kernel.values():
            for path, launches in counts.items():
                row[path] = launches[row["name"]]
            # `launches`: the main path of the row's head dim, the base
            # per-step run at 64 and the large per-step run at 128
            row["launches"] = row["large_launches" if row["head_dim"] == 128 else "launches"]
    print(json.dumps({
        "kernels": [row for by_kernel in rows.values() for row in by_kernel.values()],
        "backward_pair": {f"d{d}": pair for d, pair in pairs.items()},
        "ptxas_registers": {f"{n}<{d}>": r for (n, d), r in sorted(registers.items())},
    }))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

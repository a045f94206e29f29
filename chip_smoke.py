"""On-card smoke run of the PyTorch/H100 port (`elasticdl_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero on any failure and prints
its result lines only when every phase passed:

1. the card's name and power limit (`nvidia-smi`);
2. builds the attention kernels from `elasticdl_tpu_torch/ops/csrc/`,
   prints ptxas's register, shared-memory and spill lines, and fails if
   a tensor-core kernel spills;
3. holds each kernel against its plain PyTorch version on the card, at
   the training slice's shapes in bfloat16, at a small shape in float32,
   and at [1, 192, 3, 64] (L a multiple of 64 but not of 128, B*H odd)
   in both dtypes, causal and not, under a limit per output; each
   backward check runs once on the plain forward's lse and once on the
   kernel's own lse and o. Times kernel, plain version and the library
   yardsticks, which the port never calls: `F.scaled_dot_product_attention`
   for the forward, and one call of aten's flash-attention backward
   (dq, dk and dv together, checked against the plain versions) for the
   backward pair. Then checks the model's forward and backward against
   the materializing reference;
4. trains the base transformer (vocab 8192, d_model 512, 8 heads,
   d_ff 2048, 8 layers, bfloat16 compute, batch 8 x seq 1024) for 8
   per-step updates through the port's in-process master/PS loop, and
   checks the exactness block, the losses, the kernels' launch counts
   and that the parameters moved; then profiles a short second run for
   the device time by kernel;
5. prints the kernels' JSON line (one row per kernel; the backward
   pair's yardstick once, as `backward_pair`, since no single kernel's
   row matches it), the card line, and the result line.

Float32 products run in full float32: TF32 is switched off for matmuls
and cuDNN.
"""

import json
import math
import os
import re
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


def check_close(name, got, want, tols, failures) -> list:
    """Per tensor (got[i] against want[i] under tols[i]): max |got - want|
    and the largest share of its limit atol + rtol*|want| that an element
    uses. A share above 1 or a non-finite output is added to `failures`."""
    readings = []
    for g, w, tol in zip(got, want, tols):
        g, w = g.float(), w.float()
        err = (g - w).abs()
        share = (err / (tol["atol"] + tol["rtol"] * w.abs())).max().item()
        readings.append((err.max().item(), share))
        if not torch.isfinite(g).all():
            failures.append(f"{name}: kernel output is not finite")
        elif share > 1:
            failures.append(f"{name}: max |kernel - plain| {err.max().item():.3e}, "
                            f"{share:.2f}x the limit {tol}")
    return readings


def reading_text(readings) -> str:
    return ", ".join(f"{err:.3e} ({share:.2f} of its limit)" for err, share in readings)


def attention_inputs(b, L, h, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [
        torch.randn(b, L, h, 64, device="cuda", generator=g).to(dtype)
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
    lse and delta; returns their readings (dq; dk, dv)."""
    dq = fa.flash_dq(q, k, v, do, lse, delta, causal)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    grad = tols["grad"]
    return {
        "flash_dq": check_close(
            f"flash_dq {tag}", (dq,), (fa.plain_dq(q, k, v, do, lse, delta, causal),),
            (grad,), failures,
        ),
        "flash_dkv": check_close(
            f"flash_dkv {tag}", (dk, dv), fa.plain_dkv(q, k, v, do, lse, delta, causal),
            (grad, grad), failures,
        ),
    }


def library_backward(fa, q, k, v, do) -> dict:
    """The backward pair's yardstick: one call of aten's flash-attention
    backward, which computes dq, dk and dv together (the port never calls
    it), on [B, H, L, D] views of the same bf16 inputs, causal. Its
    gradients are held against plain_dq / plain_dkv fed its own lse and o;
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
        (BF16_TOL["grad"],) * 3, failures,
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


def phase_kernels(fa):
    """Kernel vs plain version on the card; returns the per-kernel rows
    (without launches) at the slice's shapes and the backward pair's
    yardstick. Prints every check's
    readings (max |err| and share of the limit, per output) and raises
    after the last if any was beyond its limit."""
    import torch.nn.functional as F

    failures = []
    for dtype, shape, causals in (
        (torch.float32, (2, 256, 2), (True,)),
        (torch.float32, (1, 192, 3), (True, False)),
        (torch.bfloat16, (1, 192, 3), (True, False)),
        (torch.bfloat16, (BATCH, SEQ, SLICE["n_heads"]), (True,)),
    ):
        q, k, v, do = attention_inputs(*shape, dtype, seed=1)
        tols = TOLS[dtype]
        for causal in causals:
            tag = f"{dtype} {tuple(q.shape)} causal={causal}"
            o, lse = fa.flash_forward(q, k, v, causal)
            po, plse = fa.plain_forward(q, k, v, causal)
            torch.cuda.synchronize()
            readings = {"flash_forward": check_close(
                f"flash_forward {tag}", (o, lse), (po, plse), (tols["o"], tols["lse"]), failures
            )}
            # on the plain forward's residuals, then on the kernel's own (fwd -> bwd)
            delta = fa.attention_delta(do, po)
            readings.update(backward_errs(
                fa, q, k, v, do, plse, delta, causal, tols, tag, failures
            ))
            own = backward_errs(
                fa, q, k, v, do, lse, fa.attention_delta(do, o), causal, tols,
                tag + " own lse", failures,
            )
            print(f"kernels vs plain, {tag}: forward (o, lse) "
                  f"{reading_text(readings['flash_forward'])}; dq "
                  f"{reading_text(readings['flash_dq'])}; dk+dv (dk, dv) "
                  f"{reading_text(readings['flash_dkv'])}; on the kernel's lse and o: dq "
                  f"{reading_text(own['flash_dq'])}; dk+dv {reading_text(own['flash_dkv'])}")
    if failures:
        raise AssertionError("kernels disagree with their plain versions:\n"
                             + "\n".join(failures))

    # the slice's shapes (bf16) stay from the loop's last pass
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    pair = library_backward(fa, q, k, v, do)
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
    for name, (ops, nbytes) in bounds(BATCH, SEQ, SLICE["n_heads"], 64).items():
        ms, plain_ms, library_ms = timings[name]
        ops_ms, bytes_ms = ops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        rows[name] = {
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[name],
            "max_abs_err": max(err for err, _share in readings[name]),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": library_ms,
            "bound_share": max(ops_ms, bytes_ms) / ms,
        }
        print(f"{name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
              f"{rows[name]['bound_ms']:.4f} ms by {rows[name]['bound_by']}, "
              f"share {rows[name]['bound_share']:.3f}, {ops / ms / 1e9:.1f} TFLOP/s)")
    return rows, pair


def check_ptxas(log: str):
    """Prints ptxas's lines per kernel (entry, registers, shared memory,
    spills); raises if a kernel of NO_SPILL spills."""
    kernel = None
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            kernel = line.split()[-1].strip("'") if "properties" in line else line.split("'")[1]
        if any(w in line for w in ("Compiling entry", "registers", "spill", "smem")):
            print(line.strip())
        if "spill stores" in line and kernel and any(n in kernel for n in NO_SPILL):
            stores, loads = (int(x.split()[0]) for x in line.split(",")[1:3])
            if stores or loads:
                raise AssertionError(f"{kernel} spills: {line.strip()}")


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


def slice_job(path, n_records):
    """The slice's in-process master/PS and one worker on the card, over
    `n_records` token records in tasks of half of them."""
    from elasticdl_tpu_torch.api.model_spec_helpers import spec_from_module
    from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
    from elasticdl_tpu_torch.models import transformer_lm_zoo as zoo
    from elasticdl_tpu_torch.models.record_codec import write_learnable_token_records
    from elasticdl_tpu_torch.testing import InProcessMaster, build_job
    from elasticdl_tpu_torch.worker.worker import Worker

    write_learnable_token_records(path, n_records, SEQ, SLICE["vocab"], seed=0)
    dispatcher = TaskDispatcher({path: n_records}, {}, {}, n_records // 2, 1, shuffle_seed=0)
    model = zoo.custom_model(**SLICE, dtype=torch.bfloat16)
    spec = spec_from_module(zoo, model=model)
    servicer = build_job(spec, dispatcher, grads_to_wait=1)
    master = InProcessMaster(servicer)
    worker = Worker(0, master, spec, minibatch_size=BATCH, device="cuda", seed=0)
    return dispatcher, servicer, master, worker, model


def phase_train(fa, tmp):
    """The slice's main path: 8 per-step updates on the card."""
    from elasticdl_tpu_torch.common import codec

    dispatcher, servicer, master, worker, model = slice_job(
        os.path.join(tmp, "train.rio"), BATCH * STEPS
    )
    for wrapper in (fa.flash_forward, fa.flash_dq, fa.flash_dkv):
        wrapper.launches = 0
    t0 = time.perf_counter()
    ok = worker.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in (fa.flash_forward, fa.flash_dq, fa.flash_dkv)}
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
    want = SLICE["n_layers"] * STEPS
    if any(n != want for n in launches.values()):
        raise AssertionError(f"kernel launches {launches}, {want} each expected")
    final, _aux, _v = servicer.get_params_copy()
    if np.array_equal(codec.ravel_np(final), codec.ravel_np(model.init_params(0))):
        raise AssertionError("the parameters did not move")

    times = [t for t, _loss in worker.step_log]
    tokens = BATCH * SEQ
    steady = (len(times) - 1) * tokens / (times[-1] - times[0])
    rounded = lambda c: {k: round(v, 3) for k, v in c.items()}  # noqa: E731
    print(f"slice throughput: {STEPS * tokens / wall:.1f} tokens/s over the whole "
          f"run ({wall:.2f} s incl. model init), {steady:.1f} tokens/s over "
          f"steps 2-{STEPS}")
    print(f"host breakdown (s, whole run): worker {rounded(worker.phase_seconds)}, "
          f"servicer handlers {rounded(master.handler_seconds)}, "
          f"wire codec {rounded(master.codec_seconds)}")
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
        check_ptxas(f.read())

    rows, pair = phase_kernels(fa)
    phase_model_reference()
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_train(fa, tmp)
        phase_profile(tmp)
    for name, row in rows.items():
        row["launches"] = launches[name]
    print(json.dumps({"kernels": list(rows.values()), "backward_pair": pair}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
